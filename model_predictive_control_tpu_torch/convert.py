"""Build the port's dataclasses from the JAX package's objects.

Takes a numpy copy of each field by name, so this module needs no JAX import:
it reads attributes of whatever object it is given. The tests use it to feed
both packages the same operator and the same vehicle parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .utils.device import resolve_device


def from_jax_arrays(obj, cls, *, device=None, dtype=torch.float32):
    """A ``cls`` instance (e.g. :class:`~.ops.condensed.CondensedQP` or
    :class:`~.solvers.qp.QPOperator`) whose fields are copied from ``obj``'s
    attributes of the same names. Integer fields stay Python ints; array
    fields become tensors of ``dtype`` on ``device`` (the card when ``None``)."""
    device = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(cls):
        value = getattr(obj, f.name)
        if f.type in ("int", "bool"):
            kwargs[f.name] = {"int": int, "bool": bool}[f.type](np.asarray(value))
        else:
            kwargs[f.name] = torch.as_tensor(
                np.array(value, dtype=np.float64), dtype=dtype, device=device
            )
    return cls(**kwargs)


def vehicle_parameters_from_jax(params, *, device=None, dtype=torch.float32):
    """A port :class:`~.models.parameters.VehicleParameters` from the JAX
    package's: a 0-d field becomes a Python float, a ``(B,)`` field a
    tensor of ``dtype`` on ``device`` (the card when ``None``)."""
    from .models.parameters import VehicleParameters

    device = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(VehicleParameters):
        value = np.asarray(getattr(params, f.name))
        kwargs[f.name] = (
            float(value)
            if value.ndim == 0
            else torch.as_tensor(value.astype(np.float64), dtype=dtype, device=device)
        )
    return VehicleParameters(**kwargs)


def stagewise_mpc_from_jax(ctrl, *, device=None, dtype=torch.float32):
    """A port :class:`~.solvers.riccati_ip.StagewiseMPC` from the JAX
    package's: its nine arrays as tensors of ``dtype`` on ``device``, with
    its ``N``, ``iters`` and ``parallel``, so that both compute the same
    thing."""
    from .solvers.riccati_ip import StagewiseMPC

    return from_jax_arrays(ctrl, StagewiseMPC, device=device, dtype=dtype)


def _t(value, dtype, device):
    return torch.as_tensor(np.array(value, dtype=np.float64), dtype=dtype, device=device)


def tracking_nmpc_from_jax(ctrl, step_fn, *, device=None, dtype=torch.float32):
    """A port :class:`~.solvers.nmpc_tracking.TrackingNMPC` from the JAX
    package's: its weights, input box and reference as tensors of ``dtype``
    on ``device`` (the card when ``None``), its horizon, tube and budgets;
    ``step_fn`` is the port's prediction step (a JAX closure cannot be
    copied)."""
    from .solvers.nmpc_tracking import TrackingNMPC

    device = resolve_device(device)
    t = lambda a: _t(a, dtype, device)
    return TrackingNMPC(step_fn, nx=ctrl.nx, nu=ctrl.nu, N=ctrl.N, Q=t(ctrl.Q), R=t(ctrl.R),
                        QN=t(ctrl.QN), u_lb=t(ctrl.u_lb), u_ub=t(ctrl.u_ub),
                        ref_traj=t(ctrl.ref_traj), tube_radius=ctrl.tube_radius,
                        outer_iters=ctrl.outer_iters, inner_iters=ctrl.inner_iters)


def nonlinear_mhe_from_jax(mhe, step_fn, obs_fn, *, device=None, dtype=torch.float32):
    """A port :class:`~.estimation_nl.NonlinearMHE` from the JAX package's:
    ``Qw``, ``Rv``, ``P0`` and the state bounds copied through numpy as
    tensors of ``dtype`` on ``device`` (the card when ``None``), its window
    and its iteration settings; ``step_fn`` / ``obs_fn`` are the port's
    functions (a JAX closure cannot be copied)."""
    from .estimation_nl import NonlinearMHE

    device = resolve_device(device)
    t = lambda a: None if a is None else _t(a, dtype, device)
    return NonlinearMHE(step_fn, obs_fn, t(mhe.Qw), t(mhe.Rv), t(mhe.P0), mhe.M, mhe.nx,
                        x_min=t(mhe.x_min), x_max=t(mhe.x_max), gn_iters=mhe.gn_iters,
                        qp_iters=mhe.qp_iters, qp_solver=mhe.qp_solver,
                        propagate_arrival=mhe.propagate_arrival, reg=mhe.reg)


def _copy_ekf(port_ctrl, ctrl, dtype, device):
    """The augmented EKF's covariances as the JAX object holds them (its
    constructor's scalars are not kept there), copied over the port
    object's."""
    for name in ("Qw", "Rv_mat"):
        setattr(port_ctrl, name, _t(getattr(ctrl, name), dtype, device))
    return port_ctrl


def offset_free_nmpc_from_jax(ctrl, step_fn, obs_fn=None, *, device=None, dtype=torch.float32):
    """A port :class:`~.solvers.offset_free_nmpc.OffsetFreeNMPC` from the JAX
    package's: ``r``, ``H``, ``Bd``, the EKF covariances, the weights and
    boxes as tensors of ``dtype`` on ``device`` (the card when ``None``);
    ``step_fn`` / ``obs_fn`` are the port's functions."""
    from .solvers.offset_free_nmpc import OffsetFreeNMPC

    device = resolve_device(device)
    t = lambda a: None if a is None else _t(a, dtype, device)
    out = OffsetFreeNMPC(step_fn, nx=ctrl.nx, nu=ctrl.nu, N=ctrl.N, Q=t(ctrl.Q), R=t(ctrl.R),
                         QN=t(ctrl.QN), u_lb=t(ctrl.u_lb), u_ub=t(ctrl.u_ub), r=t(ctrl.r),
                         H=t(ctrl.H), Bd=t(ctrl.Bd), obs_fn=obs_fn, x_lb=t(ctrl.x_lb),
                         x_ub=t(ctrl.x_ub), newton_iters=ctrl.newton_iters,
                         outer_iters=ctrl.outer_iters, inner_iters=ctrl.inner_iters,
                         dtype=dtype, device=device)
    return _copy_ekf(out, ctrl, dtype, device)


def disturbance_compensated_tracking_from_jax(ctrl, step_fn, obs_fn=None, *, device=None,
                                              dtype=torch.float32):
    """A port :class:`~.solvers.offset_free_nmpc.DisturbanceCompensatedTracking`
    from the JAX package's, as :func:`offset_free_nmpc_from_jax` (its
    reference, ``ts`` and re-projection too)."""
    from .solvers.offset_free_nmpc import DisturbanceCompensatedTracking

    device = resolve_device(device)
    t = lambda a: _t(a, dtype, device)
    out = DisturbanceCompensatedTracking(
        step_fn, nx=ctrl.nx, nu=ctrl.nu, N=ctrl.N, Q=t(ctrl.Q), R=t(ctrl.R), QN=t(ctrl.QN),
        u_lb=t(ctrl.u_lb), u_ub=t(ctrl.u_ub), ref_traj=t(ctrl.ref_traj), Bd=t(ctrl.Bd),
        obs_fn=obs_fn, outer_iters=ctrl.outer_iters, inner_iters=ctrl.inner_iters, ts=ctrl.ts,
        reproject=ctrl.reproject, dtype=dtype, device=device)
    return _copy_ekf(out, ctrl, dtype, device)


def tuning_theta_from_jax(theta, *, device=None, dtype=torch.float64):
    """A tuning parameter set from the JAX package's: a ``dict`` of arrays
    (``{"logQ", "logR"}`` of the parking tier) becomes a ``dict`` of tensors
    of ``dtype`` on ``device`` (the card when ``None``)."""
    device = resolve_device(device)
    return {k: _t(v, dtype, device) for k, v in theta.items()}


def tune_result_from_jax(res, *, device=None, dtype=torch.float64):
    """A port :class:`~.tuning.TuneResult` from the JAX package's
    ``tune_mpc_weights`` result, every field a tensor of ``dtype`` on
    ``device`` (the card when ``None``)."""
    from .tuning import TuneResult

    device = resolve_device(device)
    return TuneResult(*(_t(getattr(res, f), dtype, device) for f in TuneResult._fields))
