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
