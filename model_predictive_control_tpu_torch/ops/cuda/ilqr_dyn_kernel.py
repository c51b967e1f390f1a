"""The 6-state Pacejka single-track model as a tracker model for the fused
tracker kernel, and the dynamic racing tier's solve (port of
``ops/pallas/ilqr_dyn_kernel.py``).

The rows are ``models/bicycle.py::dynamic_bicycle_ode`` in row form, with
``torch.atan`` where the reference carries its Mosaic polynomial ``matan``
(CUDA has ``atanf``; the two differ by at most 1.3e-7). Divisions by the
constants ``M``, ``I_z`` and 0.01 are multiplications by their float32
reciprocals, as XLA compiles the reference.
"""

from __future__ import annotations

import functools

import torch

from .ilqr_factory import (
    DEFAULT_TILE,
    BatchedTrackerSolution,
    TrackerModel,
    fused_tracker_solve_cuda,
    fused_tracker_solve_twin,
)
from .ilqr_kernel import inv_f32

NXD = 6  # (p_x, p_y, psi, v_x, v_y, omega)
NU = 2  # (drive a, steer delta)

BatchedDynILQRSolution = BatchedTrackerSolution


def model_tuple(params) -> tuple:
    """Static Pacejka/motor parameter tuple, in the JAX package's field
    order, from a ``VehicleParameters`` (floats)."""
    return tuple(
        float(getattr(params, f))
        for f in (
            "axis_front", "axis_rear", "mass", "inertia",
            "bf", "cf", "df", "br", "cr", "dr",
            "cm1", "cm2", "cr1", "cr2",
        )
    )


@functools.lru_cache(maxsize=64)
def make_pacejka_ode_rows(model: tuple) -> TrackerModel:
    """Row-form dynamic single-track ODE from :func:`model_tuple`. C++
    instantiation ``PacejkaRows``, constants ``(l_f, l_r, 1/m, 1/I_z, b_f,
    c_f, d_f, b_r, c_r, d_r, cm1, cm2, cr1, cr2, 1/0.01)``."""
    LF, LR, M_, IZ, BF, CF, DF, BR, CR, DR, CM1, CM2, CR1, CR2 = model
    inv_m, inv_iz, inv_eps = inv_f32(M_), inv_f32(IZ), inv_f32(0.01)

    def ode_rows(xr, ur):
        _px, _py, psi, vx, vy, om = xr
        a, dl = ur
        eps = 1e-2
        vx_safe = torch.where(vx >= 0.0, torch.clamp(vx, min=eps), torch.clamp(vx, max=-eps))
        alpha_f = dl - torch.atan((om * LF + vy) / vx_safe)
        alpha_r = torch.atan((om * LR - vy) / vx_safe)
        F_f = DF * torch.sin(CF * torch.atan(BF * alpha_f))
        F_r = DR * torch.sin(CR * torch.atan(BR * alpha_r))
        F_x = (CM1 - CM2 * vx) * a - CR2 * vx * torch.abs(vx) - CR1 * torch.tanh(vx * inv_eps)
        sp, cp = torch.sin(psi), torch.cos(psi)
        sd, cd = torch.sin(dl), torch.cos(dl)
        return (
            vx * cp - vy * sp,
            vx * sp + vy * cp,
            om,
            (F_x - F_f * sd) * inv_m + vy * om,
            (F_r + F_f * cd) * inv_m - vx * om,
            (F_f * LF * cd - F_r * LR) * inv_iz,
        )

    return TrackerModel(
        rows=ode_rows, kernel="pacejka",
        consts=(LF, LR, inv_m, inv_iz, BF, CF, DF, BR, CR, DR, CM1, CM2, CR1, CR2, inv_eps),
        nx=NXD, nu=NU,
    )


def _dyn_kwargs(N, ts, substeps, model, limits, weights, outer_iters, inner_iters, mu_init,
                mu_scale, mu_max, viol_tol, tol, tile, group):
    return dict(
        ode_rows=make_pacejka_ode_rows(model), nx=NXD, nu=NU, N=N, ts=float(ts),
        substeps=substeps, limits=limits, weights=weights, outer_iters=outer_iters,
        inner_iters=inner_iters, mu_init=mu_init, mu_scale=mu_scale, mu_max=mu_max,
        viol_tol=viol_tol, tol=tol, tile=tile, group=group,
    )


def al_ilqr_dyn_solve_cuda(
    x0s: torch.Tensor,  # (B, 6)
    u_init: torch.Tensor,  # (B, N, 2)
    refs: torch.Tensor,  # (B, N + 1, 6) tracking reference windows
    *,
    N: int,
    ts: float,
    substeps: int,
    model: tuple,  # model_tuple(params)
    limits: tuple,  # (lb_u(2), ub_u(2))
    weights: tuple,  # (Qd(6), Rd(2), qn)
    outer_iters: int = 6,
    inner_iters: int = 15,
    mu_init: float = 10.0,
    mu_scale: float = 10.0,
    mu_max: float = 1e8,
    viol_tol: float = 1e-4,
    tol: float = 1e-6,
    tile: int = DEFAULT_TILE,
    group: int | None = None,
) -> BatchedTrackerSolution:
    """Batched 6-state Pacejka tracking AL-iLQR with RK4×``substeps``
    prediction and an input box: the kernel for CUDA tensors, its twin for
    CPU tensors (the JAX package's ``al_ilqr_dyn_solve_pallas``). ``group``:
    threads per lane on the card (``fused_tracker_solve_cuda``)."""
    return fused_tracker_solve_cuda(
        x0s, u_init, refs, **_dyn_kwargs(N, ts, substeps, model, limits, weights, outer_iters,
                                         inner_iters, mu_init, mu_scale, mu_max, viol_tol,
                                         tol, tile, group)
    )


def al_ilqr_dyn_solve_twin(
    x0s, u_init, refs, *, N, ts, substeps, model, limits, weights, outer_iters=6,
    inner_iters=15, mu_init=10.0, mu_scale=10.0, mu_max=1e8, viol_tol=1e-4, tol=1e-6,
    tile=DEFAULT_TILE, group=None,
) -> BatchedTrackerSolution:
    """:func:`al_ilqr_dyn_solve_cuda` on the plain twin, on any device."""
    return fused_tracker_solve_twin(
        x0s, u_init, refs, **_dyn_kwargs(N, ts, substeps, model, limits, weights, outer_iters,
                                         inner_iters, mu_init, mu_scale, mu_max, viol_tol,
                                         tol, tile, group)
    )
