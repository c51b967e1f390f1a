"""The reference's obstacle-parking OCP through the fused tracker kernel
(port of ``ops/pallas/parking_factory.py``).

The instantiation, with no kernel code of its own: the kinematic bicycle in
row form with per-scenario ``pr = (acc, fric)`` (:func:`make_parking_ode_rows`,
C++ ``KinematicRows``; one Euler substep of it is the parking kernel's
discrete map, and the kinematic racing sweep predicts with it), the nine
covering-circle clearances as user constraint rows
(:func:`make_clearance_rows`, C++ ``ClearanceRows``; they touch ``(px, py,
ψ)`` only, so their dependency columns are ``(0, 1, 2)``) with the exact
curvature ``Σ act·∂²c`` at ``extra_order=2`` or the Gauss-Newton block at 1,
regulation (the parking cost drives x to 0), Euler prediction, and the state
and input boxes of ``parking_geometry``.

:func:`al_ilqr_parking_solve_factory` is the parking sweep's
``backend="factory"`` (``parallel/batch.py``): the same OCP as the
hand-written parking kernel (``ops/cuda/ilqr_kernel.py``), generated by the
tracker kernel, an independent second implementation of it.
"""

from __future__ import annotations

import functools

import torch

from .ilqr_factory import (
    DEFAULT_TILE,
    BatchedTrackerSolution,
    TrackerConstraints,
    TrackerModel,
    fused_tracker_solve_cuda,
)
from .ilqr_kernel import inv_f32

NX = 4
NU = 2


@functools.lru_cache(maxsize=16)
def make_parking_ode_rows(kb: float, lr: float) -> TrackerModel:
    """Row-form kinematic-bicycle ODE with per-scenario ``pr = (acc,
    fric)``; ``kb = l_r / (l_f + l_r)``, and β enters through sin β = kb tan δ
    / √(1 + kb² tan² δ), so no ``atan`` is needed. The division by ``lr`` is a
    multiplication by its float32 reciprocal, as XLA compiles the
    reference. C++ instantiation ``KinematicRows``, constants ``(kb, kb²,
    1/lr)``."""
    kb2 = kb * kb
    inv_lr = inv_f32(lr)

    def ode_rows(xr, ur, pr):
        _px, _py, psi, v = xr
        a, dl = ur
        acc, fric = pr
        t = torch.tan(dl)
        den = torch.sqrt(1.0 + kb2 * t * t)
        sinb = kb * t / den
        cosb = 1.0 / den
        sp, cp = torch.sin(psi), torch.cos(psi)
        return (
            v * (cp * cosb - sp * sinb),
            v * (sp * cosb + cp * sinb),
            v * sinb * inv_lr,
            acc * a - fric * v,
        )

    return TrackerModel(
        rows=ode_rows, kernel="kinematic", consts=(kb, kb2, inv_lr), nx=NX, nu=NU, n_params=2
    )


@functools.lru_cache(maxsize=16)
def make_clearance_rows(ox: tuple, r2: float, obs: tuple) -> TrackerConstraints:
    """The reference's anti-collision rows in the tracker's
    ``extra_constraints`` form: for every (vehicle circle i, obstacle circle
    j) pair, c = (r_v + r_o)² − ‖center_i(x) − q_j‖² ≤ 0, rows in (i, j)
    order. State-only: they depend on ``(px, py, ψ)``. C++ instantiation
    ``ClearanceRows`` (three circles each side), constants ``(ox, r2,
    obs)``; other circle counts run on the twin."""
    n = len(ox)

    def rows(xr, ur, pr=None):
        px, py, psi, _v = xr
        sp, cp = torch.sin(psi), torch.cos(psi)
        out = []
        for i in range(n):
            cx = px + ox[i] * cp
            cy = py + ox[i] * sp
            for j in range(n):
                wx = cx - obs[j][0]
                wy = cy - obs[j][1]
                out.append(r2 - (wx * wx + wy * wy))
        return tuple(out)

    built = n == 3 and len(obs) == 3
    consts = (*ox, r2, *(v for q in obs for v in q)) if built else ()
    return TrackerConstraints(rows=rows, kernel="clearance" if built else None, consts=consts,
                              n_extra=n * n, deps=(0, 1, 2))


def al_ilqr_parking_solve_factory(
    x0s: torch.Tensor,  # (B, 4)
    u_init: torch.Tensor,  # (B, N, 2)
    acc: torch.Tensor,  # (B,) per-scenario acceleration parameter
    fric: torch.Tensor,  # (B,) per-scenario friction parameter
    *,
    N: int,
    ts: float,
    geom: tuple,  # parking_geometry(...)[0]: (kb, lr, ox, r2, obs)
    limits: tuple,  # parking_geometry(...)[1]: (lb_x, ub_x, lb_u, ub_u)
    weights: tuple | None = None,  # (Qd(4), Rd(2), qn): the constant weights
    weights_rt: torch.Tensor | None = None,  # (B, 7) per-lane [Qd(4), Rd(2), qn]
    n_circles: int = 3,
    lam_init: torch.Tensor | None = None,  # (B, N, nc) AL warm start
    outer_iters: int = 6,
    inner_iters: int = 15,
    mu_init: float = 10.0,
    viol_tol: float = 1e-4,
    extra_order: int = 2,
    tile: int = DEFAULT_TILE,
    group: int | None = None,
) -> BatchedTrackerSolution:
    """The parking OCP of ``ops/cuda/ilqr_kernel.py::al_ilqr_solve_cuda``
    through the fused tracker kernel instead of the hand-written one; the
    JAX package's signature without ``interpret``, and ``group`` (threads
    per lane on the card). CUDA tensors launch the kernel, CPU tensors run
    its twin.

    Constraint-row order (for ``lam_init`` round trips): the tracker's order
    [u-box (4), x-box (8), clearances (n²)], internally consistent but NOT
    the hand kernel's [x-box, u-box, clearances]: multipliers are not
    interchangeable between the two backends."""
    kb, lr, ox, r2, obs = geom
    lb_x, ub_x, lb_u, ub_u = limits
    has_obs = n_circles > 0 and len(obs) > 0
    extra = make_clearance_rows(tuple(ox), float(r2), tuple(obs)) if has_obs else None
    n_extra = n_circles * n_circles if has_obs else 0
    return fused_tracker_solve_cuda(
        x0s,
        u_init,
        None,  # regulation: the parking cost drives x -> 0
        ode_rows=make_parking_ode_rows(float(kb), float(lr)),
        nx=NX,
        nu=NU,
        N=N,
        ts=float(ts),
        substeps=1,
        integrator="euler",
        limits=(lb_u, ub_u),
        state_limits=(lb_x, ub_x),
        weights=weights,
        weights_rt=weights_rt,
        extra_constraints=extra,
        n_extra=n_extra,
        # the clearances touch (px, py, ψ) only: three dependency columns
        extra_deps=(0, 1, 2),
        extra_order=extra_order,
        params=torch.stack([acc.to(torch.float32), fric.to(torch.float32)], dim=-1),
        n_params=2,
        lam_init=lam_init,
        outer_iters=outer_iters,
        inner_iters=inner_iters,
        mu_init=mu_init,
        viol_tol=viol_tol,
        tile=tile,
        group=group,
    )
