"""Single-shooting SQP for nonlinear MPC, batched over scenarios (port of
``solvers/sqp.py``).

The OCP is a pair of functions of one scenario's stacked inputs: a
least-squares residual (cost = ‖r(ū)‖²) and a constraint stack c(ū) with
two-sided bounds. Their Jacobians come from ``torch.func.jacfwd`` through
the rollout, mapped over the scenarios with ``vmap``; each scenario's QP
subproblem (Gauss-Newton Hessian, its own linearized constraints) goes to
the Mehrotra interior point :func:`..solvers.qp.pdip_solve` as one operator
per scenario; the step is line-searched on a fixed grid over an ℓ1 merit.
Fixed iteration count, each scenario frozen once converged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.func import hessian, jacfwd, vmap

from ..utils.precision import set_solver_precision
from .ilqr import _repeat
from .qp import QPMatrices, pdip_solve

ALPHAS = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.0)


class ShootingOCP(NamedTuple):
    """A single-shooting OCP in residual/constraint form.

    residual(u_flat, x0, p) -> r with cost(ū) = ‖r‖²  (Gauss-Newton structure)
    constraints(u_flat, x0, p) -> c with bounds  l_c ≤ c ≤ u_c
    input box  l_u ≤ ū ≤ u_u  (flat, length n = N·nu)

    ``p`` is one scenario's slice of ``params`` (a pytree with leaves
    ``(B, ...)``, or ``None``); the bounds are shared ``(m,)`` / ``(n,)`` or
    per scenario ``(B, m)`` / ``(B, n)``.
    """

    residual: Callable
    constraints: Callable
    l_c: torch.Tensor
    u_c: torch.Tensor
    l_u: torch.Tensor
    u_u: torch.Tensor
    n_controls: int
    horizon: int
    nu: int
    params: Any = None


@dataclasses.dataclass(frozen=True)
class SQPSolution:
    u: torch.Tensor  # (B, n) stacked inputs
    cost: torch.Tensor  # (B,) ‖r‖²
    kkt_res: torch.Tensor  # (B,) stationarity ∞-norm
    viol: torch.Tensor  # (B,) max constraint violation
    converged: torch.Tensor  # (B,) bool


def _violation(c, l_c, u_c):
    over = torch.where(torch.isfinite(u_c), torch.clamp(c - u_c, min=0.0), 0.0)
    under = torch.where(torch.isfinite(l_c), torch.clamp(l_c - c, min=0.0), 0.0)
    return over + under


def sqp_solve(
    ocp: ShootingOCP,
    x0: torch.Tensor,
    u_init: torch.Tensor | None = None,
    iters: int = 25,
    qp_iters: int = 30,
    trust_radius: float = 0.5,
    merit_mu: float = 10.0,
    gn_reg: float = 1e-8,
    tol: float | None = None,
    lagrangian_hessian: bool = False,
) -> SQPSolution:
    """SQP with ℓ1-merit backtracking on a fixed step grid, for ``x0 (B,
    nx)``.

    The Gauss-Newton Hessian ``2 JᵀJ`` by default; ``lagrangian_hessian``
    adds the constraint curvature ``Σ yᵢ ∇²cᵢ`` of the previous QP's duals,
    shifted positive definite (experimental, as in the JAX package). Runs
    exactly ``iters`` iterations; a scenario's iterate freezes once its KKT
    residual and violation are below ``tol`` (1e-5 in float64, 5e-3
    otherwise).
    """
    set_solver_precision()
    n = ocp.n_controls
    B, dtype, dev = x0.shape[0], x0.dtype, x0.device
    if tol is None:
        tol = 1e-5 if dtype == torch.float64 else 5e-3
    if u_init is None:
        u_init = torch.zeros(B, n, dtype=dtype, device=dev)
    # project into the input box: the QP step keeps every iterate inside it
    u = torch.clamp(u_init, ocp.l_u, ocp.u_u)
    p = {} if ocp.params is None else ocp.params
    res_fn = vmap(ocp.residual)
    con_fn = vmap(ocp.constraints)
    jac_res = vmap(jacfwd(ocp.residual))
    jac_con = vmap(jacfwd(ocp.constraints))
    alphas = torch.tensor(ALPHAS, dtype=dtype, device=dev)
    A = len(ALPHAS)
    eye = torch.eye(n, dtype=dtype, device=dev)
    p_a, x0_a = _repeat(p, A), _repeat(x0, A)
    bound_a = lambda b: _repeat(b, A) if b.ndim == 2 else b

    def merits(u, delta, mu):
        """The ℓ1 merit of ``u + α δ`` for every α of the grid: ``(A, B)``."""
        uu = (u[None] + alphas[:, None, None] * delta[None]).reshape(A * B, n)
        r = res_fn(uu, x0_a, p_a)
        c = con_fn(uu, x0_a, p_a)
        viol = _violation(c, bound_a(ocp.l_c), bound_a(ocp.u_c)).sum(dim=-1)
        return ((r * r).sum(dim=-1) + mu.repeat(A) * viol).reshape(A, B)

    m_c = ocp.l_c.shape[-1]
    y_prev = torch.zeros(B, m_c, dtype=dtype, device=dev)
    kkt = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    for _ in range(iters):
        r = res_fn(u, x0, p)
        # Jacobians in the working dtype (torch.func's forward mode may
        # promote a float32 product with a Python float to float64)
        Jr = jac_res(u, x0, p).to(dtype)
        c = con_fn(u, x0, p)
        Jc = jac_con(u, x0, p).to(dtype)
        g = 2.0 * (Jr.transpose(1, 2) @ r[..., None])[..., 0]
        H = 2.0 * Jr.transpose(1, 2) @ Jr + gn_reg * eye
        if lagrangian_hessian:
            Hc = vmap(hessian(lambda uu, x, pp, y: ocp.constraints(uu, x, pp) @ y))(
                u, x0, p, y_prev).to(dtype)
            H_full = H + 0.5 * (Hc + Hc.transpose(1, 2))
            shift = torch.clamp(-torch.linalg.eigvalsh(H_full)[:, 0], min=0.0) + 1e-8
            H = H_full + shift[:, None, None] * eye

        # QP subproblem: δ bounded by the input box ∩ the trust region, the
        # constraints linearized
        dl = torch.clamp(ocp.l_u - u, min=-trust_radius)
        du = torch.clamp(ocp.u_u - u, max=trust_radius)
        A_qp = torch.cat([eye.expand(B, n, n), Jc], dim=1)
        l_qp = torch.cat([dl, (ocp.l_c - c).expand(B, m_c)], dim=1)
        u_qp = torch.cat([du, (ocp.u_c - c).expand(B, m_c)], dim=1)
        sol = pdip_solve(QPMatrices(H, A_qp), g, l_qp, u_qp, iters=qp_iters)
        delta = sol.x

        # ℓ1 exact-penalty weight from the QP duals (μ ≳ ‖y‖∞)
        mu = torch.clamp(2.0 * sol.y.abs().amax(dim=1), min=merit_mu)
        best = merits(u, delta, mu).argmin(dim=0)  # the first α at the minimum
        u_new = torch.clamp(u + alphas[best][:, None] * delta, ocp.l_u, ocp.u_u)

        # KKT stationarity with the QP duals mapped back (A_qpᵀ y)
        kkt = (g + (A_qp.transpose(1, 2) @ sol.y[..., None])[..., 0]).abs().amax(dim=1)
        viol = _violation(c, ocp.l_c, ocp.u_c).amax(dim=1)
        step_ok = ~((kkt < tol) & (viol < tol))
        u = torch.where(step_ok[:, None], u_new, u)
        y_prev = torch.where(step_ok[:, None], sol.y[:, n:], y_prev)
    r = res_fn(u, x0, p)
    viol = _violation(con_fn(u, x0, p), ocp.l_c, ocp.u_c).amax(dim=1)
    return SQPSolution(u=u, cost=(r * r).sum(dim=1), kkt_res=kkt, viol=viol,
                       converged=(kkt < tol) & (viol < tol))
