"""Stagewise Riccati interior-point QP solver, the O(N) long-horizon path
(port of ``solvers/riccati_ip.py``).

The box-constrained LQ optimal-control problem

    min  Σ_{k=1}^{N-1} ½xₖᵀQxₖ + qₖᵀxₖ  +  ½x_NᵀP_f x_N + q_Nᵀx_N
         + Σ_{k=0}^{N-1} ½uₖᵀRuₖ + rₖᵀuₖ
    s.t. x_{k+1} = A xₖ + B uₖ,   x₀ fixed,
         x_lb ≤ xₖ ≤ x_ub (k=1..N),   u_lb ≤ uₖ ≤ u_ub (k=0..N-1)

is solved by a Mehrotra predictor-corrector primal-dual interior-point method
whose Newton systems keep the block-banded KKT structure: one backward
Riccati sweep factors the horizon per iteration, and affine backward/forward
sweeps recover the predictor and the corrector steps. No condensed matrix is
formed, so memory and work per iteration are O(N); the condensed ADMM path
(``solvers/linear_mpc.py``) is O(N²) and its float32 Hessian is too
ill-conditioned at N=100.

Here the JAX package's ``vmap`` is a leading batch dimension written out and
its ``lax.scan`` a Python loop over stages on batched tensors: this module is
the plain batched PyTorch path (``backend="torch"`` of
:meth:`StagewiseMPC.batched_policy`). The fused kernel that runs the whole
solve in one launch is ``ops/cuda/riccati_ip_kernel.py``.

Infinite bounds are allowed entry-wise; their slack, dual and barrier terms
are masked out. ``parallel=True`` solves every Newton system with the
O(log N)-depth associative-scan LQ solver of ``ops/parallel_horizon.py``
instead of the sequential Riccati sweeps.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.precision import set_solver_precision

_BIG = 1e20


def bound_scale(lb, ub, xp=torch):
    """Per-entry variable scaling from box widths (the shared equilibration
    rule): two-sided bounds give the half-width, one-sided the magnitude of
    the finite bound, unbounded 1; floored at 1e-8. ``xp`` is ``torch`` or
    ``numpy``: the kernel wrapper evaluates the same rule in float64 numpy."""
    both = xp.isfinite(lb) & xp.isfinite(ub)
    one = xp.isfinite(lb) | xp.isfinite(ub)
    zero, unit = 0.0 * xp.ones_like(lb), xp.ones_like(lb)
    width = xp.where(both, 0.5 * (ub - lb), zero)
    single = xp.maximum(
        xp.abs(xp.where(xp.isfinite(lb), lb, zero)),
        xp.abs(xp.where(xp.isfinite(ub), ub, zero)),
    )
    scale = xp.where(both, width, xp.where(one, single, unit))
    return xp.maximum(scale, 1e-8 * unit)


def cost_normalizer(Qs, Rs, Pf, xp=torch):
    """Scalar cost scaling ``1 / max(|Q|, |R|, |Pf|, 1e-8)`` (shared with the
    kernel wrapper)."""
    top = max(
        float(xp.abs(Qs).max()), float(xp.abs(Rs).max()), float(xp.abs(Pf).max()), 1e-8
    )
    return 1.0 / top


class _Bounds(NamedTuple):
    """Interior-point state of one bound group ``z`` (states or inputs), each
    ``(B, N, n)``. The slacks are independent variables (not forced to
    ``z - lb``), so the iterate never has to be primal-feasible, only strictly
    positive in (s, λ). Masked (infinite-bound) entries carry s=1, λ=0."""

    s_l: torch.Tensor
    s_u: torch.Tensor
    lam_l: torch.Tensor
    lam_u: torch.Tensor


def _masks(lb, ub):
    return torch.isfinite(lb), torch.isfinite(ub)


def _bounds_init(z, lb, ub) -> _Bounds:
    """Slacks from (clipped) bound distances, duals λ = 1/s: balanced
    complementarity products (s·λ = 1, so μ₀ = 1) matter more to Mehrotra's σ
    heuristic than primal consistency."""
    mask_l, mask_u = _masks(lb, ub)
    one, zero = torch.ones_like(z), torch.zeros_like(z)
    s_l = torch.where(mask_l, torch.clamp(z - lb, 1.0, _BIG), one)
    s_u = torch.where(mask_u, torch.clamp(ub - z, 1.0, _BIG), one)
    return _Bounds(
        s_l=s_l,
        s_u=s_u,
        lam_l=torch.where(mask_l, 1.0 / s_l, zero),
        lam_u=torch.where(mask_u, 1.0 / s_u, zero),
    )


def _sigma_diag(b: _Bounds, lb, ub):
    """Barrier Hessian diagonal Σ = λ_l/s_l + λ_u/s_u (masked)."""
    mask_l, mask_u = _masks(lb, ub)
    zero = torch.zeros_like(b.s_l)
    return torch.where(mask_l, b.lam_l / b.s_l, zero) + torch.where(
        mask_u, b.lam_u / b.s_u, zero
    )


def _primal_resid(z, b: _Bounds, lb, ub):
    """r_pl = z - s_l - lb, r_pu = z + s_u - ub (0 where there is no bound)."""
    mask_l, mask_u = _masks(lb, ub)
    zero = torch.zeros_like(z)
    r_pl = torch.where(mask_l, z - b.s_l - lb, zero)
    r_pu = torch.where(mask_u, z + b.s_u - ub, zero)
    return r_pl, r_pu


def _barrier_grad(z, b: _Bounds, lb, ub, sig_mu, corr_l, corr_u):
    """The bound groups' share of the Newton-system gradient, from
    eliminating (δs, δλ) out of the perturbed KKT system:
    ``-(σμ - corr_l)/s_l + (λ_l/s_l) r_pl + (σμ - corr_u)/s_u + (λ_u/s_u) r_pu``
    (``corr_*`` = Mehrotra's second-order term δλ_aff∘δs_aff, 0 in the
    predictor)."""
    mask_l, mask_u = _masks(lb, ub)
    r_pl, r_pu = _primal_resid(z, b, lb, ub)
    g_l = -(sig_mu - corr_l) / b.s_l + (b.lam_l / b.s_l) * r_pl
    g_u = (sig_mu - corr_u) / b.s_u + (b.lam_u / b.s_u) * r_pu
    zero = torch.zeros_like(z)
    return torch.where(mask_l, g_l, zero) + torch.where(mask_u, g_u, zero)


def _bound_step(z, b: _Bounds, lb, ub, dz, sig_mu, corr_l, corr_u) -> _Bounds:
    """Newton updates (δs_l, δs_u, δλ_l, δλ_u) given the primal direction."""
    mask_l, mask_u = _masks(lb, ub)
    r_pl, r_pu = _primal_resid(z, b, lb, ub)
    zero = torch.zeros_like(z)
    ds_l = torch.where(mask_l, dz + r_pl, zero)
    ds_u = torch.where(mask_u, -dz - r_pu, zero)
    dlam_l = torch.where(
        mask_l, (sig_mu - corr_l - b.lam_l * b.s_l - b.lam_l * ds_l) / b.s_l, zero
    )
    dlam_u = torch.where(
        mask_u, (sig_mu - corr_u - b.lam_u * b.s_u - b.lam_u * ds_u) / b.s_u, zero
    )
    return _Bounds(ds_l, ds_u, dlam_l, dlam_u)


def _alpha_max(b: _Bounds, db: _Bounds, lb, ub):
    """Largest α ∈ (0, 1] keeping (s, λ) ≥ 0 along the direction, per lane
    ``(B, 1, 1)`` (a masked min over stages and entries)."""
    mask_l, mask_u = _masks(lb, ub)

    def ratio(v, dv, mask):
        r = torch.where(
            (dv < 0) & mask, -v / torch.clamp(dv, max=-1e-30), torch.full_like(v, _BIG)
        )
        return r.amin(dim=(-2, -1), keepdim=True)

    worst = torch.minimum(
        torch.minimum(ratio(b.s_l, db.s_l, mask_l), ratio(b.s_u, db.s_u, mask_u)),
        torch.minimum(ratio(b.lam_l, db.lam_l, mask_l), ratio(b.lam_u, db.lam_u, mask_u)),
    )
    return torch.clamp(worst, max=1.0)


def _bound_axpy(b: _Bounds, db: _Bounds, alpha) -> _Bounds:
    return _Bounds(*(v + alpha * dv for v, dv in zip(b, db)))


def _gap_terms(b: _Bounds, lb, ub):
    """(Σ s·λ over finite bounds per lane ``(B, 1, 1)``, finite-bound count)."""
    mask_l, mask_u = _masks(lb, ub)
    zero = torch.zeros_like(b.s_l)
    total = torch.where(mask_l, b.s_l * b.lam_l, zero).sum(dim=(-2, -1), keepdim=True)
    total = total + torch.where(mask_u, b.s_u * b.lam_u, zero).sum(dim=(-2, -1), keepdim=True)
    return total, mask_l.sum() + mask_u.sum()


# ---------------------------------------------------------------------------
# Riccati factorization + affine solves (the O(N) KKT solver)
# ---------------------------------------------------------------------------


class _LQFactors(NamedTuple):
    """Backward-sweep factorization of the block-banded Newton KKT system,
    shared by the predictor and corrector solves of one iteration."""

    K: torch.Tensor  # (..., N, nu, nx) feedback gains
    Quu_inv: torch.Tensor  # (..., N, nu, nu)
    Qux: torch.Tensor  # (..., N, nu, nx)


def _T(m):
    return m.transpose(-1, -2)


def lq_factor(As, Bs, Qts, Rts) -> _LQFactors:
    """Backward Riccati factorization for stagewise costs ``Qts`` (N+1) /
    ``Rts`` (N). ``As``/``Bs`` are stacked per stage ``(N, ...)``; the costs
    may carry leading batch dimensions ``(..., N+1, nx, nx)``."""
    N = As.shape[0]
    P = Qts[..., N, :, :]
    Ks, Qis, Quxs = [], [], []
    for t in range(N - 1, -1, -1):
        A, B = As[t], Bs[t]
        PB = P @ B
        Quu = Rts[..., t, :, :] + _T(B) @ PB
        Quu = 0.5 * (Quu + _T(Quu))
        # inv_ex: no host synchronisation for an error flag per stage
        Quu_inv = torch.linalg.inv_ex(Quu).inverse
        Qux = _T(PB) @ A
        K = -Quu_inv @ Qux
        P = Qts[..., t, :, :] + _T(A) @ P @ A + _T(Qux) @ K
        P = 0.5 * (P + _T(P))
        Ks.append(K)
        Qis.append(Quu_inv)
        Quxs.append(Qux)
    stack = lambda rows: torch.stack(rows[::-1], dim=-3)
    return _LQFactors(K=stack(Ks), Quu_inv=stack(Qis), Qux=stack(Quxs))


def lq_affine_solve(factors: _LQFactors, As, Bs, qts, rts, x_init=None):
    """Solve for the Newton direction given linear terms (``qts``: N+1,
    ``rts``: N, with any leading batch dimensions).

    The backward pass propagates the affine value-function term and the
    feedforward ``kff = -Quu⁻¹(r + Bᵀp)``; the forward pass rolls out
    ``δx₀ = x_init`` (default 0) under ``δu = K δx + kff``. Returns
    ``(δx (..., N+1, nx), δu (..., N, nu))``. With the measured state as
    ``x_init`` and the raw linear cost terms it solves the absolute
    unconstrained LQ problem."""
    N = As.shape[0]
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    p = qts[..., N, :]
    kffs = []
    for t in range(N - 1, -1, -1):
        A, B = As[t], Bs[t]
        qu = rts[..., t, :] + mv(_T(B), p)
        kff = -mv(factors.Quu_inv[..., t, :, :], qu)
        p = qts[..., t, :] + mv(_T(A), p) + mv(_T(factors.Qux[..., t, :, :]), kff)
        kffs.append(kff)
    kffs = kffs[::-1]
    nx = As.shape[-1]
    if x_init is None:
        dx = torch.zeros(*kffs[0].shape[:-1], nx, dtype=qts.dtype, device=qts.device)
    else:
        dx = x_init.to(qts.dtype)
    dxs, dus = [dx], []
    for t in range(N):
        du = mv(factors.K[..., t, :, :], dx) + kffs[t]
        dx = mv(As[t], dx) + mv(Bs[t], du)
        dxs.append(dx)
        dus.append(du)
    shape = torch.broadcast_shapes(*(d.shape for d in dxs))
    dxs = torch.stack([d.expand(shape) for d in dxs], dim=-2)
    return dxs, torch.stack(dus, dim=-2)


# ---------------------------------------------------------------------------
# The interior-point loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StagewiseIPResult:
    us: torch.Tensor  # (B, N, nu)
    xs: torch.Tensor  # (B, N+1, nx), dynamics-consistent with us from x0
    mu: torch.Tensor  # (B,) final duality measure (scaled space)
    prim_res: torch.Tensor  # (B,) ∞-norm bound violation (scaled space)
    success: torch.Tensor  # (B,) bool
    lam_x: torch.Tensor  # (B, N, nx) net state-bound multipliers (λ_u - λ_l)
    lam_u: torch.Tensor  # (B, N, nu) net input-bound multipliers


def _stage_diag(v, lead: int = 0):
    """``(B, N, n)`` diagonals as ``(B, lead + N, n, n)`` blocks, the first
    ``lead`` stages zero."""
    return torch.diag_embed(torch.nn.functional.pad(v, (0, 0, lead, 0)))


def stagewise_ip_solve(
    A, B, Q, R, Pf, x_lb, x_ub, u_lb, u_ub,
    x0: torch.Tensor,
    u_init: torch.Tensor | None = None,
    q_lin: torch.Tensor | None = None,
    r_lin: torch.Tensor | None = None,
    *,
    N: int | None = None,
    iters: int = 20,
    tol: float = 1e-8,
    tau: float = 0.995,
    parallel: bool = False,
) -> StagewiseIPResult:
    """Solve a batch of box-constrained LQ-OCPs by Mehrotra
    predictor-corrector IP: ``x0`` is ``(B, nx)`` (or ``(nx,)``, and then
    every field of the result lacks the batch dimension), ``u_init``
    ``(B, N, nu)``.

    ``A``/``B`` may be single matrices (LTI) or stacked ``(N, ...)`` (LTV),
    ``Q``/``R`` likewise (``Q`` applies to x_1..x_{N-1}, ``Pf`` to x_N).
    Bounds are ``(n,)`` or per stage ``(N, n)`` and admit ±inf. ``q_lin``
    ``(N+1, nx)`` and ``r_lin`` ``(N, nu)`` are optional linear cost terms
    (with or without a leading batch dimension). The problem data is shared
    by the batch and is converted to ``x0``'s dtype and device.

    A fixed count of ``iters`` Newton-KKT iterations, each one Riccati
    factorization and two affine sweeps; a lane freezes once converged
    (μ < 50·eps) and rejects a non-finite candidate, reporting
    ``success=False`` instead of poisoning the batch. An augmented-Lagrangian
    active-set polish follows.

    ``parallel=True`` replaces each factorization and affine sweep pair by
    :func:`..ops.parallel_horizon.lqt_solve_parallel`: the same solutions to
    rounding, but the predictor and corrector each pay a whole parallel
    solve, as nothing of it is shared between right-hand sides."""
    set_solver_precision()
    dt, dev = x0.dtype, x0.device
    t_ = lambda v: torch.as_tensor(v, dtype=dt, device=dev)
    A, B, Q, R, Pf = t_(A), t_(B), t_(Q), t_(R), t_(Pf)
    if N is None:
        if u_init is not None:
            N = int(u_init.shape[-2])
        elif A.ndim == 3:
            N = int(A.shape[0])
        else:
            raise ValueError("pass N= (or stacked A/B, or u_init) to size the horizon")
    single = x0.ndim == 1
    x0 = x0.reshape(-1, x0.shape[-1])
    nx, nu = x0.shape[-1], B.shape[-1]

    As = A.expand(N, nx, nx)
    Bs = B.expand(N, nx, nu)
    Qs = Q.expand(N, nx, nx)  # used for stages 1..N-1
    Rs = R.expand(N, nu, nu)
    x_lb, x_ub = t_(x_lb).expand(N, nx), t_(x_ub).expand(N, nx)
    u_lb, u_ub = t_(u_lb).expand(N, nu), t_(u_ub).expand(N, nu)
    # linear terms with a leading dimension of 1 (shared) or B
    q_lin = torch.zeros(N + 1, nx, dtype=dt, device=dev) if q_lin is None else t_(q_lin)
    r_lin = torch.zeros(N, nu, dtype=dt, device=dev) if r_lin is None else t_(r_lin)
    q_lin, r_lin = q_lin.reshape(-1, N + 1, nx), r_lin.reshape(-1, N, nu)

    # ---- equilibration: diagonal variable scalings from the box widths plus
    # one scalar cost scaling make every variable, slack and multiplier O(1)
    w_x = bound_scale(x_lb, x_ub).amax(dim=0)  # (nx,)
    w_u = bound_scale(u_lb, u_ub).amax(dim=0)  # (nu,)
    As = As * (w_x[None, None, :] / w_x[None, :, None])
    Bs = Bs * (w_u[None, None, :] / w_x[None, :, None])
    Qs_sc = Qs * (w_x[None, :, None] * w_x[None, None, :])
    Rs_sc = Rs * (w_u[None, :, None] * w_u[None, None, :])
    Pf_sc = Pf * (w_x[:, None] * w_x[None, :])
    c_cost = cost_normalizer(Qs_sc, Rs_sc, Pf_sc)
    Qs, Rs, Pf = c_cost * Qs_sc, c_cost * Rs_sc, c_cost * Pf_sc
    q_lin = c_cost * q_lin * w_x
    r_lin = c_cost * r_lin * w_u
    x_lb, x_ub = x_lb / w_x, x_ub / w_x
    u_lb, u_ub = u_lb / w_u, u_ub / w_u
    x0 = x0 / w_x
    if u_init is not None:
        u_init = t_(u_init).reshape(-1, N, nu) / w_u

    # stage-cost quadratic blocks with the terminal Pf; index 0 is never used
    # (δx₀ = 0) but keeps the sweeps' shapes
    Q_full = torch.cat([torch.zeros(1, nx, nx, dtype=dt, device=dev), Qs[: N - 1], Pf[None]])

    # the KKT solver: sequential Riccati (factor once, solve cheaply for each
    # right-hand side) or the O(log N)-depth parallel LQ solve, which has no
    # factorization to share
    if parallel:
        from ..ops.parallel_horizon import lqt_solve_parallel

        kkt_factor = lambda Qts, Rts: (Qts, Rts)
        x_zero = torch.zeros(nx, dtype=dt, device=dev)

        def kkt_solve(factors, qts, rts, x_init=None):
            return lqt_solve_parallel(As, Bs, *factors, qts, rts,
                                      x_zero if x_init is None else x_init)
    else:
        kkt_factor = lambda Qts, Rts: lq_factor(As, Bs, Qts, Rts)

        def kkt_solve(factors, qts, rts, x_init=None):
            return lq_affine_solve(factors, As, Bs, qts, rts, x_init=x_init)

    def rollout(us):
        xs = [x0.expand(us.shape[0], nx)]
        for t in range(N):
            xs.append(xs[-1] @ As[t].T + us[:, t] @ Bs[t].T)
        return torch.stack(xs, dim=1)

    if u_init is None:
        # warm point: the unconstrained LQ optimum from x0 (one shared
        # factorization, an affine sweep in absolute variables), the controls
        # clipped strictly into their box and re-rolled
        _, us_free = kkt_solve(kkt_factor(Q_full, Rs), q_lin, r_lin, x_init=x0)
        margin = 1e-3 * torch.minimum(u_lb.abs() + 1.0, u_ub.abs() + 1.0)
        lo = torch.where(torch.isfinite(u_lb), u_lb + margin, torch.full_like(u_lb, -_BIG))
        hi = torch.where(torch.isfinite(u_ub), u_ub - margin, torch.full_like(u_ub, _BIG))
        us0 = torch.clamp(us_free, lo, hi)
    else:
        us0 = u_init
    xs0 = rollout(us0)
    bx0 = _bounds_init(xs0[:, 1:], x_lb, x_ub)
    bu0 = _bounds_init(us0, u_lb, u_ub)

    def cost_grad_x(xs):  # over x_1..x_N: stage Q for 1..N-1, Pf at N
        return torch.einsum("kij,bkj->bki", Q_full[1:], xs[:, 1:]) + q_lin[:, 1:]

    def cost_grad_u(us):
        return torch.einsum("kij,bkj->bki", Rs, us) + r_lin

    def mu_of(bx, bu):
        gx, cx = _gap_terms(bx, x_lb, x_ub)
        gu, cu = _gap_terms(bu, u_lb, u_ub)
        return (gx + gu) / torch.clamp(cx + cu, min=1)  # (B, 1, 1)

    def solve_direction(factors, xs, us, bx, bu, sig_mu, corr):
        corr_xl, corr_xu, corr_ul, corr_uu = corr
        g_x = cost_grad_x(xs) + _barrier_grad(xs[:, 1:], bx, x_lb, x_ub, sig_mu, corr_xl, corr_xu)
        g_u = cost_grad_u(us) + _barrier_grad(us, bu, u_lb, u_ub, sig_mu, corr_ul, corr_uu)
        qts = torch.cat([torch.zeros_like(g_x[:, :1]), g_x], dim=1)
        dxs, dus = kkt_solve(factors, qts, g_u)
        dbx = _bound_step(xs[:, 1:], bx, x_lb, x_ub, dxs[:, 1:], sig_mu, corr_xl, corr_xu)
        dbu = _bound_step(us, bu, u_lb, u_ub, dus, sig_mu, corr_ul, corr_uu)
        return dxs, dus, dbx, dbu

    eps = torch.finfo(dt).eps
    all_finite = lambda v: torch.isfinite(v).all(dim=(-2, -1), keepdim=True)
    xs, us, bx, bu = xs0, us0, bx0, bu0
    for _ in range(iters):
        mu = mu_of(bx, bu)
        # barrier-modified stage costs: one Riccati factorization per iteration
        Qts = Q_full + _stage_diag(_sigma_diag(bx, x_lb, x_ub), lead=1)
        Rts = Rs + _stage_diag(_sigma_diag(bu, u_lb, u_ub))
        factors = kkt_factor(Qts, Rts)

        zero = torch.zeros((), dtype=dt, device=dev)
        # predictor: pure Newton (σ = 0) to probe the achievable step
        _, _, dbx_a, dbu_a = solve_direction(factors, xs, us, bx, bu, zero, (zero,) * 4)
        alpha_aff = torch.minimum(
            _alpha_max(bx, dbx_a, x_lb, x_ub), _alpha_max(bu, dbu_a, u_lb, u_ub)
        )
        mu_aff = mu_of(_bound_axpy(bx, dbx_a, alpha_aff), _bound_axpy(bu, dbu_a, alpha_aff))
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3, 1e-8, 1.0)

        # corrector: recenter + Mehrotra second-order terms, same factorization
        corr = (
            dbx_a.lam_l * dbx_a.s_l, dbx_a.lam_u * dbx_a.s_u,
            dbu_a.lam_l * dbu_a.s_l, dbu_a.lam_u * dbu_a.s_u,
        )
        dxs, dus, dbx, dbu = solve_direction(factors, xs, us, bx, bu, sigma * mu, corr)
        alpha = tau * torch.minimum(
            _alpha_max(bx, dbx, x_lb, x_ub), _alpha_max(bu, dbu, u_lb, u_ub)
        )
        xs_n, us_n = xs + alpha * dxs, us + alpha * dus
        bx_n, bu_n = _bound_axpy(bx, dbx, alpha), _bound_axpy(bu, dbu, alpha)

        # freeze once converged (active slacks underflow, Newton breaks down)
        # and reject non-finite candidates (infeasible problems diverge)
        ok = (
            ~(mu < 50.0 * eps)
            & all_finite(xs_n) & all_finite(us_n)
            & all_finite(bx_n.s_l) & all_finite(bx_n.lam_l)
            & all_finite(bu_n.s_l) & all_finite(bu_n.lam_l)
        )
        keep = lambda new, old: torch.where(ok, new, old)
        xs, us = keep(xs_n, xs), keep(us_n, us)
        bx = _Bounds(*(keep(n, o) for n, o in zip(bx_n, bx)))
        bu = _Bounds(*(keep(n, o) for n, o in zip(bu_n, bu)))
    mu = mu_of(bx, bu)

    # ---- active-set polish (augmented Lagrangian, Riccati-structured): read
    # the active set off the slack/multiplier ratio, then re-solve the LQ
    # problem with the active bounds enforced by a signed multiplier estimate
    # and a quadratic penalty ρ, twice with multiplier updates
    rho = 1e8 if dt == torch.float64 else 1e4

    def active_and_target(b: _Bounds, lb, ub):
        mask_l, mask_u = _masks(lb, ub)
        act_l = mask_l & (b.lam_l > b.s_l)
        act_u = mask_u & (b.lam_u > b.s_u)
        act = act_l | act_u
        zero = torch.zeros_like(b.s_l)
        target = torch.where(act_u, ub.expand_as(zero), torch.where(mask_l, lb, zero))
        lam_hat = torch.where(act_u, b.lam_u, -b.lam_l) * act
        return act.to(dt), target, lam_hat

    act_x, tgt_x, lhat_x = active_and_target(bx, x_lb, x_ub)
    act_u_, tgt_u, lhat_u = active_and_target(bu, u_lb, u_ub)
    rho_x, rho_u = rho * act_x, rho * act_u_
    factors_p = kkt_factor(Q_full + _stage_diag(rho_x, lead=1), Rs + _stage_diag(rho_u))
    q_head = q_lin[:, :1].expand(x0.shape[0], 1, nx)
    for _ in range(2):
        qts_p = torch.cat([q_head, q_lin[:, 1:] + act_x * (lhat_x - rho_x * tgt_x)], dim=1)
        rts_p = r_lin + act_u_ * (lhat_u - rho_u * tgt_u)
        xs_p, us_p = kkt_solve(factors_p, qts_p, rts_p, x_init=x0)
        lhat_x = lhat_x + rho_x * (xs_p[:, 1:] - tgt_x) * act_x
        lhat_u = lhat_u + rho_u * (us_p - tgt_u) * act_u_

    # accept the polished trajectory only if it is finite and (approximately)
    # bound-feasible, and its multipliers sit on the correct side of zero: a
    # violation means the active set was misidentified, and the IP iterate is
    # then judged by the plain (μ, feasibility) criterion
    def viol(z, lb, ub):
        mask_l, mask_u = _masks(lb, ub)
        zero = torch.zeros_like(z)
        v = torch.maximum(torch.where(mask_l, lb - z, zero), torch.where(mask_u, z - ub, zero))
        return v.amax(dim=(-2, -1), keepdim=True)

    amax = lambda v: v.abs().amax(dim=(-2, -1), keepdim=True)
    scale = 1.0 + torch.maximum(amax(us), amax(xs))
    feas_tol = (max(tol, 1e-7) if dt == torch.float64 else 1e-4) * scale
    polish_viol = torch.maximum(viol(xs_p[:, 1:], x_lb, x_ub), viol(us_p, u_lb, u_ub))

    def signs_ok(act, lhat, tgt, ub):
        side = torch.where(tgt == ub, 1.0, -1.0).to(dt)
        return ((torch.sign(lhat) * side > -1e-6) | (act == 0)).all(dim=(-2, -1), keepdim=True)

    polish_ok = (
        all_finite(us_p) & all_finite(xs_p)
        & (polish_viol < feas_tol) & (mu < 1e-2 * scale)
        & signs_ok(act_x, lhat_x, tgt_x, x_ub) & signs_ok(act_u_, lhat_u, tgt_u, u_ub)
    )
    xs = torch.where(polish_ok, xs_p, xs)
    us = torch.where(polish_ok, us_p, us)

    prim_res = torch.maximum(viol(xs[:, 1:], x_lb, x_ub), viol(us, u_lb, u_ub))
    # success needs μ small enough that the active-set read is trustworthy,
    # plus primal feasibility
    success = torch.where(
        polish_ok,
        (prim_res < feas_tol) & (mu < 1e-4 * scale),
        (mu < feas_tol) & (prim_res < feas_tol),
    )
    # back out of the equilibrated space; μ and prim_res stay in the scaled
    # space, where they are dimensionless
    flat = lambda v: v.reshape(-1)
    out = StagewiseIPResult(
        us=us * w_u,
        xs=xs * w_x,
        mu=flat(mu),
        prim_res=flat(prim_res),
        success=flat(success),
        lam_x=torch.where(polish_ok, lhat_x, bx.lam_u - bx.lam_l) / (c_cost * w_x),
        lam_u=torch.where(polish_ok, lhat_u, bu.lam_u - bu.lam_l) / (c_cost * w_u),
    )
    if single:
        out = StagewiseIPResult(**{f.name: getattr(out, f.name)[0] for f in dataclasses.fields(out)})
    return out


# ---------------------------------------------------------------------------
# Receding-horizon controller over the stagewise solver
# ---------------------------------------------------------------------------

_KERNEL_BACKENDS = ("cuda", "twin")


@dataclasses.dataclass(frozen=True)
class StagewiseMPC:
    """Receding-horizon linear MPC over the stagewise Riccati IP solver, the
    long-horizon twin of :class:`..linear_mpc.LinearMPC`. The carry is the
    warm-start input trajectory, shifted one stage per step."""

    A: torch.Tensor
    B: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    Pf: torch.Tensor
    x_lb: torch.Tensor
    x_ub: torch.Tensor
    u_lb: torch.Tensor
    u_ub: torch.Tensor
    N: int = 20
    iters: int = 20
    parallel: bool = False

    def solve(self, x0: torch.Tensor, u_warm: torch.Tensor | None = None) -> StagewiseIPResult:
        return stagewise_ip_solve(
            self.A, self.B, self.Q, self.R, self.Pf,
            self.x_lb, self.x_ub, self.u_lb, self.u_ub,
            x0, u_init=u_warm, N=self.N, iters=self.iters, parallel=self.parallel,
        )

    def policy(self):
        """Policy ``(x, t, carry) -> (u0, carry, aux)`` on one state or on a
        batch of states (carry = warm ū; a non-tensor carry starts cold)."""

        def policy_fn(x, t, carry):
            res = self.solve(x, u_warm=carry if isinstance(carry, torch.Tensor) else None)
            u_warm = torch.cat([res.us[..., 1:, :], res.us[..., -1:, :]], dim=-2)
            aux = {
                "solver_success": res.success,
                "state_prediction": res.xs[..., 1:, :],
                "input_prediction": res.us,
                "mu": res.mu,
                "prim_res": res.prim_res,
            }
            return res.us[..., 0, :], u_warm, aux

        return policy_fn

    def initial_carry(self, dtype=torch.float32, device=None):
        return torch.zeros(self.N, self.B.shape[-1], dtype=dtype, device=resolve_device(device))

    def batched_policy(
        self, backend: str = "cuda", tile: int | None = None, group: int | None = None
    ):
        """Batch-level receding-horizon policy for
        :func:`~..control.batch_loop.simulate_batch`; the carry is the warm
        input trajectories ``(B, N, nu)``, shifted one stage per step.

        ``backend="cuda"`` runs each solve as one launch of the fused kernel
        (``ops/cuda/riccati_ip_kernel.py``; its plain twin for CPU tensors),
        ``"twin"`` the twin on any device, ``"torch"`` the batched
        :func:`stagewise_ip_solve`. The kernel takes LTI data with
        time-invariant bounds, prepared once here for every step; ``tile`` is
        its scenarios per block and ``group`` its threads per scenario (the
        kernel's defaults when ``None``; the solution does not depend on
        ``group``)."""
        if backend in _KERNEL_BACKENDS:
            from ..ops.cuda import riccati_ip_kernel as K

            if any(v.ndim > 1 for v in (self.x_lb, self.x_ub, self.u_lb, self.u_ub)):
                raise NotImplementedError(
                    "the fused stagewise-IP kernel takes time-invariant bounds; "
                    "per-stage (N, n) bounds need backend='torch'"
                )
            kp = K.prepare_problem(
                *(v.detach().cpu().numpy()
                  for v in (self.A, self.B, self.Q, self.R, self.Pf,
                            self.x_lb, self.x_ub, self.u_lb, self.u_ub)),
                device=self.A.device,
            )
            kw = {} if tile is None else {"tile": tile}
            solve = lambda x, u: K.stagewise_ip_solve_prepared(
                kp, x, u, N=self.N, iters=self.iters, group=group, twin=backend == "twin", **kw
            )
        elif backend == "torch":
            solve = self.solve
        else:
            raise ValueError(f"unknown backend {backend!r}")

        def policy_fn(x_batch, t, carry):
            sol = solve(x_batch, carry)
            u_warm = torch.cat([sol.us[:, 1:], sol.us[:, -1:]], dim=1)
            aux = {
                "solver_success": sol.success,
                "state_prediction": sol.xs[:, 1:],
                "input_prediction": sol.us,
                "mu": sol.mu,
                "prim_res": sol.prim_res,
            }
            return sol.us[:, 0], u_warm, aux

        return policy_fn

    def initial_batch_carry(self, batch: int, dtype=torch.float32, device=None):
        return torch.zeros(
            batch, self.N, self.B.shape[-1], dtype=dtype, device=resolve_device(device)
        )


def make_stagewise_mpc(
    problem,
    iters: int = 20,
    dtype=torch.float32,
    N: int | None = None,
    terminal: str = "Q",
    parallel: bool = False,
    terminal_set: bool = False,
    device=None,
) -> StagewiseMPC:
    """Build a :class:`StagewiseMPC` from session-2/3 ``Problem`` (or
    ``BoxProblem``) data on ``device`` in ``dtype``, with horizon ``N``
    (the problem's own when ``None``). ``terminal="dare"`` takes the
    infinite-horizon Riccati solution as the terminal weight;
    ``terminal_set=True`` (implies it) tightens the last stage's state box
    to the certified inner box of the invariant DARE ellipsoid
    (:func:`.lqr.lqr_terminal_set`), which makes the bounds per stage
    ``(N, nx)``: the fused kernel refuses those, ``backend="torch"`` takes
    them. ``parallel=True`` solves with the O(log N) parallel-in-horizon
    KKT solver on ``backend="torch"``; the fused kernel of
    :meth:`StagewiseMPC.batched_policy` runs its own sequential sweeps
    whatever ``parallel`` is, as the JAX package's Pallas backend does."""
    from ..ops.riccati import dare_sda
    from .linear_mpc import as_box_problem

    if terminal not in ("Q", "dare"):
        raise ValueError(f"unknown terminal {terminal!r}")
    device = resolve_device(device)
    box = as_box_problem(problem)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    A, B, Q, R = t(box.A), t(box.B), t(box.Q), t(box.R)
    Pf = dare_sda(A, B, Q, R) if terminal == "dare" or terminal_set else Q
    N_eff = N if N is not None else box.N
    x_lb, x_ub, u_lb, u_ub = t(box.x_min), t(box.x_max), t(box.u_min), t(box.u_max)
    if terminal_set:
        from .lqr import lqr_terminal_set

        _P, _K, _alpha, d = lqr_terminal_set(A, B, Q, R, x_lb, x_ub, u_lb, u_ub)
        nx = x_lb.shape[0]
        x_lb = x_lb.expand(N_eff, nx).clone()
        x_ub = x_ub.expand(N_eff, nx).clone()
        x_lb[-1] = torch.maximum(x_lb[-1], -d)
        x_ub[-1] = torch.minimum(x_ub[-1], d)
    return StagewiseMPC(
        A=A, B=B, Q=Q, R=R, Pf=Pf, x_lb=x_lb, x_ub=x_ub, u_lb=u_lb, u_ub=u_ub,
        N=N_eff, iters=iters, parallel=parallel,
    )
