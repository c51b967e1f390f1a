"""Implicit differentiation through the solvers (port of
``solvers/implicit.py``): OptNet-style KKT gradients for the box-QP, the
stagewise interior point and the AL-iLQR.

Each of the JAX package's ``custom_vjp`` wrappers is a
:class:`torch.autograd.Function` here. Its forward is the production solver,
unchanged and not differentiated; its backward freezes the active set at the
solution and solves one linear system with the KKT Jacobian, so the gradient
costs one solve whatever the solver's iteration budget.

Box-QP ``min ½ xᵀPx + qᵀx  s.t.  l ≤ A x ≤ u`` with duals ``y`` (negative on
lower-active rows, positive on upper-active ones): with the active set ``d``
and the active bound ``b`` the KKT conditions are the smooth system

    F1 = P x + q + Aᵀ y                      = 0        (n rows)
    F2 = d ∘ (A x − b) + (1 − d) ∘ y         = 0        (m rows)

and for the incoming cotangent ``g`` one solve ``K v = g`` with

    K = [[P, Aᵀ·diag(d)], [diag(d)·A, diag(1−d) − δ·diag(d)]]

gives ``q̄ = −v_x``, ``l̄ = lower ∘ v_y``, ``ū = upper ∘ v_y``,
``P̄ = −v_x xᵀ`` and ``Ā = −(y v_xᵀ + (d ∘ v_y) xᵀ)``.

The stagewise and AL-iLQR wrappers write the KKT residual once as a function
``F(w, params)`` and take ``K = ∂F/∂w`` with ``torch.func.jacfwd`` and the
parameter pullback with ``torch.func.vjp``. The AL-iLQR backward of a batch
is one ``torch.func.vmap`` of the one-scenario backward.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.func import grad, jacfwd, vjp, vmap
from torch.utils._pytree import tree_map

from ..utils.precision import set_solver_precision
from .qp import QPSolution, admm_solve, pdip_solve

_BIG = 1e19


def _active_sets(y, l, u, scale_tol: float = 1e-8):
    """Active bounds read off the dual signs (the polish convention):
    lower-active where ``y < −tol`` and ``l`` is finite, with ``tol`` relative
    to each scenario's largest dual (``y`` is ``(..., m)``)."""
    tol = scale_tol * torch.clamp(y.abs().amax(dim=-1, keepdim=True), min=1.0)
    return (y < -tol) & (l > -_BIG), (y > tol) & (u < _BIG)


def _finite_or_zero(v, *outs):
    """``outs`` per scenario where ``v (B, k)`` is finite, zeros elsewhere (a
    degenerate KKT matrix gives zero cotangents, not a poisoned batch)."""
    finite = torch.isfinite(v).all(dim=-1)
    return tuple(torch.where(finite.reshape(-1, *[1] * (a.ndim - 1)), a, torch.zeros_like(a))
                 for a in outs)


def _refined_solve(K, g):
    """``K v = g`` with one step of iterative refinement; ``solve_ex`` so that
    a singular system gives non-finite values instead of raising."""
    v = torch.linalg.solve_ex(K, g).result
    return v + torch.linalg.solve_ex(K, g - (K @ v[..., None])[..., 0]).result


def kkt_vjp(P, A, x, y, lower, upper, gx, gy, gz, delta: float = 1e-9):
    """One KKT solve per scenario mapping output cotangents ``(gx, gy, gz)``
    to input cotangents ``(q̄, l̄, ū, P̄, Ā)``. Batched over a leading axis:
    ``x (B, n)``, ``y``/``z`` cotangents ``(B, m)``, ``P`` ``(n, n)`` or
    ``(B, n, n)``, ``A`` ``(m, n)`` or ``(B, m, n)``; ``P̄ (B, n, n)``, ``Ā
    (B, m, n)``. One-scenario inputs (``x (n,)``) give one scenario's."""
    if x.ndim == 1:
        one = lambda a: a[None]
        outs = kkt_vjp(P, A, one(x), one(y), one(lower), one(upper), one(gx), one(gy),
                       one(gz), delta)
        return tuple(a[0] for a in outs)
    set_solver_precision()
    dtype = P.dtype
    B, n = x.shape
    m = y.shape[-1]
    d = (lower | upper).to(dtype)
    P = P.expand(B, n, n)
    A = A.expand(B, m, n)
    At = A.transpose(-1, -2)

    # z = clip(Ax, l, u): inactive rows pass A dx through, active rows follow
    # the moving bound; fold the z cotangent into the x and bound channels
    gx_eff = gx + (At @ ((1.0 - d) * gz)[..., None])[..., 0]
    zero = torch.zeros_like(gz)
    l_bar_z = torch.where(lower, gz, zero)
    u_bar_z = torch.where(upper, gz, zero)

    K = torch.cat([
        torch.cat([P, At * d[:, None, :]], dim=2),
        torch.cat([d[:, :, None] * A, torch.diag_embed(1.0 - d - delta * d)], dim=2),
    ], dim=1)
    v = _refined_solve(K, torch.cat([gx_eff, gy], dim=1))
    vx, vy = v[:, :n], v[:, n:]
    q_bar = -vx
    l_bar = l_bar_z + torch.where(lower, vy, zero)
    u_bar = u_bar_z + torch.where(upper, vy, zero)
    P_bar = -vx[:, :, None] * x[:, None, :]
    A_bar = -(y[:, :, None] * vx[:, None, :] + (d * vy)[:, :, None] * x[:, None, :])
    return _finite_or_zero(v, q_bar, l_bar, u_bar, P_bar, A_bar)


def _zeros_if_none(g, like):
    return torch.zeros_like(like) if g is None else g


def _sum_to(g, shape):
    """A batched cotangent reduced to an input's (shared) shape."""
    return g.sum(dim=0) if g.ndim > len(shape) else g


class _ImplicitQP(torch.autograd.Function):
    """The QP solve as one autograd node: differentiable in ``P``, ``A_c``,
    ``q``, ``l`` and ``u``; every other field of the operator (the Ruiz
    scalings, the ρ-ladder inverses) is a constant of the node, and the warm
    start gets no gradient."""

    @staticmethod
    def forward(ctx, fwd_solve, op, warm, P, A_c, q, l, u):
        sol = fwd_solve(op, q, l, u, warm)
        lower, upper = _active_sets(sol.y, l, u)
        ctx.save_for_backward(P, A_c, sol.x, sol.y, lower, upper)
        ctx.mark_non_differentiable(sol.prim_res, sol.dual_res, sol.converged)
        return sol.x, sol.z, sol.y, sol.prim_res, sol.dual_res, sol.converged

    @staticmethod
    def backward(ctx, gx, gz, gy, *_):
        P, A_c, x, y, lower, upper = ctx.saved_tensors
        gx, gz, gy = _zeros_if_none(gx, x), _zeros_if_none(gz, y), _zeros_if_none(gy, y)
        q_bar, l_bar, u_bar, P_bar, A_bar = kkt_vjp(P, A_c, x, y, lower, upper, gx, gy, gz)
        return (None, None, None, _sum_to(P_bar, P.shape), _sum_to(A_bar, A_c.shape),
                q_bar, l_bar, u_bar)


def make_implicit_qp_solver(solver: str = "admm", **solver_kwargs) -> Callable[..., QPSolution]:
    """``solve(op, q, l, u, warm=None) -> QPSolution``, differentiable by the
    KKT implicit function theorem.

    The forward is :func:`.qp.admm_solve` or :func:`.qp.pdip_solve` verbatim,
    on a batch (``q (B, n)``) or on one scenario (``q (n,)``). Cotangents of
    ``sol.x``, ``sol.y`` and ``sol.z`` reach ``q``, ``l``, ``u``, ``op.P``
    and ``op.A_c`` through one KKT solve per scenario; the residuals and the
    convergence flags are reports, not smooth outputs. The other fields of
    ``op`` get no gradient (the JAX package gives them zero cotangents), and
    neither does ``warm``: at an exact KKT point the solution does not depend
    on the warm start, which also cuts the spurious step-to-step dependence of
    a warm-started closed loop."""
    if solver == "admm":
        def fwd_solve(op, q, l, u, warm):
            return admm_solve(op, q, l, u, warm=warm, **solver_kwargs)
    elif solver == "pdip":
        def fwd_solve(op, q, l, u, warm):
            return pdip_solve(op, q, l, u, **solver_kwargs)
    else:
        raise ValueError(f"unknown solver {solver!r}")

    def solve(op, q, l, u, warm=None) -> QPSolution:
        single = q.ndim == 1
        if single:
            q, l, u = q[None], l[None], u[None]
            warm = None if warm is None else (warm[0][None], warm[1][None])
        out = _ImplicitQP.apply(fwd_solve, op, warm, op.P, op.A_c, q, l, u)
        if single:
            out = tuple(a[0] for a in out)
        return QPSolution(*out)

    return solve


admm_solve_implicit = make_implicit_qp_solver("admm")
pdip_solve_implicit = make_implicit_qp_solver("pdip")


@functools.lru_cache(maxsize=None)
def _cached_implicit_solver(solver: str, kw_items: tuple):
    return make_implicit_qp_solver(solver, **dict(kw_items))


def implicit_qp_solver(solver: str = "admm", **solver_kwargs):
    """Cached :func:`make_implicit_qp_solver` (the keywords must be
    hashable): one wrapper per configuration."""
    return _cached_implicit_solver(solver, tuple(sorted(solver_kwargs.items())))


# ---------------------------------------------------------------------------
# Stagewise (Riccati-IP) implicit differentiation
# ---------------------------------------------------------------------------
#
# The same move on the stagewise KKT system of the box-constrained LQ-OCP
# that solvers/riccati_ip.py::stagewise_ip_solve solves. With the Lagrangian
# L = Σ ℓ_k + Σ λ_{k+1}ᵀ(A_k x_k + B_k u_k − x_{k+1}) and the net bound
# multipliers μ (lam_u / lam_x of the result, positive at upper bounds):
#   stat_u_k:  R_k u_k + r_k + B_kᵀ λ_{k+1} + μ_u,k            = 0
#   stat_x_j:  Q_j x_j + q_j + A_jᵀ λ_{j+1} − λ_j + μ_x,j      = 0   (A_N ≡ 0)
#   dyn_k:     A_k x_k + B_k u_k − x_{k+1}                     = 0
# The solver does not return the costates λ_1..λ_N; the backward pass
# rebuilds them exactly from stat_x.

_STAGEWISE_PARAMS = ("As", "Bs", "Qs", "Rs", "Pf", "x_lb", "x_ub", "u_lb", "u_ub", "x0",
                     "q_lin", "r_lin")


def _stagewise_kkt_resid(w, params, masks, N, nx, nu):
    """Flat stagewise KKT residual with a frozen active set;
    ``w = [us (N·nu) | x₁..x_N (N·nx) | λ₁..λ_N (N·nx) | μ_u | μ_x]``."""
    As, Bs, Qs, Rs, Pf, x_lb, x_ub, u_lb, u_ub, x0, q_lin, r_lin = params
    u_low, u_up, x_low, x_up = masks
    us, xs1, lam, mu_u, mu_x = (
        seg.reshape(N, -1) for seg in torch.split(w, (N * nu, N * nx, N * nx, N * nu, N * nx))
    )
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    mtv = lambda M, v: (M.transpose(-1, -2) @ v[..., None])[..., 0]
    x_prev = torch.cat([x0[None], xs1[:-1]])
    dyn = mv(As, x_prev) + mv(Bs, us) - xs1
    stat_u = mv(Rs, us) + r_lin + mtv(Bs, lam) + mu_u
    # the x_j cost: Qs[j] for j = 1..N−1, Pf for j = N (the solver's convention)
    Qeff = torch.cat([Qs[1:], Pf[None]])
    Anext = torch.cat([As[1:], torch.zeros_like(As[:1])])
    lam_next = torch.cat([lam[1:], torch.zeros_like(lam[:1])])
    stat_x = mv(Qeff, xs1) + q_lin[1:] + mtv(Anext, lam_next) - lam + mu_x
    bnd_u = torch.where(u_low, us - u_lb, torch.where(u_up, us - u_ub, mu_u))
    bnd_x = torch.where(x_low, xs1 - x_lb, torch.where(x_up, xs1 - x_ub, mu_x))
    return torch.cat([stat_u.reshape(-1), stat_x.reshape(-1), dyn.reshape(-1),
                      bnd_u.reshape(-1), bnd_x.reshape(-1)])


class _ImplicitStagewise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, config, *params):
        from .riccati_ip import stagewise_ip_solve

        N, iters, tol, parallel = config
        As, Bs, Qs, Rs, Pf, x_lb, x_ub, u_lb, u_ub, x0, q_lin, r_lin = params
        res = stagewise_ip_solve(As, Bs, Qs, Rs, Pf, x_lb, x_ub, u_lb, u_ub, x0,
                                 q_lin=q_lin, r_lin=r_lin, N=N, iters=iters, tol=tol,
                                 parallel=parallel)
        ctx.N = N
        ctx.save_for_backward(*params, res.us, res.xs, res.lam_u, res.lam_x)
        ctx.mark_non_differentiable(res.mu, res.prim_res, res.success)
        return res.us, res.xs, res.lam_x, res.lam_u, res.mu, res.prim_res, res.success

    @staticmethod
    def backward(ctx, g_us, g_xs, g_lam_x, g_lam_u, *_):
        set_solver_precision()
        *params, us, xs, mu_u, mu_x = ctx.saved_tensors
        params = tuple(params)
        As, Bs, Qs, Rs, Pf, x_lb, x_ub, u_lb, u_ub, x0, q_lin, r_lin = params
        N, nx, nu = ctx.N, x0.shape[0], us.shape[1]
        g_us, g_xs = _zeros_if_none(g_us, us), _zeros_if_none(g_xs, xs)
        g_lam_x, g_lam_u = _zeros_if_none(g_lam_x, mu_x), _zeros_if_none(g_lam_u, mu_u)
        xs1 = xs[1:]

        def act(mu, lb, ub):  # active sets from the net multiplier signs
            t = 1e-8 * torch.clamp(mu.abs().max(), min=1.0)
            return (mu < -t) & (lb > -_BIG), (mu > t) & (ub < _BIG)

        masks = (*act(mu_u, u_lb, u_ub), *act(mu_x, x_lb, x_ub))
        # the costates λ_N..λ_1 from stat_x (exact at the KKT point)
        Qeff = torch.cat([Qs[1:], Pf[None]])
        Anext = torch.cat([As[1:], torch.zeros_like(As[:1])])
        lam_next, lams = torch.zeros_like(x0), []
        for j in range(N - 1, -1, -1):
            lam_next = Qeff[j] @ xs1[j] + q_lin[j + 1] + Anext[j].T @ lam_next + mu_x[j]
            lams.append(lam_next)
        lam = torch.stack(lams[::-1])

        w = torch.cat([us.reshape(-1), xs1.reshape(-1), lam.reshape(-1), mu_u.reshape(-1),
                       mu_x.reshape(-1)])
        K = jacfwd(lambda ww: _stagewise_kkt_resid(ww, params, masks, N, nx, nu))(w)
        # the cotangent in w-space: λ has no output slot
        g = torch.cat([g_us.reshape(-1), g_xs[1:].reshape(-1), torch.zeros(N * nx, dtype=w.dtype,
                       device=w.device), g_lam_u.reshape(-1), g_lam_x.reshape(-1)])
        v = _refined_solve(K.T, g)
        _, pullback = vjp(lambda *p: _stagewise_kkt_resid(w, p, masks, N, nx, nu), *params)
        pbar = [-a for a in pullback(v)]
        pbar[9] = pbar[9] + g_xs[0]  # xs[0] ≡ x0 is returned verbatim
        finite = bool(torch.isfinite(v).all())
        return (None, *(a if finite else torch.zeros_like(a) for a in pbar))


def make_implicit_stagewise_solver(N: int, iters: int = 20, tol: float = 1e-8,
                                   parallel: bool = False):
    """Implicit-differentiation wrapper around
    :func:`.riccati_ip.stagewise_ip_solve` for horizon ``N``:
    ``solve(As, Bs, Qs, Rs, Pf, x_lb, x_ub, u_lb, u_ub, x0, q_lin, r_lin) ->
    StagewiseIPResult`` over the canonical stacked shapes of one scenario
    (``(N, nx, nx)`` dynamics and costs, ``(N, nx)`` / ``(N, nu)`` bounds,
    ``(N + 1, nx)`` / ``(N, nu)`` linear terms, ``x0 (nx,)``). Gradients
    reach every parameter through one stagewise KKT solve; the interior-point
    iterations are not differentiated. :func:`stagewise_ip_solve_implicit`
    takes the solver's broadcasting signature."""
    from .riccati_ip import StagewiseIPResult

    def solve(*params) -> StagewiseIPResult:
        us, xs, lam_x, lam_u, mu, prim_res, success = _ImplicitStagewise.apply(
            (N, iters, tol, parallel), *params)
        return StagewiseIPResult(us=us, xs=xs, mu=mu, prim_res=prim_res, success=success,
                                 lam_x=lam_x, lam_u=lam_u)

    return solve


def stagewise_ip_solve_implicit(
    A, B, Q, R, Pf, x_lb, x_ub, u_lb, u_ub, x0, q_lin=None, r_lin=None, *,
    N: int, iters: int = 20, tol: float = 1e-8, parallel: bool = False,
):
    """Differentiable :func:`.riccati_ip.stagewise_ip_solve` for one
    scenario (``x0 (nx,)``), with the solver's broadcasting (LTI or stacked
    LTV data, entry-wise bounds); the gradients reduce to the caller's shapes
    through the broadcasts. The data follows ``x0``'s dtype and device."""
    dt, dev = x0.dtype, x0.device
    nx, nu = x0.shape[-1], B.shape[-1]
    t_ = lambda v: torch.as_tensor(v, device=dev).to(dt)
    As = t_(A).expand(N, nx, nx)
    Bs = t_(B).expand(N, nx, nu)
    Qs = t_(Q).expand(N, nx, nx)
    Rs = t_(R).expand(N, nu, nu)
    x_lb, x_ub = t_(x_lb).expand(N, nx), t_(x_ub).expand(N, nx)
    u_lb, u_ub = t_(u_lb).expand(N, nu), t_(u_ub).expand(N, nu)
    q_lin = torch.zeros(N + 1, nx, dtype=dt, device=dev) if q_lin is None else t_(q_lin)
    r_lin = torch.zeros(N, nu, dtype=dt, device=dev) if r_lin is None else t_(r_lin)
    solve = make_implicit_stagewise_solver(N, iters=iters, tol=tol, parallel=parallel)
    return solve(As, Bs, Qs, Rs, t_(Pf), x_lb, x_ub, u_lb, u_ub, x0, q_lin, r_lin)


# ---------------------------------------------------------------------------
# AL-iLQR (nonlinear single shooting) implicit differentiation
# ---------------------------------------------------------------------------
#
# Decision variable ū = vec(us), the states eliminated through the rollout,
# the converged AL multipliers λ as the inequality duals:
#   stat:  ∇_ū [ J(ū; x0, θ) + Σ_k λ_kᵀ c_k(x_k(ū), u_k) ] = 0
#   comp:  active (k, i): c_{k,i} = 0;   inactive: λ_{k,i} = 0
# The KKT Jacobian is the exact Lagrangian Hessian through the rollout
# (jacfwd of grad), one dense solve per scenario.


def _one_scenario(prob, p, s):
    """``prob`` restricted to one scenario: its ``params``/``stages`` slices
    ``p``/``s`` (``{}`` for none) given back a leading axis of one, so that
    :func:`.ilqr.rollout` and :func:`.ilqr.total_cost` run on it."""
    one = lambda tree: tree_map(lambda a: a[None], tree) if tree else None
    return prob._replace(params=one(p), stages=one(s))


class _ImplicitALILQR(torch.autograd.Function):
    @staticmethod
    def forward(ctx, core, x0, u_init, *theta_leaves):
        theta = dict(zip(core.keys, theta_leaves))
        sol = core.forward(theta, x0, u_init)
        ctx.core = core
        ctx.save_for_backward(x0, sol.us, sol.lams, *theta_leaves)
        ctx.mark_non_differentiable(sol.viol, sol.converged)
        return sol.us, sol.xs, sol.cost, sol.lams, sol.viol, sol.converged

    @staticmethod
    def backward(ctx, g_us, g_xs, g_cost, g_lams, *_):
        set_solver_precision()
        core = ctx.core
        x0, us, lams, *theta_leaves = ctx.saved_tensors
        theta = dict(zip(core.keys, theta_leaves))
        B, N, nu = us.shape
        dt = x0.dtype
        g_us = _zeros_if_none(g_us, us).to(dt)
        g_xs = torch.zeros(B, N + 1, x0.shape[-1], dtype=dt, device=x0.device) \
            if g_xs is None else g_xs.to(dt)
        g_cost = torch.zeros(B, dtype=dt, device=x0.device) if g_cost is None else g_cost.to(dt)
        g_lams = _zeros_if_none(g_lams, lams).to(dt)
        p, s = core.scenario_data(theta)
        theta_bar, x0_bar = vmap(core.backward_one, in_dims=(None, 0, 0, 0, 0, 0, 0, 0, 0, 0))(
            theta, x0, p, s, us.to(dt), lams.to(dt), g_us, g_xs, g_cost, g_lams)
        return (None, x0_bar, None, *(theta_bar[k].sum(dim=0) for k in core.keys))


class _ALILQRCore:
    """The pieces of an implicit AL-iLQR solve: the problem builder, the
    forward, and the one-scenario KKT backward."""

    def __init__(self, problem_fn, n_constraints, forward, solver_kwargs, keys, with_theta):
        self.problem_fn = problem_fn
        self.nc = n_constraints
        self.keys = keys
        self.solver_kwargs = solver_kwargs
        self._forward = forward
        self.with_theta = with_theta  # forward(theta, x0, u_init), else forward(x0, u_init)

    def forward(self, theta, x0, u_init):
        if self._forward is not None:
            if self.with_theta:
                return self._forward(theta, x0, u_init)
            return self._forward(x0, u_init)
        from .ilqr import al_ilqr_solve

        prob, constraints = self.problem_fn(theta)
        return al_ilqr_solve(prob, constraints, self.nc, x0, u_init=u_init, **self.solver_kwargs)

    def scenario_data(self, theta):
        """The problem's per-scenario ``params`` and per-stage ``stages``
        (leaves ``(B, ...)``), mapped over by the batched backward."""
        prob, _ = self.problem_fn(theta)
        return prob.params or {}, prob.stages or {}

    def _pieces(self, theta, p, s):
        prob, constraints = self.problem_fn(theta)
        return _one_scenario(prob, p, s), constraints

    def _outs(self, theta, x0, U, p, s):
        from .ilqr import rollout, total_cost

        prob, _ = self._pieces(theta, p, s)
        us = U.reshape(1, prob.N, prob.nu)
        xs = rollout(prob, x0[None], us)
        return xs, total_cost(prob, xs, us), prob

    def _kkt_resid(self, w, x0, theta, p, s, active):
        prob, constraints = self._pieces(theta, p, s)
        N, nu = prob.N, prob.nu

        def lagrangian(U, lam):
            xs, cost, _ = self._outs(theta, x0, U, p, s)
            cs = vmap(constraints, in_dims=(0, 0, None, 0))(xs[0, :-1], U.reshape(N, nu), p, s)
            return cost[0] + (lam * cs).sum()

        U, lam = w[: N * nu], w[N * nu:].reshape(N, self.nc)
        stat = grad(lagrangian)(U, lam)
        xs, _, _ = self._outs(theta, x0, U, p, s)
        cs = vmap(constraints, in_dims=(0, 0, None, 0))(xs[0, :-1], U.reshape(N, nu), p, s)
        return torch.cat([stat, torch.where(active, cs, lam).reshape(-1)])

    def backward_one(self, theta, x0, p, s, us, lam, g_us, g_xs, g_cost, g_lams):
        """One scenario's cotangents ``(θ̄, x̄0)`` from the converged ``(ū,
        λ)`` and the output cotangents of ``(us, xs, cost, lams)``."""
        U = us.reshape(-1)
        # the active set: multipliers above a tolerance relative to the largest
        active = lam > 1e-6 * torch.clamp(lam.max(), min=1.0)
        w = torch.cat([U, lam.reshape(-1)])
        K = jacfwd(lambda ww: self._kkt_resid(ww, x0, theta, p, s, active))(w)

        # xs and cost are smooth in (θ, x0, ū): their ∂/∂ū joins the KKT
        # solve, their ∂/∂(θ, x0) bypasses it
        def outs(theta_, x0_, U_):
            xs, cost, _ = self._outs(theta_, x0_, U_, p, s)
            return xs[0], cost[0]

        _, pull = vjp(outs, theta, x0, U)
        gtheta_direct, gx0_direct, gU_extra = pull((g_xs, g_cost))
        g = torch.cat([g_us.reshape(-1) + gU_extra, g_lams.reshape(-1)])
        v = _refined_solve(K.T, g)
        _, pull_p = vjp(lambda th, x0_: self._kkt_resid(w, x0_, th, p, s, active), theta, x0)
        theta_kkt, x0_kkt = pull_p(v)
        finite = torch.isfinite(v).all()
        keep = lambda a: torch.where(finite, a, torch.zeros_like(a))
        return ({k: keep(gtheta_direct[k] - theta_kkt[k]) for k in self.keys},
                keep(gx0_direct - x0_kkt))


def _implicit_al_ilqr(core: _ALILQRCore, theta: dict, x0, u_init):
    from .ilqr import ALILQRSolution

    single = x0.ndim == 1
    prob, _ = core.problem_fn(theta)
    if u_init is None:
        u_init = torch.zeros(*x0.shape[:-1], prob.N, prob.nu, dtype=x0.dtype, device=x0.device)
    if single:
        x0, u_init = x0[None], u_init[None]
    us, xs, cost, lams, viol, conv = _ImplicitALILQR.apply(
        core, x0, u_init, *(theta[k] for k in core.keys))
    sol = ALILQRSolution(us=us, xs=xs, cost=cost, viol=viol, converged=conv, lams=lams)
    if single:
        sol = ALILQRSolution(us=us[0], xs=xs[0], cost=cost[0], viol=viol[0],
                             converged=conv[0], lams=lams[0])
    return sol


def make_implicit_al_ilqr_solver(prob, constraints, n_constraints: int, forward=None,
                                 **solver_kwargs):
    """Implicit-differentiation wrapper around :func:`.ilqr.al_ilqr_solve`:
    ``solve(x0, u_init=None) -> ALILQRSolution`` whose ``us``, ``xs``,
    ``cost`` and ``lams`` are differentiable in ``x0`` (``(B, nx)``, or
    ``(nx,)`` for one scenario).

    The backward solves one dense KKT system per scenario, the exact
    Lagrangian Hessian through the rollout, with the converged multipliers
    as the inequality duals; the gradient's accuracy is the AL solve's
    (``viol_tol``). ``forward(x0, u_init) -> ALILQRSolution`` may replace the
    forward solve (a fused kernel on the same OCP, its multipliers in the
    row order of ``constraints``): the backward reads only the converged
    ``(us, lams)``. For gradients in cost weights or model parameters use
    :func:`make_implicit_al_ilqr_param_solver`."""
    core = _ALILQRCore(lambda theta: (prob, constraints), n_constraints, forward,
                       solver_kwargs, keys=(), with_theta=False)

    def solve(x0, u_init=None):
        return _implicit_al_ilqr(core, {}, x0, u_init)

    return solve


def make_implicit_al_ilqr_param_solver(problem_fn, n_constraints: int, forward=None,
                                       **solver_kwargs):
    """Parameter-differentiable AL-iLQR: ``problem_fn(theta) ->
    (ILQRProblem, constraints)`` builds the OCP from ``theta``, a ``dict`` of
    tensors (cost weights, model parameters, references). Returns
    ``solve(theta, x0, u_init=None) -> ALILQRSolution`` differentiable in
    ``theta`` and ``x0``.

    The backward of :func:`make_implicit_al_ilqr_solver` with the residual's
    dependence on ``theta`` exposed: one VJP of the KKT residual in
    ``(theta, x0)`` plus the direct path of the smooth outputs ``(xs,
    cost)``. A batch (``x0 (B, nx)``) runs one ``torch.func.vmap`` of the
    one-scenario backward and sums ``theta``'s cotangent over it.
    ``forward(theta, x0, u_init)`` may replace the forward solve (the fused
    kernel with per-lane weights); its multipliers come in the row order of
    ``problem_fn``'s constraints."""

    def solve(theta, x0, u_init=None):
        core = _ALILQRCore(problem_fn, n_constraints, forward, solver_kwargs,
                           keys=tuple(sorted(theta)), with_theta=True)
        return _implicit_al_ilqr(core, theta, x0, u_init)

    return solve
