"""iLQR / AL-iLQR, batched over scenarios (port of ``solvers/ilqr.py``).

The backward pass is a time-varying Riccati recursion over the stages, the
forward pass a rollout under the affine policy ``u = û + α k + K (x − x̂)``
line-searched over a fixed α grid, every α at once. Constraints ``c ≤ 0``
enter by augmented Lagrangian: an outer loop adds the PHR penalty to the
stage cost and updates the multipliers (the ALTRO pattern).

Every solve takes a leading scenario axis. A problem's functions are written
for one scenario and one stage; the solver maps them over scenarios and
stages with ``torch.func.vmap`` and takes their derivatives with
``torch.func`` (``jacfwd``, ``grad``, ``hessian``), where the JAX package
uses ``jax.jacfwd`` / ``jax.hessian``. The JAX package's functions take a
stage index ``t``; here a stage reads its data from ``stages`` (leaves
``(B, N, ...)``) and a scenario its own from ``params`` (leaves ``(B,
...)``), so that a batch may hold one problem per scenario.

The loops are those of a ``vmap`` of the JAX ``while_loop``s: each scenario
iterates until its own exit fires and is frozen from then on, so a batched
solve equals the solves of its scenarios one by one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
from torch.func import grad, hessian, jacfwd, jacrev, vmap
from torch.utils._pytree import tree_map

from ..utils.precision import set_solver_precision

ALPHAS = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.01, 0.0)


class ILQRProblem(NamedTuple):
    """Unconstrained trajectory-optimization problem for the inner iLQR.

    dynamics(x, u, p) -> x_next          (one scenario's discrete step)
    stage_cost(x, u, p, s) -> scalar     (stages k = 0..N-1)
    terminal_cost(x, p) -> scalar

    ``p`` is one scenario's slice of ``params``, ``s`` one stage's slice of
    ``stages`` (pytrees of tensors, or ``None`` for none).
    """

    dynamics: Callable
    stage_cost: Callable
    terminal_cost: Callable
    N: int
    nx: int
    nu: int
    params: Any = None  # leaves (B, ...)
    stages: Any = None  # leaves (B, N, ...)


@dataclasses.dataclass(frozen=True)
class ILQRSolution:
    us: torch.Tensor  # (B, N, nu)
    xs: torch.Tensor  # (B, N + 1, nx)
    cost: torch.Tensor  # (B,)
    grad_norm: torch.Tensor  # (B,) ∞-norm of the control-space gradient
    converged: torch.Tensor  # (B,) bool


@dataclasses.dataclass(frozen=True)
class ALILQRSolution:
    us: torch.Tensor  # (B, N, nu)
    xs: torch.Tensor  # (B, N + 1, nx)
    cost: torch.Tensor  # (B,) true (unpenalized) cost
    viol: torch.Tensor  # (B,) max constraint violation
    converged: torch.Tensor  # (B,) bool
    lams: torch.Tensor  # (B, N, nc) AL multipliers (≥ 0, for c ≤ 0)


def _data(tree):
    return {} if tree is None else tree


def _repeat(tree, n: int):
    """Each leaf repeated ``n`` times along its leading axis (the α grid
    laid out as ``(α, scenario)`` rows)."""
    return tree_map(lambda a: a.repeat(n, *([1] * (a.ndim - 1))), tree)


def _over_stages(fn):
    """``fn(x, u, p, s)`` mapped over scenarios, then stages: ``(B, N, ·)``."""
    return vmap(vmap(fn, in_dims=(0, 0, None, 0)))


def rollout(prob: ILQRProblem, x0: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """States ``(B, N + 1, nx)`` of the open-loop rollout of ``us``."""
    dyn = vmap(prob.dynamics)
    p = _data(prob.params)
    xs = [x0]
    for t in range(prob.N):
        xs.append(dyn(xs[-1], us[:, t], p))
    return torch.stack(xs, dim=1)


def total_cost(prob: ILQRProblem, xs, us) -> torch.Tensor:
    p, s = _data(prob.params), _data(prob.stages)
    stage = _over_stages(prob.stage_cost)(xs[:, :-1], us, p, s)
    return stage.sum(dim=1) + vmap(prob.terminal_cost)(xs[:, -1], p)


def ilqr_solve(
    prob: ILQRProblem,
    x0: torch.Tensor,
    u_init: torch.Tensor | None = None,
    iters: int = 50,
    reg_init: float = 1.0,
    reg_min: float = 1e-8,
    reg_max: float = 1e8,
    tol: float = 1e-6,
    active: torch.Tensor | None = None,
) -> ILQRSolution:
    """Levenberg-regularized iLQR on ``x0 (B, nx)``, at most ``iters``
    iterations per scenario.

    The regularization adapts like a trust region: an accepted line search
    halves it, a rejected sweep multiplies it by ten. A scenario stops once
    its gradient is far below ``tol`` (``< 0.01 tol``; a NaN gradient keeps
    it going, as in the JAX package). ``active`` (B,) bool: scenarios that
    iterate at all (the others keep ``u_init``).
    """
    set_solver_precision()
    N, nx, nu = prob.N, prob.nx, prob.nu
    B, dtype, dev = x0.shape[0], x0.dtype, x0.device
    us = torch.zeros(B, N, nu, dtype=dtype, device=dev) if u_init is None else u_init
    p, s = _data(prob.params), _data(prob.stages)
    A = len(ALPHAS)
    alphas = torch.tensor(ALPHAS, dtype=dtype, device=dev)[:, None, None]

    # one reverse-over-reverse pass per stage gives the stage cost's gradient
    # and Hessian in z = (x, u) (faster under torch.func than forward over
    # reverse), one forward pass the step's Jacobian
    def stage_z(z, p_, s_):
        return prob.stage_cost(z[:nx], z[nx:], p_, s_)

    def grad_twice(z, p_, s_):
        g = grad(stage_z)(z, p_, s_)
        return g, g

    def stage_derivs(x, u, p_, s_):
        z = torch.cat([x, u])
        lzz, lz = jacrev(grad_twice, has_aux=True)(z, p_, s_)
        return jacfwd(prob.dynamics, argnums=(0, 1))(x, u, p_), lz, lzz

    derivs = _over_stages(stage_derivs)
    term_derivs = vmap(lambda x, p_: (
        grad(prob.terminal_cost)(x, p_), hessian(prob.terminal_cost)(x, p_)))
    dyn_a = vmap(prob.dynamics)
    stage_a = _over_stages(prob.stage_cost)
    term_a = vmap(prob.terminal_cost)
    p_a, s_a = _repeat(p, A), _repeat(s, A)
    I_u = torch.eye(nu, dtype=dtype, device=dev)
    T = lambda m: m.transpose(-1, -2)

    def backward(xs, us, reg):
        # derivatives in the working dtype: torch.func's forward mode may
        # promote a float32 product with a Python float to float64
        (fx, fu), lz, lzz = tree_map(lambda a: a.to(dtype), derivs(xs[:, :-1], us, p, s))
        lx, lu = lz[..., :nx], lz[..., nx:]
        lxx, luu, lux = lzz[..., :nx, :nx], lzz[..., nx:, nx:], lzz[..., nx:, :nx]
        Vx, Vxx = (a.to(dtype) for a in term_derivs(xs[:, -1], p))
        ok = torch.ones(B, dtype=torch.bool, device=dev)
        ks = torch.empty(B, N, nu, dtype=dtype, device=dev)
        Ks = torch.empty(B, N, nu, nx, dtype=dtype, device=dev)
        Qus = torch.empty(B, N, nu, dtype=dtype, device=dev)
        for t in range(N - 1, -1, -1):
            Ak, Bk = fx[:, t], fu[:, t]
            Qx = lx[:, t] + (T(Ak) @ Vx[..., None])[..., 0]
            Qu = lu[:, t] + (T(Bk) @ Vx[..., None])[..., 0]
            Qxx = lxx[:, t] + T(Ak) @ Vxx @ Ak
            Quu = luu[:, t] + T(Bk) @ Vxx @ Bk
            Qux = lux[:, t] + T(Bk) @ Vxx @ Ak
            Quu_r = Quu + reg[:, None, None] * I_u
            Quu_r = 0.5 * (Quu_r + T(Quu_r))
            L, info = torch.linalg.cholesky_ex(Quu_r)
            # a factor that fails is NaN, as JAX's cho_factor returns it
            fine = (info == 0)[:, None, None]
            L = torch.where(fine, L, torch.full_like(L, math.nan))
            diag = torch.diagonal(L, dim1=-2, dim2=-1)
            ok = ok & torch.isfinite(L).all(dim=(1, 2)) & (diag > 0.0).all(dim=1)
            k = -torch.cholesky_solve(Qu[..., None], L)[..., 0]
            K = -torch.cholesky_solve(Qux, L)
            Vx = (Qx + (T(K) @ (Quu @ k[..., None]))[..., 0] + (T(K) @ Qu[..., None])[..., 0]
                  + (T(Qux) @ k[..., None])[..., 0])
            Vxx = Qxx + T(K) @ Quu @ K + T(K) @ Qux + T(Qux) @ K
            Vxx = 0.5 * (Vxx + T(Vxx))
            ks[:, t], Ks[:, t], Qus[:, t] = k, K, Qu
        return ks, Ks, ok, Qus.abs().amax(dim=(1, 2))

    def forward_all(xs, us, ks, Ks):
        """Every α's closed-loop rollout at once, as ``(α·B, ·)`` rows."""
        x = xs[:, 0].repeat(A, 1)
        xs_n, us_n = [x], []
        for t in range(N):
            dx = (x - xs[:, t].repeat(A, 1)).reshape(A, B, nx)
            u = us[:, t] + alphas * ks[:, t] + (Ks[:, t] @ dx[..., None])[..., 0]
            u = u.reshape(A * B, nu)
            x = dyn_a(x, u, p_a)
            xs_n.append(x)
            us_n.append(u)
        xs_n, us_n = torch.stack(xs_n, dim=1), torch.stack(us_n, dim=1)
        costs = stage_a(xs_n[:, :-1], us_n, p_a, s_a).sum(dim=1) + term_a(xs_n[:, -1], p_a)
        return (costs.reshape(A, B), xs_n.reshape(A, B, N + 1, nx),
                us_n.reshape(A, B, N, nu))

    xs = rollout(prob, x0, us)
    cost = total_cost(prob, xs, us)
    reg = torch.full((B,), reg_init, dtype=dtype, device=dev)
    grad_norm = torch.full((B,), math.inf, dtype=dtype, device=dev)
    it = torch.zeros(B, dtype=torch.long, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev) if active is None else active
    while True:
        # NaN-safe: a NaN gradient keeps iterating (nan < x is False)
        running = active & (it < iters) & ~(grad_norm < 0.01 * tol)
        if not bool(running.any()):
            break
        ks, Ks, ok, grad_n = backward(xs, us, reg)
        costs, xs_all, us_all = forward_all(xs, us, ks, Ks)
        costs = torch.where(torch.isfinite(costs), costs, math.inf)
        best = costs.argmin(dim=0)  # the first α at the minimum
        rows = torch.arange(B, device=dev)
        best_cost = costs[best, rows]
        improved = ok & (best_cost < cost - 1e-12)
        take = running & improved
        xs = torch.where(take[:, None, None], xs_all[best, rows], xs)
        us = torch.where(take[:, None, None], us_all[best, rows], us)
        cost = torch.where(take, best_cost, cost)
        reg_n = torch.where(improved, torch.clamp(reg * 0.5, min=reg_min),
                            torch.clamp(reg * 10.0, max=reg_max))
        reg = torch.where(running, reg_n, reg)
        grad_norm = torch.where(running, grad_n, grad_norm)
        it = it + running.long()
    return ILQRSolution(us=us, xs=xs, cost=cost, grad_norm=grad_norm, converged=grad_norm < tol)


def al_ilqr_solve(
    prob: ILQRProblem,
    constraints: Callable,  # (x, u, p, s) -> c, c ≤ 0 feasible, shape (nc,)
    n_constraints: int,
    x0: torch.Tensor,
    u_init: torch.Tensor | None = None,
    outer_iters: int = 10,
    inner_iters: int = 25,
    mu_init: float = 10.0,
    mu_scale: float = 10.0,
    mu_max: float = 1e8,
    viol_tol: float = 1e-6,
) -> ALILQRSolution:
    """Augmented-Lagrangian iLQR for inequality-constrained OCPs, batched.

    The stage constraints ``c(x, u, p, s) ≤ 0`` enter the stage cost as the
    PHR term ``(max(0, λ + μc)² − λ²) / (2μ)``; after each inner iLQR solve
    the multipliers update ``λ ← max(0, λ + μc)`` and μ grows tenfold while
    the violation exceeds ``viol_tol``. A scenario stops once it is
    primal-feasible with settled multipliers (relative step < 1e-3), or
    after ``outer_iters`` rounds; μ and λ are the scenario's own.
    """
    set_solver_precision()
    N = prob.N
    B, dtype, dev = x0.shape[0], x0.dtype, x0.device
    us = torch.zeros(B, N, prob.nu, dtype=dtype, device=dev) if u_init is None else u_init
    p, s = _data(prob.params), _data(prob.stages)

    def stage(x, u, pm, sl):
        c = constraints(x, u, pm["p"], sl["s"])
        lam, mu = sl["lam"], pm["mu"]
        # the tie rule of jnp.maximum (half the gradient at 0): torch.maximum's
        act = torch.maximum(torch.zeros_like(c), lam + mu * c)
        return prob.stage_cost(x, u, pm["p"], sl["s"]) + (act * act - lam * lam).sum() / (2.0 * mu)

    def penalized(lams, mu):
        return ILQRProblem(
            dynamics=lambda x, u, pm: prob.dynamics(x, u, pm["p"]),
            stage_cost=stage,
            terminal_cost=lambda x, pm: prob.terminal_cost(x, pm["p"]),
            N=N, nx=prob.nx, nu=prob.nu,
            params={"p": p, "mu": mu}, stages={"s": s, "lam": lams},
        )

    cons = _over_stages(constraints)
    lams = torch.zeros(B, N, n_constraints, dtype=dtype, device=dev)
    mu = torch.full((B,), mu_init, dtype=dtype, device=dev)
    viol = torch.full((B,), math.inf, dtype=dtype, device=dev)
    lam_step = torch.full((B,), math.inf, dtype=dtype, device=dev)
    oi = torch.zeros(B, dtype=torch.long, device=dev)
    while True:
        # NaN-safe: a NaN violation or step keeps iterating
        solved = (viol < viol_tol) & (lam_step < 1e-3)
        running = (oi < outer_iters) & ~solved
        if not bool(running.any()):
            break
        sol = ilqr_solve(penalized(lams, mu), x0, u_init=us, iters=inner_iters, active=running)
        cs = cons(sol.xs[:, :-1], sol.us, p, s)  # (B, N, nc)
        v_n = torch.clamp(cs, min=0.0).amax(dim=(1, 2))
        lams_n = torch.clamp(lams + mu[:, None, None] * cs, min=0.0)
        step = (lams_n - lams).abs().amax(dim=(1, 2)) / (1.0 + lams_n.abs().amax(dim=(1, 2)))
        mu_n = torch.where(v_n > viol_tol, torch.clamp(mu * mu_scale, max=mu_max), mu)
        r3 = running[:, None, None]
        us = torch.where(r3, sol.us, us)
        lams = torch.where(r3, lams_n, lams)
        mu = torch.where(running, mu_n, mu)
        viol = torch.where(running, v_n, viol)
        lam_step = torch.where(running, step, lam_step)
        oi = oi + running.long()
    xs = rollout(prob, x0, us)
    return ALILQRSolution(us=us, xs=xs, cost=total_cost(prob, xs, us), viol=viol,
                          converged=viol < viol_tol, lams=lams)
