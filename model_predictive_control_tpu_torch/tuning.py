"""Gradient-based MPC weight tuning through the differentiable closed loop
(port of ``tuning.py``).

The controller's weights are the parameters of a true closed-loop objective:
the condensed-QP build, the Ruiz/KKT setup, the box-QP solve (differentiated
at its KKT point, :func:`.solvers.implicit.make_implicit_qp_solver`) and the
rollout are one differentiable torch function of ``theta``, so autograd
tunes the controller against any closed-loop cost. The nonlinear parking
tier does the same through the implicit AL-iLQR
(:func:`.solvers.implicit.make_implicit_al_ilqr_param_solver`), with the
forward solve per scenario in plain torch or, batched, on the fused tracker
kernel with per-lane weights (:func:`make_fused_parking_forward`).

- The solves are differentiated by the implicit function theorem, not by
  unrolling their iterations: the backward is one KKT solve per step.
- The closed loop is a Python loop over steps on the whole scenario batch
  (the JAX package's ``lax.scan`` over a ``vmap``).
- Weights are log-diagonals, so every candidate is positive definite.
- The updates are :class:`torch.optim.Adam` at its defaults, which is
  ``optax.adam`` (β 0.9 / 0.999, eps 1e-8, the same bias correction).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from .ops.condensed import build_condensed_qp
from .ops.cuda.ilqr_factory import DEFAULT_TILE
from .solvers.implicit import make_implicit_al_ilqr_param_solver, make_implicit_qp_solver
from .solvers.linear_mpc import Problem
from .solvers.qp import qp_setup


class TuneResult(NamedTuple):
    theta: torch.Tensor  # final log-weights, (nx + nu,)
    Q: torch.Tensor  # (nx, nx) tuned state weight (diagonal)
    R: torch.Tensor  # (nu, nu) tuned input weight (diagonal)
    losses: torch.Tensor  # (updates + 1,) true closed-loop cost per update
    grads: torch.Tensor  # (updates, nx + nu) gradient trace


def theta_to_weights(theta: torch.Tensor, nx: int, nu: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-diagonal parameterization: always positive definite."""
    return torch.diag(torch.exp(theta[:nx])), torch.diag(torch.exp(theta[nx: nx + nu]))


def make_closed_loop_cost(
    problem: Problem,
    x0s: torch.Tensor,  # (B, nx) scenario batch
    steps: int,
    true_Q: torch.Tensor,  # (nx, nx) the true objective's state weight
    true_R: torch.Tensor,  # (nu, nu) the true objective's input weight
    iters: int = 300,
    rho: float = 0.1,
    solver: str = "admm",
    dtype=torch.float64,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``loss(theta) -> scalar``: the mean true closed-loop cost over the
    batch when the plant is driven by an MPC whose weights are ``theta``
    (log-diagonals of Q and R). The controller's Q/R (what it optimizes over
    the horizon) and the true Q/R (what the trajectory is charged) are apart:
    the gap tuning closes. Runs on ``x0s``'s device."""
    device = x0s.device
    system = problem.system(dtype, device)
    A, B = system.A, system.B
    nx, nu = B.shape
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    u_min, u_max = t([problem.u_min] * nu), t([problem.u_max] * nu)
    x_min, x_max = t([problem.p_min, problem.v_min]), t([problem.p_max, problem.v_max])
    solve = make_implicit_qp_solver(solver, iters=iters)
    x0s, true_Q, true_R = x0s.to(dtype), t(true_Q), t(true_R)

    def loss(theta: torch.Tensor) -> torch.Tensor:
        Q, R = theta_to_weights(theta.to(dtype), nx, nu)
        cq = build_condensed_qp(A, B, Q, R, Q, problem.N, u_min=u_min, u_max=u_max,
                                x_min=x_min, x_max=x_max)
        op = qp_setup(cq.P, cq.A_c, rho=rho)
        x, total = x0s, 0.0
        for _ in range(steps):
            sol = solve(op, *cq.qp_vectors(x))
            u0 = sol.x[:, :nu]
            total = total + ((x @ true_Q) * x).sum(-1) + ((u0 @ true_R) * u0).sum(-1)
            x = x @ A.T + u0 @ B.T
        return total.mean()

    return loss


def _adam(theta0, learning_rate):
    """A trainable copy of ``theta0`` (a tensor or a dict of tensors) and
    its Adam optimizer."""
    theta = theta0.detach().clone() if torch.is_tensor(theta0) else {
        k: v.detach().clone() for k, v in theta0.items()}
    leaves = [theta] if torch.is_tensor(theta) else list(theta.values())
    for leaf in leaves:
        leaf.requires_grad_(True)
    return theta, torch.optim.Adam(leaves, lr=learning_rate)


def tune_mpc_weights(
    problem: Problem,
    x0s: torch.Tensor,
    steps: int,
    true_Q: torch.Tensor,
    true_R: torch.Tensor,
    theta0: torch.Tensor | None = None,
    updates: int = 30,
    learning_rate: float = 0.1,
    iters: int = 300,
    rho: float = 0.1,
    dtype=torch.float64,
) -> TuneResult:
    """Adam on the true closed-loop cost (:func:`make_closed_loop_cost`):
    the tuned weights and the loss and gradient traces."""
    nx, nu = problem.n_state, problem.n_input
    if theta0 is None:
        theta0 = torch.log(torch.tensor([*problem.Q, *problem.R], dtype=dtype,
                                        device=x0s.device))
    loss = make_closed_loop_cost(problem, x0s, steps, true_Q, true_R, iters=iters, rho=rho,
                                 dtype=dtype)
    theta, opt = _adam(theta0, learning_rate)
    with torch.no_grad():
        losses = [float(loss(theta))]
    grads = []
    for _ in range(updates):
        opt.zero_grad()
        loss(theta).backward()
        grads.append(theta.grad.detach().clone())
        opt.step()
        with torch.no_grad():
            losses.append(float(loss(theta)))
    theta = theta.detach()
    Q, R = theta_to_weights(theta, nx, nu)
    return TuneResult(
        theta=theta, Q=Q, R=R, losses=torch.tensor(losses, dtype=dtype),
        grads=torch.stack(grads) if grads else torch.zeros(0, nx + nu, dtype=dtype),
    )


# ---------------------------------------------------------------------------
# The nonlinear tier: parking weights through the implicit AL-iLQR
# ---------------------------------------------------------------------------


def make_fused_parking_forward(
    N: int,
    ts: float,
    qn_scale: float = 10.0,
    outer_iters: int = 8,
    inner_iters: int = 30,
    tile: int = DEFAULT_TILE,
    dtype=torch.float64,
) -> Callable:
    """A fused forward for the implicit parking layer: ``forward(theta,
    x0s, u_init) -> ALILQRSolution`` solving the no-obstacle parking OCP for
    the whole batch in one launch of the tracker kernel with per-lane weights
    (the ``kinematic_wrt`` instantiation; its twin on CPU tensors), so that
    one build serves every ``theta`` of a tuning run.

    The KKT backward reads only the converged ``(us, lams)``: the
    multipliers are permuted from the kernel's row order [u-box (4), x-box
    (8)] to :func:`.solvers.parking.make_parking_ilqr`'s [x-box (8), u-box
    (4)], and ``xs`` / ``cost`` are re-derived in ``dtype`` from the float32
    controls, so that the smooth cotangent paths keep full precision.
    ``tile`` is the kernel's scenarios per block: its exits are tile-wide,
    so the solution depends on it."""
    from .models.parameters import VehicleParameters
    from .ops.cuda.ilqr_kernel import parking_geometry
    from .ops.cuda.parking_factory import al_ilqr_parking_solve_factory
    from .solvers.ilqr import ALILQRSolution, rollout, total_cost
    from .solvers.parking import make_parking_ilqr

    params = VehicleParameters()
    geom, limits = parking_geometry(params, None, n_circles=3)
    accf, fricf = float(params.acceleration), float(params.friction)

    def forward(theta, x0s, u_init):
        B, f32 = x0s.shape[0], torch.float32
        Q, R = torch.exp(theta["logQ"]), torch.exp(theta["logR"])
        w = torch.cat([Q, R, torch.tensor([qn_scale], dtype=Q.dtype, device=Q.device)])
        sol = al_ilqr_parking_solve_factory(
            x0s.to(f32), u_init.to(f32),
            torch.full((B,), accf, dtype=f32, device=x0s.device),
            torch.full((B,), fricf, dtype=f32, device=x0s.device),
            N=N, ts=float(ts), geom=geom, limits=limits,
            weights_rt=w.to(f32).expand(B, 7).contiguous(), n_circles=0,
            outer_iters=outer_iters, inner_iters=inner_iters, viol_tol=1e-4, tile=tile,
        )
        lam = torch.cat([sol.lam[..., 4:12], sol.lam[..., :4]], dim=-1).to(dtype)
        prob, _, _ = make_parking_ilqr(params, N=N, ts=ts, x_obs=None, Q=Q, R=R,
                                       qn_scale=qn_scale, dtype=dtype)
        us = sol.us.to(dtype)
        xs = rollout(prob, x0s.to(dtype), us)
        return ALILQRSolution(us=us, xs=xs, cost=total_cost(prob, xs, us),
                              viol=sol.viol.to(dtype), converged=sol.converged, lams=lam)

    return forward


def make_parking_closed_loop_cost(
    x0s: torch.Tensor,  # (B, 4) scenario batch
    steps: int,
    true_Q,  # (4,) diagonal of the true state objective
    true_R,  # (2,) diagonal of the true input objective
    N: int = 8,
    ts: float = 0.05,
    qn_scale: float = 10.0,
    friction_scale: float = 1.0,
    outer_iters: int = 8,
    inner_iters: int = 30,
    forward: str | None = None,
    tile: int = DEFAULT_TILE,
    dtype=torch.float64,
) -> Callable:
    """``loss(theta) -> scalar`` for the nonlinear parking tier: the mean
    true closed-loop cost over the batch when the plant (Euler bicycle,
    optionally friction-mismatched) is driven by an AL-iLQR MPC whose weights
    are ``theta = {"logQ": (4,), "logR": (2,)}``, warm-started from its shifted
    previous solution.

    Gradients reach ``theta`` through every step's solve by the implicit
    function theorem (:func:`.solvers.implicit.make_implicit_al_ilqr_param_solver`).
    ``forward=None`` solves each step with the batched plain-torch AL-iLQR;
    ``forward="fused"`` with one launch of the tracker kernel for the whole
    batch (:func:`make_fused_parking_forward`, at ``tile``).
    Both land on the same stationary points, so their gradients agree to the
    solvers' shared tolerance. Runs on ``x0s``'s device."""
    from .models.bicycle import NU, kinematic_bicycle_ode
    from .models.parameters import VehicleParameters
    from .ops.integrators import euler
    from .solvers.parking import make_parking_ilqr

    if forward not in (None, "fused"):
        raise ValueError(f"unknown forward {forward!r} (None or 'fused')")
    device = x0s.device
    params = VehicleParameters()
    plant_params = dataclasses.replace(params, friction=params.friction * friction_scale)
    plant = euler(lambda x, u: kinematic_bicycle_ode(plant_params, x, u), ts)
    true_Q = torch.as_tensor(true_Q, device=device).to(dtype)
    true_R = torch.as_tensor(true_R, device=device).to(dtype)
    x0s = x0s.to(dtype)

    def problem_fn(theta):
        prob, cons, _ = make_parking_ilqr(
            params, N=N, ts=ts, x_obs=None, Q=torch.exp(theta["logQ"]),
            R=torch.exp(theta["logR"]), qn_scale=qn_scale, dtype=dtype)
        return prob, cons

    nc = make_parking_ilqr(params, N=N, ts=ts, x_obs=None, dtype=dtype, device=device)[2]
    fwd = None
    if forward == "fused":
        fwd = make_fused_parking_forward(N=N, ts=ts, qn_scale=qn_scale, outer_iters=outer_iters,
                                         inner_iters=inner_iters, tile=tile, dtype=dtype)
    solve = make_implicit_al_ilqr_param_solver(problem_fn, nc, forward=fwd,
                                               outer_iters=outer_iters, inner_iters=inner_iters)

    def loss(theta) -> torch.Tensor:
        x = x0s
        u_warm = torch.zeros(x.shape[0], N, NU, dtype=dtype, device=device)
        total = 0.0
        for _ in range(steps):
            sol = solve(theta, x, u_init=u_warm)
            u0 = sol.us[:, 0]
            u_warm = torch.cat([sol.us[:, 1:], sol.us[:, -1:]], dim=1)
            c = (x * (true_Q * x)).sum(-1) + (u0 * (true_R * u0)).sum(-1)
            total = total + c.mean()
            x = plant(x, u0)
        return total + (x * (qn_scale * true_Q * x)).sum(-1).mean()

    return loss


def tune_parking_weights(
    x0s: torch.Tensor,
    steps: int,
    true_Q,
    true_R,
    theta0: dict | None = None,
    updates: int = 15,
    learning_rate: float = 0.15,
    dtype=torch.float64,
    **cost_kwargs,
) -> dict:
    """Adam on the true nonlinear closed-loop cost of the parking tier
    (:func:`make_parking_closed_loop_cost`, whose keywords ``cost_kwargs``
    are): ``{theta, Q, R, losses}`` with the loss before each update and
    after the last."""
    if theta0 is None:
        theta0 = {
            "logQ": torch.log(torch.tensor([1.0, 3.0, 0.1, 0.01], dtype=dtype,
                                           device=x0s.device)),
            "logR": torch.log(torch.tensor([1.0, 0.01], dtype=dtype, device=x0s.device)),
        }
    loss = make_parking_closed_loop_cost(x0s, steps, true_Q, true_R, dtype=dtype, **cost_kwargs)
    theta, opt = _adam(theta0, learning_rate)
    losses = []
    for _ in range(updates):
        opt.zero_grad()
        val = loss(theta)
        val.backward()
        losses.append(val.item())
        opt.step()
    with torch.no_grad():
        losses.append(float(loss(theta)))
    theta = {k: v.detach() for k, v in theta.items()}
    return {"theta": theta, "Q": torch.exp(theta["logQ"]), "R": torch.exp(theta["logR"]),
            "losses": torch.tensor(losses, dtype=dtype)}
