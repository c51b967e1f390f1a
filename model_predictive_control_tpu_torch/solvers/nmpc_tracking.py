"""Nonlinear trajectory-tracking MPC: receding reference windows over the
AL-iLQR (port of ``solvers/nmpc_tracking.py``).

Per closed-loop step the policy takes the ``(N+1, nx)`` window of the
reference that starts at the step and solves the stagewise AL-iLQR problem
that tracks it; the window is per-stage data of the problem
(:class:`..solvers.ilqr.ILQRProblem`'s ``stages``), so a batch of states may
track a batch of windows. Constraints: the input box and, optionally, a
moving tube ``‖p − p_ref‖² ≤ r²`` around the reference positions.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..control.simulate import Policy
from ..utils.device import resolve_device
from .ilqr import ILQRProblem, al_ilqr_solve


class TrackingNMPC:
    """Receding-horizon nonlinear tracking MPC over AL-iLQR.

    ``step_fn(x, u) -> x⁺`` is the discrete prediction model (for one
    scenario); ``Q``, ``R``, ``QN`` diagonal weights of the state error, the
    input and the terminal error; ``ref_traj`` ``(steps + N + 1, nx)``: at
    closed-loop step t stage k weights ``x_k − ref_traj[t + k]``;
    ``tube_radius`` adds one corridor row per stage. ``solve`` and the
    policy take one state ``(nx,)`` or a batch ``(B, nx)``.
    """

    def __init__(
        self,
        step_fn: Callable,
        nx: int,
        nu: int,
        N: int,
        Q,
        R,
        QN,
        u_lb,
        u_ub,
        ref_traj,
        tube_radius: float | None = None,
        outer_iters: int = 6,
        inner_iters: int = 15,
    ):
        self.step_fn = step_fn
        self.nx, self.nu, self.N = nx, nu, N
        self.ref_traj = torch.as_tensor(ref_traj)
        as_ref = lambda a: torch.as_tensor(a, dtype=self.ref_traj.dtype, device=self.ref_traj.device)
        self.Q, self.R, self.QN = as_ref(Q), as_ref(R), as_ref(QN)
        self.u_lb, self.u_ub = as_ref(u_lb), as_ref(u_ub)
        if self.ref_traj.shape[-1] != nx:
            raise ValueError(f"ref_traj last dim {self.ref_traj.shape[-1]} != nx {nx}")
        self.tube_radius = tube_radius
        self.outer_iters = outer_iters
        self.inner_iters = inner_iters
        self.n_constraints = 2 * nu + (1 if tube_radius is not None else 0)

    def window_problem(self, windows: torch.Tensor):
        """``(ILQRProblem, constraints)`` tracking ``windows (B, N+1, nx)``."""
        Q, R, QN, N = self.Q, self.R, self.QN, self.N

        def stage_cost(x, u, p, s):
            e = x - s["ref"]
            return e @ (Q * e) + u @ (R * u)

        def terminal_cost(x, p):
            e = x - p["ref_N"]
            return e @ (QN * e)

        prob = ILQRProblem(
            dynamics=lambda x, u, p: self.step_fn(x, u),
            stage_cost=stage_cost, terminal_cost=terminal_cost, N=N, nx=self.nx, nu=self.nu,
            params={"ref_N": windows[:, N]}, stages={"ref": windows[:, :N]},
        )

        def constraints(x, u, p, s):
            rows = [u - self.u_ub, self.u_lb - u]
            if self.tube_radius is not None:
                d2 = ((x[:2] - s["ref"][:2]) ** 2).sum()
                rows.append((d2 - self.tube_radius**2)[None])
            return torch.cat(rows)

        return prob, constraints

    def solve(self, x0: torch.Tensor, t: int, u_init=None):
        """One tracking solve at state ``x0`` and closed-loop time ``t``."""
        single = x0.ndim == 1
        x = x0[None] if single else x0
        window = self.ref_traj[t : t + self.N + 1]
        prob, constraints = self.window_problem(window[None].expand(x.shape[0], -1, -1))
        sol = al_ilqr_solve(prob, constraints, self.n_constraints, x,
                            u_init=None if u_init is None else (u_init[None] if single else u_init),
                            outer_iters=self.outer_iters, inner_iters=self.inner_iters)
        if single:
            sol = type(sol)(**{k: v[0] for k, v in vars(sol).items()})
        return sol

    def policy(self) -> Policy:
        """Receding-horizon policy; aux carries the solver log plus ``ref``
        (the stage-0 reference) and ``tracking_error`` (‖p − p_ref‖)."""

        def policy_fn(x, t, carry):
            u_init = carry if not isinstance(carry, tuple) else None
            sol = self.solve(x, t, u_init=u_init)
            u_warm = torch.cat([sol.us[..., 1:, :], sol.us[..., -1:, :]], dim=-2)
            ref0 = self.ref_traj[t]
            aux = {
                "solver_success": sol.converged,
                "state_prediction": sol.xs[..., 1:, :],
                "input_prediction": sol.us,
                "viol": sol.viol,
                "ref": ref0,
                "tracking_error": torch.linalg.vector_norm(x[..., :2] - ref0[:2], dim=-1),
            }
            return sol.us[..., 0, :], u_warm, aux

        return policy_fn

    def initial_carry(self, dtype=torch.float32, device=None):
        device = self.ref_traj.device if device is None else resolve_device(device)
        return torch.zeros(self.N, self.nu, dtype=dtype, device=device)
