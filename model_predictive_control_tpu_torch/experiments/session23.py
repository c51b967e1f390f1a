"""Session-2/3 experiments: constrained linear MPC on the braking problem
(port of ``experiments/session23.py``).

A receding-horizon box-QP closed loop from an aggressive initial state,
logging the per-step telemetry (solver success, state and input
predictions), for the session-2 bounds and the session-3 relaxed variant
with the DARE terminal cost and warm-started solves.
"""

from __future__ import annotations

import numpy as np
import torch

from ..control.simulate import simulate
from ..obs.metrics import summarize_run
from ..solvers.linear_mpc import make_linear_mpc, session2_problem, session3_problem
from ..utils.device import resolve_device

DEFAULT_X0 = (-100.0, 20.0)  # far from the wall, closing fast


def closed_loop_linear_mpc(session: int = 2, N: int = 20, steps: int = 60, x0=DEFAULT_X0,
                           solver: str = "admm", iters: int = 200, terminal: str | None = None,
                           soft: bool = False, terminal_set: bool = False,
                           dtype=torch.float32, device=None):
    """One closed-loop run on ``device`` (the card when ``None``).
    ``terminal`` defaults to "Q" for session 2 and "dare" for session 3.
    Returns ``(SimResult, LinearMPC, Problem)``."""
    if session == 2:
        problem = session2_problem(N=N)
        terminal = terminal or "Q"
    elif session == 3:
        problem = session3_problem(N=N)
        terminal = terminal or "dare"
    else:
        raise ValueError(f"session must be 2 or 3, got {session}")
    device = resolve_device(device)
    ctrl = make_linear_mpc(problem, solver=solver, iters=iters, dtype=dtype, device=device,
                           terminal=terminal, soft_state=soft, terminal_set=terminal_set)
    system = problem.system(dtype, device)
    res = simulate(torch.as_tensor(x0, dtype=dtype, device=device), system, steps=steps,
                   policy=ctrl.policy(), policy_carry=ctrl.initial_carry(dtype, device))
    return res, ctrl, problem


def run(session: int = 2, N: int = 20, steps: int = 60, outdir: str | None = None,
        solver: str = "admm", iters: int = 200, soft: bool = False, terminal_set: bool = False,
        x0=DEFAULT_X0, device=None) -> dict:
    """Driver: the closed loop, the constraint checks, plots. A JSON-able
    summary."""
    res, ctrl, problem = closed_loop_linear_mpc(
        session=session, N=N, steps=steps, x0=x0, solver=solver, iters=iters, soft=soft,
        terminal_set=terminal_set, device=device)
    states = res.states.cpu().numpy()
    inputs = res.inputs.cpu().numpy()
    tol = 1e-2  # ADMM feasibility tolerance at fp32
    summary = summarize_run(res, per_solve_iters=iters)
    summary.update(
        session=session,
        N=N,
        final_state=[float(v) for v in states[-1]],
        p_max_violation=float(np.max(states[:, 0] - problem.p_max)),
        u_box_violation=float(np.max(np.maximum(inputs - problem.u_max,
                                                problem.u_min - inputs))),
        constraints_respected=bool(
            np.max(states[:, 0]) <= problem.p_max + tol
            and np.max(np.abs(inputs)) <= max(abs(problem.u_min), problem.u_max) + tol),
    )
    if outdir is not None:
        import os

        from ..viz import plot_phase_trajectory, plot_states_separately

        os.makedirs(outdir, exist_ok=True)
        tag = f"session{session}_N{N}"
        plot_phase_trajectory(states, predictions=res.logs["state_prediction"].cpu().numpy(),
                              labels=("position p [m]", "velocity v [m/s]"),
                              save=os.path.join(outdir, f"{tag}_phase.png"))
        plot_states_separately(states, ts=problem.Ts,
                               labels=("position p [m]", "velocity v [m/s]"),
                               save=os.path.join(outdir, f"{tag}_states.png"))
    return summary
