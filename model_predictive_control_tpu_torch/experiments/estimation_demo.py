"""Output-feedback MPC and estimation driver (port of
``experiments/estimation_demo.py``).

Closes the session-2 braking loop on noisy position measurements through a
Kalman filter: true against estimated trajectories and the per-step
estimation error, one JSON summary and optional plots.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from .. import estimation as est
from ..solvers.linear_mpc import make_linear_mpc, session2_problem
from ..utils.device import resolve_device


def run(outdir: str | None = None, N: int = 20, steps: int = 60, x0=(-80.0, 10.0),
        meas_sigma: float = 0.1, process_sigma: float = 0.02, iters: int = 300, seed: int = 0,
        dtype=torch.float32, device=None, generator: torch.Generator | None = None,
        noise=None) -> dict:
    """The episode on ``device`` (the card when ``None``). The process and
    measurement noises are drawn from ``generator`` (a CPU generator, seeded
    with ``seed`` when ``None``), or given as ``noise = (ws (steps, 2), vs
    (steps, 1))``."""
    device = resolve_device(device)
    problem = session2_problem(N=N)
    system = problem.system(dtype, device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    C = t([[1.0, 0.0]])  # position-only measurement
    msys = type(system)(A=system.A, B=system.B, C=C)
    Qw = (process_sigma**2) * torch.eye(2, dtype=dtype, device=device)
    Rv = t([[meas_sigma**2]])
    kf = est.kalman_gain(msys, Qw, Rv)
    # slack-softened state constraints: estimation error can push the
    # measured state slightly outside the feasible set; the soft QP stays
    # solvable there
    ctrl = make_linear_mpc(problem, solver="admm", iters=iters, dtype=dtype, device=device,
                           soft_state=True)
    policy = est.output_feedback_policy(ctrl, kf)
    if noise is None:
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        ws = process_sigma * torch.randn(steps, 2, generator=g, dtype=torch.float64)
        vs = meas_sigma * torch.randn(steps, 1, generator=g, dtype=torch.float64)
    else:
        ws, vs = (torch.as_tensor(np.array(a)) for a in noise)
    ws, vs = t(ws), t(vs)
    x = t(x0)
    carry = est.initial_output_feedback_carry(ctrl, x, dtype, device)
    xs, us, succ, xhats = [], [], [], []
    for k in range(steps):
        y = C @ x + vs[k]
        u, carry, aux = policy(y, k, carry)
        x = system.A @ x + system.B @ u + ws[k]
        xs.append(x)
        us.append(u)
        succ.append(aux["solver_success"])
        xhats.append(aux["state_estimate"])
    xs, us, succ, xhats = (torch.stack(a).cpu().numpy() for a in (xs, us, succ, xhats))
    est_err = xhats[1:] - xs[:-1]  # xhats[k] estimates the pre-step state
    summary = {
        "experiment": "estimation_demo",
        "steps": steps,
        "success_rate": float(succ.mean()),
        "final_state": [round(float(v), 5) for v in xs[-1]],
        "est_rmse_pos": round(float(np.sqrt((est_err[:, 0] ** 2).mean())), 5),
        "est_rmse_vel": round(float(np.sqrt((est_err[:, 1] ** 2).mean())), 5),
        "meas_sigma": meas_sigma,
        "kalman_gain": [round(float(v), 5) for v in kf.L.cpu().numpy().ravel()],
    }
    if outdir is not None:
        out = pathlib.Path(outdir)
        out.mkdir(parents=True, exist_ok=True)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        tt = np.arange(steps)
        fig, axes = plt.subplots(3, 1, figsize=(7, 8), sharex=True)
        axes[0].plot(tt, xs[:, 0], label="true p")
        axes[0].plot(tt[1:], xhats[1:, 0], "--", label="KF estimate")
        axes[0].set_ylabel("position")
        axes[0].legend()
        axes[1].plot(tt, xs[:, 1], label="true v")
        axes[1].plot(tt[1:], xhats[1:, 1], "--", label="KF estimate")
        axes[1].set_ylabel("velocity")
        axes[2].plot(tt[1:], np.abs(est_err[:, 0]), label="|p error|")
        axes[2].plot(tt[1:], np.abs(est_err[:, 1]), label="|v error|")
        axes[2].set_ylabel("estimation error")
        axes[2].set_xlabel("step")
        axes[2].legend()
        fig.suptitle("Output-feedback MPC on noisy position measurements")
        fig.savefig(out / "estimation_demo.png", dpi=120, bbox_inches="tight")
        plt.close(fig)
        (out / "estimation_summary.json").write_text(json.dumps(summary, indent=2))
    return summary
