"""Closed-loop weight-tuning driver (port of ``experiments/tuning.py``).

The session-2 weights ``Q = diag(10, 1)``, ``R = 0.01`` are tuned by
gradient descent on a true closed-loop objective, autograd flowing through
the condensed build, the Ruiz/KKT setup, the implicit ADMM solve and the
rollout (``tuning.py``). The true objective is comfort-heavy (velocity and
input effort are expensive) while the controller starts at the session-2
defaults (position-heavy, nearly free inputs); a few Adam updates close most
of the gap.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from .. import tuning
from ..solvers.linear_mpc import session2_problem
from ..utils.device import resolve_device


def run(
    outdir: str | None = None,
    N: int = 6,
    steps: int = 16,
    batch: int = 8,
    updates: int = 15,
    learning_rate: float = 0.3,
    iters: int = 400,
    dtype=torch.float32,
    device=None,
) -> dict:
    """Tune the session-2 weights on ``batch`` starts near the origin and
    return the summary; with ``outdir`` also write ``tuning_loss.png`` and
    ``tuning_summary.json`` there. The starts come from a ``torch.Generator``
    seeded 3 (the JAX package draws them from ``PRNGKey(3)``, which torch
    cannot reproduce): ``p`` uniform in [-10, -2], ``v`` in [-2, 5] — the
    near-origin regime, where the weights shape the trajectory (far-field
    approaches are bang-bang and barely tunable)."""
    device = resolve_device(device)
    problem = session2_problem(N=N)
    g = torch.Generator().manual_seed(3)
    p = -10.0 + 8.0 * torch.rand(batch, generator=g, dtype=torch.float64)
    v = -2.0 + 7.0 * torch.rand(batch, generator=g, dtype=torch.float64)
    x0s = torch.stack([p, v], dim=1).to(dtype=dtype, device=device)
    true_Q = torch.diag(torch.tensor([2.0, 6.0], dtype=dtype, device=device))
    true_R = torch.tensor([[1.5]], dtype=dtype, device=device)

    res = tuning.tune_mpc_weights(problem, x0s, steps, true_Q, true_R, updates=updates,
                                  learning_rate=learning_rate, iters=iters, dtype=dtype)
    losses = res.losses.cpu().numpy()
    best = int(np.argmin(losses))
    summary = {
        "experiment": "tuning",
        "initial_loss": float(losses[0]),
        "final_loss": float(losses[-1]),
        "best_loss": float(losses[best]),
        "best_update": best,
        "reduction": round(1.0 - float(losses[best]) / float(losses[0]), 4),
        "Q_init": list(problem.Q),
        "R_init": list(problem.R),
        "Q_tuned": [round(float(q), 4) for q in torch.diagonal(res.Q).tolist()],
        "R_tuned": [round(float(r), 4) for r in torch.diagonal(res.R).tolist()],
        "updates": updates,
    }

    if outdir is not None:
        out = pathlib.Path(outdir)
        out.mkdir(parents=True, exist_ok=True)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(losses, marker="o", ms=3)
        ax.set_xlabel("Adam update")
        ax.set_ylabel("true closed-loop cost")
        ax.set_title("MPC weight tuning via implicit differentiation")
        fig.savefig(out / "tuning_loss.png", dpi=120, bbox_inches="tight")
        plt.close(fig)
        (out / "tuning_summary.json").write_text(json.dumps(summary, indent=2))

    return summary
