"""Batched closed-loop simulation under a batch-level policy (port of
``control/batch_loop.py``): a Python loop over steps."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

# batched policy: (x_batch (B, nx), t, carry) -> (u_batch (B, nu), carry, aux)
BatchedPolicy = Callable[[torch.Tensor, int, Any], tuple]


@dataclasses.dataclass(frozen=True)
class BatchSimResult:
    states: torch.Tensor  # (steps + 1, B, nx)
    inputs: torch.Tensor  # (steps, B, nu)
    logs: dict  # aux entries stacked, each (steps, ...)
    final_carry: Any = None  # policy carry after the last step


def simulate_batch(
    x0: torch.Tensor,
    dynamics: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    steps: int,
    policy: BatchedPolicy,
    policy_carry: Any = (),
) -> BatchSimResult:
    """Roll a batch of plants forward ``steps`` times.

    ``dynamics`` maps ``(B, nx) × (B, nu) → (B, nx)``, as a
    :class:`LinearSystem` or :func:`..parallel.batch.batched_plant` does: the
    JAX package's ``batched_dynamics=True`` is implied, since nothing here
    vmaps.
    """
    if steps < 1:
        raise ValueError("steps must be positive")
    x, carry = x0, policy_carry
    states, inputs, logs = [x0], [], []
    for t in range(steps):
        u, carry, aux = policy(x, t, carry)
        x = dynamics(x, u)
        states.append(x)
        inputs.append(u)
        logs.append(aux)
    return BatchSimResult(
        states=torch.stack(states),
        inputs=torch.stack(inputs),
        logs={k: torch.stack([a[k] for a in logs]) for k in logs[0]},
        final_carry=carry,
    )
