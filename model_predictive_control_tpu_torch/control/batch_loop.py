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
    batched_dynamics: bool = False,
    disturbances: torch.Tensor | None = None,
) -> BatchSimResult:
    """Roll a batch of plants forward ``steps`` times.

    ``dynamics`` maps ``(B, nx) × (B, nu) → (B, nx)``, as a
    :class:`LinearSystem` or :func:`..parallel.batch.batched_plant` does.
    ``batched_dynamics`` is accepted for the JAX package's signature; both
    values mean the same here, since nothing vmaps (a per-scenario function
    written for row vectors takes a batch as it is).

    ``disturbances``: optional ``(steps, B, nx)`` additive process
    disturbances, added after the plant step: ``x_{t+1} = f(x_t, u_t) + w_t``.
    """
    if steps < 1:
        raise ValueError("steps must be positive")
    if disturbances is not None and disturbances.shape[0] != steps:
        raise ValueError(f"disturbances hold {disturbances.shape[0]} steps, not {steps}")
    x, carry = x0, policy_carry
    states, inputs, logs = [x0], [], []
    for t in range(steps):
        u, carry, aux = policy(x, t, carry)
        x = dynamics(x, u)
        if disturbances is not None:
            x = x + disturbances[t]
        states.append(x)
        inputs.append(u)
        logs.append(aux)
    return BatchSimResult(
        states=torch.stack(states),
        inputs=torch.stack(inputs),
        logs={k: torch.stack([a[k] for a in logs]) for k in logs[0]},
        final_carry=carry,
    )
