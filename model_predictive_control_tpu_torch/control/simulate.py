"""Single-scenario closed-loop simulation (port of ``control/simulate.py``):
a Python loop over steps.

A policy maps ``(x (nx,), t, carry) -> (u (nu,), carry, aux)``; ``aux`` is a
dict of per-step telemetry (stacked over steps in :class:`SimResult`) or
``()``. Instability is a running flag, ``‖x‖ > 100`` at any step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

# policy: (x, t, carry) -> (u, new_carry, aux)
Policy = Callable[[torch.Tensor, int, Any], tuple]

INSTABILITY_NORM = 100.0


@dataclasses.dataclass(frozen=True)
class SimResult:
    states: torch.Tensor  # (steps + 1, nx): x_0 .. x_steps
    inputs: torch.Tensor  # (steps, nu)
    unstable: torch.Tensor  # () bool: ever ‖x‖ > the instability norm
    logs: Any  # aux entries stacked over steps (dict), or ()


def policy_from_law(law: Callable[[torch.Tensor, int], torch.Tensor]) -> Policy:
    """Lift a stateless law ``(x, t) -> u`` to the policy protocol."""

    def policy(x, t, carry):
        return law(x, t), carry, ()

    return policy


def open_loop_policy(controls: torch.Tensor) -> Policy:
    """Replay a precomputed input sequence ``(steps, nu)``."""

    def policy(x, t, carry):
        return controls[t], carry, ()

    return policy


def _stack_logs(logs: list):
    if not logs or not isinstance(logs[0], dict):
        return ()
    return {k: torch.stack([torch.as_tensor(a[k]) for a in logs]) for k in logs[0]}


def simulate(
    x0: torch.Tensor,
    dynamics: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    steps: int,
    policy: Policy,
    policy_carry: Any = (),
    instability_norm: float = INSTABILITY_NORM,
    disturbances: torch.Tensor | None = None,
) -> SimResult:
    """Roll the plant ``dynamics`` forward ``steps`` steps under ``policy``;
    ``disturbances`` ``(steps, nx)`` are added after each plant step."""
    x, carry = x0, policy_carry
    unstable = torch.zeros((), dtype=torch.bool, device=x0.device)
    states, inputs, logs = [x0], [], []
    for t in range(steps):
        u, carry, aux = policy(x, t, carry)
        x = dynamics(x, u)
        if disturbances is not None:
            x = x + disturbances[t]
        unstable = unstable | (torch.linalg.vector_norm(x) > instability_norm)
        states.append(x)
        inputs.append(u)
        logs.append(aux)
    return SimResult(
        states=torch.stack(states), inputs=torch.stack(inputs), unstable=unstable,
        logs=_stack_logs(logs),
    )


def rollout(
    x0: torch.Tensor,
    dynamics: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    controls: torch.Tensor,
) -> torch.Tensor:
    """Open-loop rollout under ``controls (N, nu)``: states ``(N + 1, nx)``
    including ``x0``."""
    xs = [x0]
    for u in controls:
        xs.append(dynamics(xs[-1], u))
    return torch.stack(xs)
