"""Discretization combinators: a continuous ODE ``f(x, u) -> ẋ`` and a
sampling time become a step ``F(x, u) -> x⁺`` (port of ``ops/integrators.py``).

All steps are fixed-step and act on whole batches. :func:`rk4_fine` with 16
substeps is the plant of the parking sweep, the stand-in for the reference's
``odeint``. :data:`INTEGRATORS` names the single-stage schemes for
:func:`get_integrator`.
"""

from __future__ import annotations

from typing import Callable

import torch

Dynamics = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def euler(f: Dynamics, ts: float) -> Dynamics:
    """Forward Euler: ``x⁺ = x + ts f(x, u)``."""

    def step(x, u):
        return x + ts * f(x, u)

    return step


def heun(f: Dynamics, ts: float) -> Dynamics:
    """Second-order Heun (the explicit trapezoid): two stages."""

    def step(x, u):
        s1 = f(x, u)
        s2 = f(x + ts * s1, u)
        return x + 0.5 * ts * (s1 + s2)

    return step


def rk4(f: Dynamics, ts: float) -> Dynamics:
    """Classic 4th-order Runge-Kutta."""

    def step(x, u):
        s1 = f(x, u)
        s2 = f(x + 0.5 * ts * s1, u)
        s3 = f(x + 0.5 * ts * s2, u)
        s4 = f(x + ts * s3, u)
        return x + (ts / 6.0) * (s1 + 2.0 * s2 + 2.0 * s3 + s4)

    return step


def euler_fine(f: Dynamics, ts: float, substeps: int = 1) -> Dynamics:
    """Forward Euler over ``substeps`` uniform sub-intervals of one sample;
    ``substeps=1`` is :func:`euler` (the reference's parking prediction
    model, ``session_4/main.py:76``)."""
    inner = euler(f, ts / substeps)

    def step(x, u):
        for _ in range(substeps):
            x = inner(x, u)
        return x

    return step


def rk4_fine(f: Dynamics, ts: float, substeps: int = 16) -> Dynamics:
    """RK4 over ``substeps`` uniform sub-intervals of one sample."""
    inner = rk4(f, ts / substeps)

    def step(x, u):
        for _ in range(substeps):
            x = inner(x, u)
        return x

    return step


INTEGRATORS = {
    "euler": euler,
    "heun": heun,
    "rk4": rk4,
    "rk4_fine": rk4_fine,
}


def get_integrator(name: str) -> Callable[..., Dynamics]:
    try:
        return INTEGRATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown integrator {name!r}; available: {sorted(INTEGRATORS)}"
        ) from None
