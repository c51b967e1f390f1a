"""Discrete linear time-invariant systems (port of ``models/linear.py``).

A system is a frozen dataclass of ``(nx, nx)`` / ``(nx, nu)`` tensors. Calling
it steps a whole batch of states at once: ``x`` is ``(..., nx)`` and ``u`` is
``(..., nu)``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LinearSystem:
    """``x⁺ = A x + B u`` on a batch of row vectors, with an optional output
    map ``y = C x + D u`` (the reference's ``set_output_eq``,
    ``session_1/LinearSystem.py:12-14``; the estimators read ``C``)."""

    A: torch.Tensor  # (nx, nx)
    B: torch.Tensor  # (nx, nu)
    C: torch.Tensor | None = None  # (ny, nx)
    D: torch.Tensor | None = None  # (ny, nu)

    @property
    def nx(self) -> int:
        return self.A.shape[-1]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]

    def __call__(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return x @ self.A.T + u @ self.B.T

    def with_output(self, C, D=None) -> "LinearSystem":
        """``set_output_eq`` as a new frozen system (``C``, ``D`` on ``A``'s
        device and dtype)."""
        t = lambda M: torch.as_tensor(M, dtype=self.A.dtype, device=self.A.device)
        return dataclasses.replace(self, C=t(C), D=None if D is None else t(D))

    def output(self, x: torch.Tensor, u: torch.Tensor | None = None) -> torch.Tensor:
        """``y = C x (+ D u)`` on a batch of row vectors; ``x`` itself when
        no ``C`` was set."""
        if self.C is None:
            return x
        y = x @ self.C.T
        if self.D is not None and u is not None:
            y = y + u @ self.D.T
        return y


def session2_dynamics(
    ts: float, dtype: torch.dtype = torch.float32, device=None
) -> LinearSystem:
    """Exact ZOH double integrator of sessions 2/3:
    ``A = [[1, Ts], [0, 1]]``, ``B = [[0], [Ts]]``, on ``device`` (the card
    when ``None``)."""
    device = resolve_device(device)
    A = torch.tensor([[1.0, ts], [0.0, 1.0]], dtype=dtype, device=device)
    B = torch.tensor([[0.0], [ts]], dtype=dtype, device=device)
    return LinearSystem(A=A, B=B)


def double_integrator_continuous(dtype: torch.dtype = torch.float32, device=None) -> LinearSystem:
    """The continuous cruise-control model of session 1, relative position
    and velocity of a lead car, the input decelerating: ``A = [[0, 1], [0,
    0]]``, ``B = [[0], [−1]]`` (a matrix pair, not a step)."""
    device = resolve_device(device)
    A = torch.tensor([[0.0, 1.0], [0.0, 0.0]], dtype=dtype, device=device)
    B = torch.tensor([[0.0], [-1.0]], dtype=dtype, device=device)
    return LinearSystem(A=A, B=B)


def double_integrator_discrete(ts: float, dtype: torch.dtype = torch.float32,
                               device=None) -> LinearSystem:
    """Forward-Euler discretization ``Ad = I + A ts``, ``Bd = B ts`` of the
    double integrator (session 1), on ``device`` (the card when ``None``)."""
    cont = double_integrator_continuous(dtype, device)
    Ad = torch.eye(2, dtype=dtype, device=cont.A.device) + cont.A * ts
    return LinearSystem(A=Ad, B=cont.B * ts)
