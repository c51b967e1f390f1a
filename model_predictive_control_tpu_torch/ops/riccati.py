"""Riccati recursions and the discrete algebraic Riccati equation (port of
``ops/riccati.py``).

The finite-horizon recursion is a Python loop over stages; the DARE is solved
by the structure-preserving doubling algorithm (SDA), a fixed number of
doublings built from solves and matmuls, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..utils.precision import set_solver_precision


def lqr_gain(A: torch.Tensor, B: torch.Tensor, R: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """One-step LQR gain ``K = -(R + BᵀPB)⁻¹ BᵀPA``."""
    set_solver_precision()
    BtP = B.T @ P
    return -torch.linalg.solve(R + BtP @ B, BtP @ A)


def riccati_recursion(A, B, Q, R, Pf, N: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward Riccati recursion: ``P (N + 1, nx, nx)`` and ``K (N, nu, nx)``
    in stage order (index 0 = stage 0)."""
    set_solver_precision()
    P = Pf
    Ps, Ks = [Pf], []
    for _ in range(N):
        K = lqr_gain(A, B, R, P)
        P = Q + A.T @ P @ (A + B @ K)
        P = 0.5 * (P + P.T)  # keep symmetric under rounding
        Ps.append(P)
        Ks.append(K)
    return torch.stack(Ps[::-1]), torch.stack(Ks[::-1])


def dare_sda(A, B, Q, R, iters: int = 30) -> torch.Tensor:
    """Solve ``P = Q + AᵀPA − AᵀPB (R + BᵀPB)⁻¹ BᵀPA`` by structured
    doubling: with ``G = B R⁻¹ Bᵀ``, ``E₀ = A``, ``H₀ = Q``,

        E⁺ = E (I + GH)⁻¹ E,  G⁺ = G + E (I + GH)⁻¹ G Eᵀ,  H⁺ = H + Eᵀ H (I + GH)⁻¹ E,

    and ``H → P`` quadratically; ``iters`` doublings, no test."""
    set_solver_precision()
    I = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    E, G, H = A, B @ torch.linalg.solve(R, B.T), Q
    for _ in range(iters):
        M = I + G @ H
        Minv_E = torch.linalg.solve(M, E)
        Minv_G = torch.linalg.solve(M, G)
        E, G, H = E @ Minv_E, G + E @ Minv_G @ E.T, H + E.T @ H @ Minv_E
        G = 0.5 * (G + G.T)
        H = 0.5 * (H + H.T)
    return H


def dare_residual(A, B, Q, R, P) -> torch.Tensor:
    """‖P − (Q + AᵀPA − AᵀPB(R + BᵀPB)⁻¹BᵀPA)‖∞, a convergence diagnostic."""
    set_solver_precision()
    BtP = B.T @ P
    P_new = Q + A.T @ P @ A - A.T @ P @ B @ torch.linalg.solve(R + BtP @ B, BtP @ A)
    return (P - P_new).abs().max()
