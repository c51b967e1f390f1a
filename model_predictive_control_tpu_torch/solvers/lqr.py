"""Finite- and infinite-horizon LQR controllers (port of ``solvers/lqr.py``):
the receding-horizon law ``u = K₀ x``, the time-varying prediction law, the
cost-to-go and the invariant LQR terminal set."""

from __future__ import annotations

import dataclasses

import torch

from ..control.simulate import Policy
from ..models.linear import LinearSystem
from ..ops.riccati import dare_sda, lqr_gain, riccati_recursion


@dataclasses.dataclass(frozen=True)
class LQRSolution:
    P: torch.Tensor  # (N + 1, nx, nx) cost-to-go Hessians, stage order
    K: torch.Tensor  # (N, nu, nx) feedback gains, stage order


def solve_finite_horizon(sys: LinearSystem, Q, R, Pf, N: int, parallel: bool = False) -> LQRSolution:
    """Backward Riccati solve over ``N`` stages. ``parallel=True`` runs the
    O(log N) associative-scan recursion (``ops/parallel_horizon.py``): the
    same result to rounding, a shorter critical path at large ``N``."""
    if parallel:
        from ..ops.parallel_horizon import riccati_recursion_parallel

        P, K = riccati_recursion_parallel(sys.A, sys.B, Q, R, Pf, N)
    else:
        P, K = riccati_recursion(sys.A, sys.B, Q, R, Pf, N)
    return LQRSolution(P=P, K=K)


def solve_infinite_horizon(sys: LinearSystem, Q, R, iters: int = 30) -> LQRSolution:
    """DARE solution; ``K∞`` as a 1-stage gain stack."""
    P_inf = dare_sda(sys.A, sys.B, Q, R, iters=iters)
    K_inf = lqr_gain(sys.A, sys.B, R, P_inf)
    return LQRSolution(P=P_inf[None], K=K_inf[None])


def lqr_terminal_set(A, B, Q, R, x_lb, x_ub, u_lb, u_ub):
    """Invariant LQR terminal set: the largest sublevel set
    ``{x : xᵀP∞x ≤ α}`` on which ``u = K∞x`` respects the state and input
    boxes, and the balanced inner box of it, half-widths
    ``d_i = √α / (nx √P_ii)``. A row ``aᵀx ≤ b`` bounds ``α ≤ b²/(aᵀP⁻¹a)``;
    the rows are ``±e_i`` and ``±K_j`` with their binding symmetric bound,
    infinite bounds skipped. Returns ``(P, K, alpha, d)``."""
    P = dare_sda(A, B, Q, R)
    K = lqr_gain(A, B, R, P)
    P_inv = torch.linalg.inv(P)
    big = torch.tensor(float("inf"), dtype=P.dtype, device=P.device)

    def alpha_rows(rows, lb, ub):
        b = torch.minimum(
            torch.where(torch.isfinite(ub), ub, big), torch.where(torch.isfinite(lb), -lb, big)
        )
        quad = torch.einsum("ri,ij,rj->r", rows, P_inv, rows)
        return torch.where(torch.isfinite(b), b * b / quad, big)

    nx = A.shape[0]
    eye = torch.eye(nx, dtype=P.dtype, device=P.device)
    alpha = torch.minimum(alpha_rows(eye, x_lb, x_ub).min(), alpha_rows(K, u_lb, u_ub).min())
    d = torch.sqrt(alpha) / (nx * torch.sqrt(torch.diagonal(P)))
    return P, K, alpha, d


def receding_horizon_policy(sol: LQRSolution) -> Policy:
    """``u = K₀ x`` each step."""
    K0 = sol.K[0]

    def policy(x, t, carry):
        return K0 @ x, carry, ()

    return policy


def prediction_policy(sol: LQRSolution) -> Policy:
    """``u = K_t x`` along the prediction horizon."""

    def policy(x, t, carry):
        return sol.K[t] @ x, carry, ()

    return policy


def cost_to_go(sol: LQRSolution, x0: torch.Tensor) -> torch.Tensor:
    """Finite-horizon value ``x0ᵀ P₀ x0``."""
    return x0 @ sol.P[0] @ x0
