"""Condensed-QP construction for linear MPC (port of ``ops/condensed.py``).

Single-shooting condensation with ``x̄ = [x_1; …; x_N]`` and
``ū = [u_0; …; u_{N-1}]``:

    x̄ = Φ x0 + Γ ū,   Φ block-row k = A^{k+1},   Γ[k, j] = A^{k-j} B  (j ≤ k)
    P = 2 (Γᵀ Q̄ Γ + R̄),   q(x0) = 2 Γᵀ Q̄ Φ x0

with ``Q̄ = blkdiag(Q ×(N-1), QN)``. Constraints stack the input and state
boxes into ``l(x0) ≤ A_c ū ≤ u(x0)`` with ``A_c = [I; Γ]``. This slice builds
the regulation form only (no reference, no terminal box).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CondensedQP:
    """Condensed MPC-QP data, fixed for a given (system, horizon, weights).

    ``(q, l, u)`` are affine in the measured state and come from
    :meth:`qp_vectors`; everything else is shared across a scenario batch.
    """

    P: torch.Tensor  # (n, n), n = N*nu
    A_c: torch.Tensor  # (m, n), m = N*nu + N*nx
    Phi: torch.Tensor  # (N*nx, nx)
    Gamma: torch.Tensor  # (N*nx, n)
    QG: torch.Tensor  # (N*nx, n) Q̄Γ
    q_x0: torch.Tensor  # (n, nx): q(x0) = q_x0 @ x0 + q_const
    q_const: torch.Tensor  # (n,)
    u_lb: torch.Tensor  # (n,)
    u_ub: torch.Tensor  # (n,)
    x_lb: torch.Tensor  # (N*nx,)
    x_ub: torch.Tensor  # (N*nx,)
    N: int
    nx: int
    nu: int

    @property
    def n(self) -> int:
        return self.N * self.nu

    @property
    def m(self) -> int:
        return self.N * self.nu + self.N * self.nx

    def qp_vectors(
        self, x0: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-scenario ``(q, l, u)`` for states ``x0`` of shape ``(..., nx)``:
        ``q`` is ``(..., n)``, ``l`` and ``u`` are ``(..., m)``."""
        shift = x0 @ self.Phi.T
        q = x0 @ self.q_x0.T + self.q_const
        batch = shift.shape[:-1]
        l = torch.cat([self.u_lb.expand(*batch, -1), self.x_lb - shift], dim=-1)
        u = torch.cat([self.u_ub.expand(*batch, -1), self.x_ub - shift], dim=-1)
        return q, l, u


def prediction_matrices(
    A: torch.Tensor, B: torch.Tensor, N: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense prediction matrices: ``Phi (N*nx, nx)`` and ``Gamma (N*nx, N*nu)``."""
    nx, nu = B.shape
    powers = [torch.eye(nx, dtype=A.dtype, device=A.device)]  # A^0 .. A^{N-1}
    for _ in range(N - 1):
        powers.append(A @ powers[-1])
    Phi = torch.cat([A @ Ak for Ak in powers], dim=0)
    AB = [Ak @ B for Ak in powers]
    zero = torch.zeros(nx, nu, dtype=A.dtype, device=A.device)
    Gamma = torch.cat(
        [
            torch.cat([AB[k - j] if j <= k else zero for j in range(N)], dim=1)
            for k in range(N)
        ],
        dim=0,
    )
    return Phi, Gamma


def build_condensed_qp(
    A: torch.Tensor,
    B: torch.Tensor,
    Q: torch.Tensor,
    R: torch.Tensor,
    QN: torch.Tensor,
    N: int,
    u_min: torch.Tensor,
    u_max: torch.Tensor,
    x_min: torch.Tensor,
    x_max: torch.Tensor,
) -> CondensedQP:
    """Assemble the condensed regulation QP from problem data."""
    nx, nu = B.shape
    dtype, device = B.dtype, B.device
    Phi, Gamma = prediction_matrices(A, B, N)

    Qbar = torch.block_diag(*([Q] * (N - 1) + [QN]))
    QbarGamma = Qbar @ Gamma
    H = Gamma.T @ QbarGamma
    Rbar = torch.kron(torch.eye(N, dtype=dtype, device=device), R)
    P = 2.0 * (H + Rbar)
    P = 0.5 * (P + P.T)
    q_x0 = 2.0 * QbarGamma.T @ Phi
    A_c = torch.cat([torch.eye(N * nu, dtype=dtype, device=device), Gamma], dim=0)

    def tile(v):
        return torch.as_tensor(v, dtype=dtype, device=device).repeat(N)

    return CondensedQP(
        P=P,
        A_c=A_c,
        Phi=Phi,
        Gamma=Gamma,
        QG=QbarGamma,
        q_x0=q_x0,
        q_const=torch.zeros(N * nu, dtype=dtype, device=device),
        u_lb=tile(u_min),
        u_ub=tile(u_max),
        x_lb=tile(x_min),
        x_ub=tile(x_max),
        N=N,
        nx=nx,
        nu=nu,
    )
