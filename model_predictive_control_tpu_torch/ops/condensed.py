"""Condensed-QP construction for linear MPC (port of ``ops/condensed.py``).

Single-shooting condensation with ``x̄ = [x_1; …; x_N]`` and
``ū = [u_0; …; u_{N-1}]``:

    x̄ = Φ x0 + Γ ū,   Φ block-row k = A^{k+1},   Γ[k, j] = A^{k-j} B  (j ≤ k)
    P = 2 (Γᵀ Q̄ Γ + R̄),   q(x0) = 2 Γᵀ Q̄ Φ x0

with ``Q̄ = blkdiag(Q ×(N-1), QN)``; a reference ``x̄_ref`` adds
``−2 Γᵀ Q̄ x̄_ref`` to ``q``. Constraints stack the input and state boxes into
``l(x0) ≤ A_c ū ≤ u(x0)`` with ``A_c = [I; Γ]``; a terminal box tightens the
last state block. :class:`SoftCondensedQP` softens the state boxes with one
slack per state component and stage.
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

    def predict_states(self, x0: torch.Tensor, u_flat: torch.Tensor) -> torch.Tensor:
        """``x̄ = Φ x0 + Γ ū`` as ``(..., N, nx)``."""
        xs = x0 @ self.Phi.T + u_flat @ self.Gamma.T
        return xs.reshape(*xs.shape[:-1], self.N, self.nx)

    def ref_linear_term(self, x_ref: torch.Tensor) -> torch.Tensor:
        """Tracking linear term ``−2·ΓᵀQ̄·x̄_ref`` of a reference window
        ``(..., N, nx)``: ``(..., n)``."""
        return -2.0 * x_ref.reshape(*x_ref.shape[:-2], self.N * self.nx) @ self.QG


@dataclasses.dataclass(frozen=True)
class SoftCondensedQP:
    """Slack-softened condensed QP: decision ``z = [ū; s]`` with one slack
    ``s ≥ 0`` per state component and stage, cost ``+ w‖s‖² + γ·1ᵀs``, rows

        l_u ≤ ū ≤ u_u,   Γū − s ≤ x_ub − Φx0,   Γū + s ≥ x_lb − Φx0,   s ≥ 0,

    so the QP is feasible at every measured state. Has the per-solve
    interface of :class:`CondensedQP` (``n``, ``m``, ``qp_vectors``,
    ``predict_states``)."""

    P: torch.Tensor  # (n2, n2) blkdiag(P_hard, 2w I)
    A_c: torch.Tensor  # (m2, n2)
    base: CondensedQP
    slack_linear: float  # γ

    @property
    def N(self) -> int:
        return self.base.N

    @property
    def nx(self) -> int:
        return self.base.nx

    @property
    def nu(self) -> int:
        return self.base.nu

    @property
    def n_inputs(self) -> int:
        return self.base.n

    @property
    def n_slack(self) -> int:
        return self.base.N * self.base.nx

    @property
    def n(self) -> int:
        return self.n_inputs + self.n_slack

    @property
    def m(self) -> int:
        return self.n_inputs + 3 * self.n_slack

    def qp_vectors(self, x0: torch.Tensor):
        """``(q (..., n), l (..., m), u (..., m))`` for states ``(..., nx)``."""
        b = self.base
        shift = x0 @ b.Phi.T
        q_u = x0 @ b.q_x0.T + b.q_const
        batch, ns = shift.shape[:-1], self.n_slack
        full = lambda v: torch.full((*batch, ns), v, dtype=q_u.dtype, device=q_u.device)
        inf = float("inf")
        q = torch.cat([q_u, full(self.slack_linear)], dim=-1)
        l = torch.cat([b.u_lb.expand(*batch, -1), full(-inf), b.x_lb - shift, full(0.0)], dim=-1)
        u = torch.cat([b.u_ub.expand(*batch, -1), b.x_ub - shift, full(inf), full(inf)], dim=-1)
        return q, l, u

    def predict_states(self, x0: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self.base.predict_states(x0, z[..., : self.n_inputs])


def soften_condensed_qp(
    cqp: CondensedQP, slack_weight: float = 100.0, slack_linear: float = 1.0
) -> SoftCondensedQP:
    """Extend a hard condensed QP with per-stage state-constraint slacks."""
    dtype, device = cqp.P.dtype, cqp.P.device
    n, ns = cqp.n, cqp.N * cqp.nx
    Z = torch.zeros(n, ns, dtype=dtype, device=device)
    I_n = torch.eye(n, dtype=dtype, device=device)
    I_s = torch.eye(ns, dtype=dtype, device=device)
    P = torch.cat([torch.cat([cqp.P, Z], 1), torch.cat([Z.T, 2.0 * slack_weight * I_s], 1)], 0)
    A_c = torch.cat(
        [
            torch.cat([I_n, Z], 1),  # input box
            torch.cat([cqp.Gamma, -I_s], 1),  # Γū − s ≤ x_ub − Φx0
            torch.cat([cqp.Gamma, I_s], 1),  # Γū + s ≥ x_lb − Φx0
            torch.cat([Z.T, I_s], 1),  # s ≥ 0
        ],
        0,
    )
    return SoftCondensedQP(P=P, A_c=A_c, base=cqp, slack_linear=float(slack_linear))


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
    x_ref=None,
    x_term_min=None,
    x_term_max=None,
) -> CondensedQP:
    """Assemble the condensed QP from problem data. ``x_ref`` (``(nx,)`` or
    ``(N, nx)``) makes the stage cost ``(x_k − x_ref_k)ᵀ Q (x_k − x_ref_k)``;
    ``x_term_min`` / ``x_term_max`` tighten the last state block's box (a
    terminal set on ``x_N``, intersected with the stage box)."""
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

    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    q_const = torch.zeros(N * nu, dtype=dtype, device=device)
    if x_ref is not None:
        x_ref = t(x_ref)
        if x_ref.ndim == 1:
            x_ref = x_ref.expand(N, nx)
        q_const = -2.0 * QbarGamma.T @ x_ref.reshape(N * nx)
    x_lb, x_ub = tile(x_min), tile(x_max)
    if x_term_min is not None:
        x_lb[-nx:] = torch.maximum(x_lb[-nx:], t(x_term_min))
    if x_term_max is not None:
        x_ub[-nx:] = torch.minimum(x_ub[-nx:], t(x_term_max))
    return CondensedQP(
        P=P,
        A_c=A_c,
        Phi=Phi,
        Gamma=Gamma,
        QG=QbarGamma,
        q_x0=q_x0,
        q_const=q_const,
        u_lb=tile(u_min),
        u_ub=tile(u_max),
        x_lb=x_lb,
        x_ub=x_ub,
        N=N,
        nx=nx,
        nu=nu,
    )
