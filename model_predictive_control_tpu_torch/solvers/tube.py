"""Rigid-tube robust linear MPC for additive bounded disturbances (port of
``solvers/tube.py``).

For ``x⁺ = A x + B u + w`` with ``|w| ≤ w_half`` elementwise, an ancillary
LQR gain ``K`` keeps the true state in a tube ``x ∈ z ⊕ Z`` around a nominal
state ``z`` that moves without disturbance: the applied input is
``u = v + K (x − z)``, the error ``e = x − z`` obeys ``e⁺ = (A + BK) e + w``.
The nominal MPC solves the same condensed box-QP as :class:`.linear_mpc.
LinearMPC` on boxes tightened by the tube's cross-section (state boxes by the
mRPI support ``z_margin``, input boxes by the support of ``K·Z``). The supports
are computed once in float64 numpy (Raković's outer approximation).

The certificate holds only with full-precision plant, nominal and feedback
products: every solver path pins FP32 matmuls (``utils/precision.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.precision import set_solver_precision
from .linear_mpc import BoxProblem, LinearMPC, as_box_problem, make_box_mpc


def _np_dare(A: np.ndarray, B: np.ndarray, Q: np.ndarray, R: np.ndarray,
             iters: int = 10_000, tol: float = 1e-12) -> np.ndarray:
    """Float64 DARE fixed point by the Riccati iteration (set-up only)."""
    P = Q.copy()
    for _ in range(iters):
        BtP = B.T @ P
        K = -np.linalg.solve(R + BtP @ B, BtP @ A)
        P_next = Q + A.T @ P @ (A + B @ K)
        P_next = 0.5 * (P_next + P_next.T)
        if np.max(np.abs(P_next - P)) < tol * (1.0 + np.max(np.abs(P_next))):
            return P_next
        P = P_next
    return P


def mrpi_box_margins(
    A_K: np.ndarray, w_half: np.ndarray, K: np.ndarray, alpha_max: float = 0.5,
    s_max: int = 400,
) -> tuple[np.ndarray, np.ndarray, int, float]:
    """Axis-direction supports of an RPI outer approximation of the mRPI set
    ``Z = (1−α)⁻¹ ⊕_{i<s} A_K^i W``: ``(z_margin, u_margin, s, alpha)``, with
    ``s`` grown until ``A_K^s W ⊆ α_max W``. Raises ``ValueError`` when
    ``s_max`` is reached."""
    A_K = np.asarray(A_K, dtype=np.float64)
    K = np.asarray(K, dtype=np.float64)
    w_half = np.asarray(w_half, dtype=np.float64)
    nx = A_K.shape[0]
    if not np.any(w_half > 0):
        return np.zeros(nx), np.zeros(K.shape[0]), 0, 0.0
    T = np.eye(nx)
    s_z = np.zeros(nx)
    s_u = np.zeros(K.shape[0])
    for s in range(1, s_max + 1):
        s_z = s_z + np.abs(T) @ w_half
        s_u = s_u + np.abs(K @ T) @ w_half
        T = A_K @ T
        reach = np.abs(T) @ w_half
        with np.errstate(divide="ignore", invalid="ignore"):
            ratios = np.where(w_half > 0, reach / np.where(w_half > 0, w_half, 1.0),
                              np.where(reach > 1e-15, np.inf, 0.0))
        alpha = float(np.max(ratios))
        if alpha <= alpha_max:
            scale = 1.0 / (1.0 - alpha)
            return s_z * scale, s_u * scale, s, alpha
    raise ValueError(
        f"A_K^s W not inside {alpha_max}·W after s={s_max} steps: the closed loop "
        "contracts too weakly for a rigid tube with this disturbance set"
    )


def lqr_gain_np(A: np.ndarray, B: np.ndarray, Q: np.ndarray, R: np.ndarray) -> np.ndarray:
    """The ancillary gain ``K = −(R + BᵀPB)⁻¹BᵀPA`` of the float64 DARE."""
    P = _np_dare(A, B, Q, R)
    BtP = B.T @ P
    return -np.linalg.solve(R + BtP @ B, BtP @ A)


@dataclasses.dataclass(frozen=True)
class TubeMPC:
    """Rigid-tube robust MPC: the nominal tightened MPC plus ancillary
    feedback, ``u_t = v_t + K (x_t − z_t)`` with ``z_{t+1} = A z_t + B v_t``."""

    inner: LinearMPC  # nominal MPC on the tightened problem
    A: torch.Tensor
    B: torch.Tensor
    K: torch.Tensor  # ancillary gain, u = v + K e
    z_margin: torch.Tensor  # (nx,) |e| ≤ z_margin
    u_margin: torch.Tensor  # (nu,) |K e| supports
    s: int = 0
    alpha: float = 0.0

    def initial_carry(self, x0: torch.Tensor):
        """Anchor the nominal trajectory at the measured initial state."""
        return (x0, self.inner.initial_carry(x0.dtype, x0.device))

    def policy(self):
        """Tube policy for :func:`..control.simulate.simulate`; aux adds
        ``nominal``, ``error`` and ``tube_ok`` (the error inside the
        certified cross-section)."""

        def policy_fn(x, t, carry):
            set_solver_precision()
            z, warm = carry
            v_traj, sol = self.inner.solve(z, warm=warm)
            e = x - z
            u = v_traj[0] + self.K @ e
            z_next = self.A @ z + self.B @ v_traj[0]
            aux = {
                "solver_success": sol.converged,
                "state_prediction": self.inner.qp.predict_states(z, sol.x),
                "input_prediction": v_traj,
                "nominal": z,
                "error": e,
                "tube_ok": (e.abs() <= self.z_margin * 1.0000001).all(),
            }
            return u, (z_next, self.inner._shift_warm(sol.x, sol.y)), aux

        return policy_fn

    def batched_policy(self, **kw):
        """Batch-level tube policy for
        :func:`..control.batch_loop.simulate_batch`: the nominal tightened
        solve through :meth:`.linear_mpc.LinearMPC.batched_policy` (the fused
        kernel by default), the tube correction two batched products. Carry
        ``(z (B, nx), inner warm start)`` from :meth:`initial_batch_carry`."""
        inner_fn = self.inner.batched_policy(**kw)

        def policy_fn(x_batch, t, carry):
            set_solver_precision()
            z, inner_carry = carry
            v0, inner_carry, aux = inner_fn(z, t, inner_carry)
            e = x_batch - z
            u = v0 + e @ self.K.T
            z_next = z @ self.A.T + v0 @ self.B.T
            aux = dict(aux, nominal=z, error=e,
                       tube_ok=(e.abs() <= self.z_margin * 1.0000001).all(dim=-1))
            return u, (z_next, inner_carry), aux

        return policy_fn

    def initial_batch_carry(self, x0_batch: torch.Tensor, dtype=torch.float32):
        """Anchor each scenario's nominal trajectory at its measured x0."""
        x0_batch = x0_batch.to(dtype)
        return (x0_batch, self.inner.initial_batch_carry(
            x0_batch.shape[0], dtype=dtype, device=x0_batch.device))


def make_tube_mpc(
    problem,
    w_half,
    solver: str = "admm",
    iters: int = 200,
    dtype=torch.float32,
    terminal: str = "dare",
    alpha_max: float = 0.5,
    rho: float = 0.1,
    terminal_set: bool = False,
    device=None,
) -> TubeMPC:
    """Build a rigid-tube robust MPC from session-2/3 ``Problem`` data or any
    :class:`BoxProblem`, on ``device`` (the card when ``None``). ``w_half``:
    half-widths of the box disturbance set. Raises ``ValueError`` when the
    tube does not fit inside the boxes. ``terminal_set=True`` adds the
    tightened problem's terminal set on the nominal ``z_N``."""
    device = resolve_device(device)
    box = as_box_problem(problem)
    A, B, Q, R = box.A, box.B, box.Q, box.R
    K = lqr_gain_np(A, B, Q, R)
    z_margin, u_margin, s, alpha = mrpi_box_margins(
        A + B @ K, np.asarray(w_half, dtype=np.float64), K, alpha_max=alpha_max
    )
    tight = BoxProblem(
        A=A, B=B, Q=Q, R=R,
        x_min=box.x_min + z_margin, x_max=box.x_max - z_margin,
        u_min=box.u_min + u_margin, u_max=box.u_max - u_margin,
        N=box.N,
    )
    if not (np.all(tight.x_min < tight.x_max) and np.all(tight.u_min < tight.u_max)):
        raise ValueError(
            f"tube does not fit: state margins {z_margin}, input margins "
            f"{u_margin} empty one of the constraint boxes"
        )
    inner = make_box_mpc(tight, solver=solver, iters=iters, dtype=dtype, device=device,
                         terminal=terminal, rho=rho, terminal_set=terminal_set)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return TubeMPC(inner=inner, A=t(A), B=t(B), K=t(K), z_margin=t(z_margin),
                   u_margin=t(u_margin), s=s, alpha=alpha)
