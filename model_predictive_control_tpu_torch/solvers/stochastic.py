"""Chance-constrained stochastic linear MPC by variance propagation (port of
``solvers/stochastic.py``).

For ``x⁺ = A x + B u + w``, ``w ~ N(0, Σ_w)``, each bound holds as a chance
constraint ``Pr(x_k[j] ≤ x_max[j]) ≥ 1 − ε``. With ``u_k = v_k + K e_k`` the
prediction error has covariance ``Σ_0 = 0``, ``Σ_{k+1} = A_K Σ_k A_Kᵀ + Σ_w``,
and the constraints become per-stage tightenings of the nominal QP's bounds:
states by ``β·√diag Σ_k``, inputs by ``β·√diag(K Σ_k Kᵀ)``, ``β = Φ⁻¹(1−ε)``.
The margins are a float64 numpy set-up; the per-step solve is the nominal
controller's, on the fused kernel.
"""

from __future__ import annotations

import dataclasses
from statistics import NormalDist

import numpy as np
import torch

from ..utils.device import resolve_device
from .linear_mpc import LinearMPC, as_box_problem, make_box_mpc
from .tube import lqr_gain_np


def gaussian_stage_margins(A, B, K, Sigma_w, N: int, eps: float):
    """Per-stage tightenings ``(state (N, nx), input (N, nu), β)``: row k of
    the state margins applies to ``x_{k+1}``, row k of the input margins to
    ``u_k`` (row 0 is zero)."""
    if not (0.0 < eps < 0.5):
        raise ValueError(f"eps must be in (0, 0.5), got {eps}")
    beta = float(NormalDist().inv_cdf(1.0 - eps))
    A, B, K = (np.asarray(a, dtype=np.float64) for a in (A, B, K))
    Sigma_w = np.asarray(Sigma_w, dtype=np.float64)
    A_K = A + B @ K
    nx, nu = B.shape
    Sigma = np.zeros((nx, nx))
    state_m = np.zeros((N, nx))
    input_m = np.zeros((N, nu))
    for k in range(N):
        input_m[k] = beta * np.sqrt(np.maximum(np.diag(K @ Sigma @ K.T), 0.0))
        Sigma = A_K @ Sigma @ A_K.T + Sigma_w
        state_m[k] = beta * np.sqrt(np.maximum(np.diag(Sigma), 0.0))
    return state_m, input_m, beta


@dataclasses.dataclass(frozen=True)
class StochasticMPC:
    """Chance-constrained MPC in the re-anchoring form: each step re-plans
    from the measured state on the tightened QP and applies the plan's first
    input, so the policy is the nominal controller's on that QP."""

    inner: LinearMPC  # nominal MPC whose QP carries the per-stage tightenings
    A: torch.Tensor
    B: torch.Tensor
    K: torch.Tensor  # the feedback of the Σ_k propagation
    state_margin: torch.Tensor  # (N, nx)
    input_margin: torch.Tensor  # (N, nu)
    eps: float = 0.05
    beta: float = 0.0

    def initial_carry(self, dtype=torch.float32, device=None):
        return self.inner.initial_carry(dtype, device)

    def policy(self):
        return self.inner.policy()

    def batched_policy(self, **kw):
        """The tightened QP's batch path (the fused kernel by default)."""
        return self.inner.batched_policy(**kw)


def make_stochastic_mpc(
    problem,
    Sigma_w,
    eps: float = 0.05,
    solver: str = "admm",
    iters: int = 200,
    dtype=torch.float32,
    terminal: str = "dare",
    rho: float = 0.1,
    device=None,
) -> StochasticMPC:
    """Build a chance-constrained MPC from session-2/3 ``Problem`` data or any
    ``BoxProblem``, on ``device`` (the card when ``None``). ``Sigma_w``:
    the noise covariance (or its diagonal); ``eps``: the per-constraint
    violation probability. Raises ``ValueError`` when the tightening empties
    a box."""
    device = resolve_device(device)
    box = as_box_problem(problem)
    K = lqr_gain_np(box.A, box.B, box.Q, box.R)
    Sigma_w = np.asarray(Sigma_w, dtype=np.float64)
    if Sigma_w.ndim == 1:
        Sigma_w = np.diag(Sigma_w)
    state_m, input_m, beta = gaussian_stage_margins(box.A, box.B, K, Sigma_w, box.N, eps)
    if np.any(box.x_min + state_m.max(0) >= box.x_max - state_m.max(0)) or np.any(
        box.u_min + input_m.max(0) >= box.u_max - input_m.max(0)
    ):
        raise ValueError(
            f"chance tightening empties a constraint box: state margins up to "
            f"{state_m.max(0)}, input up to {input_m.max(0)} at eps={eps}"
        )
    inner = make_box_mpc(box, solver=solver, iters=iters, dtype=dtype, device=device,
                         terminal=terminal, rho=rho)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    qp = inner.qp
    sm, im = t(state_m.reshape(-1)), t(input_m.reshape(-1))
    inner = dataclasses.replace(inner, qp=dataclasses.replace(
        qp, x_lb=qp.x_lb + sm, x_ub=qp.x_ub - sm, u_lb=qp.u_lb + im, u_ub=qp.u_ub - im))
    return StochasticMPC(inner=inner, A=t(box.A), B=t(box.B), K=t(K), state_margin=t(state_m),
                         input_margin=t(input_m), eps=eps, beta=beta)
