"""State estimation: Kalman filtering, moving-horizon estimation, output
feedback (port of ``estimation.py``).

- The steady-state Kalman gain by control/filter duality: the filter DARE is
  the control DARE of ``(Aᵀ, Cᵀ)``, solved by :func:`.ops.riccati.dare_sda`.
- The time-varying Kalman filter as a loop carrying ``(x̂, P)``.
- Moving-horizon estimation as a condensed box-QP in ``z = [x₀; w₀..w_{M−1}]``:
  the Hessian is fixed per window geometry, the window data moves only the
  linear term and the bounds, so a batch of windows is one launch of the
  fused ADMM kernel (:meth:`MHE.solve_batch`).
- Output-feedback MPC: Kalman correction, then the MPC solve, then the
  prediction through the applied input.
- The extended Kalman filter, its Jacobians by ``torch.func.jacfwd``.

Vectors are rows: a state is ``(nx,)`` or a batch ``(B, nx)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .models.linear import LinearSystem
from .ops.condensed import prediction_matrices
from .ops.cuda.admm_kernel import DEFAULT_TILE
from .ops.riccati import dare_sda
from .solvers.linear_mpc import _TILED, _squeeze
from .solvers.qp import QPOperator, admm_solve, qp_setup
from .utils.precision import set_solver_precision


def _gain(Ppred, C, S):
    """``Ppred Cᵀ S⁻¹`` without forming ``S⁻¹``."""
    return torch.linalg.solve(S.T, (Ppred @ C.T).T).T


# ---------------------------------------------------------------------------
# Kalman filtering
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KalmanFilter:
    """Steady-state (a priori) Kalman filter for ``x⁺ = Ax + Bu + w``,
    ``y = Cx + v``, ``w ~ N(0, Qw)``, ``v ~ N(0, Rv)``."""

    system: LinearSystem
    L: torch.Tensor  # (nx, ny) innovation gain
    P: torch.Tensor  # (nx, nx) a priori error covariance

    def step(self, xhat, u, y_next):
        """Predict with ``u``, then correct with the next measurement."""
        A, B, C = self.system.A, self.system.B, self.system.C
        xpred = xhat @ A.T + u @ B.T
        return xpred + (y_next - xpred @ C.T) @ self.L.T


def kalman_gain(system: LinearSystem, Qw, Rv, iters: int = 30) -> KalmanFilter:
    """Steady-state gain from the filter DARE, as the control DARE at
    ``(A, B, Q, R) → (Aᵀ, Cᵀ, Qw, Rv)``."""
    if system.C is None:
        raise ValueError("kalman_gain needs a system with an output equation")
    set_solver_precision()
    A, C = system.A, system.C
    P = dare_sda(A.T, C.T, Qw, Rv, iters=iters)
    return KalmanFilter(system=system, L=_gain(P, C, C @ P @ C.T + Rv), P=P)


def kalman_filter_trajectory(system: LinearSystem, Qw, Rv, xhat0, P0, us, ys):
    """Time-varying Kalman filter: step ``k`` predicts through ``us[k]`` and
    corrects with ``ys[k]`` (the measurement of ``x_{k+1}``); the covariance
    update in Joseph form. Returns the posteriors ``(T, nx)`` and
    ``(T, nx, nx)``."""
    set_solver_precision()
    A, B, C = system.A, system.B, system.C
    I = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    xhat, P = xhat0, P0
    xs, Ps = [], []
    for u, y in zip(us, ys):
        xpred = A @ xhat + B @ u
        Ppred = A @ P @ A.T + Qw
        K = _gain(Ppred, C, C @ Ppred @ C.T + Rv)
        xhat = xpred + K @ (y - C @ xpred)
        IKC = I - K @ C
        P = IKC @ Ppred @ IKC.T + K @ Rv @ K.T
        xs.append(xhat)
        Ps.append(P)
    return torch.stack(xs), torch.stack(Ps)


# ---------------------------------------------------------------------------
# Moving-horizon estimation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MHE:
    """Condensed MHE over a window of ``M`` steps. Decision
    ``z = [x₀; w₀..w_{M−1}]``; window states ``X = Φ x₀ + Γ_u ū + Γ_w w̄``;
    cost ``‖x₀ − x̄‖²_{P₀⁻¹} + Σ‖wₖ‖²_{Qw⁻¹} + Σ‖yₖ − C xₖ‖²_{Rv⁻¹}``."""

    system: LinearSystem
    op: QPOperator | None
    H: torch.Tensor  # (nz, nz) cost Hessian
    Phi: torch.Tensor  # (M nx, nx)
    Gamma_u: torch.Tensor  # (M nx, M nu)
    Gamma_w: torch.Tensor  # (M nx, M nx)
    Cbar: torch.Tensor  # ((M+1) ny, nz) observation map of z
    obs_shift: torch.Tensor  # ((M+1) ny, M nu) the known inputs' part
    P0_inv: torch.Tensor
    Qw_inv: torch.Tensor
    Rv_inv: torch.Tensor
    x_lb: torch.Tensor  # (M nx,) window-state bounds (±inf where unbounded)
    x_ub: torch.Tensor
    M: int = 10
    iters: int = 200

    @property
    def nx(self) -> int:
        return self.system.A.shape[0]

    def _linear_term(self, xbar, us, ys):
        """q of the window data: ``xbar (..., nx)``, ``us (..., M, nu)``,
        ``ys (..., M+1, ny)`` (measurements of x₀..x_M) → ``(..., nz)``."""
        yflat = ys.reshape(*ys.shape[:-2], -1)
        uflat = us.reshape(*us.shape[:-2], -1)
        y_eff = yflat - uflat @ self.obs_shift.T
        Rbig = torch.kron(torch.eye(self.M + 1, dtype=yflat.dtype, device=yflat.device),
                          self.Rv_inv)
        q = -((y_eff @ Rbig.T) @ self.Cbar)
        nx = self.nx
        return torch.cat([q[..., :nx] - xbar @ self.P0_inv.T, q[..., nx:]], dim=-1)

    def _bounds(self, us):
        """Box rows ``(l, u)``: x₀ (unshifted), then the window states less
        the known inputs' part; and that part, ``(..., M nx)``."""
        nx = self.nx
        shift = us.reshape(*us.shape[:-2], -1) @ self.Gamma_u.T
        batch = shift.shape[:-1]
        l = torch.cat([self.x_lb[:nx].expand(*batch, nx), self.x_lb - shift], dim=-1)
        u = torch.cat([self.x_ub[:nx].expand(*batch, nx), self.x_ub - shift], dim=-1)
        return l, u, shift

    def _window(self, z, shift):
        nx, M = self.nx, self.M
        x0, w = z[..., :nx], z[..., nx:]
        X = (x0 @ self.Phi.T + shift + w @ self.Gamma_w.T).reshape(*z.shape[:-1], M, nx)
        X_full = torch.cat([x0[..., None, :], X], dim=-2)
        return X[..., -1, :], X_full, w.reshape(*z.shape[:-1], M, nx)

    def solve(self, xbar, us, ys, warm=None):
        """One window: ``(x̂_M, X (M+1, nx), ŵ (M, nx), QPSolution)``.
        ``xbar``: arrival mean of x₀; ``us (M, nu)``; ``ys (M+1, ny)``."""
        if self.op is None:
            raise ValueError("this MHE was built without state bounds; use solve_unconstrained")
        x_M, X, w, sol = self.solve_batch(
            xbar[None], us[None], ys[None], backend="xla",
            warm=None if warm is None else (warm[0][None], warm[1][None]),
        )
        return x_M[0], X[0], w[0], _squeeze(sol)

    def solve_batch(self, xbars, us, ys, backend: str = "cuda", tile: int = DEFAULT_TILE,
                    warm=None):
        """Batched windows in one solve: ``xbars (B, nx)``, ``us (B, M, nu)``,
        ``ys (B, M+1, ny)`` → ``(x̂_M (B, nx), X (B, M+1, nx), ŵ (B, M, nx),
        QPSolution)``. ``backend="cuda"``: the fused ADMM kernel (its twin on
        CPU tensors); ``"twin"``: the twin; ``"xla"``: the per-scenario
        :func:`..solvers.qp.admm_solve`. ``warm``: ``(x (B, nz), y (B, rows))``
        of a previous batch of windows."""
        if self.op is None:
            raise ValueError("this MHE was built without state bounds; use solve_unconstrained")
        set_solver_precision()
        q = self._linear_term(xbars, us, ys)
        l, u_b, shift = self._bounds(us)
        wx, wy = warm if warm is not None else (None, None)
        if backend in _TILED:
            sol = _TILED[backend](self.op, q, l, u_b, wx, wy, iters=self.iters, tile=tile)
        elif backend == "xla":
            sol = admm_solve(self.op, q, l, u_b, iters=self.iters, warm=warm)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        return (*self._window(sol.x, shift), sol)

    def solve_unconstrained(self, xbar, us, ys):
        """Closed-form window solve (no state bounds): ``H z = −q``."""
        set_solver_precision()
        q = self._linear_term(xbar, us, ys)
        z = torch.linalg.solve(self.H, -q[..., None])[..., 0]
        shift = us.reshape(*us.shape[:-2], -1) @ self.Gamma_u.T
        return self._window(z, shift)


def make_mhe(system: LinearSystem, Qw, Rv, P0, M: int, x_min=None, x_max=None,
             iters: int = 200, rho: float = 0.1) -> MHE:
    """The condensed MHE QP for a window of ``M`` steps, in the system's
    dtype on its device. ``x_min`` / ``x_max`` ``(nx,)`` bound the window
    states (and x₀); without them there is no operator and only
    :meth:`MHE.solve_unconstrained` runs."""
    if system.C is None:
        raise ValueError("make_mhe needs a system with an output equation")
    set_solver_precision()
    A, B, C = system.A, system.B, system.C
    nx, nu = B.shape
    ny = C.shape[0]
    dtype, device = A.dtype, A.device
    eye = lambda k: torch.eye(k, dtype=dtype, device=device)
    zeros = lambda *s: torch.zeros(*s, dtype=dtype, device=device)

    Phi, Gamma_u = prediction_matrices(A, B, M)
    _, Gamma_w = prediction_matrices(A, eye(nx), M)
    P0_inv, Qw_inv, Rv_inv = (torch.linalg.inv(a.to(dtype)).contiguous() for a in (P0, Qw, Rv))

    Cbig = torch.kron(eye(M), C)
    Cbar = torch.cat([torch.cat([C, zeros(ny, M * nx)], 1),
                      torch.cat([Cbig @ Phi, Cbig @ Gamma_w], 1)], 0)
    obs_shift = torch.cat([zeros(ny, M * nu), Cbig @ Gamma_u], 0)
    H = Cbar.T @ torch.kron(eye(M + 1), Rv_inv) @ Cbar
    H[:nx, :nx] += P0_inv
    H = H + torch.block_diag(zeros(nx, nx), torch.kron(eye(M), Qw_inv))
    H = 0.5 * (H + H.T)

    inf = torch.full((nx,), float("inf"), dtype=dtype, device=device)
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    x_lb = (-inf if x_min is None else as_t(x_min)).repeat(M)
    x_ub = (inf if x_max is None else as_t(x_max)).repeat(M)
    op = None
    if x_min is not None or x_max is not None:
        A_c = torch.cat([torch.cat([eye(nx), zeros(nx, M * nx)], 1),
                         torch.cat([Phi, Gamma_w], 1)], 0)
        op = qp_setup(H, A_c, rho=rho)
    return MHE(system=system, op=op, H=H, Phi=Phi, Gamma_u=Gamma_u, Gamma_w=Gamma_w, Cbar=Cbar,
               obs_shift=obs_shift, P0_inv=P0_inv, Qw_inv=Qw_inv, Rv_inv=Rv_inv, x_lb=x_lb,
               x_ub=x_ub, M=M, iters=iters)


def mhe_trajectory(mhe: MHE, xbar0, us, ys, unconstrained: bool = False) -> torch.Tensor:
    """Receding-horizon MHE over a record: window ``k`` estimates ``x_{k+M}``
    from ``us[k:k+M]``, ``ys[k:k+M+1]`` and the arrival mean
    ``x̄_{k+1} = A x̂₀ + B u_k + ŵ₀``, the arrival covariance held at ``P₀``.
    Returns the window-end estimates ``(T − M + 1, nx)``."""
    M, T = mhe.M, us.shape[0]
    A, B = mhe.system.A, mhe.system.B
    xbar, ends = xbar0, []
    for k in range(T - M + 1):
        u_w, y_w = us[k : k + M], ys[k : k + M + 1]
        if unconstrained:
            x_M, X, w = mhe.solve_unconstrained(xbar, u_w, y_w)
        else:
            x_M, X, w, _ = mhe.solve(xbar, u_w, y_w)
        xbar = A @ X[0] + B @ u_w[0] + w[0]
        ends.append(x_M)
    return torch.stack(ends)


# ---------------------------------------------------------------------------
# Output-feedback MPC
# ---------------------------------------------------------------------------


def output_feedback_policy(ctrl, kf: KalmanFilter) -> Callable:
    """Kalman correction → MPC solve → prediction, as one policy
    ``(y, t, (x̂_pred, mpc_carry)) -> (u, carry, aux)``; aux adds
    ``state_estimate``."""
    mpc_policy = ctrl.policy()
    A, B, C = kf.system.A, kf.system.B, kf.system.C

    def policy(y, t, carry):
        xhat_pred, mpc_carry = carry
        xhat = xhat_pred + kf.L @ (y - C @ xhat_pred)
        u, mpc_carry, aux = mpc_policy(xhat, t, mpc_carry)
        return u, (A @ xhat + B @ u, mpc_carry), dict(aux, state_estimate=xhat)

    return policy


def initial_output_feedback_carry(ctrl, xhat0, dtype=torch.float32, device=None):
    xhat0 = torch.as_tensor(xhat0, dtype=dtype, device=device)
    return (xhat0, ctrl.initial_carry(dtype, xhat0.device))


# ---------------------------------------------------------------------------
# Extended Kalman filter
# ---------------------------------------------------------------------------


class ExtendedKalmanFilter:
    """EKF for ``x⁺ = F(x, u) + w``, ``y = h(x) + v``: the Jacobians by
    ``torch.func.jacfwd`` through the step and the output map; the
    covariance update in Joseph form."""

    def __init__(self, step_fn: Callable, obs_fn: Callable, Qw, Rv):
        self.step_fn = step_fn
        self.obs_fn = obs_fn
        self.Qw = torch.as_tensor(Qw)
        self.Rv = torch.as_tensor(Rv)

    def _correct(self, xhat, P, y):
        C = torch.func.jacfwd(self.obs_fn)(xhat)
        K = _gain(P, C, C @ P @ C.T + self.Rv)
        IKC = torch.eye(xhat.shape[0], dtype=P.dtype, device=P.device) - K @ C
        return xhat + K @ (y - self.obs_fn(xhat)), IKC @ P @ IKC.T + K @ self.Rv @ K.T

    def step(self, xhat, P, u, y_next):
        """Predict through ``u``, correct with the next measurement."""
        set_solver_precision()
        A = torch.func.jacfwd(self.step_fn, argnums=0)(xhat, u)
        xpred = self.step_fn(xhat, u)
        return self._correct(xpred, A @ P @ A.T + self.Qw, y_next)


def ekf_trajectory(ekf: ExtendedKalmanFilter, xhat0, P0, us, ys):
    """The EKF over a record, as :func:`kalman_filter_trajectory`."""
    xhat, P = xhat0, P0
    xs, Ps = [], []
    for u, y in zip(us, ys):
        xhat, P = ekf.step(xhat, P, u, y)
        xs.append(xhat)
        Ps.append(P)
    return torch.stack(xs), torch.stack(Ps)


def ekf_output_feedback_policy(ctrl, ekf: ExtendedKalmanFilter) -> Callable:
    """EKF correct → MPC solve → EKF predict, for any controller with the
    ``policy()`` / ``initial_carry()`` contract. Carry
    ``(x̂_pred, P, mpc_carry)``; aux adds ``state_estimate``, ``cov_trace``."""
    mpc_policy = ctrl.policy()

    def policy(y, t, carry):
        set_solver_precision()
        xhat_pred, P, mpc_carry = carry
        xhat, Pcorr = ekf._correct(xhat_pred, P, y)
        u, mpc_carry, aux = mpc_policy(xhat, t, mpc_carry)
        A = torch.func.jacfwd(ekf.step_fn, argnums=0)(xhat, u)
        carry = (ekf.step_fn(xhat, u), A @ Pcorr @ A.T + ekf.Qw, mpc_carry)
        return u, carry, dict(aux, state_estimate=xhat, cov_trace=torch.trace(Pcorr))

    return policy


def initial_ekf_carry(ctrl, xhat0, P0, dtype=torch.float32, device=None):
    xhat0 = torch.as_tensor(xhat0, dtype=dtype, device=device)
    return (xhat0, torch.as_tensor(P0, dtype=dtype, device=xhat0.device),
            ctrl.initial_carry(dtype, xhat0.device))
