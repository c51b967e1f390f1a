"""Offset-free nonlinear MPC: a disturbance-augmented EKF and a nonlinear
target shift over the AL-iLQR (port of ``solvers/offset_free_nmpc.py``).

- The model is augmented with a constant disturbance, ``x⁺ = F(x, u) +
  B_d d``, ``d⁺ = d``, and ``(x̂, d̂)`` is estimated by an EKF over the
  stacked state, its Jacobians by ``torch.func.jacfwd`` through the step.
- :class:`OffsetFreeNMPC` solves the steady pair ``(x_s, u_s)`` holding the
  tracked outputs at the reference despite ``d̂`` (``F(x_s, u_s) + B_d d̂ −
  x_s = 0``, ``H x_s = r``; a fixed-iteration damped Newton on the square
  system) and tracks it with the AL-iLQR under the corrected model.
- :class:`DisturbanceCompensatedTracking` tracks a reference window under
  the corrected model, the window re-projected so that the corrected model
  can follow it, and the input cost centred on the input that does.

The EKF halves, the target and the reference transforms are written for one
scenario, as in the JAX package; a batch maps them with ``torch.func.vmap``
(:func:`..parallel.batch.wind_sweep`, :func:`..parallel.batch.
offset_free_sweep`). The AL-iLQR solves are batched.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.func import jacfwd, vmap

from ..control.simulate import Policy
from ..utils.device import resolve_device
from ..utils.precision import set_solver_precision
from ..utils.smallsolve import solve_spd
from .ilqr import ILQRProblem, al_ilqr_solve


def _block_diag(a: float, n: int, b: float, m: int, dtype, device) -> torch.Tensor:
    return torch.block_diag(a * torch.eye(n, dtype=dtype, device=device),
                            b * torch.eye(m, dtype=dtype, device=device))


def _first(sol):
    return type(sol)(**{k: v[0] for k, v in vars(sol).items()})


class _AugmentedEKF:
    """The disturbance-augmented EKF over ``z = [x; d]``, for one scenario.

    Subclasses set ``step_fn``, ``obs_fn``, ``Bd``, ``nx``, ``nd``, ``Qw``,
    ``Rv_mat``, ``dtype``, ``device``; ``_P0X`` / ``_P0D`` are the default
    initial covariance blocks.
    """

    _P0X = 1e-3
    _P0D = 1e-2

    def _step_aug(self, z, u):
        x, d = z[: self.nx], z[self.nx:]
        return torch.cat([self.step_fn(x, u) + self.Bd @ d, d])

    def _obs_aug(self, z):
        return self.obs_fn(z[: self.nx])

    def _ekf_correct(self, z_pred, P, y):
        """Correct with the current measurement (Joseph-form covariance)."""
        I = torch.eye(self.nx + self.nd, dtype=P.dtype, device=P.device)
        # Jacobians in the working dtype (torch.func's forward mode may
        # promote a float32 product with a Python float to float64)
        C = jacfwd(self._obs_aug)(z_pred).to(P.dtype)
        S = C @ P @ C.T + self.Rv_mat
        K = solve_spd(S, (P @ C.T).T).T
        z = z_pred + K @ (y - self._obs_aug(z_pred))
        KC = K @ C
        return z, (I - KC) @ P @ (I - KC).T + K @ self.Rv_mat @ K.T

    def _ekf_predict(self, z, Pc, u):
        """Predict through the applied input."""
        A = jacfwd(self._step_aug)(z, u).to(Pc.dtype)
        return self._step_aug(z, u), A @ Pc @ A.T + self.Qw

    def initial_P(self, P0_x: float | None = None, P0_d: float | None = None) -> torch.Tensor:
        return _block_diag(self._P0X if P0_x is None else P0_x, self.nx,
                           self._P0D if P0_d is None else P0_d, self.nd, self.dtype, self.device)

    def initial_carry(self, xhat0, P0_x: float | None = None, P0_d: float | None = None):
        z0 = torch.cat([torch.as_tensor(xhat0, dtype=self.dtype, device=self.device),
                        torch.zeros(self.nd, dtype=self.dtype, device=self.device)])
        return (z0, self.initial_P(P0_x, P0_d),
                torch.zeros(self.N, self.nu, dtype=self.dtype, device=self.device))


def _setup(self, step_fn, nx, nu, N, Q, R, QN, u_lb, u_ub, Bd, obs_fn, Qw_x, Qw_d, Rv,
           outer_iters, inner_iters, dtype, device):
    """The fields the two controllers share."""
    self.step_fn = step_fn
    self.nx, self.nu, self.N = nx, nu, N
    self.dtype, self.device = dtype, resolve_device(device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
    self.Q, self.R, self.QN = t(Q), t(R), t(QN)
    self.u_lb, self.u_ub = t(u_lb), t(u_ub)
    self.Bd = torch.eye(nx, dtype=dtype, device=self.device) if Bd is None else t(Bd)
    self.nd = self.Bd.shape[1]
    self.obs_fn = obs_fn if obs_fn is not None else (lambda x: x)
    ny = self.obs_fn(torch.zeros(nx, dtype=dtype, device=self.device)).shape[0]
    self.Qw = _block_diag(Qw_x, nx, Qw_d, self.nd, dtype, self.device)
    self.Rv_mat = Rv * torch.eye(ny, dtype=dtype, device=self.device)
    self.outer_iters = outer_iters
    self.inner_iters = inner_iters


class OffsetFreeNMPC(_AugmentedEKF):
    """Measurement-driven offset-free nonlinear MPC (EKF, target shift,
    AL-iLQR), the JAX package's parameters: ``r`` (nr,) reference for the
    tracked outputs ``H x`` (``nr == nu``: a square target system; ``H``
    the first ``nu`` states by default), ``Bd`` (identity by default),
    ``obs_fn`` (identity), the EKF covariances ``Qw_x``, ``Qw_d``, ``Rv``,
    optional state box rows ``x_lb``/``x_ub``, ``newton_iters`` of the
    target solve. Its tensors lie on ``device`` (the card when ``None``)."""

    def __init__(self, step_fn: Callable, nx: int, nu: int, N: int, Q, R, QN, u_lb, u_ub, r,
                 H=None, Bd=None, obs_fn: Callable | None = None, Qw_x: float = 1e-4,
                 Qw_d: float = 1e-2, Rv: float = 1e-5, x_lb=None, x_ub=None,
                 newton_iters: int = 12, outer_iters: int = 6, inner_iters: int = 15,
                 dtype=torch.float32, device=None):
        _setup(self, step_fn, nx, nu, N, Q, R, QN, u_lb, u_ub, Bd, obs_fn, Qw_x, Qw_d, Rv,
               outer_iters, inner_iters, dtype, device)
        self.r = torch.atleast_1d(torch.as_tensor(r, dtype=dtype, device=self.device))
        nr = self.r.shape[0]
        if nr != nu:
            raise ValueError(f"need nr == nu for a square nonlinear target system "
                             f"({nr} tracked outputs vs {nu} inputs)")
        self.H = (torch.eye(nx, dtype=dtype, device=self.device)[:nr] if H is None
                  else torch.as_tensor(H, dtype=dtype, device=self.device))
        t = lambda a: None if a is None else torch.as_tensor(a, dtype=dtype, device=self.device)
        self.x_lb, self.x_ub = t(x_lb), t(x_ub)
        self.newton_iters = newton_iters
        self.n_constraints = 2 * nu + (0 if self.x_lb is None else 2 * nx)

    def solve_target(self, d_hat, x_guess=None, u_guess=None):
        """Fixed-iteration damped Newton on the square steady-state system,
        for one scenario: ``(x_s, u_s, residual_norm)``."""
        set_solver_precision()
        nx, nu = self.nx, self.nu
        zeros = lambda n: torch.zeros(n, dtype=self.dtype, device=d_hat.device)
        w = torch.cat([zeros(nx) if x_guess is None else x_guess,
                       zeros(nu) if u_guess is None else u_guess])

        def g(w):
            x_s, u_s = w[:nx], w[nx:]
            return torch.cat([self.step_fn(x_s, u_s) + self.Bd @ d_hat - x_s,
                              self.H @ x_s - self.r])

        eye = torch.eye(nx + nu, dtype=w.dtype, device=w.device)
        for _ in range(self.newton_iters):
            J = jacfwd(g)(w).to(w.dtype)
            # Levenberg damping keeps the fixed-iteration loop safe at a
            # singular intermediate Jacobian
            w = w - solve_spd(J.T @ J + 1e-8 * eye, J.T @ g(w))
        return w[:nx], w[nx:], torch.linalg.vector_norm(g(w))

    def shifted_problem(self, d_hat, x_s, u_s):
        """``(ILQRProblem, constraints)`` tracking ``(x_s, u_s)`` under the
        model corrected by ``d̂``, for ``(B, ·)`` batches of the three."""
        Q, R, QN = self.Q, self.R, self.QN

        def stage_cost(x, u, p, s):
            e, du = x - p["x_s"], u - p["u_s"]
            return e @ (Q * e) + du @ (R * du)

        def terminal_cost(x, p):
            e = x - p["x_s"]
            return e @ (QN * e)

        prob = ILQRProblem(
            dynamics=lambda x, u, p: self.step_fn(x, u) + self.Bd @ p["d"],
            stage_cost=stage_cost, terminal_cost=terminal_cost, N=self.N, nx=self.nx,
            nu=self.nu, params={"d": d_hat, "x_s": x_s, "u_s": u_s},
        )

        def constraints(x, u, p, s):
            rows = [u - self.u_ub, self.u_lb - u]
            if self.x_lb is not None:
                rows.extend([x - self.x_ub, self.x_lb - x])
            return torch.cat(rows)

        return prob, constraints

    def solve(self, x0, d_hat, u_init=None):
        """One shifted solve at ``x0`` under ``d̂`` (``(nx,)`` or ``(B,
        nx)``): ``(solution, (x_s, u_s, target residual))``."""
        single = x0.ndim == 1
        if single:
            x0, d_hat = x0[None], d_hat[None]
            u_init = None if u_init is None else u_init[None]
        x_s, u_s, res = vmap(lambda d, xg: self.solve_target(d, x_guess=xg))(d_hat, x0)
        prob, cons = self.shifted_problem(d_hat, x_s, u_s)
        sol = al_ilqr_solve(prob, cons, self.n_constraints, x0, u_init=u_init,
                            outer_iters=self.outer_iters, inner_iters=self.inner_iters,
                            viol_tol=1e-4)
        if single:
            return _first(sol), (x_s[0], u_s[0], res[0])
        return sol, (x_s, u_s, res)

    def policy(self) -> Policy:
        """Policy over measurements ``y``: EKF correct → target → shifted
        AL-iLQR → EKF predict. Carry ``(ẑ_pred, P, u_warm)`` from
        :meth:`initial_carry`."""
        nx = self.nx

        def policy_fn(y, t, carry):
            z_pred, P, u_warm = carry
            z, Pc = self._ekf_correct(z_pred, P, y)
            x_hat, d_hat = z[:nx], z[nx:]
            sol, (x_s, u_s, target_res) = self.solve(x_hat, d_hat, u_init=u_warm)
            u = sol.us[0]
            u_next = torch.cat([sol.us[1:], sol.us[-1:]], dim=0)
            z_next, P_next = self._ekf_predict(z, Pc, u)
            aux = {
                "solver_success": sol.converged,
                "state_prediction": sol.xs[1:],
                "input_prediction": sol.us,
                "viol": sol.viol,
                "state_estimate": x_hat,
                "disturbance_estimate": d_hat,
                "target_state": x_s,
                "target_input": u_s,
                "target_residual": target_res,
            }
            return u, (z_next, P_next, u_next), aux

        return policy_fn


class DisturbanceCompensatedTracking(_AugmentedEKF):
    """Offset-free tracking: the disturbance-augmented EKF and reference
    tracking under the corrected model ``F(x, u) + B_d d̂`` (the racing twin
    of :class:`OffsetFreeNMPC`). The window is re-projected so that the
    corrected model can realize it (``reproject``, kinematic 4-state layout,
    needs ``ts``) and the R-cost is centred on the input that advances it;
    constraints are the input box. Same policy and carry as
    :class:`OffsetFreeNMPC`."""

    _P0X = 1e-4
    _P0D = 1e-3

    def __init__(self, step_fn: Callable, nx: int, nu: int, N: int, Q, R, QN, u_lb, u_ub,
                 ref_traj, Bd=None, obs_fn: Callable | None = None, Qw_x: float = 1e-5,
                 Qw_d: float = 1e-3, Rv: float = 1e-5, outer_iters: int = 6,
                 inner_iters: int = 15, ts: float | None = None, reproject: bool = True,
                 dtype=torch.float32, device=None):
        ref_traj = torch.as_tensor(ref_traj, dtype=dtype)
        device = ref_traj.device if device is None else device  # follows the reference
        _setup(self, step_fn, nx, nu, N, Q, R, QN, u_lb, u_ub, Bd, obs_fn, Qw_x, Qw_d, Rv,
               outer_iters, inner_iters, dtype, device)
        self.ref_traj = ref_traj.to(self.device)
        self.ts = ts
        self.reproject = reproject and ts is not None and nx == 4
        self.n_constraints = 2 * nu

    def reproject_window(self, window, d_hat):
        """Keep the reference positions, re-derive the heading and speed the
        corrected model needs to realize them (one scenario): per stage the
        required ground motion is ``Δp_ref − (B_d d̂)_p``, and the car points
        its velocity along it at the matching speed."""
        drift = (self.Bd @ d_hat)[:2]
        dp = window[1:, :2] - window[:-1, :2] - drift
        psi_raw = torch.atan2(dp[:, 1], dp[:, 0])
        # align with the (unwrapped) reference heading branch
        k = torch.round((window[:-1, 2] - psi_raw) / (2.0 * math.pi))
        psi = psi_raw + 2.0 * math.pi * k
        v = torch.linalg.vector_norm(dp, dim=1) / self.ts
        head = torch.cat([window[:-1, :2], psi[:, None], v[:, None], window[:-1, 4:]], dim=1)
        return torch.cat([head, window[-1:]], dim=0)

    def input_reference(self, window, d_hat):
        """Per stage the input that best advances the corrected model from
        ``ref_t`` to ``ref_{t+1}`` (6 damped Gauss-Newton steps on the
        nu-dimensional least squares), clipped to the box: ``(N, nu)``."""
        set_solver_precision()
        eye = torch.eye(self.nu, dtype=window.dtype, device=window.device)

        def one(r_now, r_next):
            def g(u):
                return self.step_fn(r_now, u) + self.Bd @ d_hat - r_next

            u = torch.zeros(self.nu, dtype=window.dtype, device=window.device)
            for _ in range(6):
                J = jacfwd(g)(u).to(u.dtype)
                u = u - solve_spd(J.T @ J + 1e-8 * eye, J.T @ g(u))
            return torch.clamp(u, self.u_lb, self.u_ub)

        return vmap(one)(window[:-1], window[1:])

    def window_problem(self, windows, d_hat, urefs):
        """``(ILQRProblem, constraints)`` for ``(B, ·)`` batches of windows,
        estimates and input references."""
        Q, R, QN, N = self.Q, self.R, self.QN, self.N

        def stage_cost(x, u, p, s):
            e, du = x - s["ref"], u - s["uref"]
            return e @ (Q * e) + du @ (R * du)

        def terminal_cost(x, p):
            e = x - p["ref_N"]
            return e @ (QN * e)

        prob = ILQRProblem(
            dynamics=lambda x, u, p: self.step_fn(x, u) + self.Bd @ p["d"],
            stage_cost=stage_cost, terminal_cost=terminal_cost, N=N, nx=self.nx, nu=self.nu,
            params={"d": d_hat, "ref_N": windows[:, N]},
            stages={"ref": windows[:, :N], "uref": urefs},
        )
        constraints = lambda x, u, p, s: torch.cat([u - self.u_ub, self.u_lb - u])
        return prob, constraints

    def prepared_windows(self, window, d_hat):
        """The per-scenario windows and input references for ``d̂ (B,
        nd)`` and the shared ``window``: ``((B, N+1, nx), (B, N, nu))``."""
        if self.reproject:
            wins = vmap(self.reproject_window, in_dims=(None, 0))(window, d_hat)
        else:
            wins = window[None].expand(d_hat.shape[0], -1, -1)
        return wins, vmap(self.input_reference)(wins, d_hat)

    def policy(self) -> Policy:
        """Measurement-driven tracking policy: EKF correct → corrected-model
        window solve → EKF predict."""
        nx = self.nx

        def policy_fn(y, t, carry):
            z_pred, P, u_warm = carry
            z, Pc = self._ekf_correct(z_pred, P, y)
            x_hat, d_hat = z[:nx], z[nx:]
            window = self.ref_traj[t : t + self.N + 1]
            wins, urefs = self.prepared_windows(window, d_hat[None])
            prob, cons = self.window_problem(wins, d_hat[None], urefs)
            sol = _first(al_ilqr_solve(prob, cons, self.n_constraints, x_hat[None],
                                       u_init=u_warm[None], outer_iters=self.outer_iters,
                                       inner_iters=self.inner_iters, viol_tol=1e-4))
            u = sol.us[0]
            u_next = torch.cat([sol.us[1:], sol.us[-1:]], dim=0)
            z_next, P_next = self._ekf_predict(z, Pc, u)
            aux = {
                "solver_success": sol.converged,
                "input_prediction": sol.us,
                "viol": sol.viol,
                "state_estimate": x_hat,
                "disturbance_estimate": d_hat,
                "ref": window[0],
                "tracking_error": torch.linalg.vector_norm(x_hat[:2] - window[0][:2]),
            }
            return u, (z_next, P_next, u_next), aux

        return policy_fn
