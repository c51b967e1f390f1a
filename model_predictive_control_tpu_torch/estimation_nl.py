"""Nonlinear moving-horizon estimation (port of ``estimation_nl.py``): a
Gauss-Newton MHE for the bicycle tiers.

- decision vector ``z = [x₀; w₀..w_{M−1}]`` (the linear MHE's condensing,
  :class:`.estimation.MHE`), window states by the nonlinear rollout
  ``x_{k+1} = F(x_k, u_k) + w_k``;
- the nonlinear least-squares residual (arrival, process and measurement
  terms, square-root weighted), its Jacobian by ``torch.func.jacfwd``
  through the rollout, mapped over a batch of windows with
  ``torch.func.vmap``;
- per Gauss-Newton iteration the state bounds bound the step ``δz`` as a
  box-QP on the linearized window states, solved by the port's batched
  interior point (``pdip_solve``, one QP per window) or ADMM (``admm_solve``
  on each window's operator);
- optional arrival-covariance propagation (the filtering form: an EKF step
  at the window head between windows).

In the linear-Gaussian unconstrained limit one Gauss-Newton step is exact and
the estimator is the linear MHE / the Kalman filter.

:meth:`NonlinearMHE.solve_batch_fused` maps the bounded window NLP onto the
fused tracker kernel's additive input mode (``ops/cuda/ilqr_factory.py``): the
decision inputs are the process noises, the recorded plant inputs ride the
exogenous operand with a gate γ that makes a prepended virtual stage the
identity carrying the arrival cost, the measurements are a selector tracking
reference, and the state box holds at every knot through the stage and the
terminal rows.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .ops.cuda.ilqr_factory import DEFAULT_TILE, TrackerModel, fused_tracker_solve_cuda
from .solvers.qp import QPMatrices, admm_solve, pdip_solve, qp_setup
from .utils.precision import set_solver_precision
from .utils.smallsolve import solve_spd

# the finite stand-in for an absent bound of the bounded GN step
_BIG = 1e19
# the gated instantiation of a tracker model, where the kernel library holds one
_GATED_KERNELS = {"kinematic_const": "gated_kinematic"}


class NonlinearMHE:
    """Gauss-Newton MHE over a fixed window of ``M`` steps.

    Parameters
    ----------
    step_fn : discrete dynamics ``F(x, u) -> x⁺`` on one state ``(nx,)``.
    obs_fn : measurement map ``h(x) -> y``.
    Qw, Rv : process / measurement noise covariances (tensors; their dtype
        and device are the estimator's).
    P0 : arrival covariance (initial; propagated when ``propagate_arrival``).
    M : window length (``M`` process steps, ``M+1`` measurements).
    x_min, x_max : optional hard state bounds on the window states x₀..x_M.
    gn_iters : fixed Gauss-Newton iterations per window (1 is exact in the
        linear limit).
    qp_iters : inner-QP iterations for each bounded step.
    qp_solver : ``"pdip"`` (default) or ``"admm"``.
    propagate_arrival : update ``P₀`` between windows with the filtering-form
        EKF recursion at the window head instead of freezing it.
    """

    def __init__(
        self,
        step_fn: Callable,
        obs_fn: Callable,
        Qw,
        Rv,
        P0,
        M: int,
        nx: int,
        x_min=None,
        x_max=None,
        gn_iters: int = 3,
        qp_iters: int = 25,
        qp_solver: str = "pdip",
        propagate_arrival: bool = False,
        reg: float = 1e-9,
    ):
        if qp_solver not in ("pdip", "admm"):
            raise ValueError(f"unknown qp_solver {qp_solver!r}")
        self.qp_solver = qp_solver
        self.step_fn = step_fn
        self.obs_fn = obs_fn
        self.Qw = torch.as_tensor(Qw)
        self.Rv = torch.as_tensor(Rv)
        self.P0 = torch.as_tensor(P0)
        self.M = M
        self.nx = nx
        self.ny = self.Rv.shape[0]
        box = lambda b: None if b is None else torch.as_tensor(
            b, dtype=self.P0.dtype, device=self.P0.device)
        self.x_min = box(x_min)
        self.x_max = box(x_max)
        self.bounded = x_min is not None or x_max is not None
        self.gn_iters = gn_iters
        self.qp_iters = qp_iters
        self.propagate_arrival = propagate_arrival
        self.reg = reg
        # square-root weights of the residual
        self.Qw_sqrt_inv = _sqrt_inv(self.Qw)
        self.Rv_sqrt_inv = _sqrt_inv(self.Rv)

    # -- window pieces ------------------------------------------------------

    def _states(self, z, us):
        """Window states x₀..x_M ``(M+1, nx)`` from z = [x₀; w̄]: the
        nonlinear rollout, in z's dtype: under ``torch.func``'s forward mode
        a float32 step times a Python float has a float64 tangent, which only
        a copying cast converts."""
        nx, M = self.nx, self.M
        x = z[:nx]
        w = z[nx:].reshape(M, nx)
        xs = [x]
        for k in range(M):
            x = (self.step_fn(x, us[k]) + w[k]).to(z.dtype, copy=True)
            xs.append(x)
        return torch.stack(xs)

    def _residual(self, z, us, ys, xbar, P0_sqrt_inv):
        nx, M = self.nx, self.M
        X = self._states(z, us)
        w = z[nx:].reshape(M, nx)
        r_arr = P0_sqrt_inv @ (z[:nx] - xbar)
        r_w = (w @ self.Qw_sqrt_inv.T).reshape(-1)
        innov = ys - vmap(self.obs_fn)(X)
        r_y = (innov @ self.Rv_sqrt_inv.T).reshape(-1)
        return torch.cat([r_arr, r_w, r_y])

    def _windows(self, xbars, us, ys, P0s):
        """``B`` window solves at once: ``xbars (B, nx)``, ``us (B, M,
        nu)``, ``ys (B, M+1, ny)``, ``P0s (B, nx, nx)``."""
        set_solver_precision()
        nx, M = self.nx, self.M
        B, dt = xbars.shape[0], xbars.dtype
        P0_sqrt_inv = _sqrt_inv(P0s)
        z = torch.cat([xbars, torch.zeros(B, M * nx, dtype=dt, device=xbars.device)], dim=1)
        eye = torch.eye(z.shape[1], dtype=dt, device=z.device)
        lb = None if self.x_min is None else self.x_min.to(dt).repeat(M + 1)
        ub = None if self.x_max is None else self.x_max.to(dt).repeat(M + 1)
        residual = vmap(self._residual)
        # torch.func's forward mode promotes float32 x Python float to
        # float64: derivatives are cast back to the working dtype
        jac = vmap(jacfwd(self._residual))
        states = vmap(lambda zz, u: self._states(zz, u).reshape(-1))
        states_jac = vmap(jacfwd(lambda zz, u: self._states(zz, u).reshape(-1)))
        for _ in range(self.gn_iters):
            r = residual(z, us, ys, xbars, P0_sqrt_inv)
            J = jac(z, us, ys, xbars, P0_sqrt_inv).to(dt)
            H = J.transpose(1, 2) @ J + self.reg * eye
            g = (J.transpose(1, 2) @ r[..., None])[..., 0]
            if not self.bounded:
                dz = -torch.linalg.solve(H, g)
            else:
                # the linearized window states bound the STEP: A_c dz within
                # the box shifted by the current states
                X = states(z, us)
                A_c = states_jac(z, us).to(dt)
                l_rows = torch.full_like(X, -_BIG) if lb is None else lb - X
                u_rows = torch.full_like(X, _BIG) if ub is None else ub - X
                # only the primal step is read: no polish
                if self.qp_solver == "admm":
                    dz = torch.cat([
                        admm_solve(qp_setup(H[b], A_c[b], rho=0.1, n_rho_levels=1), g[b : b + 1],
                                   l_rows[b : b + 1], u_rows[b : b + 1], iters=self.qp_iters,
                                   polish=False, adapt_chunks=1).x
                        for b in range(B)
                    ])
                else:
                    dz = pdip_solve(QPMatrices(H, A_c), g, l_rows, u_rows, iters=self.qp_iters,
                                    polish=False).x
            z = z + dz
        X = vmap(self._states)(z, us)
        return X[:, -1], X, z[:, nx:].reshape(B, M, nx)

    # -- solve --------------------------------------------------------------

    def solve(self, xbar, us, ys, P0=None):
        """One window solve → ``(x̂_M, X (M+1, nx), ŵ (M, nx))``.

        ``xbar``: arrival mean for x₀. ``us``: (M, nu). ``ys``: (M+1, ny)
        measurements of x₀..x_M. ``P0`` overrides the build-time arrival
        covariance (the propagating trajectory uses it)."""
        P0 = self.P0 if P0 is None else P0
        x_M, X, w = self._windows(xbar[None], us[None], ys[None], P0[None])
        return x_M[0], X[0], w[0]

    def solve_batch(self, xbars, us, ys, P0s=None):
        """Batched window solves: ``xbars (B, nx)``, ``us (B, M, nu)``,
        ``ys (B, M+1, ny)`` → ``(x̂_M (B, nx), X (B, M+1, nx), ŵ (B, M,
        nx))``, the windows of :meth:`solve` solved together. ``P0s``:
        optional per-window arrival covariances ``(B, nx, nx)``. For the
        throughput path see :meth:`solve_batch_fused`."""
        if P0s is None:
            P0s = self.P0.expand(xbars.shape[0], self.nx, self.nx)
        return self._windows(xbars, us, ys, P0s)

    def solve_batch_fused(
        self, xbars, us, ys, *,
        ode_rows, ts: float, obs_indices: tuple,
        integrator: str = "rk4", substeps: int = 1,
        outer_iters: int = 4, inner_iters: int = 8,
        viol_tol: float = 1e-4, tile: int = DEFAULT_TILE, group: int | None = None,
    ):
        """Batched bounded MHE windows on the fused tracker kernel (its twin
        for CPU tensors). The window NLP in the tracker's OCP shape:

        - **decision inputs = process noises** (nu = nx) entering
          additively after the step (``input_mode="additive"``, B = I);
        - the recorded plant inputs ride the per-stage **exo** operand,
          gated by γ ∈ {0, 1}: the ODE is γ·f(x, u), so the prepended
          virtual stage (γ = 0) is the identity ``x₁ = x̄ + δx₀`` whose input
          δx₀ carries the arrival cost through the per-stage input weights
          (P₀⁻¹ at stage 0, Q_w⁻¹ after: ``input_weights_rt``);
        - measurements are the tracking reference: knot k ≥ 1 holds y_{k−1}
          in the measured components, weighted R_v⁻¹ there and 0 elsewhere
          (``obs_indices`` maps measurement j to state component
          ``obs_indices[j]``);
        - the state box holds at every knot, x_M included, through the
          tracker's ``terminal_state_limits`` rows.

        Requirements: state bounds, DIAGONAL ``Qw``/``Rv``/``P0``, a selector
        ``obs_fn`` consistent with ``obs_indices``, ``x̄`` inside the box.
        ``ode_rows`` is the continuous row-form ODE whose ``integrator`` /
        ``substeps`` / ``ts`` discretization is ``step_fn``; on the card it
        must be a tracker model with a gated instantiation
        (:func:`..models.bicycle.make_kinematic_ode_rows`): a bare row
        function raises ``NotImplementedError`` there (ROADMAP S4.6).

        Returns ``(x̂_M, X, ŵ, converged)``."""
        nx, M = self.nx, self.M
        if self.x_min is None and self.x_max is None:
            raise ValueError(
                "solve_batch_fused requires state bounds (the AL kernel needs constraint "
                "rows); the unbounded window belongs on solve_batch / a Kalman smoother"
            )
        for name, S in (("Qw", self.Qw), ("Rv", self.Rv), ("P0", self.P0)):
            S = S.detach().cpu().numpy()
            if np.abs(S - np.diag(np.diag(S))).max() > 1e-12:
                raise ValueError(f"solve_batch_fused requires diagonal {name}")
        f32, dev = torch.float32, xbars.device
        B = xbars.shape[0]
        nu_m = us.shape[-1]
        N_ocp = M + 1
        diag = lambda S: np.diag(S.detach().cpu().numpy().astype(np.float64))
        qw_inv = torch.as_tensor(1.0 / diag(self.Qw), dtype=f32, device=dev)
        p0_inv = torch.as_tensor(1.0 / diag(self.P0), dtype=f32, device=dev)
        rv_inv = 1.0 / diag(self.Rv)
        qd = np.zeros(nx, np.float32)
        for j, idx in enumerate(obs_indices):
            qd[idx] = float(rv_inv[j])
        # per-stage input weights: the arrival's P0^-1 at the virtual stage,
        # Qw^-1 after
        rw = torch.cat([p0_inv.expand(B, 1, nx), qw_inv.expand(B, M, nx)], dim=1)
        # exo: (γ, u_model) per stage; γ = 0 makes stage 0 the identity
        exo = torch.cat([
            torch.zeros(B, 1, 1 + nu_m, dtype=f32, device=dev),
            torch.cat([torch.ones(B, M, 1, dtype=f32, device=dev), us.to(f32)], dim=-1),
        ], dim=1)
        # measurements as the tracking reference (knot 0 = x̄, constant)
        refs = torch.zeros(B, N_ocp + 1, nx, dtype=f32, device=dev)
        refs[:, 0] = xbars.to(f32)
        for j, idx in enumerate(obs_indices):
            refs[:, 1:, idx] = ys[..., j].to(f32)
        big = 1e9
        as_floats = lambda b, fill: (
            tuple(float(v) for v in b.detach().cpu().tolist()) if b is not None else (fill,) * nx)
        limits = (as_floats(self.x_min, -big), as_floats(self.x_max, big))
        sol = fused_tracker_solve_cuda(
            xbars.to(f32),
            torch.zeros(B, N_ocp, nx, dtype=f32, device=dev),
            refs,
            ode_rows=_gated_ode_rows(ode_rows, nu_m),
            nx=nx, nu=nx, N=N_ocp, ts=float(ts), substeps=substeps,
            integrator=integrator,
            limits=None,  # process noises are unbounded: no input-box rows
            weights=(tuple(float(v) for v in qd), (0.0,) * nx, 1.0),
            state_limits=limits,
            terminal_state_limits=limits,
            input_mode="additive", exo=exo, n_exo=1 + nu_m,
            input_weights_rt=rw,
            outer_iters=outer_iters, inner_iters=inner_iters,
            viol_tol=viol_tol, tile=tile, group=group,
        )
        X = sol.xs[:, 1:]  # knots 1..M+1 = x₀..x_M
        w = sol.us[:, 1:]  # stages 1..M = process noises
        return X[:, -1], X, w, sol.converged

    # -- receding-horizon trajectory ---------------------------------------

    def _arrival_step(self, xbar, P0, y_head, u_head, X, w):
        """The next window's arrival prior: with ``propagate_arrival`` the
        filtering form (an EKF step on the head data only), else the smoothed
        head pushed one step with ``P₀`` frozen."""
        if not self.propagate_arrival:
            return self.step_fn(X[0], u_head) + w[0], P0
        dt = P0.dtype
        I = torch.eye(self.nx, dtype=dt, device=P0.device)
        C = jacfwd(self.obs_fn)(xbar).to(dt)
        S = C @ P0 @ C.T + self.Rv
        K = solve_spd(S, (P0 @ C.T).T).T
        xf = xbar + K @ (y_head - self.obs_fn(xbar))
        KC = K @ C
        P_corr = (I - KC) @ P0 @ (I - KC).T + K @ self.Rv @ K.T
        A = jacfwd(self.step_fn, argnums=0)(xf, u_head).to(dt)
        return self.step_fn(xf, u_head), A @ P_corr @ A.T + self.Qw

    def trajectory(self, xbar0, us, ys):
        """Receding-horizon MHE over a record: window ``k`` estimates
        ``x_{k+M}`` from ``us[k:k+M]``, ``ys[k:k+M+1]``; the arrival prior
        moves between windows as :meth:`_arrival_step` says (the filtering
        arrival cost makes the window ends equal the Kalman filter exactly in
        the linear-Gaussian unconstrained limit). Returns the window-end
        estimates ``(T − M + 1, nx)``."""
        M = self.M
        xbar, P0 = torch.as_tensor(xbar0), self.P0
        ends = []
        for k in range(us.shape[0] - M + 1):
            u_w, y_w = us[k : k + M], ys[k : k + M + 1]
            x_M, X, w = self.solve(xbar, u_w, y_w, P0=P0)
            ends.append(x_M)
            xbar, P0 = self._arrival_step(xbar, P0, y_w[0], u_w[0], X, w)
        return torch.stack(ends)


@functools.lru_cache(maxsize=32)
def _gated_ode_rows(ode_rows, nu_m: int):
    """γ-gated row-form ODE for the fused MHE window: exo = (γ, u_model),
    ẋ = γ·f(x, u). RK4/Euler of γ·f is exactly the identity at γ = 0 (the
    virtual arrival stage) and exactly the model step at γ = 1. A tracker
    model with a gated instantiation (``_GATED_KERNELS``) stays one, in the
    additive mode (nu = nx); cached, so that it keeps one identity."""

    def gated(xr, er):
        gam = er[0]
        um = tuple(er[1 + j] for j in range(nu_m))
        return tuple(gam * r for r in ode_rows(xr, um))

    kernel = _GATED_KERNELS.get(getattr(ode_rows, "kernel", None))
    if isinstance(ode_rows, TrackerModel) and kernel is not None and ode_rows.nu == nu_m:
        return TrackerModel(rows=gated, kernel=kernel, consts=ode_rows.consts, nx=ode_rows.nx,
                            nu=ode_rows.nx)
    return gated


def _sqrt_inv(S):
    """Inverse matrix square root of an SPD matrix (``eigh``; batches too)."""
    vals, vecs = torch.linalg.eigh(S)
    return (vecs / torch.sqrt(torch.clamp(vals, min=1e-30))[..., None, :]) @ vecs.transpose(-1, -2)


def mhe_output_feedback_policy(ctrl, mhe: NonlinearMHE):
    """Close the MPC loop on the MHE: ``policy(y, t, carry)`` for
    :func:`..control.simulate.simulate` driven by measurements, with ``carry
    = (ys_buf (M+1, ny), us_buf (M, nu), x̄, P₀, mpc_carry)`` from
    :func:`initial_mhe_feedback_carry`. Per step: append the measurement to
    the rolling window, solve the MHE for x̂_t, run the controller at x̂_t,
    append the applied input, advance the arrival prior as
    :meth:`NonlinearMHE.trajectory` does.

    The buffers start as if the system had sat at the initial estimate for
    M steps (replicated first measurement, zero inputs): the first M windows
    are warm-up approximations."""
    mpc_policy = ctrl.policy()

    def policy(y, t, carry):
        ys_buf, us_buf, xbar, P0, mpc_carry = carry
        ys_buf = torch.cat([ys_buf[1:], y[None]], dim=0)
        x_t, X, w = mhe.solve(xbar, us_buf, ys_buf, P0=P0)
        u, mpc_carry, aux = mpc_policy(x_t, t, mpc_carry)
        xbar_next, P0_next = mhe._arrival_step(xbar, P0, ys_buf[0], us_buf[0], X, w)
        us_buf = torch.cat([us_buf[1:], u[None]], dim=0)
        return u, (ys_buf, us_buf, xbar_next, P0_next, mpc_carry), dict(aux, state_estimate=x_t)

    return policy


def initial_mhe_feedback_carry(ctrl, mhe: NonlinearMHE, xhat0, nu: int, dtype=torch.float32,
                               device=None):
    """Warm-up carry: buffers as if the system sat at ``xhat0`` for M steps."""
    xhat0 = torch.as_tensor(xhat0, dtype=dtype, device=device)
    y0 = mhe.obs_fn(xhat0)
    return (
        y0[None].repeat(mhe.M + 1, 1),
        torch.zeros(mhe.M, nu, dtype=dtype, device=xhat0.device),
        xhat0,
        mhe.P0.to(dtype=dtype, device=xhat0.device),
        ctrl.initial_carry(dtype, xhat0.device),
    )
