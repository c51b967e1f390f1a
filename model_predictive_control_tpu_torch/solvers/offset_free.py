"""Offset-free linear MPC: disturbance observer and target calculation (port
of ``solvers/offset_free.py``).

The model is augmented with a constant disturbance, ``x⁺ = A x + B u + B_d d``,
``d⁺ = d``, ``y = C x + C_d d``; a steady-state Kalman observer on the
augmented system estimates ``(x̂, d̂)``; the target ``(x_s, u_s)`` that holds
the tracked outputs ``H y`` at ``r`` despite ``d̂`` solves

    [A − I  B] [x_s]   [−B_d d̂]
    [H C    0] [u_s] = [ r − H C_d d̂ ],

whose pseudo-inverse is a float64 set-up; the condensed MPC runs in
deviation variables ``(x − x_s, u − u_s)``, its bounds shifted by the target.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..estimation import kalman_gain
from ..models.linear import LinearSystem
from ..ops.cuda.admm_kernel import DEFAULT_TILE
from ..utils.device import resolve_device
from ..utils.precision import set_solver_precision
from .linear_mpc import _TILED, LinearMPC, _squeeze, as_box_problem, make_box_mpc
from .qp import admm_solve, pdip_solve


@dataclasses.dataclass(frozen=True)
class OffsetFreeMPC:
    """Observer-augmented MPC with zero steady-state output offset. Its
    policies take measurements ``y``; the carry is ``(x̂, d̂, warm)``."""

    inner: LinearMPC
    system: LinearSystem  # the model (A, B, C)
    Bd: torch.Tensor  # (nx, nd)
    Cd: torch.Tensor  # (ny, nd)
    L: torch.Tensor  # (nx + nd, ny) augmented observer gain
    T_d: torch.Tensor  # (nx + nu, nd): [x_s; u_s] = T_d d̂ + T_r r
    T_r: torch.Tensor  # (nx + nu, nr)
    r: torch.Tensor  # (nr,)

    def _targets(self, d_hat):
        t = d_hat @ self.T_d.T + self.r @ self.T_r.T
        nx = self.system.A.shape[0]
        return t[..., :nx], t[..., nx:]

    def _deviation_vectors(self, dx0, x_s, u_s):
        qp = self.inner.qp
        q, l, u = qp.qp_vectors(dx0)
        shift = torch.cat([u_s.repeat(*([1] * (u_s.ndim - 1)), qp.N),
                           x_s.repeat(*([1] * (x_s.ndim - 1)), qp.N)], dim=-1)
        return q, l - shift, u - shift

    def _correct(self, y, x_hat, d_hat):
        C, Cd = self.system.C, self.Cd
        nx = C.shape[1]
        corr = (y - (x_hat @ C.T + d_hat @ Cd.T)) @ self.L.T
        return x_hat + corr[..., :nx], d_hat + corr[..., nx:]

    def solve_deviation(self, dx0, x_s, u_s, warm=None):
        """The deviation QP at one estimate, by ``self.inner.solver``:
        ``(du_traj (N, nu), sol)``."""
        qp, op = self.inner.qp, self.inner.op
        q, l, u = self._deviation_vectors(dx0[None], x_s[None], u_s[None])
        if self.inner.solver == "admm":
            w = None if warm is None else (warm[0][None], warm[1][None])
            sol = admm_solve(op, q, l, u, iters=self.inner.iters, warm=w)
        elif self.inner.solver == "pdip":
            sol = pdip_solve(op, q, l, u, iters=self.inner.iters)
        else:
            raise ValueError(f"unknown solver {self.inner.solver!r}")
        sol = _squeeze(sol)
        return sol.x[: qp.N * qp.nu].reshape(qp.N, qp.nu), sol

    def policy(self):
        """Measurement-driven policy for :func:`..control.simulate.simulate`."""
        A, B = self.system.A, self.system.B

        def policy_fn(y, t, carry):
            set_solver_precision()
            x_hat, d_hat, warm = carry
            x_hat, d_hat = self._correct(y, x_hat, d_hat)
            x_s, u_s = self._targets(d_hat)
            du_traj, sol = self.solve_deviation(x_hat - x_s, x_s, u_s, warm)
            u = du_traj[0] + u_s
            x_next = A @ x_hat + B @ u + self.Bd @ d_hat
            aux = {
                "solver_success": sol.converged,
                "state_prediction": self.inner.qp.predict_states(x_hat - x_s, sol.x) + x_s,
                "input_prediction": du_traj + u_s,
                "state_estimate": x_hat,
                "disturbance_estimate": d_hat,
                "target_state": x_s,
                "target_input": u_s,
            }
            return u, (x_next, d_hat, self.inner._shift_warm(sol.x, sol.y)), aux

        return policy_fn

    def initial_carry(self, xhat0, dtype=torch.float32, device=None):
        xhat0 = torch.as_tensor(xhat0, dtype=dtype, device=device)
        nd = self.Bd.shape[1]
        return (xhat0, torch.zeros(nd, dtype=dtype, device=xhat0.device),
                self.inner.initial_carry(dtype, xhat0.device))

    def batched_policy(self, backend: str = "cuda", tile: int = DEFAULT_TILE, chunks: int = 2,
                       max_rho_moves: int | None = None, schedule: str = "uniform",
                       alpha: float = 1.6):
        """Batch-level policy on measurement batches ``y (B, ny)``: the
        observer and target updates are batched products, the deviation QP
        goes through the fused kernel (``"cuda"``, its twin on CPU tensors),
        the twin (``"twin"``) or the per-scenario :func:`..solvers.qp.
        admm_solve` (``"xla"``). Carry from :meth:`initial_batch_carry`."""
        if backend not in _TILED and backend != "xla":
            raise ValueError(f"unknown backend {backend!r}")
        A, B = self.system.A, self.system.B
        op, nu = self.inner.op, self.inner.qp.nu

        def policy_fn(y_batch, t, carry):
            set_solver_precision()
            x_hat, d_hat, (warm_x, warm_y) = carry
            x_hat, d_hat = self._correct(y_batch, x_hat, d_hat)
            x_s, u_s = self._targets(d_hat)
            q, l, u = self._deviation_vectors(x_hat - x_s, x_s, u_s)
            if backend == "xla":
                sol = admm_solve(op, q, l, u, iters=self.inner.iters, warm=(warm_x, warm_y))
            else:
                sol = _TILED[backend](op, q, l, u, warm_x, warm_y, iters=self.inner.iters,
                                      chunks=chunks, max_rho_moves=max_rho_moves,
                                      schedule=schedule, tile=tile, alpha=alpha)
            u_apply = sol.x[:, :nu] + u_s
            x_next = x_hat @ A.T + u_apply @ B.T + d_hat @ self.Bd.T
            aux = {
                "solver_success": sol.converged,
                "prim_res": sol.prim_res,
                "dual_res": sol.dual_res,
                "disturbance_estimate": d_hat,
                "target_state": x_s,
                "target_input": u_s,
            }
            warm = self.inner._shift_warm(sol.x, sol.y, axis=1)
            return u_apply, (x_next, d_hat, warm), aux

        return policy_fn

    def initial_batch_carry(self, xhat0_batch, dtype=torch.float32):
        xhat0_batch = xhat0_batch.to(dtype)
        B, nd = xhat0_batch.shape[0], self.Bd.shape[1]
        return (xhat0_batch, torch.zeros(B, nd, dtype=dtype, device=xhat0_batch.device),
                self.inner.initial_batch_carry(B, dtype=dtype, device=xhat0_batch.device))


def make_offset_free_mpc(
    problem, r, H=None, C=None, Bd=None, Cd=None, Qw_scale: float = 1e-3,
    Qd_scale: float = 1.0, Rv_scale: float = 1e-4, solver: str = "admm", iters: int = 200,
    dtype=torch.float32, rho: float = 0.1, device=None,
) -> OffsetFreeMPC:
    """Build an offset-free MPC from session-2/3 ``Problem`` data or any
    ``BoxProblem`` on ``device`` (the card when ``None``). ``r``: reference
    of the tracked outputs ``H C x`` (default: the first ``nd`` outputs);
    ``C``: the measurement map (default identity); ``Bd``/``Cd``: the
    disturbance model (default an input disturbance, ``Bd = B``,
    ``Cd = 0``); ``Qd_scale``: the observer's integral bandwidth. The
    observer DARE is solved in float64."""
    device = resolve_device(device)
    box = as_box_problem(problem)
    A, B = box.A, box.B
    nx, nu = B.shape
    C = np.eye(nx) if C is None else np.asarray(C, dtype=np.float64)
    ny = C.shape[0]
    Bd = B.copy() if Bd is None else np.asarray(Bd, dtype=np.float64)
    nd = Bd.shape[1]
    Cd = np.zeros((ny, nd)) if Cd is None else np.asarray(Cd, np.float64)
    H = np.eye(ny)[:nd] if H is None else np.asarray(H, np.float64)
    nr = H.shape[0]
    if nr != nd:
        raise ValueError(
            f"need as many tracked outputs as disturbances ({nr} vs {nd}) "
            "for a square target system"
        )
    T = np.block([[A - np.eye(nx), B], [H @ C, np.zeros((nr, nu))]])
    if np.linalg.matrix_rank(T) < nx + nu:
        raise ValueError("target system singular: (A, B, HC) cannot hold r")
    rhs_d = np.concatenate([-Bd, -H @ Cd], axis=0)
    rhs_r = np.concatenate([np.zeros((nx, nr)), np.eye(nr)], axis=0)
    T_inv = np.linalg.pinv(T)
    T_d, T_r = T_inv @ rhs_d, T_inv @ rhs_r
    res = max(float(np.abs(T @ T_d - rhs_d).max()), float(np.abs(T @ T_r - rhs_r).max()))
    if res > 1e-8:
        raise ValueError(
            f"target system overdetermined (residual {res:.2e}): with "
            f"{nr} tracked outputs and {nu} inputs the references are not "
            "achievable; offset-free tracking needs nr <= nu in general"
        )

    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    aug = LinearSystem(
        A=f64(np.block([[A, Bd], [np.zeros((nd, nx)), np.eye(nd)]])),
        B=f64(np.concatenate([B, np.zeros((nd, nu))], axis=0)),
        C=f64(np.concatenate([C, Cd], axis=1)),
    )
    Qw = np.block([[Qw_scale * np.eye(nx), np.zeros((nx, nd))],
                   [np.zeros((nd, nx)), Qd_scale * np.eye(nd)]])
    kf = kalman_gain(aug, f64(Qw), f64(Rv_scale * np.eye(ny)))

    inner = make_box_mpc(box, solver=solver, iters=iters, dtype=dtype, device=device,
                         terminal="dare", rho=rho)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
    return OffsetFreeMPC(
        inner=inner, system=LinearSystem(A=t(A), B=t(B), C=t(C)), Bd=t(Bd), Cd=t(Cd),
        L=t(kf.L.numpy()), T_d=t(T_d), T_r=t(T_r), r=t(np.atleast_1d(r)),
    )
