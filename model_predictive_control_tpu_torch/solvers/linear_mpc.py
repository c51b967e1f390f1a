"""Constrained linear MPC over a condensed box-QP (port of
``solvers/linear_mpc.py``): problem data, controller construction and the
batch-level receding-horizon policy.

This slice covers the hard-constrained regulation controller with the plain
``terminal="Q"`` cost. The DARE terminal cost, the terminal set, the soft
state boxes and reference tracking come with ROADMAP S2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.linear import LinearSystem, session2_dynamics
from ..ops.condensed import CondensedQP, build_condensed_qp
from ..ops.cuda.admm_kernel import DEFAULT_TILE, admm_solve_cuda, admm_solve_twin
from ..utils.device import resolve_device
from ..utils.precision import set_solver_precision
from .qp import QPOperator, admm_solve, qp_setup

_S2 = "not ported yet (ROADMAP S2)"
# tiled backends: the fused kernel (its twin on CPU tensors), the twin alone
_TILED = {"cuda": admm_solve_cuda, "twin": admm_solve_twin}


@dataclasses.dataclass(frozen=True)
class Problem:
    """Session-2/3 problem data: ``x = (p, v)``, position below ``p_max``,
    acceleration inputs. Defaults are session 2's."""

    Ts: float = 0.3
    Q: tuple = (10.0, 1.0)
    R: tuple = (0.01,)
    p_min: float = -150.0
    p_max: float = 1.0
    v_min: float = -20.0
    v_max: float = 25.0
    u_min: float = -20.0
    u_max: float = 10.0
    N: int = 5

    def system(self, dtype=torch.float32, device=None) -> LinearSystem:
        """A = [[1, Ts], [0, 1]], B = [[0], [Ts]], on ``device`` (the card
        when ``None``)."""
        return session2_dynamics(self.Ts, dtype, device)

    @property
    def n_state(self) -> int:
        return 2

    @property
    def n_input(self) -> int:
        return 1


def session2_problem(N: int = 5) -> Problem:
    return Problem(N=N)


def session3_problem(N: int = 5) -> Problem:
    """Relaxed lower bounds of session 3."""
    return Problem(p_min=-120.0, v_min=-50.0, N=N)


@dataclasses.dataclass(frozen=True)
class BoxProblem:
    """Box-constrained linear-MPC data: any ``(A, B)``, full weights and
    elementwise boxes, held as float64 numpy and converted by the builders."""

    A: np.ndarray  # (nx, nx)
    B: np.ndarray  # (nx, nu)
    Q: np.ndarray  # (nx, nx) or diagonal (nx,)
    R: np.ndarray  # (nu, nu) or diagonal (nu,)
    x_min: np.ndarray  # (nx,)
    x_max: np.ndarray
    u_min: np.ndarray  # (nu,)
    u_max: np.ndarray
    N: int = 5

    def __post_init__(self):
        arr = lambda v: np.asarray(v, dtype=np.float64)
        A, B, Q, R = arr(self.A), arr(self.B), arr(self.Q), arr(self.R)
        Q = np.diag(Q) if Q.ndim == 1 else Q
        R = np.diag(R) if R.ndim == 1 else R
        nx, nu = B.shape
        if A.shape != (nx, nx) or Q.shape != (nx, nx) or R.shape != (nu, nu):
            raise ValueError(
                f"inconsistent shapes: A {A.shape}, B {B.shape}, Q {Q.shape}, "
                f"R {R.shape}"
            )
        box = lambda v, k: np.broadcast_to(arr(v), (k,)).copy()
        for name, value in (
            ("A", A), ("B", B), ("Q", Q), ("R", R),
            ("x_min", box(self.x_min, nx)), ("x_max", box(self.x_max, nx)),
            ("u_min", box(self.u_min, nu)), ("u_max", box(self.u_max, nu)),
        ):
            object.__setattr__(self, name, value)

    def system(self, dtype=torch.float32, device=None) -> LinearSystem:
        device = resolve_device(device)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return LinearSystem(A=t(self.A), B=t(self.B))

    @property
    def n_state(self) -> int:
        return self.B.shape[0]

    @property
    def n_input(self) -> int:
        return self.B.shape[1]


def as_box_problem(problem) -> BoxProblem:
    """Normalize a session :class:`Problem` (or pass a :class:`BoxProblem`)."""
    if isinstance(problem, BoxProblem):
        return problem
    Ts = problem.Ts
    return BoxProblem(
        A=np.array([[1.0, Ts], [0.0, 1.0]]),
        B=np.array([[0.0], [Ts]]),
        Q=np.diag(np.asarray(problem.Q, dtype=np.float64)),
        R=np.diag(np.asarray(problem.R, dtype=np.float64)),
        x_min=np.array([problem.p_min, problem.v_min]),
        x_max=np.array([problem.p_max, problem.v_max]),
        u_min=np.array([problem.u_min]),
        u_max=np.array([problem.u_max]),
        N=problem.N,
    )


@dataclasses.dataclass(frozen=True)
class LinearMPC:
    """Receding-horizon linear MPC over a condensed box-QP. The QP family and
    its operator are built once; each step solves ``(q, l, u)`` of the
    measured states."""

    qp: CondensedQP
    op: QPOperator
    iters: int = 200

    @property
    def N(self) -> int:
        return self.qp.N

    def _shift_warm(self, x, y, axis: int = 0):
        """Shift a warm start one stage along ``axis``: repeat the last input
        block of the primal, zero the freed input and state dual rows."""
        nu, nx, N = self.qp.nu, self.qp.nx, self.qp.N

        def roll(v, d, repeat):
            size = v.shape[axis]
            tail = v.narrow(axis, size - d, d) if repeat else torch.zeros_like(
                v.narrow(axis, 0, d)
            )
            return torch.cat([v.narrow(axis, d, size - d), tail], dim=axis)

        y_in, y_st = torch.split(y, (N * nu, N * nx), dim=axis)
        y_warm = torch.cat([roll(y_in, nu, False), roll(y_st, nx, False)], dim=axis)
        return roll(x, nu, True), y_warm

    def batched_policy(
        self, backend: str = "cuda", tile: int = DEFAULT_TILE, chunks: int = 2,
        max_rho_moves: int | None = None, schedule: str = "uniform",
        alpha: float = 1.6, polish: bool = True, probe_iters: int | None = None,
    ):
        """Batch-level policy for :func:`..control.batch_loop.simulate_batch`:
        ``(x_batch (B, nx), t, (warm_x, warm_y)) -> (u0 (B, nu), carry, aux)``.

        ``backend="cuda"`` solves through the fused kernel (its plain twin for
        CPU tensors); ``"twin"`` runs the twin on any device, the kernel's
        reference on the card; ``"xla"`` is the per-scenario batched
        :func:`..solvers.qp.admm_solve` with per-scenario ρ adaptation.
        """
        nu = self.qp.nu
        if backend not in _TILED and backend != "xla":
            raise ValueError(f"unknown backend {backend!r}")
        kw = {} if probe_iters is None else {"probe_iters": probe_iters}

        def policy_fn(x_batch, t, carry):
            warm_x, warm_y = carry
            q, l, u = self.qp.qp_vectors(x_batch)
            if backend == "xla":
                sol = admm_solve(self.op, q, l, u, iters=self.iters, warm=(warm_x, warm_y))
            else:
                sol = _TILED[backend](
                    self.op, q, l, u, warm_x, warm_y, iters=self.iters,
                    chunks=chunks, max_rho_moves=max_rho_moves,
                    schedule=schedule, tile=tile, alpha=alpha, polish=polish,
                    **kw,
                )
            x_warm, y_warm = self._shift_warm(sol.x, sol.y, axis=1)
            aux = {
                "solver_success": sol.converged,
                "prim_res": sol.prim_res,
                "dual_res": sol.dual_res,
            }
            return sol.x[:, :nu], (x_warm, y_warm), aux

        return policy_fn

    def initial_batch_carry(self, batch: int, dtype=torch.float32, device=None):
        device = resolve_device(device)
        return (
            torch.zeros(batch, self.qp.n, dtype=dtype, device=device),
            torch.zeros(batch, self.qp.m, dtype=dtype, device=device),
        )

    def presolve_batch_carry(
        self, x_batch, iters_mult: int = 4, backend: str = "cuda",
        tile: int = DEFAULT_TILE,
    ):
        """Warm-start carry from one deeper cold solve at the initial states:
        ``iters_mult`` times the budget in ``2 * iters_mult`` chunks, ρ
        adaptation and polish on, no probe chunk."""
        q, l, u = self.qp.qp_vectors(x_batch)
        if backend == "xla":
            sol = admm_solve(self.op, q, l, u, iters=self.iters * iters_mult)
        else:
            warm_x, warm_y = self.initial_batch_carry(
                x_batch.shape[0], dtype=q.dtype, device=q.device
            )
            sol = _TILED[backend](
                self.op, q, l, u, warm_x, warm_y, iters=self.iters * iters_mult,
                chunks=2 * iters_mult, probe_iters=0, tile=tile,
            )
        return (sol.x, sol.y)


def make_box_mpc(
    box: BoxProblem,
    solver: str = "admm",
    iters: int = 200,
    dtype=torch.float32,
    device=None,
    terminal: str = "Q",
    x_ref=None,
    rho: float = 0.1,
    soft_state: bool = False,
    terminal_set: bool = False,
) -> LinearMPC:
    """Build a :class:`LinearMPC` from :class:`BoxProblem` data on ``device``
    (the card when ``None``) in ``dtype``. Only ``solver="admm"``, ``terminal="Q"``, no reference,
    no soft boxes and no terminal set are ported so far."""
    if solver != "admm":
        raise NotImplementedError(f"solver={solver!r} is {_S2}")
    if terminal != "Q":
        raise NotImplementedError(f"terminal={terminal!r} is {_S2}")
    if soft_state:
        raise NotImplementedError(f"soft_state is {_S2}")
    if terminal_set:
        raise NotImplementedError(f"terminal_set is {_S2}")
    if x_ref is not None:
        raise NotImplementedError(f"x_ref tracking is {_S2}")
    set_solver_precision()
    device = resolve_device(device)
    box = as_box_problem(box)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Q = t(box.Q)
    qp = build_condensed_qp(
        t(box.A), t(box.B), Q, t(box.R), Q, box.N,
        u_min=t(box.u_min), u_max=t(box.u_max),
        x_min=t(box.x_min), x_max=t(box.x_max),
    )
    return LinearMPC(qp=qp, op=qp_setup(qp.P, qp.A_c, rho=rho), iters=iters)


def make_linear_mpc(problem, **kwargs) -> LinearMPC:
    """Build a :class:`LinearMPC` from a session :class:`Problem` or a
    :class:`BoxProblem`; see :func:`make_box_mpc` for the options."""
    return make_box_mpc(as_box_problem(problem), **kwargs)
