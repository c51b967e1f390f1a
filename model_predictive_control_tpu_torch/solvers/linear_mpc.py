"""Constrained linear MPC over a condensed box-QP (port of
``solvers/linear_mpc.py``): problem data, controller construction and the
batch-level receding-horizon policy.

Options: the DARE terminal cost, the invariant terminal set, slack-softened
state boxes, a baked reference and preview tracking, and the ADMM or the
interior-point solver for single-scenario solves, and the differentiable
solve and policy (``solve(implicit=True)``, ``policy(differentiable=True)``)
through the KKT implicit-function wrapper of :mod:`.implicit`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.linear import LinearSystem, session2_dynamics
from ..obs.profiling import span
from ..ops.condensed import (
    CondensedQP,
    SoftCondensedQP,
    build_condensed_qp,
    soften_condensed_qp,
)
from ..ops.cuda.admm_kernel import DEFAULT_TILE, admm_solve_cuda, admm_solve_twin
from ..ops.riccati import dare_sda
from ..utils.device import resolve_device
from ..utils.precision import set_solver_precision
from .qp import QPOperator, QPSolution, admm_solve, pdip_solve, qp_setup

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


def _roll(v, d: int, repeat: bool, axis: int):
    """Shift ``v`` by ``d`` entries along ``axis``: drop the first ``d``,
    append the last ``d`` again (``repeat``) or zeros."""
    size = v.shape[axis]
    tail = v.narrow(axis, size - d, d) if repeat else torch.zeros_like(v.narrow(axis, 0, d))
    return torch.cat([v.narrow(axis, d, size - d), tail], dim=axis)


def _squeeze(sol: QPSolution) -> QPSolution:
    """A batch-of-one solution as one scenario's."""
    return QPSolution(**{f.name: None if (v := getattr(sol, f.name)) is None else v[0]
                         for f in dataclasses.fields(sol)})


@dataclasses.dataclass(frozen=True)
class LinearMPC:
    """Receding-horizon linear MPC over a condensed box-QP (hard, or with
    slack-softened state boxes). The QP family and its operator are built
    once; each step solves ``(q, l, u)`` of the measured states."""

    qp: CondensedQP | SoftCondensedQP
    op: QPOperator
    iters: int = 200
    terminal_P: torch.Tensor | None = None  # the DARE terminal weight, when used
    solver: str = "admm"
    soft: bool = False

    @property
    def N(self) -> int:
        return self.qp.N

    def _shift_warm(self, x, y, axis: int = 0):
        """Shift a warm start one stage along ``axis``: repeat the last input
        (and slack) block of the primal, zero the freed dual rows of every
        constraint block. Hard layout ``[ū | (in, st)]``, soft layout
        ``[ū, s | (in, up, lo, sl)]``."""
        nu, nx, N = self.qp.nu, self.qp.nx, self.qp.N
        roll = lambda v, d, repeat: _roll(v, d, repeat, axis)
        if not self.soft:
            y_in, y_st = torch.split(y, (N * nu, N * nx), dim=axis)
            y_warm = torch.cat([roll(y_in, nu, False), roll(y_st, nx, False)], dim=axis)
            return roll(x, nu, True), y_warm
        ns = N * nx
        z_u, z_s = torch.split(x, (N * nu, ns), dim=axis)
        x_warm = torch.cat([roll(z_u, nu, True), roll(z_s, nx, True)], dim=axis)
        y_in, y_up, y_lo, y_sl = torch.split(y, (N * nu, ns, ns, ns), dim=axis)
        y_warm = torch.cat(
            [roll(y_in, nu, False), roll(y_up, nx, False), roll(y_lo, nx, False),
             roll(y_sl, nx, False)],
            dim=axis,
        )
        return x_warm, y_warm

    def solve(self, x0, warm=None, q_extra=None, implicit: bool = False):
        """Solve the MPC QP at one measured state ``x0 (nx,)``: ``(u_traj
        (N, nu), sol)``. ``q_extra`` adds to the leading entries of the linear
        term (the ū block; the preview-tracking hook). ``implicit=True`` runs
        the same solve through the KKT implicit-differentiation wrapper
        (:func:`.implicit.implicit_qp_solver`): autograd then flows through
        the solution by one KKT solve, not through the solver's iterations."""
        q, l, u = self.qp.qp_vectors(x0[None])
        if q_extra is not None:
            k = q_extra.shape[-1]
            q = torch.cat([q[:, :k] + q_extra, q[:, k:]], dim=1)
        w = None if warm is None else (warm[0][None], warm[1][None])
        if implicit:
            from .implicit import implicit_qp_solver

            sol = implicit_qp_solver(self.solver, iters=self.iters)(self.op, q, l, u, w)
        elif self.solver == "admm":
            sol = admm_solve(self.op, q, l, u, iters=self.iters, warm=w)
        elif self.solver == "pdip":
            sol = pdip_solve(self.op, q, l, u, iters=self.iters)
        else:
            raise ValueError(f"unknown solver {self.solver!r}")
        sol = _squeeze(sol)
        N, nu = self.qp.N, self.qp.nu
        return sol.x[: N * nu].reshape(N, nu), sol

    def _step(self, x, carry, q_extra=None, implicit: bool = False):
        warm = carry if (isinstance(carry, tuple) and len(carry) == 2) else None
        u_traj, sol = self.solve(x, warm=warm, q_extra=q_extra, implicit=implicit)
        x_warm, y_warm = self._shift_warm(sol.x, sol.y)
        aux = {
            "solver_success": sol.converged,
            "state_prediction": self.qp.predict_states(x, sol.x),
            "input_prediction": u_traj,
            "prim_res": sol.prim_res,
            "dual_res": sol.dual_res,
        }
        if self.soft:
            aux["max_slack"] = sol.x[self.qp.N * self.qp.nu :].max()
        return u_traj[0], (x_warm, y_warm), aux

    def policy(self, differentiable: bool = False):
        """Receding-horizon policy for :func:`..control.simulate.simulate`:
        carry the shifted warm start ``(x, y)`` (``()`` starts cold), aux
        ``solver_success``, ``state_prediction (N, nx)``,
        ``input_prediction (N, nu)``, the residuals (and ``max_slack`` on the
        soft QP). ``differentiable=True`` solves each step implicitly
        differentiable, so that autograd flows through a whole closed loop
        (e.g. the trajectory cost's gradient in ``x0``)."""

        def policy_fn(x, t, carry):
            return self._step(x, carry, implicit=differentiable)

        return policy_fn

    def initial_carry(self, dtype=torch.float32, device=None):
        device = resolve_device(device)
        return (
            torch.zeros(self.qp.n, dtype=dtype, device=device),
            torch.zeros(self.qp.m, dtype=dtype, device=device),
        )

    def tracking_policy(self, ref_traj: torch.Tensor):
        """Preview tracking: at step ``t`` the MPC tracks the window
        ``ref_traj[t+1 : t+1+N]`` of a ``(steps + N, nx)`` reference (padded
        N rows past the run). Build the controller without ``x_ref``. Aux
        adds ``ref``, the stage-1 reference of the step."""
        base = self.qp.base if self.soft else self.qp
        N = base.N

        def policy_fn(x, t, carry):
            window = ref_traj[t + 1 : t + 1 + N]
            u0, carry, aux = self._step(x, carry, q_extra=base.ref_linear_term(window))
            return u0, carry, dict(aux, ref=window[0])

        return policy_fn

    def batched_policy(
        self, backend: str = "cuda", tile: int = DEFAULT_TILE, chunks: int = 2,
        max_rho_moves: int | None = None, schedule: str = "uniform",
        alpha: float = 1.6, polish: bool = True, probe_iters: int | None = None,
        mesh=None,
    ):
        """Batch-level policy for :func:`..control.batch_loop.simulate_batch`:
        ``(x_batch (B, nx), t, (warm_x, warm_y)) -> (u0 (B, nu), carry, aux)``.

        ``backend="cuda"`` solves through the fused kernel (its plain twin for
        CPU tensors); ``"twin"`` runs the twin on any device, the kernel's
        reference on the card; ``"xla"`` is the per-scenario batched
        :func:`..solvers.qp.admm_solve` with per-scenario ρ adaptation. On the
        tiled backends aux adds ``admm_iters (B,)``, the ADMM iterations the
        solve executed for each scenario (its tile's).

        Spans (:mod:`..obs.profiling`): ``policy.qp`` around the QP's vectors,
        ``policy.shift`` around the shifted warm start and the aux; the tiled
        solve's own (``admm.*``) between them.

        ``mesh`` (a device mesh, :mod:`..parallel.mesh`): the policy takes the
        global batch on every rank, each rank solves its data slice on its own
        device, and ``u0`` and the logs are gathered over the data axis; the
        warm-start carry stays with its rank
        (:func:`..parallel.mesh.shard_policy`). With the data slices a
        multiple of ``tile`` apart, the kernel's tiles are those of the
        unsharded call.
        """
        nu, N = self.qp.nu, self.qp.N
        if backend not in _TILED and backend != "xla":
            raise ValueError(f"unknown backend {backend!r}")
        kw = {} if probe_iters is None else {"probe_iters": probe_iters}

        def policy_fn(x_batch, t, carry):
            warm_x, warm_y = carry
            with span("policy.qp"):
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
            with span("policy.shift"):
                x_warm, y_warm = self._shift_warm(sol.x, sol.y, axis=1)
                aux = {
                    "solver_success": sol.converged,
                    "prim_res": sol.prim_res,
                    "dual_res": sol.dual_res,
                }
                if sol.iters is not None:
                    aux["admm_iters"] = sol.iters
                if self.soft:
                    aux["max_slack"] = sol.x[:, N * nu :].amax(dim=1)
            return sol.x[:, :nu], (x_warm, y_warm), aux

        if mesh is not None:
            from ..parallel.mesh import shard_policy

            return shard_policy(policy_fn, mesh)
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
        adaptation and polish on, no probe chunk: the span ``presolve``."""
        with span("presolve"):
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
    slack_weight: float = 100.0,
    slack_linear: float = 1.0,
    terminal_set: bool = False,
) -> LinearMPC:
    """Build a :class:`LinearMPC` from :class:`BoxProblem` data on ``device``
    (the card when ``None``) in ``dtype``.

    ``terminal="dare"`` takes the infinite-horizon Riccati solution as the
    terminal cost; ``terminal_set=True`` (implies it) also bounds ``x_N`` to
    the certified inner box of the invariant DARE ellipsoid
    (:func:`.lqr.lqr_terminal_set`) and certifies the origin, so it refuses
    ``x_ref``. ``soft_state=True`` softens the state boxes with per-stage
    slacks (quadratic weight ``slack_weight``, ℓ1 weight ``slack_linear``).
    ``solver`` is ``"admm"`` or ``"pdip"`` for :meth:`LinearMPC.solve`."""
    if solver not in ("admm", "pdip"):
        raise ValueError(f"unknown solver {solver!r}")
    if terminal not in ("Q", "dare"):
        raise ValueError(f"unknown terminal {terminal!r}")
    set_solver_precision()
    device = resolve_device(device)
    box = as_box_problem(box)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    A, B, Q, R = t(box.A), t(box.B), t(box.Q), t(box.R)
    u_min, u_max, x_min, x_max = t(box.u_min), t(box.u_max), t(box.x_min), t(box.x_max)

    terminal_P = None
    x_term_min = x_term_max = None
    if terminal_set:
        if x_ref is not None:
            raise ValueError("terminal_set certifies the origin; drop x_ref")
        from .lqr import lqr_terminal_set

        terminal_P, _K, _alpha, d = lqr_terminal_set(A, B, Q, R, x_min, x_max, u_min, u_max)
        x_term_min, x_term_max = -d, d
    elif terminal == "dare":
        terminal_P = dare_sda(A, B, Q, R)
    QN = Q if terminal_P is None else terminal_P

    qp = build_condensed_qp(
        A, B, Q, R, QN, box.N, u_min=u_min, u_max=u_max, x_min=x_min, x_max=x_max,
        x_ref=x_ref, x_term_min=x_term_min, x_term_max=x_term_max,
    )
    if soft_state:
        qp = soften_condensed_qp(qp, slack_weight=slack_weight, slack_linear=slack_linear)
    return LinearMPC(
        qp=qp, op=qp_setup(qp.P, qp.A_c, rho=rho), iters=iters, terminal_P=terminal_P,
        solver=solver, soft=soft_state,
    )


def make_linear_mpc(problem, **kwargs) -> LinearMPC:
    """Build a :class:`LinearMPC` from a session :class:`Problem` or a
    :class:`BoxProblem`; see :func:`make_box_mpc` for the options."""
    return make_box_mpc(as_box_problem(problem), **kwargs)
