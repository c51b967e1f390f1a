"""Model-parametric fused AL-iLQR tracker: the hand-written CUDA kernel
(``csrc/ilqr_factory.cu``), its plain-PyTorch twin and the wrapper.

Replaces ``model_predictive_control_tpu/ops/pallas/ilqr_factory.py``
(``_tracker_tile_kernel``, wrapper ``fused_tracker_solve``). One launch runs
the whole augmented-Lagrangian tracking solve for every scenario: the outer
PHR multiplier/μ loop, the inner Levenberg-iLQR on a row-form ODE (exact step
Jacobians by forward-mode dual numbers through the integrator, the regularised
Quu solved as the reference solves it: ``1/q`` at ``nu = 1``, the closed-form
2×2 inverse at ``nu = 2``, an unrolled Cholesky up to ``nu = 8``) and the
7-step line search.

How a model reaches the kernel: a :class:`TrackerModel` pairs the torch row
function ``(xr, ur[, pr]) -> nx rows`` with the name of its C++ instantiation
and the float constants that instantiation reads; a
:class:`TrackerConstraints` does the same for user constraint rows. The twin
runs the torch rows, on tensors for values and on :class:`Dual` numbers for
derivatives (nested duals for the rows' curvature); the kernel runs the C++
functors of the same names, templated on the same dual arithmetic. Any
other row function, or a combination of options no hand-written
instantiation holds, runs on a functor generated from the row functions
(:mod:`.tracker_codegen`: traced on symbols, emitted as C++ in the rows'
order of operations, built at first use), the same float program as the
twin.

The whole JAX signature is ported: tracking (``refs``) and regulation
(``refs=None``: x costed against the origin), per-scenario ODE parameters, an
optional input box and an optional state box, user constraint rows
(``extra_constraints`` with ``n_extra``, ``extra_deps``, ``extra_order``),
the multipliers' warm start (``lam_init``), the additive input mode
(``input_mode="additive"`` with ``exo``), per-stage input weights
(``input_weights_rt``), terminal state-box rows (``terminal_state_limits``:
the multipliers then have a row N), per-lane weights (``weights_rt``),
Euler or RK4 prediction with substeps, ``1 ≤ nu ≤ 8``. It raises where the
JAX package raises. The C++ instantiations (:data:`DEFAULT_GROUP`) are the
pairs the paths use, from two sources, one library each per group: the
racing pair (``"kinematic"``, ``"pacejka"``; Euler and RK4, with an input
box) and the benchmark models of :mod:`...models.benchmarks` (RK4, with or
without an input box) from ``csrc/ilqr_factory.cu``; the factory parking OCP
(the kinematic model with the clearance rows at order 2 and 1, each with
constant and per-lane weights) and the nonlinear MHE windows (the gated
kinematic model in the additive mode) from ``csrc/ilqr_factory_ext.cu``, the
generalized solver (in one source with the first, it cost the kinematic
racing launch 5%: PERF.md). A solve with ``lam_init`` on the first
library's models runs on a generated instantiation.

Tile semantics (kept from the reference): the inner exit (every lane's
``max|Qu| < 0.01·tol``) and the outer exit (every lane primal-feasible with
settled multipliers) are tile-wide; padded lanes (zero state, controls,
reference and parameters) vote in both. ``inner_iters_executed`` is the
tile's summed inner count. :func:`tracker_tiles_reference` is the plain twin
of the same tile algorithm on stage-major ``(stage, row, lane)`` operands;
:func:`fused_tracker_solve_cuda` takes it only for CPU tensors.

Lane groups: on the card ``group`` threads serve one lane (the Jacobian
directions of all stages and the line-search candidates are dealt to them;
``csrc/ilqr_factory.cu``), so a CTA has ``tile × group`` threads. ``tile``
keeps its meaning, lanes per CTA, and the numbers of a solve depend on the
tile only: every group computes the same float program. One library is built
per group. :func:`launch_plan` reckons, for ``(nx, N, nc, tile, group)``, the
threads, the regions of a lane's working set that fit into shared memory and
the workspace for the rest, and raises on what the kernel cannot take.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import inspect
import math
from typing import Callable

import torch

from ._build import PKG, load_library
from .ilqr_kernel import (
    ALPHAS,
    REG_INIT,
    REG_MAX,
    REG_MIN,
    SMEM_LIMIT,
    LaunchPlan,
    _relu,
    plan_launch,
    resolve_group,
)

MAX_NX = 8  # csrc/ilqr_factory.cu MAXX
MAX_NU = 8  # csrc/ilqr_factory.cu MAXU: the unrolled Cholesky's widest Quu
MAX_CONSTS = 16  # csrc/ilqr_factory.cu MAXC
MAX_EXTRA_CONSTS = 16  # csrc/ilqr_factory.cu MAXE
# GPU default scenario tile and (below) thread group, chosen by a tile × group
# sweep on the H100 at both racing sweeps' contract configurations, by the
# time the sweeps spend in the kernel (PERF.md, Findings): 128 CTAs for 2,048
# lanes, about one per SM, and the tile-wide exits fire earlier than at 64
DEFAULT_TILE = 16
# threads per lane a library can be built for, and the threads per CTA
# (tile × group) its launch bounds allow (csrc/ilqr_factory.cu MAX_THREADS)
GROUPS = (1, 8, 16, 32)
MAX_THREADS = {1: 256, 8: 512, 16: 512, 32: 512}
# default group per C++ instantiation, from the same sweep (the racing pair),
# from a launch sweep at the benchmark sweeps' shapes, and from one at the
# factory parking sweep's and the MHE windows' shapes (PERF.md, Findings)
DEFAULT_GROUP = {"kinematic": 8, "pacejka": 32, "cartpole": 8, "quadrotor": 8,
                 "omnibase": 8, "omnibase_param": 8, "thruster": 8,
                 "kinematic_clearance_o2": 8, "kinematic_clearance_o2_wrt": 8,
                 "kinematic_clearance_o1": 8, "kinematic_clearance_o1_wrt": 8,
                 "gated_kinematic": 8, "kinematic_wrt": 8}
# What the first library holds beyond RK4 with an input box, as the paths use
# the models: Euler (with the box) for the racing pair, the solve without an
# input box (RK4) for the benchmark models. The input box is a compile-time
# property of an instantiation: as a runtime flag it cost the kinematic
# launch 12% (PERF.md, Findings).
BASE_KERNELS = ("kinematic", "pacejka", "cartpole", "quadrotor", "omnibase", "omnibase_param",
                "thruster")
EULER_KERNELS = ("kinematic", "pacejka")
NO_INPUT_BOX_KERNELS = ("cartpole", "quadrotor", "omnibase", "omnibase_param", "thruster")
# The second library (csrc/ilqr_factory_ext.cu): each instantiation built
# with one integrator, its input box present or not, terminal rows, per-stage
# input weights and the additive mode as listed, and its rows' dependency
# columns.
_PARKING_BUILD = dict(integrator="euler", ubox=True, tbox=False, rw=False, additive=False,
                      deps=(0, 1, 2))
EXT_BUILDS = {
    "kinematic_clearance_o2": _PARKING_BUILD,
    "kinematic_clearance_o2_wrt": _PARKING_BUILD,
    "kinematic_clearance_o1": _PARKING_BUILD,
    "kinematic_clearance_o1_wrt": _PARKING_BUILD,
    "gated_kinematic": dict(integrator="rk4", ubox=False, tbox=True, rw=True, additive=True),
    # the no-obstacle parking OCP with per-lane weights (the tuning layer's
    # fused forward): no user rows
    "kinematic_wrt": dict(_PARKING_BUILD, deps=()),
}
EXT_KERNELS = tuple(EXT_BUILDS)
# threads per lane of a generated instantiation's library (one group is built
# per library at first use unless another is asked)
GENERATED_GROUP = 8
N_ALPHA = len(ALPHAS)

# Kernel launches made by fused_tracker_solve_cuda (one per solve), in all and
# by instantiation (:func:`instantiation`). Tests and chip_smoke.py read them
# to show that a run went through the kernel.
LAUNCHES = 0
LAUNCHES_BY_KERNEL = dict.fromkeys(DEFAULT_GROUP, 0)

LIBRARY = "ilqr_factory"  # library_name(group) is the file's stem
_SOURCES = [PKG / "csrc" / "ilqr_factory.cu"]
_EXT_SOURCES = [PKG / "csrc" / "ilqr_factory_ext.cu"]
# the twin rounds after every operation; so does the kernel without
# contraction into fused multiply-adds (as K2, PERF.md)
NVCC_EXTRA = ("--fmad=false",)


@dataclasses.dataclass(frozen=True)
class BatchedTrackerSolution:
    us: torch.Tensor  # (B, N, nu)
    xs: torch.Tensor  # (B, N + 1, nx)
    viol: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,) bool
    lam: torch.Tensor  # (B, N[+1], nc) AL multipliers (the warm-start handle)
    inner_iters_executed: torch.Tensor  # (B,) the tile's inner iterations


@dataclasses.dataclass(frozen=True)
class TrackerModel:
    """A row-form ODE with a C++ instantiation in ``csrc/ilqr_factory.cu``.

    ``rows(xr, ur[, pr])`` is the torch row function (``nx`` state rows,
    ``nu`` input rows and, with ``n_params``, the parameter rows), written
    with operations :class:`Dual` supports. ``kernel`` names the C++ functor
    (entry ``tracker_<kernel>_launch``) and ``consts`` lists the float
    constants it reads, in its order. Calling the model calls ``rows``.

    The functor does the rows' operations in the rows' order, so that twin
    and kernel are one float program. Mind that torch computes a number
    divided by a tensor as the number times the tensor's reciprocal: write
    it so in C++ too (only ``1 / x`` is the same either way)."""

    rows: Callable
    kernel: str
    consts: tuple
    nx: int
    nu: int
    n_params: int = 0

    def __call__(self, *args):
        return self.rows(*args)


@dataclasses.dataclass(frozen=True)
class TrackerConstraints:
    """User constraint rows ``c(x, u[, p]) ≤ 0`` with a C++ instantiation in
    ``csrc/ilqr_factory.cu``.

    ``rows(xr, ur[, pr])`` is the torch row function (``n_extra`` rows, the
    operations :class:`Dual` supports, nested too), ``kernel`` names the C++
    functor (the instantiation's name carries it, :func:`instantiation`),
    ``consts`` lists the float constants it reads in its order, and ``deps``
    the z columns (x rows, then u rows) the rows depend on, as the C++
    functor's ``dep``. Calling it calls ``rows``."""

    rows: Callable
    kernel: str
    consts: tuple
    n_extra: int
    deps: tuple

    def __call__(self, *args):
        return self.rows(*args)


# ---------------------------------------------------------------------------
# forward-mode dual numbers (the twin's step Jacobians)
# ---------------------------------------------------------------------------


class Dual:
    """A value ``v`` and its tangents ``d`` (one per direction, along the
    leading dimension of ``d``). Python operators and the torch functions in
    :data:`_DUAL_FUNCS` act on it; every rule is the one the kernel's
    ``Dual<W>`` applies, in the same float order. Derivatives at kinks
    follow JAX's jvp rules: ``abs`` takes ``+d`` at 0, ``clamp`` (JAX's
    ``maximum``/``minimum`` against a constant) takes half the tangent at a
    tie, ``where`` the chosen branch's. Tensors and floats mixed in are
    constants (zero tangent)."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v = v
        self.d = d

    def __add__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v + o.v, self.d + o.d)
        return Dual(self.v + o, self.d)

    def __radd__(self, o):
        return Dual(o + self.v, self.d)

    def __sub__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v - o.v, self.d - o.d)
        return Dual(self.v - o, self.d)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.d)

    def __mul__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v * o.v, self.d * o.v + self.v * o.d)
        return Dual(self.v * o, self.d * o)

    def __rmul__(self, o):
        return Dual(o * self.v, o * self.d)

    def __truediv__(self, o):
        if isinstance(o, Dual):
            q = self.v / o.v
            return Dual(q, (self.d - q * o.d) / o.v)
        return Dual(self.v / o, self.d / o)

    def __rtruediv__(self, o):
        q = o / self.v
        return Dual(q, -(q * self.d) / self.v)

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __ge__(self, o):
        return self.v >= _value(o)

    def __gt__(self, o):
        return self.v > _value(o)

    def __le__(self, o):
        return self.v <= _value(o)

    def __lt__(self, o):
        return self.v < _value(o)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        rule = _DUAL_FUNCS.get(func)
        if rule is None:
            raise NotImplementedError(
                f"{func} has no dual-number rule: the tracker twin differentiates "
                f"only {sorted(f.__name__ for f in _DUAL_FUNCS)}"
            )
        return rule(*args, **(kwargs or {}))


def _value(a):
    return a.v if isinstance(a, Dual) else a


def _tan(a):
    t = torch.tan(a.v)
    return Dual(t, a.d * (1.0 + t * t))


def _sqrt(a):
    s = torch.sqrt(a.v)
    return Dual(s, a.d * (0.5 / s))


def _tanh(a):
    t = torch.tanh(a.v)
    return Dual(t, a.d * (1.0 - t * t))


def _clamp(a, min=None, max=None):
    """``clamp`` against one constant bound, with ``jnp.maximum``'s /
    ``jnp.minimum``'s balanced tangent (weight 1, ½ at a tie, 0)."""
    if (min is None) == (max is None):
        raise NotImplementedError("the dual clamp takes one constant bound")
    if min is not None:
        v, side = torch.clamp(a.v, min=min), a.v > min
        tie = a.v == min
    else:
        v, side = torch.clamp(a.v, max=max), a.v < max
        tie = a.v == max
    w = torch.where(side, 1.0, torch.where(tie, 0.5, 0.0))
    return Dual(v, a.d * w)


def _where(cond, a, b):
    d = a.d if isinstance(a, Dual) else torch.zeros_like(b.d)
    e = b.d if isinstance(b, Dual) else torch.zeros_like(a.d)
    return Dual(torch.where(cond, _value(a), _value(b)), torch.where(cond, d, e))


def _swap(op):  # tensor (op) Dual, dispatched as Tensor.op(tensor, dual)
    return lambda t, a: getattr(a, op)(t)


_DUAL_FUNCS = {
    torch.sin: lambda a: Dual(torch.sin(a.v), a.d * torch.cos(a.v)),
    torch.cos: lambda a: Dual(torch.cos(a.v), -(a.d * torch.sin(a.v))),
    torch.tan: _tan,
    torch.sqrt: _sqrt,
    torch.atan: lambda a: Dual(torch.atan(a.v), a.d / (1.0 + a.v * a.v)),
    torch.tanh: _tanh,
    torch.abs: lambda a: Dual(torch.abs(a.v), torch.where(a.v >= 0.0, a.d, -a.d)),
    torch.clamp: _clamp,
    torch.where: _where,
    torch.Tensor.add: _swap("__radd__"),
    torch.Tensor.sub: _swap("__rsub__"),
    torch.Tensor.mul: _swap("__rmul__"),
    torch.Tensor.div: _swap("__rtruediv__"),
}


def _integrate(call, xr, h, substeps: int, rk4: bool):
    """``substeps`` classic RK4 or forward-Euler sub-steps of ``ẋ =
    call(x)`` (the reference's ``_integrate``), on tensors or duals. The
    sum ``k1 + 2 k2 + 2 k3 + k4`` runs left to right, as in the reference
    and the kernel."""
    nx = len(xr)
    h_half, h_sixth = 0.5 * h, h / 6.0
    for _ in range(substeps):
        k = call(xr)
        if not rk4:
            xr = tuple(xr[i] + h * k[i] for i in range(nx))
            continue
        acc = list(k)
        xs = tuple(xr[i] + h_half * k[i] for i in range(nx))
        k = call(xs)
        acc = [acc[i] + 2.0 * k[i] for i in range(nx)]
        xs = tuple(xr[i] + h_half * k[i] for i in range(nx))
        k = call(xs)
        acc = [acc[i] + 2.0 * k[i] for i in range(nx)]
        xs = tuple(xr[i] + h * k[i] for i in range(nx))
        k = call(xs)
        acc = [acc[i] + k[i] for i in range(nx)]
        xr = tuple(xr[i] + h_sixth * acc[i] for i in range(nx))
    return xr


def _step(ode_rows, xr, ur, pr, h, substeps: int, rk4: bool):
    """One prediction interval of the row-form ODE (``pr``: parameter rows
    or ``None``)."""
    if pr is None:
        return _integrate(lambda x: ode_rows(x, ur), tuple(xr), h, substeps, rk4)
    return _integrate(lambda x: ode_rows(x, ur, pr), tuple(xr), h, substeps, rk4)


def step_jacobian(ode_rows, x, u, pr=None, *, ts: float, substeps: int, integrator: str):
    """Exact Jacobians of one prediction interval at ``(x, u)`` by one dual
    pass over all ``nx + nu`` directions (the reference's packed jvp):
    ``A[k, i] = ∂x⁺_k/∂x_i`` ``(nx, nx, ...)`` and ``B[k, j] = ∂x⁺_k/∂u_j``
    ``(nx, nu, ...)``. ``x`` and ``u`` are sequences of same-shaped tensors
    (rows), ``pr`` the parameter rows."""
    nx, nu = len(x), len(u)
    NZ = nx + nu
    eye = torch.eye(NZ, dtype=x[0].dtype, device=x[0].device)
    seed = lambda p: eye[p].reshape(NZ, *([1] * x[0].ndim)).expand(NZ, *x[0].shape)
    xd = tuple(Dual(x[i], seed(i)) for i in range(nx))
    ud = tuple(Dual(u[j], seed(nx + j)) for j in range(nu))
    out = _step(ode_rows, xd, ud, pr, ts / substeps, substeps, integrator == "rk4")
    return torch.stack([o.d[:nx] for o in out]), torch.stack([o.d[nx:] for o in out])


@functools.lru_cache(maxsize=64)
def step_jacobian_pattern(ode_rows, nx: int, nu: int, n_params: int = 0):
    """Structural sparsity of the discrete step's Jacobian, from the
    dependency graph of the row function (the JAX package's
    ``step_jacobian_pattern``, which walks a jaxpr).

    Traces ``ode_rows`` once on symbols (:func:`.tracker_codegen.trace`):
    output row r depends on input z_d iff a chain of operations connects
    them (a ``where`` counts its condition and both branches). The one-step
    map (Euler or RK4, any substep count) then has the A pattern of the
    boolean closure of (I ∪ S_x) and the B pattern closure @ S_u:
    conservative, so a False entry is a structural zero of ∂x⁺/∂z. Returns
    ``(A_pat, B_pat)`` as tuples of tuples of bool; where the row function
    cannot be traced, fully dense (all True)."""
    import numpy as np

    from . import tracker_codegen

    dense = (
        tuple((True,) * nx for _ in range(nx)),
        tuple((True,) * nu for _ in range(nx)),
    )
    try:
        tr = tracker_codegen.trace(ode_rows, nx, nu, n_params, n_out=nx)
    except Exception:  # analysis is best-effort, as the JAX package's
        return dense
    deps: list[frozenset] = []  # input indices z_d each node depends on
    for node in tr.nodes:
        if node.op == "x":
            deps.append(frozenset([node.args[0]]))
        elif node.op == "u":
            deps.append(frozenset([nx + node.args[0]]))
        elif node.op == "p":
            deps.append(frozenset())
        else:  # an operation: its operands' (constants carry none)
            deps.append(frozenset().union(*(deps[a] for a in node.args if isinstance(a, int))))
    S = np.zeros((nx, nx + nu), dtype=bool)
    for r, o in enumerate(tr.outputs):
        for d in (deps[o] if isinstance(o, int) else ()):
            S[r, d] = True
    # closure of the one-substep state map I ∪ S_x
    R = np.eye(nx, dtype=bool) | S[:, :nx]
    for _ in range(nx):
        R = R | (R @ R)
    return (
        tuple(tuple(bool(b) for b in row) for row in R),
        tuple(tuple(bool(b) for b in row) for row in R @ S[:, nx:]),
    )


def rowform_to_vector(ode_rows, nx: int, nu: int):
    """Adapt a row-form ODE to the ``(x, u) -> ẋ`` convention of the
    integrators (state and input in the last dimension, any batch shape in
    front), so one definition serves the kernel and a vector-form caller."""

    def ode(x, u):
        xr = tuple(x[..., i] for i in range(nx))
        ur = tuple(u[..., j] for j in range(nu))
        return torch.stack(tuple(ode_rows(xr, ur)), dim=-1)

    return ode


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------


def _resolve_deps(extra_deps, nx: int, nu: int) -> tuple:
    """The z columns (x rows, then u rows) the user rows depend on."""
    if extra_deps == "xu":
        return tuple(range(nx + nu))
    if extra_deps == "x":
        return tuple(range(nx))
    return tuple(int(d) for d in extra_deps)


def tracker_tiles_reference(
    x0, u0, refs, par, *, ode_rows, nx, nu, N, tile, ts, substeps, integrator,
    limits, state_limits, weights, outer_iters, inner_iters, mu_init, mu_scale,
    mu_max, viol_tol, tol, extra_constraints=None, n_extra=0, extra_deps=(), extra_order=2,
    input_mode="ode", exo=None, rw=None, wrt=None, terminal_state_limits=None, lam0=None,
):
    """Plain-PyTorch twin of the kernel on stage-major padded operands.

    ``x0`` is ``(nx, Bp)``, ``u0`` ``(N, nu, Bp)``, ``refs`` ``(N+1, nx,
    Bp)`` or ``None`` (regulation), ``par`` ``(n_params, Bp)`` or ``None``,
    with ``Bp`` a multiple of ``tile``; ``limits`` or ``state_limits`` may be
    ``None``. The other operands, each ``None`` where the solve has none:
    ``exo`` ``(N, n_exo, Bp)`` (the additive mode's exogenous rows), ``rw``
    ``(N, nu, Bp)`` (per-stage Rd), ``wrt`` ``(nx + nu + 1, Bp)`` (per-lane
    ``[Qd, Rd, qn]`` in place of ``weights``), ``lam0`` ``(n_lam, nc, Bp)``
    (the multipliers' warm start); ``extra_constraints`` gives ``n_extra``
    rows ``c ≤ 0`` on the resolved dependency columns ``extra_deps``, at
    derivative order ``extra_order``. Works on ``(Bp/T, T)`` lane views with
    per-tile masks and tile-wide loop exits; the 7 line-search rollouts run as
    one leading dimension. Every operation is the kernel's, in its order.
    Returns ``us (N, nu, Bp)``, ``xs (N+1, nx, Bp)``, ``viol (Bp,)``,
    ``converged (Bp,)``, ``lam (n_lam, nc, Bp)`` and the tile's executed inner
    iterations ``(Bp,)``.
    """
    dev, f32 = x0.device, torch.float32
    Bp = x0.shape[-1]
    T = tile
    nt = Bp // T
    ubox, sbox = limits is not None, state_limits is not None
    tbox = terminal_state_limits is not None
    n_extra = n_extra if extra_constraints is not None else 0
    nc = (2 * nu if ubox else 0) + (2 * nx if sbox else 0) + n_extra
    n_lam = N + 1 if tbox else N
    additive = input_mode == "additive"
    rk4 = integrator == "rk4"
    h = ts / substeps
    lanes = lambda a: a.reshape(*a.shape[:-1], nt, T)
    full = lambda v: torch.full((nt, T), v, dtype=f32, device=dev)
    # float32 constant columns (n, 1, 1), made once (on a card, each is a copy)
    col = lambda v: torch.tensor(v, dtype=f32, device=dev).reshape(-1, 1, 1)
    A_LS = len(ALPHAS)
    alpha = col(ALPHAS)
    idx = torch.arange(nx, device=dev)
    # the weights (constant columns, or the lane's rows) and the products the
    # solver reads, 2 Qd, 2 Rd and (2 qn) Qd, in float32
    if wrt is None:
        QD, RD, QN = weights
        qd, rd = col(QD), col(RD)
        qnqd2 = (2.0 * torch.tensor(QN, dtype=f32, device=dev)) * qd
    else:
        wl = lanes(wrt)
        qd, rd, QN = wl[:nx], wl[nx : nx + nu], wl[nx + nu]
        qnqd2 = (2.0 * QN) * qd
    qd2, rd2 = 2.0 * qd, 2.0 * rd
    rws = lanes(rw) if rw is not None else None

    def rd_of(t):  # Rd and 2 Rd of stage t
        return (rd, rd2) if rws is None else (rws[t], 2.0 * rws[t])

    if ubox:
        lbu, ubu = (col(b) for b in limits)
    if sbox:
        lbx, ubx = (col(b) for b in state_limits)
    if tbox:
        tlb, tub = (col(b) for b in terminal_state_limits)
    # a column against (n, nt, T) rows, or against (n, A, nt, T) candidate packs
    fit = lambda c, X: c if X.ndim == 3 else c[:, None]

    x0 = lanes(x0)
    # regulation costs x against the origin: x - 0 has the bits of x
    refs = (lanes(refs) if refs is not None
            else torch.zeros(N + 1, nx, nt, T, dtype=f32, device=dev))
    us = lanes(u0).clone()
    pr = tuple(lanes(par)) if par is not None else None
    exos = lanes(exo) if exo is not None else None
    lam = (lanes(lam0).clone() if lam0 is not None
           else torch.zeros(n_lam, nc, nt, T, dtype=f32, device=dev))
    xs = torch.empty(N + 1, nx, nt, T, dtype=f32, device=dev)
    k_s = torch.zeros(N, nu, nt, T, dtype=f32, device=dev)
    K_s = torch.zeros(N, nu * nx, nt, T, dtype=f32, device=dev)
    deps = tuple(extra_deps)
    NE = len(deps)
    pos = {d: p for p, d in enumerate(deps)}
    base = (2 * nu if ubox else 0) + (2 * nx if sbox else 0)  # the user rows' first multiplier

    def ode(xr, dr):
        return ode_rows(xr, dr) if pr is None else ode_rows(xr, dr, pr)

    def step(xr, ur, t):
        """One interval: the model's step, or in the additive mode step(x;
        exo_t) + u."""
        if additive:
            er = tuple(exos[t])
            base_x = _integrate(lambda x: ode(x, er), tuple(xr), h, substeps, rk4)
            return tuple(base_x[i] + ur[i] for i in range(nx))
        return _integrate(lambda x: ode(x, tuple(ur)), tuple(xr), h, substeps, rk4)

    def jacobians(X, U, t):
        """A (nx, nx, nt, T) and B (nx, nu, nt, T) (``None`` in the additive
        mode, where B = I), one dual pass over the directions."""
        if not additive:
            return step_jacobian(ode_rows, X, U, pr, ts=ts, substeps=substeps,
                                 integrator=integrator)
        eye = torch.eye(nx, dtype=f32, device=dev)
        xd = tuple(Dual(X[i], eye[i].reshape(nx, 1, 1).expand(nx, nt, T)) for i in range(nx))
        er = tuple(exos[t])
        out = _integrate(lambda x: ode(x, er), xd, h, substeps, rk4)
        return torch.stack([o.d for o in out]), None

    def extra_rows(X, U):
        xr, ur = tuple(X), tuple(U)
        rows = extra_constraints(xr, ur) if pr is None else extra_constraints(xr, ur, pr)
        return list(rows)

    def fold(rows):  # left-to-right sum over the leading dimension
        s = rows[0]
        for v in rows[1:]:
            s = s + v
        return s

    # Below, a row or matrix entry is one slice of a stacked tensor, and
    # each element sees the kernel's operations in the kernel's order; only
    # independent entries are batched together.

    def constraint_rows(X, U):
        """With the input box [u − ub_u, lb_u − u], with the state box [x −
        ub_x, lb_x − x], then the user rows, stacked ``(nc, ...)``."""
        rows = [U - fit(ubu, U), fit(lbu, U) - U] if ubox else []
        if sbox:
            rows += [X - fit(ubx, X), fit(lbx, X) - X]
        if n_extra:
            rows.append(torch.stack(extra_rows(X, U)))
        return torch.cat(rows)

    def terminal_rows(X):
        return torch.cat([X - fit(tub, X), fit(tlb, X) - X])

    def quad_err(X, r):
        e = X - r
        return fold(fit(qd, X) * e * e)

    def stage_cost(X, U, lam_t, mu, r, t):
        """Stage cost of stacked states ``(nx, ...)`` and inputs ``(nu, ...)``
        (``...`` = ``(nt, T)`` or ``(A, nt, T)``)."""
        if X.ndim == 4:
            lam_t, r = lam_t[:, None], r[:, None]
        quad = quad_err(X, r) + fold(fit(rd_of(t)[0], U) * U * U)
        act = _relu(lam_t + mu * constraint_rows(X, U))
        return quad + fold(act * act - lam_t * lam_t) / (2.0 * mu)

    def terminal_cost(X, r, mu):
        c = QN * quad_err(X, r)
        if tbox:
            lam_t = lam[N][: 2 * nx]
            if X.ndim == 4:
                lam_t = lam_t[:, None]
            act = _relu(lam_t + mu * terminal_rows(X))
            c = c + fold(act * act - lam_t * lam_t) / (2.0 * mu)
        return c

    def total_cost(mu):
        cost = stage_cost(xs[0], us[0], lam[0], mu, refs[0], 0)
        for t in range(1, N):
            cost = cost + stage_cost(xs[t], us[t], lam[t], mu, refs[t], t)
        return cost + terminal_cost(xs[N], refs[N], mu)

    def rollout():
        xs[0] = x0
        for t in range(N):
            xs[t + 1] = torch.stack(step(xs[t], us[t], t))

    def stage_derivs(X, U, lam_t, mu, r, t):
        """lx, lu and the diagonals of lxx and luu (the tracking cost and
        the box rows touch only diagonals)."""
        rd_t, rd2_t = rd_of(t)
        lu = rd2_t * U
        huu = rd2_t.expand(nu, nt, T)
        if ubox:
            act_u = _relu(lam_t[:nu] + mu * (U - ubu))
            act_l = _relu(lam_t[nu : 2 * nu] + mu * (lbu - U))
            lu = lu + act_u - act_l
            huu = rd2_t + mu * ((act_u > 0.0).to(f32) + (act_l > 0.0).to(f32))
        lx = qd2 * (X - r)
        hxx = qd2.expand(nx, nt, T)
        if sbox:
            o = 2 * nu if ubox else 0
            act_u = _relu(lam_t[o : o + nx] + mu * (X - ubx))
            act_l = _relu(lam_t[o + nx : o + 2 * nx] + mu * (lbx - X))
            lx = lx + (act_u - act_l)
            hxx = hxx + mu * ((act_u > 0.0).to(f32) + (act_l > 0.0).to(f32))
        return lx, lu, hxx, huu

    def extra_record(X, U, lam_t, mu):
        """The user rows' derivative record of a stage (the kernel's
        ``extra_items``): the gradient Σ_r act_r ∂c_r (NE rows), and per
        pair ``a ≤ b`` of dependency columns the Gauss-Newton term Σ_r μ
        1[act_r > 0] ∂_a c_r ∂_b c_r and, at order 2, the curvature term Σ_r
        act_r ∂²c_r/∂_a∂_b (column b by one pass of nested duals, the rows
        contracted with the frozen act first)."""
        z = list(X) + list(U)
        eye = torch.eye(max(NE, 1), dtype=f32, device=dev)
        seed = lambda c: (eye[pos[c]].reshape(NE, 1, 1).expand(NE, nt, T) if c in pos
                          else torch.zeros(NE, nt, T, dtype=f32, device=dev))
        zd = [Dual(z[c], seed(c)) for c in range(nx + nu)]
        rows = extra_rows(zd[:nx], zd[nx:])
        act = [_relu(lam_t[base + r] + mu * rows[r].v) for r in range(n_extra)]
        ind = [mu * (a > 0.0).to(f32) for a in act]
        grad = [fold([act[r] * rows[r].d[a] for r in range(n_extra)]) for a in range(NE)]
        gn = {(a, b): fold([(ind[r] * rows[r].d[a]) * rows[r].d[b] for r in range(n_extra)])
              for a in range(NE) for b in range(a, NE)}
        curv = {}
        if extra_order == 2:
            zero = torch.zeros(NE, nt, T, dtype=f32, device=dev)
            for q in range(NE):
                zh = [Dual(Dual(z[c], seed(c)),
                           Dual(torch.full_like(z[c], 1.0 if pos.get(c) == q else 0.0), zero))
                      for c in range(nx + nu)]
                rh = extra_rows(zh[:nx], zh[nx:])
                ws = rh[0] * act[0]
                for r in range(1, n_extra):
                    ws = ws + rh[r] * act[r]
                for a in range(q, NE):
                    curv[(q, a)] = ws.d.d[a]
        return grad, gn, curv

    def outer(a, b):  # (m, ...) × (n, ...) -> (m, n, ...) products a_i b_j
        return a[:, None] * b[None]

    jdx = torch.arange(nu, device=dev)

    def quu_solve(quu, Qu, Qux, reg):
        """``kg = −Quu_r⁻¹ Qu`` ``(nu, ...)`` and ``Kg = −Quu_r⁻¹ Qux``
        ``(nu, nx, ...)`` with ``Quu_r = Quu + reg I``, and whether it was
        found positive definite: ``1/q`` at nu = 1, the closed-form inverse at
        nu = 2, an unrolled Cholesky with a forward and a backward sweep per
        right-hand side beyond (the reference's three forms)."""
        if nu <= 2:
            q00r = quu[0, 0] + reg
            if nu == 1:
                ok = q00r > 0.0
                inv = (1.0 / torch.where(q00r > 0.0, q00r, torch.ones_like(q00r)))[None, None]
            else:
                q11r = quu[1, 1] + reg
                q01 = quu[0, 1]
                det = q00r * q11r - q01 * q01
                ok = (q00r > 0.0) & (det > 0.0)
                det_safe = torch.where(det > 0.0, det, torch.ones_like(det))
                inv = torch.stack([torch.stack([q11r / det_safe, -q01 / det_safe]),
                                   torch.stack([-q01 / det_safe, q00r / det_safe])])
            # columns of the inverse against the rows of Qu and Qux
            kg = -fold([inv[:, b] * Qu[b] for b in range(nu)])
            Kg = -fold([outer(inv[:, b], Qux[b]) for b in range(nu)])
            return kg, Kg, ok
        ok = torch.ones(nt, T, dtype=torch.bool, device=dev)
        L = [[None] * nu for _ in range(nu)]
        for a in range(nu):
            for b in range(a + 1):
                s = quu[a, b] + reg if a == b else quu[a, b]
                for v in range(b):
                    s = s - L[a][v] * L[b][v]
                if a == b:
                    ok = ok & (s > 0.0)
                    L[a][a] = torch.sqrt(torch.where(s > 0.0, s, torch.ones_like(s)))
                else:
                    L[a][b] = s / L[b][b]
        rhs = torch.cat([Qu[:, None], Qux], dim=1)  # (nu, 1 + nx, ...): every column at once
        y = []
        for a in range(nu):
            s = rhs[a]
            for v in range(a):
                s = s - L[a][v] * y[v]
            y.append(s / L[a][a])
        sol = [None] * nu
        for a in reversed(range(nu)):
            s = y[a]
            for v in range(a + 1, nu):
                s = s - L[v][a] * sol[v]
            sol[a] = s / L[a][a]
        sol = torch.stack(sol)
        return -sol[:, 0], -sol[:, 1:], ok

    def backward(mu, reg):
        """Riccati sweep over (xs, us); writes the gains, returns (ok, grad).
        ``V`` is Vxx ``(nx, nx, nt, T)``; ``A[k]``, ``B[k]``, ``M[k]`` are
        rows k of the step Jacobians and of Vxx A."""
        Vx = qnqd2 * (xs[N] - refs[N])
        V = torch.zeros(nx, nx, nt, T, dtype=f32, device=dev)
        V[idx, idx] = qnqd2.expand(nx, nt, T)
        if tbox:
            act_u = _relu(lam[N][:nx] + mu * (xs[N] - tub))
            act_l = _relu(lam[N][nx : 2 * nx] + mu * (tlb - xs[N]))
            Vx = Vx + (act_u - act_l)
            V[idx, idx] = V[idx, idx] + mu * ((act_u > 0.0).to(f32) + (act_l > 0.0).to(f32))
        ok = torch.ones(nt, T, dtype=torch.bool, device=dev)
        grad = full(0.0)
        for t in range(N - 1, -1, -1):
            X, U = xs[t], us[t]
            A, B = jacobians(X, U, t)
            lx, lu, hxx, huu = stage_derivs(X, U, lam[t], mu, refs[t], t)
            # the user rows' entries of the stage Hessian, by (column, column)
            hz = {}
            if n_extra:
                g, gn, curv = extra_record(X, U, lam[t], mu)
                lx, lu, hxx, huu = list(lx), list(lu), list(hxx), list(huu)
                for a, d in enumerate(deps):
                    if d < nx:
                        lx[d] = lx[d] + g[a]
                    else:
                        lu[d - nx] = lu[d - nx] + g[a]
                for a in range(NE):
                    for b in range(a, NE):
                        d1, d2 = sorted((deps[a], deps[b]))
                        if d1 == d2:
                            hb = hxx if d1 < nx else huu
                            k = d1 if d1 < nx else d1 - nx
                            hb[k] = hb[k] + gn[(a, b)]
                            if (a, b) in curv:
                                hb[k] = hb[k] + curv[(a, b)]
                        else:
                            v = 0.0 + gn[(a, b)]
                            if (a, b) in curv:
                                v = v + curv[(a, b)]
                            hz[(d1, d2)] = v
                lx, lu, hxx, huu = (torch.stack(v) for v in (lx, lu, hxx, huu))
            Qx = fold([lx] + [A[k] * Vx[k] for k in range(nx)])
            Qu = lu + Vx if additive else fold([lu] + [B[k] * Vx[k] for k in range(nx)])
            M = fold([outer(V[:, k], A[k]) for k in range(nx)])  # Vxx A
            if additive:  # B = I: Quu = luu + Vxx, Qux = lux + M
                quu = V.clone()
                quu[jdx, jdx] = huu + V[jdx, jdx]
                Qux = M.clone()
                for (d1, d2), v in hz.items():
                    if d1 >= nx:
                        quu[d1 - nx, d2 - nx] = v + V[d1 - nx, d2 - nx]
                        quu[d2 - nx, d1 - nx] = v + V[d2 - nx, d1 - nx]
                    elif d2 >= nx:
                        Qux[d2 - nx, d1] = v + M[d2 - nx, d1]
            P = fold([outer(A[k], M[k]) for k in range(nx)])  # Aᵀ Vxx A
            Qxx = 0.5 * (P + P.transpose(0, 1))
            Qxx[idx, idx] = Qxx[idx, idx] + hxx
            for (d1, d2), v in hz.items():
                if d2 < nx:
                    Qxx[d1, d2] = Qxx[d1, d2] + v
                    Qxx[d2, d1] = Qxx[d2, d1] + v
            if not additive:
                VB = fold([outer(V[:, m], B[m]) for m in range(nx)])  # Vxx B
                BVB = fold([outer(B[k], VB[k]) for k in range(nx)])  # off-diagonal Quu
                quu_d = fold([huu] + [B[k] * VB[k] for k in range(nx)])  # diagonal Quu
                Qux = fold([outer(B[k], M[k]) for k in range(nx)])
                quu = BVB.clone()
                quu[jdx, jdx] = quu_d
                for (d1, d2), v in hz.items():
                    if d1 >= nx:
                        a, b = d1 - nx, d2 - nx
                        quu[a, b] = fold([v] + [B[k, a] * VB[k, b] for k in range(nx)])
                        quu[b, a] = fold([v] + [B[k, b] * VB[k, a] for k in range(nx)])
                    elif d2 >= nx:
                        a = d2 - nx
                        Qux[a, d1] = fold([v] + [B[k, a] * M[k, d1] for k in range(nx)])
            kg, Kg, ok_t = quu_solve(quu, Qu, Qux, reg)
            ok = ok & ok_t
            # Vx, Vxx with the unregularised Quu (quu[:, b]: its column b)
            g = fold([quu[:, b] * kg[b] for b in range(nu)]) + Qu
            Vx = (Qx + fold([Kg[a] * g[a] for a in range(nu)])) + fold(
                [Qux[a] * kg[a] for a in range(nu)])
            KQ = fold([outer(quu[:, b], Kg[b]) for b in range(nu)])
            V = (
                (Qxx + fold([outer(Kg[a], KQ[a]) for a in range(nu)]))
                + fold([outer(Kg[a], Qux[a]) for a in range(nu)])
            ) + fold([outer(Qux[a], Kg[a]) for a in range(nu)])
            k_s[t] = kg
            K_s[t] = Kg.reshape(nu * nx, nt, T)
            grad_t = Qu[0].abs()
            for a in range(1, nu):
                grad_t = torch.maximum(grad_t, Qu[a].abs())
            grad = torch.maximum(grad, grad_t)
        return ok, grad

    def forward_all(mu):
        """Closed-loop rollouts under u = (uh + α k) + K (x − xh) for every α
        at once; returns the costs (A, nt, T) and the candidate packs."""
        xs_p = torch.empty(N + 1, nx, A_LS, nt, T, dtype=f32, device=dev)
        us_p = torch.empty(N, nu, A_LS, nt, T, dtype=f32, device=dev)
        x = x0[:, None].expand(nx, A_LS, nt, T)
        cost = None
        for t in range(N):
            xs_p[t] = x
            Kg = K_s[t].reshape(nu, nx, 1, nt, T)
            dx = x - xs[t][:, None]
            u = (us[t][:, None] + alpha * k_s[t][:, None]) + fold([Kg[:, j] * dx[j] for j in range(nx)])
            us_p[t] = u
            sc = stage_cost(x, u, lam[t], mu, refs[t], t)
            cost = sc if cost is None else cost + sc
            x = torch.stack(step(tuple(x), tuple(u), t))
        xs_p[N] = x
        return cost + terminal_cost(x, refs[N][:, None], mu), xs_p, us_p

    def pick(pack, idx):  # (S, R, A, nt, T) -> (S, R, nt, T) at each lane's α
        i = idx.expand(pack.shape[0], pack.shape[1], 1, nt, T)
        return pack.gather(2, i).squeeze(2)

    def ilqr(mu, active):
        """Levenberg iLQR on the current multipliers for the tiles in
        ``active`` (nt,); returns each tile's executed iterations."""
        nonlocal xs, us
        cost = total_cost(mu)
        reg = full(REG_INIT)
        grad = full(math.inf)
        n_it = torch.zeros(nt, dtype=torch.long, device=dev)
        while True:
            run = active & (n_it < inner_iters) & ~(grad < 0.01 * tol).all(dim=1)
            if not bool(run.any()):
                return n_it
            run2 = run[:, None]
            ok, grad_n = backward(mu, reg)
            costs, xs_p, us_p = forward_all(mu)
            costs = torch.where(torch.isfinite(costs), costs, math.inf)
            best = costs.amin(dim=0)
            # ties go to the largest step: the first α at the minimum
            idx = (costs <= best).to(torch.uint8).argmax(dim=0)
            improved = (best < cost - 1e-12) & ok & run2
            take = improved[None, None]
            idx = idx[None, None, None].long()
            xs = torch.where(take, pick(xs_p, idx), xs)
            us = torch.where(take, pick(us_p, idx), us)
            cost = torch.where(improved, best, cost)
            reg_n = torch.where(
                improved, torch.clamp(reg * 0.5, min=REG_MIN), torch.clamp(reg * 10.0, max=REG_MAX)
            )
            reg = torch.where(run2, reg_n, reg)
            grad = torch.where(run2, grad_n, grad)
            n_it = n_it + run.long()

    rollout()
    mu, viol, lam_step = full(mu_init), full(math.inf), full(math.inf)
    oi = torch.zeros(nt, dtype=torch.long, device=dev)
    ni = torch.zeros(nt, dtype=torch.long, device=dev)
    while True:
        solved = ((viol < viol_tol) & (lam_step < 1e-3)).all(dim=1)
        run = (oi < outer_iters) & ~solved
        if not bool(run.any()):
            break
        run2 = run[:, None]
        ni = ni + ilqr(mu, run)
        # multiplier sweep: violation, λ update, λ step (the terminal rows
        # last, the rest of their row zero)
        v_n = step_n = lmax = full(0.0)
        for t in range(N):
            c = constraint_rows(xs[t], us[t])
            lam_n = _relu(lam[t] + mu * c)
            v_n = torch.maximum(v_n, _relu(c).amax(dim=0))
            step_n = torch.maximum(step_n, (lam_n - lam[t]).abs().amax(dim=0))
            lmax = torch.maximum(lmax, lam_n.abs().amax(dim=0))
            lam[t] = torch.where(run2, lam_n, lam[t])
        if tbox:
            c = terminal_rows(xs[N])
            lam_t = lam[N][: 2 * nx]
            lam_n = _relu(lam_t + mu * c)
            v_n = torch.maximum(v_n, _relu(c).amax(dim=0))
            step_n = torch.maximum(step_n, (lam_n - lam_t).abs().amax(dim=0))
            lmax = torch.maximum(lmax, lam_n.abs().amax(dim=0))
            row = torch.cat([lam_n, torch.zeros(nc - 2 * nx, nt, T, dtype=f32, device=dev)])
            lam[N] = torch.where(run2, row, lam[N])
        mu_n = torch.where(v_n > viol_tol, torch.clamp(mu * mu_scale, max=mu_max), mu)
        mu = torch.where(run2, mu_n, mu)
        viol = torch.where(run2, v_n, viol)
        lam_step = torch.where(run2, step_n / (1.0 + lmax), lam_step)
        oi = oi + run.long()

    flat = lambda a: a.reshape(*a.shape[:-2], Bp)
    ni = ni.to(f32)[:, None].expand(nt, T)
    return flat(us), flat(xs), flat(viol), flat(viol < viol_tol), flat(lam), flat(ni)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _consts(nx: int, nu: int, mc: tuple, ec: tuple, *, ts, substeps, limits, state_limits,
            weights, mu_init, mu_scale, mu_max, viol_tol, tol, terminal_state_limits=None,
            ext=False):
    """The float constants in the order of ``struct Consts``
    (``csrc/ilqr_factory.cu``; with ``ext``, ``csrc/ilqr_factory_ext.cu``'s,
    which adds the constraint rows' constants and the terminal box), state-
    and input-sized ones padded with zeros (an absent box is zeros too; so
    are the weights where they are per lane). ``mc`` and ``ec`` are the
    model's and the constraint rows' constants.
    The products 2 Qd, 2 Rd and (2 qn) Qd are formed in float32, as the twin
    forms them, so a launch with per-lane weights equal to these gives the
    same bits."""
    QD, RD, QN = weights if weights is not None else ((0.0,) * nx, (0.0,) * nu, 0.0)
    qd, rd = torch.tensor(QD, dtype=torch.float32), torch.tensor(RD, dtype=torch.float32)
    qn = torch.tensor(QN, dtype=torch.float32)
    LBU, UBU = limits if limits is not None else ((),) * 2
    LBX, UBX = state_limits if state_limits is not None else ((),) * 2
    TLB, TUB = terminal_state_limits if terminal_state_limits is not None else ((),) * 2
    pad = lambda v, n=MAX_NX: [float(a) for a in v] + [0.0] * (n - len(v))
    padu = lambda v: pad(v, MAX_NU)
    h = ts / substeps
    return [
        h, 0.5 * h, h / 6.0,
        *pad(qd.tolist()), *padu(rd.tolist()), float(qn),
        *pad((2.0 * qd).tolist()), *padu((2.0 * rd).tolist()), *pad(((2.0 * qn) * qd).tolist()),
        *padu(LBU), *padu(UBU), *pad(LBX), *pad(UBX),
        mu_init, mu_scale, mu_max, viol_tol, 0.01 * tol,
        *ALPHAS, REG_INIT, REG_MIN, REG_MAX,
        *pad(mc, MAX_CONSTS),
    ] + ([*pad(ec, MAX_EXTRA_CONSTS), *pad(TLB), *pad(TUB)] if ext else [])


# A lane's working set by region, in the order shared memory is filled
# (csrc/ilqr_factory.cu's enum): name, floats per lane, and whether the region
# has a home outside the workspace (an output buffer or an operand). In
# regulation (``track=False``) the ref region holds nothing. ``jac_cols`` is
# the step Jacobian's columns (``nx`` in the additive mode, where B = I),
# ``n_lam`` the multiplier stages (N + 1 with terminal rows), ``n_exo`` the
# exogenous rows, ``rw`` per-stage input weights, ``exd`` the user rows'
# derivative record per stage; a solve with none of the last three has the
# first seven regions alone.
def regions(nx: int, N: int, nc: int, nu: int = 2, track: bool = True, *, jac_cols=None,
            n_lam=None, n_exo: int = 0, rw: bool = False, exd: int = 0) -> tuple:
    jac = nx + nu if jac_cols is None else jac_cols
    base = (
        ("ab", N * nx * jac, False),  # step Jacobians [A | B]
        ("gain", N * nu * (1 + nx), False),  # k and K
        ("xs", (N + 1) * nx, True),
        ("us", N * nu, True),
        ("lam", (N if n_lam is None else n_lam) * nc, True),
        ("ref", (N + 1) * nx if track else 0, True),
        ("cand", N_ALPHA * ((N + 1) * nx + N * nu + 1), False),  # 7 candidates, costs
    )
    if not (n_exo or rw or exd):
        return base
    return base + (
        ("exo", N * n_exo, True),
        ("rw", N * nu if rw else 0, True),
        ("exd", N * exd, False),
    )


def launch_plan(nx: int, N: int, nc: int, tile: int, group: int, nu: int = 2,
                track: bool = True, **shape) -> LaunchPlan:
    """How the kernel is launched for one tile shape
    (:func:`.ilqr_kernel.plan_launch` with :data:`GROUPS`,
    :data:`MAX_THREADS`, :data:`SMEM_LIMIT`; ``shape``: :func:`regions`'
    keywords): the regions that fit shared memory in their order, the
    workspace for the rest; raises ``ValueError`` for a group no library is
    built for and for more threads than the kernel's launch bounds allow."""
    return plan_launch(regions(nx, N, nc, nu, track, **shape), tile, group, groups=GROUPS,
                       max_threads=MAX_THREADS, smem_limit=SMEM_LIMIT)


def library_name(group: int, ext: bool = False) -> str:
    stem = LIBRARY + "_ext" if ext else LIBRARY
    return stem if group == 1 else f"{stem}_g{group}"


def _configure(lib: ctypes.CDLL) -> None:
    # the second library's entries and a generated library's take the exo,
    # rw, wrt and lam0 operands too
    gen = hasattr(lib, "tracker_generated_launch")
    ext = gen or hasattr(lib, f"tracker_{EXT_KERNELS[0]}_launch")
    for kernel in ("generated",) if gen else EXT_KERNELS if ext else BASE_KERNELS:
        fn = getattr(lib, f"tracker_{kernel}_launch")
        fn.argtypes = [ctypes.c_void_p] * (16 if ext else 12) + [ctypes.c_int] * 12 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.tracker_error_string.argtypes = [ctypes.c_int]
    lib.tracker_error_string.restype = ctypes.c_char_p


def _build_library(group: int = 1, ext: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load the racing and benchmark instantiations
    (``csrc/ilqr_factory.cu``), or with ``ext`` the factory parking and MHE
    ones (``csrc/ilqr_factory_ext.cu``), for ``group`` threads per lane."""
    lib = load_library(library_name(group, ext), _EXT_SOURCES if ext else _SOURCES, _configure,
                       extra_flags=(*NVCC_EXTRA, f"-DTRACKER_GROUP={group}"))
    if (lib.tracker_group(), lib.tracker_max_threads()) != (group, MAX_THREADS[group]):
        raise RuntimeError(f"{library_name(group, ext)} was not built for group {group}")
    return lib


def instantiation(ode_rows, extra_constraints=None, extra_order: int = 2,
                  weights_rt: bool = False) -> str:
    """The name of the C++ instantiation a solve needs (its entry is
    ``tracker_<name>_launch``): the model's functor, then the constraint
    rows' functor and their derivative order, then ``_wrt`` for per-lane
    weights."""
    name = getattr(ode_rows, "kernel", None) or "?"
    if extra_constraints is not None:
        name += f"_{getattr(extra_constraints, 'kernel', None) or '?'}_o{extra_order}"
    return name + ("_wrt" if weights_rt else "")


def _hand_built(key, ode_rows, integrator, limits, extra_constraints, extra_deps, input_mode,
                rw, terminal_state_limits, lam0=None) -> bool:
    """Whether a hand-written instantiation of the two libraries holds this
    solve (:func:`instantiation` names it): the model and its rows, built
    with this integrator, input box, dependency columns, additive mode,
    terminal rows and per-stage input weights, and (second library only)
    the multipliers' warm start. Every other solve the twin takes runs on
    an instantiation generated from its row functions
    (:mod:`.tracker_codegen`)."""
    if key not in DEFAULT_GROUP or not isinstance(ode_rows, TrackerModel) or not (
            extra_constraints is None or isinstance(extra_constraints, TrackerConstraints)):
        return False
    if key in EXT_BUILDS:
        build = EXT_BUILDS[key]
        asked = dict(integrator=integrator, ubox=limits is not None,
                     tbox=terminal_state_limits is not None, rw=rw is not None,
                     additive=input_mode == "additive")
        if extra_constraints is not None:
            asked["deps"] = tuple(extra_deps)
        return all(build.get(k, v) == v for k, v in asked.items())
    if (input_mode != "ode" or terminal_state_limits is not None or rw is not None
            or lam0 is not None or extra_constraints is not None):
        return False
    if integrator == "euler" and ode_rows.kernel not in EULER_KERNELS:
        return False
    return limits is not None or ode_rows.kernel in NO_INPUT_BOX_KERNELS


def generated_instantiation(ode_rows, *, nx, nu, n_params, integrator, limits,
                            extra_constraints=None, n_extra=0, extra_deps=(), extra_order=2,
                            input_mode="ode", n_exo=0, rw=False, wrt=False,
                            terminal_state_limits=None):
    """The instantiation generated for a solve no hand-written one holds:
    the row functions traced and emitted as C++ functors with the solve's
    compile-time properties (:func:`.tracker_codegen.instantiation_of`);
    raises the twin's ``NotImplementedError`` for an operation the twin has
    no rule for."""
    from . import tracker_codegen

    additive = input_mode == "additive"
    return tracker_codegen.instantiation_of(
        ode_rows, extra_constraints if n_extra else None, nx=nx, nu=nu, n_params=n_params,
        n_extra=n_extra, extra_deps=tuple(extra_deps), extra_order=extra_order,
        integrator=integrator, ubox=limits is not None, wrt=wrt,
        tbox=terminal_state_limits is not None, rw=rw, additive=additive,
        n_exo=n_exo if additive else 0)


def _generated_library(inst, group: int) -> ctypes.CDLL:
    """Build (at first use) and load the library of a generated
    instantiation for ``group`` threads per lane."""
    from . import tracker_codegen

    lib = tracker_codegen.generated_library(inst, group, _configure, NVCC_EXTRA)
    if (lib.tracker_group(), lib.tracker_max_threads()) != (group, MAX_THREADS[group]):
        raise RuntimeError(f"{tracker_codegen.library_name(inst, group)} was not built for "
                           f"group {group}")
    return lib


def _launch(x0, u0, refs, par, *, ode_rows, nx, nu, N, tile, ts, substeps, integrator,
            limits, state_limits, weights, outer_iters, inner_iters, group=1,
            extra_constraints=None, n_extra=0, extra_deps=(), extra_order=2, input_mode="ode",
            exo=None, rw=None, wrt=None, terminal_state_limits=None, lam0=None, **solver):
    global LAUNCHES
    n_extra = n_extra if extra_constraints is not None else 0
    nc = (2 * nu if limits is not None else 0) + (2 * nx if state_limits is not None else 0) + n_extra
    ne = len(extra_deps) if n_extra else 0
    tri = ne * (ne + 1) // 2
    plan = launch_plan(
        nx, N, nc, tile, group, nu, refs is not None,
        jac_cols=nx if input_mode == "additive" else nx + nu,
        n_lam=N + 1 if terminal_state_limits is not None else N,
        n_exo=0 if exo is None else exo.shape[1], rw=rw is not None,
        exd=ne + tri * (2 if extra_order == 2 else 1) if n_extra else 0,
    )
    key = instantiation(ode_rows, extra_constraints, extra_order, wrt is not None)
    hand = _hand_built(key, ode_rows, integrator, limits, extra_constraints, extra_deps,
                       input_mode, rw, terminal_state_limits, lam0)
    if not hand:
        inst = generated_instantiation(
            ode_rows, nx=nx, nu=nu, n_params=0 if par is None else par.shape[0],
            integrator=integrator, limits=limits, extra_constraints=extra_constraints,
            n_extra=n_extra, extra_deps=extra_deps, extra_order=extra_order,
            input_mode=input_mode, n_exo=0 if exo is None else exo.shape[1], rw=rw is not None,
            wrt=wrt is not None, terminal_state_limits=terminal_state_limits)
        key = inst.key
    operands = [a for a in (x0, u0, refs, par, exo, rw, wrt, lam0) if a is not None]
    for a in operands:
        if a.device != x0.device or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError("kernel operands must be contiguous float32 on one device")
    # the second library and the generated ones take the exo, rw, wrt and
    # lam0 operands and the constraint rows' constants
    ext = not hand or key in EXT_KERNELS
    if hand:
        lib = _build_library(group, True) if ext else _build_library(group)
        fn = getattr(lib, f"tracker_{key}_launch")
    else:
        lib = _generated_library(inst, group)
        fn = lib.tracker_generated_launch
    Bp = x0.shape[-1]
    dev = x0.device
    f32 = torch.float32
    n_lam = N + 1 if terminal_state_limits is not None else N
    us = torch.empty(N, nu, Bp, dtype=f32, device=dev)
    xs = torch.empty(N + 1, nx, Bp, dtype=f32, device=dev)
    viol = torch.empty(Bp, dtype=f32, device=dev)
    conv = torch.empty(Bp, dtype=f32, device=dev)
    lam = torch.empty(n_lam, nc, Bp, dtype=f32, device=dev)
    ni = torch.empty(Bp, dtype=f32, device=dev)
    work = torch.empty(max(plan.work_rows, 1), Bp, dtype=f32, device=dev)
    # a generated functor carries its constants in its source
    values = _consts(nx, nu, ode_rows.consts if hand else (),
                     extra_constraints.consts if hand and n_extra else (), ts=ts,
                     substeps=substeps, limits=limits, state_limits=state_limits,
                     weights=weights, terminal_state_limits=terminal_state_limits, ext=ext,
                     **solver)
    cvals = (ctypes.c_float * len(values))(*values)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda a: None if a is None else a.data_ptr()
    with torch.cuda.device(dev):
        err = fn(
            *(ptr(a) for a in (x0, u0, refs, par, *((exo, rw, wrt, lam0) if ext else ()), us, xs,
                               viol, conv, lam, ni, work)),
            ctypes.addressof(cvals), len(values), N, substeps, int(integrator == "rk4"),
            int(limits is not None), int(state_limits is not None), outer_iters, inner_iters,
            tile, Bp // tile,
            group, plan.smask, stream,
        )
    if err != 0:
        raise RuntimeError(f"tracker kernel launch failed: {lib.tracker_error_string(err).decode()}")
    LAUNCHES += 1
    LAUNCHES_BY_KERNEL[key] = LAUNCHES_BY_KERNEL.get(key, 0) + 1
    return us, xs, viol, conv > 0.5, lam, ni


def _lanes(a, perm, pad):
    """A ``(B, ...)`` operand in the kernel's stage-major layout, float32,
    padded with zeros to ``B + pad`` lanes (``None`` stays ``None``)."""
    if a is None:
        return None
    return torch.nn.functional.pad(a.to(torch.float32).permute(*perm), (0, pad)).contiguous()


def prepare_tiles(x0s, u_init, refs, params, *, tile):
    """The kernel's stage-major operands, padded with zeros to a tile
    multiple as the reference pads every operand (``lanes()``,
    ``ilqr_factory.py:1364-1368`` of the JAX package); ``refs`` and
    ``params`` may be ``None``."""
    if tile < 1:
        raise ValueError("tile must be positive")
    pad = -x0s.shape[0] % tile
    return (_lanes(x0s, (1, 0), pad), _lanes(u_init, (1, 2, 0), pad),
            _lanes(refs, (1, 2, 0), pad), _lanes(params, (1, 0), pad))


def prepare_operands(B: int, *, tile, exo=None, input_weights_rt=None, weights_rt=None,
                     lam_init=None) -> dict:
    """The other operands in the kernel's layout, padded as
    :func:`prepare_tiles` pads (keywords of :func:`_launch` and the twin):
    ``exo`` ``(N, n_exo, Bp)``, ``rw`` ``(N, nu, Bp)``, ``wrt`` ``(nx + nu +
    1, Bp)``, ``lam0`` ``(n_lam, nc, Bp)``."""
    pad = -B % tile
    return dict(exo=_lanes(exo, (1, 2, 0), pad), rw=_lanes(input_weights_rt, (1, 2, 0), pad),
                wrt=_lanes(weights_rt, (1, 0), pad), lam0=_lanes(lam_init, (1, 2, 0), pad))


def _check_options(*, ode_rows, nx, nu, limits, state_limits, weights, integrator, params,
                   n_params, weights_rt=None, extra_constraints=None, n_extra=0,
                   extra_deps="xu", input_mode="ode", exo=None, n_exo=0,
                   terminal_state_limits=None):
    """Raise where the JAX package's ``fused_tracker_solve`` raises, with its
    exception types (``ilqr_factory.py:1309-1358``), and for what the port
    has no counterpart of."""
    if not 1 <= nu <= MAX_NU:
        raise NotImplementedError(
            f"fused_tracker_solve supports 1 <= nu <= {MAX_NU} (closed form at nu <= 2, "
            "unrolled Cholesky beyond), as the JAX package's"
        )
    if extra_constraints is not None and n_extra <= 0:
        raise ValueError("extra_constraints requires n_extra > 0")
    if extra_deps not in ("x", "xu") and not (
        isinstance(extra_deps, tuple)
        and all(isinstance(d, int) and 0 <= d < nx + nu for d in extra_deps)
    ):
        raise ValueError(
            "extra_deps must be 'x', 'xu', or a tuple of z indices "
            "(x rows 0..nx-1, then u rows nx..nx+nu-1)"
        )
    if (params is None) != (n_params == 0):
        raise ValueError("pass params together with n_params > 0")
    if params is not None and params.shape[-1] != n_params:
        raise ValueError("params.shape[-1] must equal n_params")
    if (weights is None) == (weights_rt is None):
        raise ValueError("pass exactly one of weights / weights_rt")
    if input_mode not in ("ode", "additive"):
        raise ValueError("input_mode must be 'ode' or 'additive'")
    if input_mode == "additive":
        if nu != nx:
            raise ValueError("additive input mode requires nu == nx (B = I)")
        if exo is None or n_exo <= 0:
            raise ValueError("additive input mode requires exo / n_exo")
    nc = ((2 * nu if limits is not None else 0) + (2 * nx if state_limits is not None else 0)
          + (n_extra if extra_constraints is not None else 0))
    if nc == 0:
        raise ValueError(
            "the AL kernel needs at least one constraint row: pass an input "
            "box (limits), a state box (state_limits), or extra_constraints"
        )
    if terminal_state_limits is not None and nc < 2 * nx:
        raise ValueError(
            "terminal_state_limits rides the lam buffer rows and needs "
            "nc >= 2*nx (add a stage state box)"
        )
    if weights_rt is not None and weights_rt.shape[-1] != nx + nu + 1:
        raise ValueError("weights_rt must be (B, nx + nu + 1)")
    if integrator not in ("rk4", "euler"):
        raise ValueError("integrator must be 'rk4' or 'euler'")
    if not 1 <= nx <= MAX_NX:
        raise ValueError(f"nx must be 1..{MAX_NX}")
    if isinstance(ode_rows, TrackerModel) and (
        (ode_rows.nx, ode_rows.nu, ode_rows.n_params) != (nx, nu, n_params)
    ):
        raise ValueError("nx, nu and n_params must match the tracker model")


def _solve_tiled(solver, x0s, u_init, refs=None, *, ode_rows, nx, nu, N, ts, substeps,
                 limits, weights=None, weights_rt=None, state_limits=None, integrator="rk4",
                 extra_constraints=None, n_extra=0, extra_deps="xu", extra_order=2,
                 params=None, n_params=0, input_mode="ode", exo=None, n_exo=0,
                 input_weights_rt=None, terminal_state_limits=None, lam_init=None,
                 outer_iters=6, inner_iters=15, mu_init=10.0, mu_scale=10.0, mu_max=1e8,
                 viol_tol=1e-4, tol=1e-6, tile=DEFAULT_TILE):
    """Check, prepare, run ``solver`` on the padded tiles, return the public
    layout."""
    _check_options(ode_rows=ode_rows, nx=nx, nu=nu, limits=limits, state_limits=state_limits,
                   weights=weights, integrator=integrator, params=params, n_params=n_params,
                   weights_rt=weights_rt, extra_constraints=extra_constraints, n_extra=n_extra,
                   extra_deps=extra_deps, input_mode=input_mode, exo=exo, n_exo=n_exo,
                   terminal_state_limits=terminal_state_limits)
    B = x0s.shape[0]
    floats = lambda b: None if b is None else tuple(tuple(float(v) for v in r) for r in b)
    x0, u0, rf, par = prepare_tiles(x0s, u_init, refs, params, tile=tile)
    us, xs, viol, conv, lam, ni = solver(
        x0, u0, rf, par, ode_rows=ode_rows, nx=nx, nu=nu, N=N, tile=tile, ts=float(ts),
        substeps=int(substeps), integrator=integrator,
        limits=floats(limits), state_limits=floats(state_limits),
        weights=None if weights is None else (
            tuple(float(v) for v in weights[0]), tuple(float(v) for v in weights[1]),
            float(weights[2])),
        outer_iters=outer_iters, inner_iters=inner_iters, mu_init=float(mu_init),
        mu_scale=float(mu_scale), mu_max=float(mu_max), viol_tol=float(viol_tol),
        tol=float(tol), extra_constraints=extra_constraints,
        n_extra=int(n_extra) if extra_constraints is not None else 0,
        extra_deps=_resolve_deps(extra_deps, nx, nu), extra_order=int(extra_order),
        input_mode=input_mode, terminal_state_limits=floats(terminal_state_limits),
        **prepare_operands(B, tile=tile, exo=exo, input_weights_rt=input_weights_rt,
                           weights_rt=weights_rt, lam_init=lam_init),
    )
    return BatchedTrackerSolution(
        us=us.permute(2, 0, 1)[:B],
        xs=xs.permute(2, 0, 1)[:B],
        viol=viol[:B],
        converged=conv[:B],
        lam=lam.permute(2, 0, 1)[:B],
        inner_iters_executed=ni[:B],
    )


def fused_tracker_solve_cuda(
    x0s: torch.Tensor,  # (B, nx)
    u_init: torch.Tensor,  # (B, N, nu)
    refs: torch.Tensor | None = None,  # (B, N + 1, nx) tracking windows; None: regulation
    *,
    ode_rows,  # a TrackerModel, or a bare row function
    nx: int,
    nu: int,
    N: int,
    ts: float,
    substeps: int,
    limits: tuple | None,  # (lb_u(nu), ub_u(nu)); None: no input box
    weights: tuple | None = None,  # (Qd(nx), Rd(nu), qn)
    weights_rt: torch.Tensor | None = None,  # (B, nx + nu + 1): per-lane [Qd, Rd, qn]
    state_limits: tuple | None = None,  # (lb_x(nx), ub_x(nx))
    integrator: str = "rk4",  # "rk4" | "euler"
    extra_constraints=None,  # a TrackerConstraints, or bare rows: c <= 0
    n_extra: int = 0,
    extra_deps="xu",  # "x", "xu" or a tuple of z columns the rows depend on
    extra_order: int = 2,  # 2: exact act·∂²c curvature, 1: Gauss-Newton
    params: torch.Tensor | None = None,  # (B, n_params) per-scenario ODE parameters
    n_params: int = 0,
    input_mode: str = "ode",  # "additive": x⁺ = step(x; exo) + u, B = I
    exo: torch.Tensor | None = None,  # (B, N, n_exo) per-stage exogenous rows
    n_exo: int = 0,
    input_weights_rt: torch.Tensor | None = None,  # (B, N, nu) per-stage Rd
    terminal_state_limits: tuple | None = None,  # box AL rows on x_N
    lam_init: torch.Tensor | None = None,  # (B, N[+1], nc) AL warm start
    outer_iters: int = 6,
    inner_iters: int = 15,
    mu_init: float = 10.0,
    mu_scale: float = 10.0,
    mu_max: float = 1e8,
    viol_tol: float = 1e-4,
    tol: float = 1e-6,
    tile: int = DEFAULT_TILE,
    group: int | None = None,  # threads per lane on the card; None: DEFAULT_GROUP
) -> BatchedTrackerSolution:
    """Batched AL-iLQR tracking solve of a row-form ODE; the signature and
    return of the JAX package's ``fused_tracker_solve`` (without
    ``interpret``), and ``group``.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    twin :func:`tracker_tiles_reference`. On CUDA a solve a hand-written
    instantiation holds (:func:`instantiation`, :func:`_hand_built`) launches
    it; any other, a bare row function included, launches an instantiation
    generated from its row functions and built at first use
    (:func:`generated_instantiation`). One CTA runs one tile with ``group``
    threads per lane (one of :data:`GROUPS`; for ``None`` the
    instantiation's :data:`DEFAULT_GROUP`, :data:`GENERATED_GROUP` for a
    generated one, or the largest group that fits ``tile`` where that does
    not); the solution does not depend on it. A CTA has ``tile ×
    group`` threads, and an explicit ``group`` that makes more than
    :data:`MAX_THREADS` raises ``ValueError`` (:func:`launch_plan`). The
    twin ignores a valid ``group``. With ``terminal_state_limits`` the
    multipliers have a row N (``lam`` is ``(B, N + 1, nc)``).
    """
    key = instantiation(ode_rows, extra_constraints, extra_order, weights_rt is not None)
    group = resolve_group(group, tile, DEFAULT_GROUP.get(key, GENERATED_GROUP), GROUPS,
                          MAX_THREADS)
    if group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, not {group}")
    if x0s.is_cuda:
        # _launch is looked up at call time, so that a run can observe it
        solver = lambda *a, **k: _launch(*a, group=group, **k)
    else:
        solver = tracker_tiles_reference
    return _solve_tiled(
        solver, x0s, u_init, refs, ode_rows=ode_rows, nx=nx, nu=nu, N=N, ts=ts,
        substeps=substeps, limits=limits, weights=weights, weights_rt=weights_rt,
        state_limits=state_limits, integrator=integrator,
        extra_constraints=extra_constraints, n_extra=n_extra, extra_deps=extra_deps,
        extra_order=extra_order, params=params, n_params=n_params, input_mode=input_mode,
        exo=exo, n_exo=n_exo, input_weights_rt=input_weights_rt,
        terminal_state_limits=terminal_state_limits, lam_init=lam_init,
        outer_iters=outer_iters, inner_iters=inner_iters, mu_init=mu_init,
        mu_scale=mu_scale, mu_max=mu_max, viol_tol=viol_tol, tol=tol, tile=tile,
    )


_SIGNATURE = inspect.signature(fused_tracker_solve_cuda)


def fused_tracker_solve_twin(*args, **kwargs) -> BatchedTrackerSolution:
    """:func:`fused_tracker_solve_cuda` with the same arguments, always on
    the plain twin and on any device: the reference the kernel is held
    against on the card."""
    bound = _SIGNATURE.bind(*args, **kwargs)
    bound.apply_defaults()
    kw = dict(bound.arguments)
    if kw.pop("group") not in (None, *GROUPS):
        raise ValueError(f"group must be one of {GROUPS}")
    return _solve_tiled(tracker_tiles_reference, **kw)


def make_fused_tracker(ode_rows, nx: int, nu: int, **config):
    """Bind a row-form ODE and a static configuration into a batched solve:

        step = make_fused_tracker(model, nx=6, nu=2, N=15, ts=0.05,
                                  substeps=4, limits=..., weights=...)
        sol = step(x0s, u_init, refs)

    Per-call tensors (``params``, ``lam_init``, ``weights_rt``, ``exo``,
    ``input_weights_rt``) stay call-site keywords; ``tile`` and ``group``
    are part of the configuration."""
    return functools.partial(fused_tracker_solve_cuda, ode_rows=ode_rows, nx=nx, nu=nu, **config)
