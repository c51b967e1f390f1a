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
and the float constants that instantiation reads. The twin runs the torch
rows, on tensors for values and on :class:`Dual` numbers for Jacobians; the
kernel runs the C++ functor of the same name, templated on the same dual
arithmetic. A bare Python ``ode_rows`` has no C++ counterpart: it runs on the
twin, and on CUDA tensors it raises (code generation for user ODEs is
ROADMAP S4.6).

Ported features: tracking (``refs``) and regulation (``refs=None``: x costed
against the origin), per-scenario ODE parameters, an optional input box and
an optional state box (at least one), Euler or RK4 prediction with substeps,
static weights, ``1 ≤ nu ≤ 8``. The rest of the JAX signature raises
``NotImplementedError`` naming its ROADMAP item. The C++ instantiations are
the racing pair (``"kinematic"``, ``"pacejka"``; Euler and RK4, with an
input box) and the benchmark models of :mod:`...models.benchmarks` (RK4,
with or without an input box): the pairs their paths use.

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
# GPU default scenario tile and (below) thread group, chosen by a tile × group
# sweep on the H100 at both racing sweeps' contract configurations, by the
# time the sweeps spend in the kernel (PERF.md, Findings): 128 CTAs for 2,048
# lanes, about one per SM, and the tile-wide exits fire earlier than at 64
DEFAULT_TILE = 16
# threads per lane a library can be built for, and the threads per CTA
# (tile × group) its launch bounds allow (csrc/ilqr_factory.cu MAX_THREADS)
GROUPS = (1, 8, 16, 32)
MAX_THREADS = {1: 256, 8: 512, 16: 512, 32: 512}
# default group per C++ instantiation, from the same sweep (the racing pair)
# and from a launch sweep at the benchmark sweeps' shapes (PERF.md, Findings)
DEFAULT_GROUP = {"kinematic": 8, "pacejka": 32, "cartpole": 8, "quadrotor": 8,
                 "omnibase": 8, "omnibase_param": 8, "thruster": 8}
# What each library holds beyond RK4 with an input box, as the paths use the
# models: Euler (with the box) for the racing pair, the solve without an input
# box (RK4) for the benchmark models. The input box is a compile-time property
# of an instantiation: as a runtime flag it cost the kinematic launch 12%
# (PERF.md, Findings).
EULER_KERNELS = ("kinematic", "pacejka")
NO_INPUT_BOX_KERNELS = ("cartpole", "quadrotor", "omnibase", "omnibase_param", "thruster")
N_ALPHA = len(ALPHAS)

# Kernel launches made by fused_tracker_solve_cuda (one per solve), in all and
# by instantiation (TrackerModel.kernel). Tests and chip_smoke.py read them to
# show that a run went through the kernel.
LAUNCHES = 0
LAUNCHES_BY_KERNEL = dict.fromkeys(DEFAULT_GROUP, 0)

LIBRARY = "ilqr_factory"  # library_name(group) is the file's stem
_SOURCES = [PKG / "csrc" / "ilqr_factory.cu"]
# the twin rounds after every operation; so does the kernel without
# contraction into fused multiply-adds (as K2, PERF.md)
NVCC_EXTRA = ("--fmad=false",)


@dataclasses.dataclass(frozen=True)
class BatchedTrackerSolution:
    us: torch.Tensor  # (B, N, nu)
    xs: torch.Tensor  # (B, N + 1, nx)
    viol: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,) bool
    lam: torch.Tensor  # (B, N, nc) AL multipliers (the warm-start handle)
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


def tracker_tiles_reference(
    x0, u0, refs, par, *, ode_rows, nx, nu, N, tile, ts, substeps, integrator,
    limits, state_limits, weights, outer_iters, inner_iters, mu_init, mu_scale,
    mu_max, viol_tol, tol,
):
    """Plain-PyTorch twin of the kernel on stage-major padded operands.

    ``x0`` is ``(nx, Bp)``, ``u0`` ``(N, nu, Bp)``, ``refs`` ``(N+1, nx,
    Bp)`` or ``None`` (regulation), ``par`` ``(n_params, Bp)`` or ``None``,
    with ``Bp`` a multiple of ``tile``; ``limits`` or ``state_limits`` may be
    ``None`` (not both). Works on ``(Bp/T, T)`` lane views with per-tile masks and
    tile-wide loop exits; the 7 line-search rollouts run as one leading
    dimension. Every operation is the reference kernel's, in its order.
    Returns ``us (N, nu, Bp)``, ``xs (N+1, nx, Bp)``, ``viol (Bp,)``,
    ``converged (Bp,)``, ``lam (N, nc, Bp)`` and the tile's executed inner
    iterations ``(Bp,)``.
    """
    QD, RD, QN = weights
    dev, f32 = x0.device, torch.float32
    Bp = x0.shape[-1]
    T = tile
    nt = Bp // T
    ubox, sbox = limits is not None, state_limits is not None
    nc = (2 * nu if ubox else 0) + (2 * nx if sbox else 0)
    rk4 = integrator == "rk4"
    h = ts / substeps
    lanes = lambda a: a.reshape(*a.shape[:-1], nt, T)
    full = lambda v: torch.full((nt, T), v, dtype=f32, device=dev)
    # float32 constant columns (n, 1, 1), made once (on a card, each is a copy)
    col = lambda v: torch.tensor(v, dtype=f32, device=dev).reshape(-1, 1, 1)
    A_LS = len(ALPHAS)
    alpha = col(ALPHAS)
    idx = torch.arange(nx, device=dev)
    qd, rd, qd2, rd2 = col(QD), col(RD), col([2.0 * q for q in QD]), col([2.0 * r for r in RD])
    qnqd2 = col([2.0 * QN * q for q in QD])
    if ubox:
        lbu, ubu = (col(b) for b in limits)
    if sbox:
        lbx, ubx = (col(b) for b in state_limits)
    # a column against (n, nt, T) rows, or against (n, A, nt, T) candidate packs
    fit = lambda c, X: c if X.ndim == 3 else c[:, None]

    x0 = lanes(x0)
    # regulation costs x against the origin: x - 0 has the bits of x
    refs = (lanes(refs) if refs is not None
            else torch.zeros(N + 1, nx, nt, T, dtype=f32, device=dev))
    us = lanes(u0).clone()
    pr = tuple(lanes(par)) if par is not None else None
    lam = torch.zeros(N, nc, nt, T, dtype=f32, device=dev)
    xs = torch.empty(N + 1, nx, nt, T, dtype=f32, device=dev)
    k_s = torch.zeros(N, nu, nt, T, dtype=f32, device=dev)
    K_s = torch.zeros(N, nu * nx, nt, T, dtype=f32, device=dev)

    def step(xr, ur):
        return _step(ode_rows, xr, ur, pr, h, substeps, rk4)

    def fold(rows):  # left-to-right sum over the leading dimension
        s = rows[0]
        for v in rows[1:]:
            s = s + v
        return s

    # Below, a row or matrix entry is one slice of a stacked tensor, and
    # each element sees the reference's operations in the reference's order
    # (the kernel's too); only independent entries are batched together.

    def constraint_rows(X, U):
        """With the input box [u − ub_u, lb_u − u] and with the state box
        [x − ub_x, lb_x − x], stacked ``(nc, ...)``."""
        rows = [U - fit(ubu, U), fit(lbu, U) - U] if ubox else []
        if sbox:
            rows += [X - fit(ubx, X), fit(lbx, X) - X]
        return torch.cat(rows)

    def quad_err(X, r):
        e = X - r
        return fold(fit(qd, X) * e * e)

    def stage_cost(X, U, lam_t, mu, r):
        """Stage cost of stacked states ``(nx, ...)`` and inputs ``(nu, ...)``
        (``...`` = ``(nt, T)`` or ``(A, nt, T)``)."""
        if X.ndim == 4:
            lam_t, r = lam_t[:, None], r[:, None]
        quad = quad_err(X, r) + fold(fit(rd, U) * U * U)
        act = _relu(lam_t + mu * constraint_rows(X, U))
        return quad + fold(act * act - lam_t * lam_t) / (2.0 * mu)

    def total_cost(mu):
        cost = stage_cost(xs[0], us[0], lam[0], mu, refs[0])
        for t in range(1, N):
            cost = cost + stage_cost(xs[t], us[t], lam[t], mu, refs[t])
        return cost + QN * quad_err(xs[N], refs[N])

    def rollout():
        xs[0] = x0
        for t in range(N):
            xs[t + 1] = torch.stack(step(xs[t], us[t]))

    def stage_derivs(X, U, lam_t, mu, r):
        """lx, lu and the diagonals of lxx and luu (the tracking cost and
        the box rows touch only diagonals)."""
        lu = rd2 * U
        huu = rd2.expand(nu, nt, T)
        if ubox:
            act_u = _relu(lam_t[:nu] + mu * (U - ubu))
            act_l = _relu(lam_t[nu : 2 * nu] + mu * (lbu - U))
            lu = lu + act_u - act_l
            huu = rd2 + mu * ((act_u > 0.0).to(f32) + (act_l > 0.0).to(f32))
        lx = qd2 * (X - r)
        hxx = qd2.expand(nx, nt, T)
        if sbox:
            o = 2 * nu if ubox else 0
            act_u = _relu(lam_t[o : o + nx] + mu * (X - ubx))
            act_l = _relu(lam_t[o + nx :] + mu * (lbx - X))
            lx = lx + (act_u - act_l)
            hxx = hxx + mu * ((act_u > 0.0).to(f32) + (act_l > 0.0).to(f32))
        return lx, lu, hxx, huu

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
        ok = torch.ones(nt, T, dtype=torch.bool, device=dev)
        grad = full(0.0)
        for t in range(N - 1, -1, -1):
            X, U = xs[t], us[t]
            A, B = step_jacobian(ode_rows, X, U, pr, ts=ts, substeps=substeps,
                                 integrator=integrator)
            lx, lu, hxx, huu = stage_derivs(X, U, lam[t], mu, refs[t])
            Qx = fold([lx] + [A[k] * Vx[k] for k in range(nx)])
            Qu = fold([lu] + [B[k] * Vx[k] for k in range(nx)])
            M = fold([outer(V[:, k], A[k]) for k in range(nx)])  # Vxx A
            P = fold([outer(A[k], M[k]) for k in range(nx)])  # Aᵀ Vxx A
            Qxx = 0.5 * (P + P.transpose(0, 1))
            Qxx[idx, idx] = Qxx[idx, idx] + hxx
            VB = fold([outer(V[:, m], B[m]) for m in range(nx)])  # Vxx B
            BVB = fold([outer(B[k], VB[k]) for k in range(nx)])  # off-diagonal Quu
            quu_d = fold([huu] + [B[k] * VB[k] for k in range(nx)])  # diagonal Quu
            Qux = fold([outer(B[k], M[k]) for k in range(nx)])
            quu = BVB.clone()
            quu[jdx, jdx] = quu_d
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
            sc = stage_cost(x, u, lam[t], mu, refs[t])
            cost = sc if cost is None else cost + sc
            x = torch.stack(step(tuple(x), tuple(u)))
        xs_p[N] = x
        return cost + QN * quad_err(x, refs[N][:, None]), xs_p, us_p

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
        # multiplier sweep: violation, λ update, λ step
        v_n = step_n = lmax = full(0.0)
        for t in range(N):
            c = constraint_rows(xs[t], us[t])
            lam_n = _relu(lam[t] + mu * c)
            v_n = torch.maximum(v_n, _relu(c).amax(dim=0))
            step_n = torch.maximum(step_n, (lam_n - lam[t]).abs().amax(dim=0))
            lmax = torch.maximum(lmax, lam_n.abs().amax(dim=0))
            lam[t] = torch.where(run2, lam_n, lam[t])
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


def _consts(model: TrackerModel, *, ts, substeps, limits, state_limits, weights,
            mu_init, mu_scale, mu_max, viol_tol, tol):
    """The float constants in the order of ``struct Consts``
    (``csrc/ilqr_factory.cu``), state- and input-sized ones padded with zeros
    (an absent box is zeros too)."""
    QD, RD, QN = weights
    LBU, UBU = limits if limits is not None else ((),) * 2
    LBX, UBX = state_limits if state_limits is not None else ((),) * 2
    pad = lambda v, n=MAX_NX: [float(a) for a in v] + [0.0] * (n - len(v))
    padu = lambda v: pad(v, MAX_NU)
    h = ts / substeps
    return [
        h, 0.5 * h, h / 6.0,
        *pad(QD), *padu(RD), QN,
        *pad([2.0 * q for q in QD]), *padu([2.0 * r for r in RD]),
        *pad([2.0 * QN * q for q in QD]),
        *padu(LBU), *padu(UBU), *pad(LBX), *pad(UBX),
        mu_init, mu_scale, mu_max, viol_tol, 0.01 * tol,
        *ALPHAS, REG_INIT, REG_MIN, REG_MAX,
        *pad(model.consts, MAX_CONSTS),
    ]


# A lane's working set by region, in the order shared memory is filled
# (csrc/ilqr_factory.cu's enum): name, floats per lane, and whether the region
# has a home outside the workspace (an output buffer or the refs operand). In
# regulation (``track=False``) the ref region holds nothing.
def regions(nx: int, N: int, nc: int, nu: int = 2, track: bool = True) -> tuple:
    return (
        ("ab", N * nx * (nx + nu), False),  # step Jacobians [A | B]
        ("gain", N * nu * (1 + nx), False),  # k and K
        ("xs", (N + 1) * nx, True),
        ("us", N * nu, True),
        ("lam", N * nc, True),
        ("ref", (N + 1) * nx if track else 0, True),
        ("cand", N_ALPHA * ((N + 1) * nx + N * nu + 1), False),  # 7 candidates, costs
    )


def launch_plan(nx: int, N: int, nc: int, tile: int, group: int, nu: int = 2,
                track: bool = True) -> LaunchPlan:
    """How the kernel is launched for one tile shape
    (:func:`.ilqr_kernel.plan_launch` with :data:`GROUPS`,
    :data:`MAX_THREADS`, :data:`SMEM_LIMIT`): the regions that fit shared
    memory in their order, the workspace for the rest; raises ``ValueError``
    for a group no library is built for and for more threads than the
    kernel's launch bounds allow."""
    return plan_launch(regions(nx, N, nc, nu, track), tile, group, groups=GROUPS,
                       max_threads=MAX_THREADS, smem_limit=SMEM_LIMIT)


def library_name(group: int) -> str:
    return LIBRARY if group == 1 else f"{LIBRARY}_g{group}"


def _configure(lib: ctypes.CDLL) -> None:
    for kernel in DEFAULT_GROUP:
        fn = getattr(lib, f"tracker_{kernel}_launch")
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.tracker_error_string.argtypes = [ctypes.c_int]
    lib.tracker_error_string.restype = ctypes.c_char_p


def _build_library(group: int = 1) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/ilqr_factory.cu`` for ``group``
    threads per lane."""
    lib = load_library(library_name(group), _SOURCES, _configure,
                       extra_flags=(*NVCC_EXTRA, f"-DTRACKER_GROUP={group}"))
    if (lib.tracker_group(), lib.tracker_max_threads()) != (group, MAX_THREADS[group]):
        raise RuntimeError(f"{library_name(group)} was not built for group {group}")
    return lib


def _launch(x0, u0, refs, par, *, ode_rows, nx, nu, N, tile, ts, substeps, integrator,
            limits, state_limits, weights, outer_iters, inner_iters, group=1, **solver):
    global LAUNCHES
    nc = (2 * nu if limits is not None else 0) + (2 * nx if state_limits is not None else 0)
    plan = launch_plan(nx, N, nc, tile, group, nu, refs is not None)
    if integrator == "euler" and ode_rows.kernel not in EULER_KERNELS:
        raise NotImplementedError(
            f"the kernel library builds the {ode_rows.kernel!r} model with RK4 only; Euler "
            f"is built for {EULER_KERNELS} (the twin takes any integrator)"
        )
    if limits is None and ode_rows.kernel not in NO_INPUT_BOX_KERNELS:
        raise NotImplementedError(
            f"the kernel library builds the {ode_rows.kernel!r} model with an input box only; "
            f"the solve without one is built for {NO_INPUT_BOX_KERNELS} (the twin takes any "
            "model)"
        )
    operands = [a for a in (x0, u0, refs, par) if a is not None]
    for a in operands:
        if a.device != x0.device or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError("kernel operands must be contiguous float32 on one device")
    lib = _build_library(group)
    Bp = x0.shape[-1]
    dev = x0.device
    f32 = torch.float32
    us = torch.empty(N, nu, Bp, dtype=f32, device=dev)
    xs = torch.empty(N + 1, nx, Bp, dtype=f32, device=dev)
    viol = torch.empty(Bp, dtype=f32, device=dev)
    conv = torch.empty(Bp, dtype=f32, device=dev)
    lam = torch.empty(N, nc, Bp, dtype=f32, device=dev)
    ni = torch.empty(Bp, dtype=f32, device=dev)
    work = torch.empty(max(plan.work_rows, 1), Bp, dtype=f32, device=dev)
    values = _consts(ode_rows, ts=ts, substeps=substeps, limits=limits,
                     state_limits=state_limits, weights=weights, **solver)
    cvals = (ctypes.c_float * len(values))(*values)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = getattr(lib, f"tracker_{ode_rows.kernel}_launch")
    ptr = lambda a: None if a is None else a.data_ptr()
    with torch.cuda.device(dev):
        err = fn(
            *(ptr(a) for a in (x0, u0, refs, par, us, xs, viol, conv, lam, ni, work)),
            ctypes.addressof(cvals), len(values), N, substeps, int(integrator == "rk4"),
            int(limits is not None), int(state_limits is not None), outer_iters, inner_iters,
            tile, Bp // tile,
            group, plan.smask, stream,
        )
    if err != 0:
        raise RuntimeError(f"tracker kernel launch failed: {lib.tracker_error_string(err).decode()}")
    LAUNCHES += 1
    LAUNCHES_BY_KERNEL[ode_rows.kernel] += 1
    return us, xs, viol, conv > 0.5, lam, ni


def prepare_tiles(x0s, u_init, refs, params, *, tile):
    """The kernel's stage-major operands, padded with zeros to a tile
    multiple as the reference pads every operand (``lanes()``,
    ``ilqr_factory.py:1364-1368`` of the JAX package); ``refs`` and
    ``params`` may be ``None``."""
    if tile < 1:
        raise ValueError("tile must be positive")
    pad = -x0s.shape[0] % tile
    lanes = lambda a, perm: None if a is None else torch.nn.functional.pad(
        a.to(torch.float32).permute(*perm), (0, pad)
    ).contiguous()
    return (lanes(x0s, (1, 0)), lanes(u_init, (1, 2, 0)), lanes(refs, (1, 2, 0)),
            lanes(params, (1, 0)))


def _check_options(*, ode_rows, nx, nu, limits, state_limits, weights, integrator, params,
                   n_params, weights_rt=None, extra_constraints=None, n_extra=0,
                   input_mode="ode", exo=None, n_exo=0, input_weights_rt=None,
                   terminal_state_limits=None, lam_init=None):
    """Raise for what the kernel and its twin do not take (yet)."""
    if not 1 <= nu <= MAX_NU:
        raise NotImplementedError(
            f"fused_tracker_solve supports 1 <= nu <= {MAX_NU} (closed form at nu <= 2, "
            "unrolled Cholesky beyond), as the JAX package's"
        )
    if extra_constraints is not None or n_extra:
        raise NotImplementedError("extra_constraints are not ported yet: ROADMAP S4.3")
    if limits is None and state_limits is None:
        raise ValueError(
            "the AL kernel needs at least one constraint row: pass an input box (limits) or "
            "a state box (state_limits)"
        )
    if lam_init is not None:
        raise NotImplementedError("lam_init (AL warm start) is not ported yet: ROADMAP S4.3")
    if weights_rt is not None:
        raise NotImplementedError("weights_rt (runtime weights) is not ported yet: ROADMAP S5")
    if (input_mode != "ode" or exo is not None or n_exo or input_weights_rt is not None
            or terminal_state_limits is not None):
        raise NotImplementedError(
            "input_mode='additive', exo, input_weights_rt and terminal_state_limits "
            "(the nonlinear MHE shape) are not ported yet: ROADMAP S4.4"
        )
    if weights is None:
        raise ValueError("pass weights (Qd, Rd, qn)")
    if integrator not in ("rk4", "euler"):
        raise ValueError("integrator must be 'rk4' or 'euler'")
    if (params is None) != (n_params == 0):
        raise ValueError("pass params together with n_params > 0")
    if params is not None and params.shape[-1] != n_params:
        raise ValueError("params.shape[-1] must equal n_params")
    if not 1 <= nx <= MAX_NX:
        raise ValueError(f"nx must be 1..{MAX_NX}")
    if isinstance(ode_rows, TrackerModel) and (
        (ode_rows.nx, ode_rows.nu, ode_rows.n_params) != (nx, nu, n_params)
    ):
        raise ValueError("nx, nu and n_params must match the tracker model")


def _solve_tiled(solver, x0s, u_init, refs=None, *, ode_rows, nx, nu, N, ts, substeps,
                 limits, weights=None, state_limits=None, integrator="rk4", params=None,
                 n_params=0, outer_iters=6, inner_iters=15, mu_init=10.0, mu_scale=10.0,
                 mu_max=1e8, viol_tol=1e-4, tol=1e-6, tile=DEFAULT_TILE, **unported):
    """Check, prepare, run ``solver`` on the padded tiles, return the public
    layout."""
    _check_options(ode_rows=ode_rows, nx=nx, nu=nu, limits=limits, state_limits=state_limits,
                   weights=weights, integrator=integrator, params=params, n_params=n_params,
                   **unported)
    B = x0s.shape[0]
    x0, u0, rf, par = prepare_tiles(x0s, u_init, refs, params, tile=tile)
    us, xs, viol, conv, lam, ni = solver(
        x0, u0, rf, par, ode_rows=ode_rows, nx=nx, nu=nu, N=N, tile=tile, ts=float(ts),
        substeps=int(substeps), integrator=integrator,
        limits=None if limits is None else tuple(tuple(float(v) for v in b) for b in limits),
        state_limits=None if state_limits is None
        else tuple(tuple(float(v) for v in b) for b in state_limits),
        weights=(tuple(float(v) for v in weights[0]), tuple(float(v) for v in weights[1]),
                 float(weights[2])),
        outer_iters=outer_iters, inner_iters=inner_iters, mu_init=float(mu_init),
        mu_scale=float(mu_scale), mu_max=float(mu_max), viol_tol=float(viol_tol),
        tol=float(tol),
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
    ode_rows,  # a TrackerModel, or a bare row function (twin only)
    nx: int,
    nu: int,
    N: int,
    ts: float,
    substeps: int,
    limits: tuple | None,  # (lb_u(nu), ub_u(nu)); None: no input box
    weights: tuple | None = None,  # (Qd(nx), Rd(nu), qn)
    weights_rt: torch.Tensor | None = None,
    state_limits: tuple | None = None,  # (lb_x(nx), ub_x(nx))
    integrator: str = "rk4",  # "rk4" | "euler"
    extra_constraints=None,
    n_extra: int = 0,
    extra_deps: str = "xu",
    extra_order: int = 2,
    params: torch.Tensor | None = None,  # (B, n_params) per-scenario ODE parameters
    n_params: int = 0,
    input_mode: str = "ode",
    exo: torch.Tensor | None = None,
    n_exo: int = 0,
    input_weights_rt: torch.Tensor | None = None,
    terminal_state_limits: tuple | None = None,
    lam_init: torch.Tensor | None = None,
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
    twin :func:`tracker_tiles_reference`. On CUDA ``ode_rows`` must be a
    :class:`TrackerModel`: a bare row function raises
    ``NotImplementedError`` (ROADMAP S4.6). One CTA runs one tile with
    ``group`` threads per lane (one of :data:`GROUPS`; for ``None`` the
    instantiation's :data:`DEFAULT_GROUP`, or the largest group that fits
    ``tile`` where that does not); the solution does not depend on it. A CTA
    has ``tile × group`` threads, and an explicit ``group`` that makes more
    than :data:`MAX_THREADS` raises ``ValueError`` (:func:`launch_plan`). The
    twin ignores a valid ``group``.
    ``extra_deps`` and ``extra_order`` belong to ``extra_constraints``, which
    is not ported.
    """
    del extra_deps, extra_order
    default = DEFAULT_GROUP.get(getattr(ode_rows, "kernel", None), 1)
    group = resolve_group(group, tile, default, GROUPS, MAX_THREADS)
    if group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, not {group}")
    if x0s.is_cuda:
        if not isinstance(ode_rows, TrackerModel):
            raise NotImplementedError(
                "a row function without a C++ instantiation runs only on the twin; "
                "code generation for user ODEs is not ported yet: ROADMAP S4.6"
            )
        # _launch is looked up at call time, so that a run can observe it
        solver = lambda *a, **k: _launch(*a, group=group, **k)
    else:
        solver = tracker_tiles_reference
    return _solve_tiled(
        solver, x0s, u_init, refs, ode_rows=ode_rows, nx=nx, nu=nu, N=N, ts=ts,
        substeps=substeps, limits=limits, weights=weights, weights_rt=weights_rt,
        state_limits=state_limits, integrator=integrator,
        extra_constraints=extra_constraints, n_extra=n_extra, params=params,
        n_params=n_params, input_mode=input_mode, exo=exo, n_exo=n_exo,
        input_weights_rt=input_weights_rt, terminal_state_limits=terminal_state_limits,
        lam_init=lam_init, outer_iters=outer_iters, inner_iters=inner_iters,
        mu_init=mu_init, mu_scale=mu_scale, mu_max=mu_max, viol_tol=viol_tol, tol=tol,
        tile=tile,
    )


_SIGNATURE = inspect.signature(fused_tracker_solve_cuda)


def fused_tracker_solve_twin(*args, **kwargs) -> BatchedTrackerSolution:
    """:func:`fused_tracker_solve_cuda` with the same arguments, always on
    the plain twin and on any device: the reference the kernel is held
    against on the card."""
    bound = _SIGNATURE.bind(*args, **kwargs)
    bound.apply_defaults()
    kw = dict(bound.arguments)
    del kw["extra_deps"], kw["extra_order"]
    if kw.pop("group") not in (None, *GROUPS):
        raise ValueError(f"group must be one of {GROUPS}")
    return _solve_tiled(tracker_tiles_reference, **kw)


def make_fused_tracker(ode_rows, nx: int, nu: int, **config):
    """Bind a row-form ODE and a static configuration into a batched solve:

        step = make_fused_tracker(model, nx=6, nu=2, N=15, ts=0.05,
                                  substeps=4, limits=..., weights=...)
        sol = step(x0s, u_init, refs)

    Per-call tensors (``params``) stay call-site keywords; ``tile`` and
    ``group`` are part of the configuration."""
    return functools.partial(fused_tracker_solve_cuda, ode_rows=ode_rows, nx=nx, nu=nu, **config)
