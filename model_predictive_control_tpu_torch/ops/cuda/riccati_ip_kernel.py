"""Fused batched stagewise Riccati interior-point solve: the hand-written
CUDA kernel (``csrc/riccati_ip_kernel.cu``), its plain-PyTorch twin and the
wrapper.

Replaces ``model_predictive_control_tpu/experimental/riccati_ip_kernel.py``
(``_stagewise_ip_tile_kernel``, wrapper ``stagewise_ip_solve_pallas``). One
launch runs the whole Mehrotra predictor-corrector solve of
``solvers/riccati_ip.py::stagewise_ip_solve`` for every scenario of an LTI
box-constrained LQ problem: the init rollout with balanced slacks; per
iteration one Riccati factor sweep, the predictor and corrector affine
sweeps, the fraction-to-boundary step, the finiteness guards and the
per-lane freeze; then the two-pass augmented-Lagrangian active-set polish,
its acceptance test and the status.

Tile semantics (kept from the reference): a lane whose duality measure falls
below 50·eps freezes, a lane whose direction or candidate is non-finite is
latched dead, both keep their state by select, and the loop ends when every
lane of the tile is done. So the executed iterations, and at the tolerance
edge nothing else, depend on the tile, and nothing depends on the group of
threads that serves a lane on the card. :func:`stagewise_ip_tiles_reference`
is the plain twin of the same tile algorithm, each element's operations in
the kernel's order; :func:`stagewise_ip_solve_cuda` takes it only for CPU
tensors.

The equilibration depends on the problem data alone: it is evaluated once in
float64 numpy and cast to float32 (:func:`prepare_problem`, once per problem
in a closed loop), the kernel solves in the scaled space, and the wrapper
maps the solution back. Supported sizes: any nx, nu ∈ {1, 2} (closed-form
Quu inverse); one library is built per ``(nx, nu)`` and thread group.

Both the kernel and the twin work on stage-major operands, ``(stage, row,
lane)`` with the padded batch last.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import inspect
import math

import numpy as np
import torch

from ...solvers.riccati_ip import bound_scale, cost_normalizer, lq_affine_solve, lq_factor
from ._build import PKG, load_library
from .ilqr_kernel import LaunchPlan, plan_launch, resolve_group

_BIG = 1e20
_TAU = 0.995
_RHO = 1e4  # the polish's penalty
EPS50 = 50.0 * float(np.finfo(np.float32).eps)  # the freeze threshold on μ
# Threads per lane the kernel is built for, and the threads per CTA (tile ×
# group) its launch bounds allow (csrc/riccati_ip_kernel.cu MAX_THREADS)
GROUPS = (1, 8, 32)
MAX_THREADS = {1: 256, 8: 512, 32: 512}
# shared memory a CTA may ask for on an H100 (227 KB)
SMEM_LIMIT = 232448
# GPU defaults: scenario lanes per CTA and threads per lane, chosen by time
# in the kernel over the long-horizon loop on the H100 (PERF.md, Findings)
DEFAULT_TILE = 16
DEFAULT_GROUP = 32

# Kernel launches made by stagewise_ip_solve_cuda (one per solve). Tests and
# chip_smoke.py read it to show that a run went through the kernel.
LAUNCHES = 0

_SOURCES = [PKG / "csrc" / "riccati_ip_kernel.cu"]
# the twin's arithmetic rounds after every operation; so does the kernel's
# without contraction into fused multiply-adds
NVCC_EXTRA = ("--fmad=false",)


def library_name(nx: int = 2, nu: int = 1, group: int = 1) -> str:
    base = f"riccati_ip_kernel_nx{nx}_nu{nu}"
    return base if group == 1 else f"{base}_g{group}"


@dataclasses.dataclass(frozen=True)
class BatchedStagewiseIPSolution:
    us: torch.Tensor  # (B, N, nu)
    xs: torch.Tensor  # (B, N+1, nx), dynamics-consistent with us from x0
    mu: torch.Tensor  # (B,) final duality measure (scaled space)
    prim_res: torch.Tensor  # (B,) ∞-norm bound violation (scaled space)
    success: torch.Tensor  # (B,) bool
    iters_executed: torch.Tensor  # (B,) the tile's executed IP iterations


@dataclasses.dataclass(frozen=True)
class ScaledProblem:
    """The equilibrated LTI problem as float32-exact Python floats (rows of
    tuples), what the kernel takes as constants. Bounds may be ±inf."""

    A: tuple
    B: tuple
    Q: tuple
    R: tuple
    Pf: tuple
    xlb: tuple
    xub: tuple
    ulb: tuple
    uub: tuple

    @property
    def nx(self) -> int:
        return len(self.A)

    @property
    def nu(self) -> int:
        return len(self.R)

    def n_finite(self, N: int) -> int:
        return N * sum(math.isfinite(v) for v in (*self.xlb, *self.xub, *self.ulb, *self.uub))


def _equilibrate_np(A, B, Q, R, Pf, x_lb, x_ub, u_lb, u_ub):
    """``stagewise_ip_solve``'s structural equilibration in float64 numpy,
    with the solver module's own ``bound_scale`` and ``cost_normalizer``;
    only the diagonal rescaling of the single (LTI) matrices is restated."""
    A, B, Q, R, Pf = (np.asarray(v, np.float64) for v in (A, B, Q, R, Pf))
    x_lb, x_ub, u_lb, u_ub = (np.asarray(v, np.float64) for v in (x_lb, x_ub, u_lb, u_ub))
    w_x = bound_scale(x_lb, x_ub, xp=np)
    w_u = bound_scale(u_lb, u_ub, xp=np)
    A_s = A * (w_x[None, :] / w_x[:, None])
    B_s = B * (w_u[None, :] / w_x[:, None])
    Q_s = Q * (w_x[:, None] * w_x[None, :])
    R_s = R * (w_u[:, None] * w_u[None, :])
    Pf_s = Pf * (w_x[:, None] * w_x[None, :])
    c = cost_normalizer(Q_s, R_s, Pf_s, xp=np)
    return (A_s, B_s, c * Q_s, c * R_s, c * Pf_s,
            x_lb / w_x, x_ub / w_x, u_lb / w_u, u_ub / w_u, w_x, w_u)


def _f32_rows(M) -> tuple:
    return tuple(tuple(float(v) for v in row) for row in np.asarray(M, np.float32))


def _f32_vec(v) -> tuple:
    return tuple(float(x) for x in np.asarray(v, np.float32))


def _dot(coeffs, vals, acc=None):
    """``acc + Σ c·v`` summed in index order (as the kernel does)."""
    for c, v in zip(coeffs, vals):
        term = c * v
        acc = term if acc is None else acc + term
    return acc


class _Group:
    """One bound group (states x_1..x_N or inputs u_0..u_{N-1}) of the twin:
    the finite-bound flags, the bounds and the slack and dual buffers
    ``(N, n, nt, T)``. Entries without a bound are never read."""

    def __init__(self, lb, ub, like):
        self.n = len(lb)
        self.ml = tuple(math.isfinite(v) for v in lb)
        self.mu = tuple(math.isfinite(v) for v in ub)
        self.lb, self.ub = lb, ub
        self.s_l, self.s_u = torch.ones_like(like), torch.ones_like(like)
        self.l_l, self.l_u = torch.zeros_like(like), torch.zeros_like(like)


def stagewise_ip_tiles_reference(x0, u0, *, N, problem: ScaledProblem, iters, tau, tile):
    """Plain-PyTorch twin of the kernel on stage-major padded operands in the
    scaled space: ``x0`` is ``(nx, Bp)``, ``u0`` ``(N, nu, Bp)``, ``Bp`` a
    multiple of ``tile``. Works on ``(Bp/T, T)`` lane views with per-lane
    masks and the tile-wide loop exit; sweeps with a carry run stage by
    stage, the others on all stages at once, each element's operations in
    the kernel's order. Returns ``us (N, nu, Bp)``, ``xs (N+1, nx, Bp)``,
    ``mu``, ``prim_res``, ``success`` (bool) and the tile's executed
    iterations, each ``(Bp,)``."""
    c = problem
    nx, nu = c.nx, c.nu
    Am, Bm, Qm, Rm, Pfm = c.A, c.B, c.Q, c.R, c.Pf
    dev, f32 = x0.device, torch.float32
    Bp, T = x0.shape[-1], tile
    nt = Bp // T
    lanes = lambda a: a.reshape(*a.shape[:-1], nt, T)
    full = lambda v: torch.full((nt, T), v, dtype=f32, device=dev)
    buf = lambda rows: torch.zeros(N, rows, nt, T, dtype=f32, device=dev)
    inv_count = 1.0 / float(max(c.n_finite(N), 1))
    ABm = tuple(Am[i] + Bm[i] for i in range(nx))  # rows of [A | B]

    x0 = lanes(x0)
    xs = torch.empty(N + 1, nx, nt, T, dtype=f32, device=dev)
    us = lanes(u0).clone()
    gx = _Group(c.xlb, c.xub, buf(nx))
    gu = _Group(c.ulb, c.uub, buf(nu))
    K_s, Qi_s, Qux_s, kff_s = buf(nu * nx), buf(nu * nu), buf(nu * nx), buf(nu)
    dx_s, du_s, dxa_s, dua_s = buf(nx), buf(nu), buf(nx), buf(nu)
    groups = lambda: ((gx, xs[1:]), (gu, us))  # each group with its z (N, n, nt, T)

    # ---- init: rollout of the warm controls, balanced slacks ----------------
    xs[0] = x0
    x = list(x0)
    for t in range(N):
        x = [_dot(ABm[i], x + list(us[t])) for i in range(nx)]
        xs[t + 1] = torch.stack(x)
    for g, z in groups():
        for i in range(g.n):
            if g.ml[i]:
                g.s_l[:, i] = torch.clamp(z[:, i] - g.lb[i], 1.0, _BIG)
                g.l_l[:, i] = torch.reciprocal(g.s_l[:, i])
            if g.mu[i]:
                g.s_u[:, i] = torch.clamp(g.ub[i] - z[:, i], 1.0, _BIG)
                g.l_u[:, i] = torch.reciprocal(g.s_u[:, i])

    # ---- per-group elementwise pieces, on all stages at once ----------------
    def bound_steps(g, z, dz, sig_mu, dza):
        """Newton slack and dual updates ``(ds_l, ds_u, dl_l, dl_u)`` per
        entry (``None`` without that bound); ``dza`` is the stored predictor
        direction when the Mehrotra correction applies."""
        out = []
        for i in range(g.n):
            ds_l = ds_u = dl_l = dl_u = None
            if g.ml[i]:
                sl, ll = g.s_l[:, i], g.l_l[:, i]
                r_pl = z[:, i] - sl - g.lb[i]
                c_l = 0.0
                if dza is not None:
                    ds_a = dza[:, i] + r_pl
                    c_l = (-ll - (ll / sl) * ds_a) * ds_a
                ds_l = dz[:, i] + r_pl
                dl_l = (sig_mu - c_l - ll * sl - ll * ds_l) / sl
            if g.mu[i]:
                su, lu = g.s_u[:, i], g.l_u[:, i]
                r_pu = z[:, i] + su - g.ub[i]
                c_u = 0.0
                if dza is not None:
                    ds_a = -dza[:, i] - r_pu
                    c_u = (-lu - (lu / su) * ds_a) * ds_a
                ds_u = -dz[:, i] - r_pu
                dl_u = (sig_mu - c_u - lu * su - lu * ds_u) / su
            out.append((ds_l, ds_u, dl_l, dl_u))
        return out

    def pairs(g, i, db_i):
        """(current value, its direction) of entry i's finite bounds, in the
        kernel's order: s_l, s_u, λ_l, λ_u."""
        ds_l, ds_u, dl_l, dl_u = db_i
        out = []
        if g.ml[i]:
            out.append((g.s_l[:, i], ds_l))
        if g.mu[i]:
            out.append((g.s_u[:, i], ds_u))
        if g.ml[i]:
            out.append((g.l_l[:, i], dl_l))
        if g.mu[i]:
            out.append((g.l_u[:, i], dl_u))
        return out

    def barrier_grad(g, z, sig_mu, dza):
        rows = []
        for i in range(g.n):
            acc = torch.zeros_like(z[:, i])
            if g.ml[i]:
                sl, ll = g.s_l[:, i], g.l_l[:, i]
                r_pl = z[:, i] - sl - g.lb[i]
                c_l = 0.0
                if dza is not None:
                    ds_a = dza[:, i] + r_pl
                    c_l = (-ll - (ll / sl) * ds_a) * ds_a
                acc = acc - (sig_mu - c_l) / sl + (ll / sl) * r_pl
            if g.mu[i]:
                su, lu = g.s_u[:, i], g.l_u[:, i]
                r_pu = z[:, i] + su - g.ub[i]
                c_u = 0.0
                if dza is not None:
                    ds_a = -dza[:, i] - r_pu
                    c_u = (-lu - (lu / su) * ds_a) * ds_a
                acc = acc + (sig_mu - c_u) / su + (lu / su) * r_pu
            rows.append(acc)
        return rows

    def gap(prods):
        """Mean complementarity product: the per-entry products summed in
        the kernel's order (stage, group, entry, lower then upper)."""
        tot = full(0.0)
        for m in range(N):
            for p in prods:
                tot = tot + p[m]
        return tot * inv_count

    def gap_now():
        prods = []
        for g, _ in groups():
            for i in range(g.n):
                if g.ml[i]:
                    prods.append(g.s_l[:, i] * g.l_l[:, i])
                if g.mu[i]:
                    prods.append(g.s_u[:, i] * g.l_u[:, i])
        return gap(prods)

    def directions(dxs, dus, sig_mu, use_corr):
        return [
            (g, z, dz, bound_steps(g, z, dz, sig_mu, dza if use_corr else None))
            for (g, z), dz, dza in zip(groups(), (dxs, dus), (dxa_s, dua_s))
        ]

    def gap_after(alpha, dirs):
        prods = []
        for g, _, _, db in dirs:
            for i in range(g.n):
                ds_l, ds_u, dl_l, dl_u = db[i]
                if g.ml[i]:
                    prods.append((g.s_l[:, i] + alpha * ds_l) * (g.l_l[:, i] + alpha * dl_l))
                if g.mu[i]:
                    prods.append((g.s_u[:, i] + alpha * ds_u) * (g.l_u[:, i] + alpha * dl_u))
        return gap(prods)

    def alpha_max(dirs):
        """Fraction-to-boundary step and whether the direction is finite."""
        acc, okf = full(_BIG), torch.ones(nt, T, dtype=torch.bool, device=dev)
        for g, _, dz, db in dirs:
            for i in range(g.n):
                for v, dv in pairs(g, i, db[i]):
                    r = torch.where(dv < 0.0, -v / torch.clamp(dv, max=-1e-30), _BIG)
                    acc = torch.minimum(acc, r.amin(dim=0))
                    okf = okf & torch.isfinite(dv).all(dim=0)
                okf = okf & torch.isfinite(dz[:, i]).all(dim=0)
        return torch.clamp(acc, max=1.0), okf

    def candidates_finite(alpha, dirs):
        fin = torch.ones(nt, T, dtype=torch.bool, device=dev)
        for g, z, dz, db in dirs:
            for i in range(g.n):
                fin = fin & torch.isfinite(z[:, i] + alpha * dz[:, i]).all(dim=0)
                for v, dv in pairs(g, i, db[i]):
                    fin = fin & torch.isfinite(v + alpha * dv).all(dim=0)
        return fin

    def update(alpha, sel, dirs):
        """Apply the step on the lanes of ``sel``; the others keep their
        state by select (a NaN direction times zero would poison them)."""
        for g, z, dz, db in dirs:
            for i in range(g.n):
                for v, dv in pairs(g, i, db[i]):
                    v.copy_(torch.where(sel, v + alpha * dv, v))
                z[:, i] = torch.where(sel, z[:, i] + alpha * dz[:, i], z[:, i])

    # ---- sweeps with a carry -----------------------------------------------
    def factor_sweep(sigx, sigu):
        """Backward Riccati over the barrier- or penalty-modified costs
        (``sig*`` are the diagonal additions, ``(N, n, nt, T)``); fills the
        gains. P's upper triangle is computed and mirrored."""
        P = [[full(Pfm[i][j]) for j in range(nx)] for i in range(nx)]
        for i in range(nx):
            P[i][i] = P[i][i] + sigx[N - 1, i]
        for t in range(N - 1, -1, -1):
            PB = [[_dot(P[i], [Bm[j][a] for j in range(nx)]) for a in range(nu)] for i in range(nx)]
            Quu = [[None] * nu for _ in range(nu)]
            for a in range(nu):
                for b in range(a, nu):
                    acc = full(Rm[a][b])
                    if a == b:
                        acc = acc + sigu[t, a]
                    acc = _dot([Bm[i][a] for i in range(nx)], [PB[i][b] for i in range(nx)], acc)
                    Quu[a][b] = Quu[b][a] = acc
            if nu == 1:
                Qi = [[torch.reciprocal(Quu[0][0])]]
            else:
                det = Quu[0][0] * Quu[1][1] - Quu[0][1] * Quu[0][1]
                inv_det = torch.reciprocal(det)
                off = -Quu[0][1] * inv_det
                Qi = [[Quu[1][1] * inv_det, off], [off, Quu[0][0] * inv_det]]
            PA = [[_dot(P[i], [Am[m][j] for m in range(nx)]) for j in range(nx)] for i in range(nx)]
            Qux = [
                [_dot([Bm[i][a] for i in range(nx)], [PA[i][j] for i in range(nx)]) for j in range(nx)]
                for a in range(nu)
            ]
            K = [
                [-_dot(Qi[a], [Qux[b][j] for b in range(nu)]) for j in range(nx)]
                for a in range(nu)
            ]
            K_s[t] = torch.stack([K[a][j] for a in range(nu) for j in range(nx)])
            Qi_s[t] = torch.stack([Qi[a][b] for a in range(nu) for b in range(nu)])
            Qux_s[t] = torch.stack([Qux[a][j] for a in range(nu) for j in range(nx)])
            if t == 0:
                break  # δx₀ is fixed: no cost-to-go at stage 0
            P_new = [[None] * nx for _ in range(nx)]
            for i in range(nx):
                for j in range(i, nx):
                    acc = full(Qm[i][j])
                    if i == j:
                        acc = acc + sigx[t - 1, i]
                    acc = _dot([Am[m][i] for m in range(nx)], [PA[m][j] for m in range(nx)], acc)
                    acc = _dot([Qux[a][i] for a in range(nu)], [K[a][j] for a in range(nu)], acc)
                    P_new[i][j] = P_new[j][i] = acc
            P = P_new

    def affine_solve(q_all, r_all, dxs, dus, x_init=None):
        """The affine backward and forward sweeps over the current
        factorization: ``q_all[m]`` / ``r_all[m]`` are the linear terms at
        x_{m+1} / u_m; the direction at x_{m+1} goes to ``dxs[m]``."""
        p = list(q_all[N - 1])
        for t in range(N - 1, -1, -1):
            Qi, Qux = Qi_s[t], Qux_s[t]
            qu = [r_all[t, a] + _dot([Bm[i][a] for i in range(nx)], p) for a in range(nu)]
            kff = [-_dot([Qi[a * nu + b] for b in range(nu)], qu) for a in range(nu)]
            kff_s[t] = torch.stack(kff)
            if t == 0:
                break
            p = [
                _dot([Qux[a * nx + j] for a in range(nu)], kff,
                     _dot([Am[i][j] for i in range(nx)], p, q_all[t - 1, j]))
                for j in range(nx)
            ]
        dx = [full(0.0)] * nx if x_init is None else list(x_init)
        for t in range(N):
            K, kff = K_s[t], kff_s[t]
            du = [kff[a] + _dot([K[a * nx + j] for j in range(nx)], dx) for a in range(nu)]
            dus[t] = torch.stack(du)
            dx = [_dot(ABm[i], dx + du) for i in range(nx)]
            dxs[t] = torch.stack(dx)

    def sigma_rows(g):
        rows = torch.zeros_like(g.s_l)
        for i in range(g.n):
            if g.ml[i]:
                rows[:, i] = rows[:, i] + g.l_l[:, i] / g.s_l[:, i]
            if g.mu[i]:
                rows[:, i] = rows[:, i] + g.l_u[:, i] / g.s_u[:, i]
        return rows

    def ip_linear_terms(sig_mu, use_corr):
        """Gradients at x_{m+1} (Q for m < N-1, Pf at the terminal stage)
        and u_m: cost plus barrier."""
        z = xs[1:]
        quad = [_dot(Qm[j], list(z.unbind(1))) for j in range(nx)]
        for j in range(nx):
            quad[j] = torch.cat([quad[j][:-1], _dot(Pfm[j], list(z[-1]))[None]])
        bar = barrier_grad(gx, z, sig_mu, dxa_s if use_corr else None)
        q_all = torch.stack([quad[j] + bar[j] for j in range(nx)], dim=1)
        quad_u = [_dot(Rm[a], list(us.unbind(1))) for a in range(nu)]
        bar_u = barrier_grad(gu, us, sig_mu, dua_s if use_corr else None)
        r_all = torch.stack([quad_u[a] + bar_u[a] for a in range(nu)], dim=1)
        return q_all, r_all

    # ---- Mehrotra predictor-corrector loop, tile-wide exit ------------------
    zero = full(0.0)
    it = torch.zeros(nt, dtype=torch.long, device=dev)
    done = torch.zeros(nt, T, dtype=torch.bool, device=dev)
    dead = torch.zeros(nt, T, dtype=torch.bool, device=dev)
    mu = gap_now()
    while True:
        run = (it < iters) & ~done.all(dim=1)
        if not bool(run.any()):
            break
        run2 = run[:, None]
        frozen = mu < EPS50
        factor_sweep(sigma_rows(gx), sigma_rows(gu))
        # predictor: pure Newton (σ = 0)
        affine_solve(*ip_linear_terms(zero, False), dxa_s, dua_s)
        dirs = directions(dxa_s, dua_s, zero, False)
        alpha_aff, _ = alpha_max(dirs)
        mu_aff = gap_after(alpha_aff, dirs)
        ratio = mu_aff / torch.clamp(mu, min=1e-30)
        sigma = torch.clamp(ratio * ratio * ratio, 1e-8, 1.0)
        sig_mu = sigma * mu
        # corrector: recenter + second-order terms, same factorization
        affine_solve(*ip_linear_terms(sig_mu, True), dx_s, du_s)
        dirs = directions(dx_s, du_s, sig_mu, True)
        alpha_raw, okf = alpha_max(dirs)
        alpha = tau * alpha_raw
        okf = okf & torch.isfinite(alpha) & candidates_finite(alpha, dirs)
        # a rejected lane recomputes the same direction forever: latch it dead
        dead = torch.where(run2, dead | ~okf, dead)
        update(alpha, ~frozen & okf & run2, dirs)
        mu = gap_now()
        done = torch.where(run2, (mu < EPS50) | dead, done)
        it = it + run.long()
    mu_final = mu

    # ---- active-set polish (augmented Lagrangian, two passes) ---------------
    def active_set(g):
        """Per entry: active (float 0/1), active at the upper bound (bool),
        the bound it sits on, the multiplier estimate."""
        out = []
        for i in range(g.n):
            like = g.s_l[:, i]
            a_l = g.l_l[:, i] > g.s_l[:, i] if g.ml[i] else torch.zeros_like(like, dtype=torch.bool)
            a_u = g.l_u[:, i] > g.s_u[:, i] if g.mu[i] else torch.zeros_like(like, dtype=torch.bool)
            act = (a_l | a_u).to(f32)
            base = torch.full_like(like, g.lb[i] if g.ml[i] else 0.0)
            tgt = torch.where(a_u, g.ub[i] if g.mu[i] else 0.0, base)
            lh = torch.where(a_u, g.l_u[:, i], -g.l_l[:, i]) * act
            out.append((act, a_u, tgt, lh))
        return out

    sets = [active_set(g) for g in (gx, gu)]
    lhs = [torch.stack([e[3] for e in s], dim=1) for s in sets]
    factor_sweep(*(torch.stack([e[0] * _RHO for e in s], dim=1) for s in sets))
    for _ in range(2):
        lin = [
            torch.stack([e[0] * (lh[:, i] - _RHO * e[2]) for i, e in enumerate(s)], dim=1)
            for s, lh in zip(sets, lhs)
        ]
        affine_solve(*lin, dx_s, du_s, x_init=x0)
        lhs = [
            torch.stack(
                [lh[:, i] + _RHO * e[0] * (zp[:, i] - e[2]) for i, e in enumerate(s)], dim=1
            )
            for s, lh, zp in zip(sets, lhs, (dx_s, du_s))
        ]

    # ---- polish acceptance and final status ---------------------------------
    def violation(g, z):
        v = torch.zeros_like(z[:, 0])
        for i in range(g.n):
            if g.ml[i]:
                v = torch.maximum(v, g.lb[i] - z[:, i])
            if g.mu[i]:
                v = torch.maximum(v, z[:, i] - g.ub[i])
        return v.amax(dim=0)

    scale_m = torch.maximum(xs.abs().amax(dim=(0, 1)), us.abs().amax(dim=(0, 1)))
    polish_viol = torch.maximum(violation(gx, dx_s), violation(gu, du_s))
    polish_fin = torch.isfinite(dx_s).all(dim=(0, 1)) & torch.isfinite(du_s).all(dim=(0, 1))
    dual_ok = torch.ones(nt, T, dtype=torch.bool, device=dev)
    for s, lh in zip(sets, lhs):
        for i, (act, a_u, _, _) in enumerate(s):
            # the polished multiplier sits on its bound's side of zero
            side_ok = torch.where(a_u, lh[:, i] >= 0.0, lh[:, i] <= 0.0)
            dual_ok = dual_ok & (side_ok | (act < 0.5)).all(dim=0)
    scale = 1.0 + scale_m
    feas_tol = 1e-4 * scale
    polish_ok = polish_fin & (polish_viol < feas_tol) & (mu_final < 1e-2 * scale) & dual_ok
    xs[1:] = torch.where(polish_ok, dx_s, xs[1:])
    us = torch.where(polish_ok, du_s, us)
    prim_res = torch.maximum(violation(gx, xs[1:]), violation(gu, us))
    success = torch.where(
        polish_ok,
        (prim_res < feas_tol) & (mu_final < 1e-4 * scale),
        (mu_final < feas_tol) & (prim_res < feas_tol),
    )
    flat = lambda a: a.reshape(*a.shape[:-2], Bp)
    it_lanes = it.to(f32)[:, None].expand(nt, T)
    return flat(us), flat(xs), flat(mu_final), flat(prim_res), flat(success), flat(it_lanes)


def _consts(problem: ScaledProblem, N: int, tau: float):
    """The kernel's constants (``csrc/riccati_ip_kernel.cu``, struct Consts):
    the float block and the finite-bound flags. A bound that is not finite
    is passed as 0 and never read."""
    c = problem
    fin = lambda v: [x if math.isfinite(x) else 0.0 for x in v]
    flat = lambda M: [v for row in M for v in row]
    floats = [
        *flat(c.A), *flat(c.B), *flat(c.Q), *flat(c.R), *flat(c.Pf),
        *fin(c.xlb), *fin(c.xub), *fin(c.ulb), *fin(c.uub),
        1.0 / float(max(c.n_finite(N), 1)), tau, EPS50, _RHO,
    ]
    flags = [int(math.isfinite(x)) for x in (*c.xlb, *c.xub, *c.ulb, *c.uub)]
    return floats, flags


@functools.lru_cache(maxsize=64)
def _const_arrays(problem: ScaledProblem, N: int, tau: float):
    """:func:`_consts` as the ctypes arrays the launch passes, made once per
    problem, horizon and step fraction."""
    floats, flags = _consts(problem, N, tau)
    return (ctypes.c_float * len(floats))(*floats), (ctypes.c_int * len(flags))(*flags)


# A lane's working set by region, in the order shared memory is filled
# (csrc/riccati_ip_kernel.cu's enum): name, floats per lane, and whether the
# region has a home outside the workspace (an output buffer).
def regions(N: int, nx: int, nu: int, group: int) -> tuple:
    ne = nx + nu
    return (
        ("exchange", group, False),  # one float per member: the group's reductions
        ("gain", N * (2 * nu * nx + nu * nu + nu), False),  # K, Quu⁻¹, Qux, kff
        ("scratch", N * 2 * ne, False),  # the chains' inputs, or the gap products
        ("dir", N * 2 * ne, False),  # the two directions (the polish's solution and multipliers)
        ("xs", N * nx, True),
        ("us", N * nu, True),
        ("slack", N * 4 * ne, False),  # s_l, s_u, λ_l, λ_u
    )


def launch_plan(N: int, nx: int, nu: int, tile: int, group: int) -> LaunchPlan:
    """:func:`~.ilqr_kernel.plan_launch` for the stagewise-IP kernel:
    :data:`GROUPS`, :data:`MAX_THREADS`, :data:`SMEM_LIMIT`."""
    return plan_launch(regions(N, nx, nu, group), tile, group, groups=GROUPS,
                       max_threads=MAX_THREADS, smem_limit=SMEM_LIMIT)


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.stagewise_ip_tiles_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.stagewise_ip_lane_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.stagewise_ip_lane_floats.restype = ctypes.c_int
    lib.stagewise_ip_error_string.argtypes = [ctypes.c_int]
    lib.stagewise_ip_error_string.restype = ctypes.c_char_p


def _build_library(nx: int = 2, nu: int = 1, group: int = 1) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/riccati_ip_kernel.cu`` for one
    ``(nx, nu)`` and ``group`` threads per lane."""
    lib = load_library(
        library_name(nx, nu, group), _SOURCES, _configure,
        extra_flags=(*NVCC_EXTRA, f"-DNX={nx}", f"-DNU={nu}", f"-DIP_GROUP={group}"),
    )
    if (lib.stagewise_ip_group(), lib.stagewise_ip_max_threads()) != (group, MAX_THREADS[group]):
        raise RuntimeError(f"{library_name(nx, nu, group)} was not built for group {group}")
    return lib


def _launch(x0, u0, *, N, problem: ScaledProblem, iters, tau, tile, group=1):
    global LAUNCHES
    nx, nu = problem.nx, problem.nu
    plan = launch_plan(N, nx, nu, tile, group)
    for a in (x0, u0):
        if a.device != x0.device or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError("kernel operands must be contiguous float32 on one device")
    Bp = x0.shape[-1]
    if x0.shape != (nx, Bp) or u0.shape != (N, nu, Bp) or Bp % tile:
        raise ValueError(f"unexpected operand shapes {tuple(x0.shape)} {tuple(u0.shape)}")
    if N * 4 * (nx + nu) * Bp >= 2**31:  # a region's element index is a 32-bit int
        raise ValueError(f"{Bp} scenarios × {N} stages exceed the kernel's 32-bit indices")
    lib = _build_library(nx, nu, group)
    if plan.smask and 4 * tile * lib.stagewise_ip_lane_floats(plan.smask, N) != plan.smem_bytes:
        raise RuntimeError("the kernel's shared-memory layout differs from the wrapper's")
    dev, f32 = x0.device, torch.float32
    us = torch.empty(N, nu, Bp, dtype=f32, device=dev)
    xs = torch.empty(N + 1, nx, Bp, dtype=f32, device=dev)
    mu, prim, succ, it = (torch.empty(Bp, dtype=f32, device=dev) for _ in range(4))
    work = torch.empty(max(plan.work_rows, 1), Bp, dtype=f32, device=dev)
    cfloats, cflags = _const_arrays(problem, N, tau)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.stagewise_ip_tiles_launch(
            *(a.data_ptr() for a in (x0, u0, us, xs, mu, prim, succ, it, work)),
            ctypes.addressof(cfloats), ctypes.addressof(cflags), len(cfloats), len(cflags),
            nx, nu, N, iters, tile, Bp // tile, group, plan.smask, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"stagewise-IP kernel launch failed: {lib.stagewise_ip_error_string(err).decode()}"
        )
    LAUNCHES += 1
    return us, xs, mu, prim, succ > 0.5, it


@dataclasses.dataclass(frozen=True)
class KernelProblem:
    """One problem as the kernel takes it, made once by
    :func:`prepare_problem` and reused by every solve of a closed loop: the
    equilibrated constants, the scalings ``w_x``, ``w_u`` that map a
    solution back, the scaled state of a padded lane, and the scaled data of
    the cold start, all on the solves' device."""

    problem: ScaledProblem
    w_x: torch.Tensor  # (nx,)
    w_u: torch.Tensor  # (nu,)
    x_pad: torch.Tensor  # (nx,) mid-box
    cold: tuple  # A, B, Q, R, Pf, u_lb, u_ub, scaled, float32


def prepare_problem(A, B, Q, R, Pf, x_lb, x_ub, u_lb, u_ub, *, device) -> KernelProblem:
    """The kernel's view of an LTI problem on ``device``: the float64
    equilibration of ``stagewise_ip_solve``, cast to float32 once."""
    if any(np.ndim(v) > 1 for v in (x_lb, x_ub, u_lb, u_ub)):
        raise NotImplementedError(
            "the fused stagewise-IP kernel takes time-invariant bounds; per-stage "
            "(N, n) bounds need solvers.riccati_ip.stagewise_ip_solve"
        )
    if np.shape(B)[-1] > 2:
        raise NotImplementedError(
            "the fused stagewise-IP kernel supports nu <= 2 (closed-form Quu "
            "inverse); use solvers.riccati_ip.stagewise_ip_solve for larger nu"
        )
    (A_s, B_s, Q_s, R_s, Pf_s, xlb_s, xub_s, ulb_s, uub_s, w_x, w_u) = _equilibrate_np(
        A, B, Q, R, Pf, x_lb, x_ub, u_lb, u_ub
    )
    problem = ScaledProblem(
        A=_f32_rows(A_s), B=_f32_rows(B_s), Q=_f32_rows(Q_s), R=_f32_rows(R_s),
        Pf=_f32_rows(Pf_s), xlb=_f32_vec(xlb_s), xub=_f32_vec(xub_s),
        ulb=_f32_vec(ulb_s), uub=_f32_vec(uub_s),
    )
    t = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    mid = 0.5 * (np.where(np.isfinite(xlb_s), xlb_s, 0.0) + np.where(np.isfinite(xub_s), xub_s, 0.0))
    return KernelProblem(
        problem=problem, w_x=t(w_x), w_u=t(w_u), x_pad=t(mid),
        cold=tuple(t(v) for v in (A_s, B_s, Q_s, R_s, Pf_s, ulb_s, uub_s)),
    )


def prepare_tiles(kp: KernelProblem, x0s, u_init, *, N, tile):
    """The kernel's operands from the public ones: the scaled stage-major
    ``x0 (nx, Bp)`` and ``u0 (N, nu, Bp)``, padded to a tile multiple.
    ``u_init=None`` gives the unconstrained LQ optimum clipped strictly into
    the input box (one shared factorization, plain torch); padded lanes get
    a mid-box state and zero controls."""
    if tile < 1:
        raise ValueError("tile must be positive")
    nx, nu = kp.problem.nx, kp.problem.nu
    f32, dev = torch.float32, x0s.device
    x0_sc = x0s.to(f32) / kp.w_x
    if u_init is not None:
        u_sc = u_init.to(f32) / kp.w_u
    else:
        A_s, B_s, Q_s, R_s, Pf_s, ulb_t, uub_t = kp.cold
        As, Bs = A_s.expand(N, nx, nx), B_s.expand(N, nx, nu)
        Q_full = torch.cat(
            [torch.zeros(1, nx, nx, dtype=f32, device=dev), Q_s.expand(N - 1, nx, nx), Pf_s[None]]
        )
        factors = lq_factor(As, Bs, Q_full, R_s.expand(N, nu, nu))
        qz = torch.zeros(N + 1, nx, dtype=f32, device=dev)
        rz = torch.zeros(N, nu, dtype=f32, device=dev)
        _, us_free = lq_affine_solve(factors, As, Bs, qz, rz, x_init=x0_sc)
        margin = 1e-3 * torch.minimum(ulb_t.abs() + 1.0, uub_t.abs() + 1.0)
        lo = torch.where(torch.isfinite(ulb_t), ulb_t + margin, torch.full_like(ulb_t, -_BIG))
        hi = torch.where(torch.isfinite(uub_t), uub_t - margin, torch.full_like(uub_t, _BIG))
        u_sc = torch.clamp(us_free, lo, hi)
    pad = -x0s.shape[0] % tile
    if pad:
        x0_sc = torch.cat([x0_sc, kp.x_pad.expand(pad, nx)])
        u_sc = torch.cat([u_sc, torch.zeros(pad, N, nu, dtype=f32, device=dev)])
    return x0_sc.T.contiguous(), u_sc.permute(1, 2, 0).contiguous()


def stagewise_ip_solve_prepared(
    kp: KernelProblem,
    x0s: torch.Tensor,  # (B, nx)
    u_init: torch.Tensor | None = None,  # (B, N, nu)
    *,
    N: int,
    iters: int = 20,
    tau: float = _TAU,
    tile: int = DEFAULT_TILE,
    group: int | None = None,
    twin: bool = False,
) -> BatchedStagewiseIPSolution:
    """:func:`stagewise_ip_solve_cuda` on a problem prepared once
    (:func:`prepare_problem`): what a closed loop calls every step. CUDA
    tensors launch the kernel (or raise); CPU tensors, or ``twin=True`` on
    any device, run the plain twin :func:`stagewise_ip_tiles_reference`,
    which validates ``group`` and ignores it."""
    group = resolve_group(group, tile, DEFAULT_GROUP, GROUPS, MAX_THREADS)
    if group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, not {group}")
    if x0s.is_cuda and not twin:
        # _launch is looked up at call time, so that a run can observe it
        solver = lambda *a, **k: _launch(*a, group=group, **k)
    else:
        solver = stagewise_ip_tiles_reference
    Bn = x0s.shape[0]
    x0, u0 = prepare_tiles(kp, x0s, u_init, N=N, tile=tile)
    us, xs, mu, prim, succ, it = solver(
        x0, u0, N=N, problem=kp.problem, iters=int(iters), tau=float(tau), tile=tile
    )
    return BatchedStagewiseIPSolution(
        us=us.permute(2, 0, 1)[:Bn] * kp.w_u,
        xs=xs.permute(2, 0, 1)[:Bn] * kp.w_x,
        mu=mu[:Bn],
        prim_res=prim[:Bn],
        success=succ[:Bn],
        iters_executed=it[:Bn],
    )


def stagewise_ip_solve_cuda(
    A, B, Q, R, Pf, x_lb, x_ub, u_lb, u_ub,
    x0s: torch.Tensor,  # (B, nx)
    u_init: torch.Tensor | None = None,  # (B, N, nu)
    *,
    N: int,
    iters: int = 20,
    tau: float = _TAU,
    tile: int = DEFAULT_TILE,
    group: int | None = None,  # threads per lane on the card; None: DEFAULT_GROUP
) -> BatchedStagewiseIPSolution:
    """Batched stagewise interior-point solve in one kernel launch; the
    signature and return of the JAX package's ``stagewise_ip_solve_pallas``
    (plus the executed iterations), and ``group``.

    Mirrors :func:`...solvers.riccati_ip.stagewise_ip_solve` on ``(B, nx)``
    states for LTI dynamics, time-invariant bounds and zero linear cost terms
    (the receding-horizon workload); the problem data are arrays on the host.
    ``u_init=None`` reproduces that solver's warm point. CUDA tensors launch
    the kernel (or raise); CPU tensors run the plain twin
    :func:`stagewise_ip_tiles_reference`. One CTA runs one ``tile`` of lanes
    with ``group`` threads per lane (one of :data:`GROUPS`;
    :data:`DEFAULT_GROUP` when ``None``, or the largest group that fits
    ``tile`` where that does not); the solution does not depend on it. A CTA
    has ``tile × group`` threads, and more than :data:`MAX_THREADS` raises
    ``ValueError`` (:func:`launch_plan`)."""
    kp = prepare_problem(A, B, Q, R, Pf, x_lb, x_ub, u_lb, u_ub, device=x0s.device)
    return stagewise_ip_solve_prepared(
        kp, x0s, u_init, N=N, iters=iters, tau=tau, tile=tile, group=group
    )


_SIGNATURE = inspect.signature(stagewise_ip_solve_cuda)


def stagewise_ip_solve_twin(*args, **kwargs) -> BatchedStagewiseIPSolution:
    """:func:`stagewise_ip_solve_cuda` with the same arguments, always on the
    plain twin and on any device: the reference the kernel is held against
    on the card."""
    bound = _SIGNATURE.bind(*args, **kwargs)
    bound.apply_defaults()
    kw = dict(bound.arguments)
    x0s, u_init = kw.pop("x0s"), kw.pop("u_init")
    solve = dict(N=kw.pop("N"), iters=kw.pop("iters"), tau=kw.pop("tau"), tile=kw.pop("tile"),
                 group=kw.pop("group"))
    kp = prepare_problem(*kw.values(), device=x0s.device)
    return stagewise_ip_solve_prepared(kp, x0s, u_init, twin=True, **solve)
