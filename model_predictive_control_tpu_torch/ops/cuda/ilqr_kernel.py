"""Fused batched AL-iLQR for the kinematic-bicycle parking OCP: the
hand-written CUDA kernel (``csrc/ilqr_kernel.cu``), its plain-PyTorch twin
and the wrapper.

Replaces ``model_predictive_control_tpu/ops/pallas/ilqr_kernel.py``
(``_alilqr_tile_kernel``, wrapper ``al_ilqr_solve_pallas``). One launch runs
the whole augmented-Lagrangian solve for every scenario: the outer PHR
multiplier/μ loop, the inner Levenberg-iLQR (analytic Jacobians, exact
clearance curvature, hand-expanded 4×4/2×4/2×2 Riccati sweep) and the
7-step line search.

Tile semantics (kept from the reference): the inner exit (every lane's
``max|Qu| < 0.01·tol``) and the outer exit (every lane primal-feasible with
settled multipliers) are tile-wide, so the tile size changes which lanes
keep iterating; padded lanes (zero state and controls, parameters 1.0) take
part in the last tile's exit tests. ``inner_iters_executed`` is the tile's
summed inner count. :func:`al_ilqr_tiles_reference` is the plain twin of the
same tile algorithm; :func:`al_ilqr_solve_cuda` takes it only for CPU
tensors.

Both work on stage-major operands, ``(stage, row, lane)`` with the padded
batch last: a warp's lanes then read neighbouring addresses in the kernel.

Operand modes (the Pallas kernel's static ``track`` / ``has_dist`` /
``has_uref``): ``refs`` (B, N+1, 4) puts the state costs on ``x − ref_t``,
``dist`` (B, 4) adds an offset to the Euler step after the nominal update,
``urefs`` (B, N, 2) puts the R-cost on ``u − uref_t``. The kernel is
instantiated for no operand (the regulation mode, unchanged), ``refs`` alone
and all three (:data:`KERNEL_MODES`); :func:`prepare_tiles` gives any other
combination as all three, the missing ones zero, which computes the same
numbers. The twin follows the same modes.

Lane groups: on the card ``group`` threads serve one lane (the stages of the
derivative pre-pass and the line-search candidates are dealt to them;
``csrc/ilqr_kernel.cu``), so a CTA has ``tile × group`` threads. ``tile``
keeps its meaning, lanes per CTA, and the numbers of a solve depend on the
tile only: every group computes the same float program. One library is built
per group. :func:`launch_plan` reckons, for ``(N, nc, tile, group)``, the
threads, the regions of a lane's working set that fit into shared memory and
the workspace for the rest, and raises on what the kernel cannot take.
"""

from __future__ import annotations

import ctypes
import dataclasses
import inspect
import math

import torch

from ...utils.geometry import cover_circle_offsets
from ._build import PKG, load_library

NX = 4
NU = 2
ALPHAS = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.01)
REG_INIT, REG_MIN, REG_MAX = 1.0, 1e-8, 1e8
MAX_CIRCLES = 3
KERNEL_CIRCLES = (0, 3)  # the kernel's instantiations (csrc/ilqr_kernel.cu)
# operand modes, bits as csrc/ilqr_kernel.cu's M_TRACK, M_DIST, M_UREF; the
# instantiated ones: regulation, tracking, all three
M_TRACK, M_DIST, M_UREF = 1, 2, 4
M_ALL = M_TRACK | M_DIST | M_UREF
KERNEL_MODES = (0, M_TRACK, M_ALL)
# GPU default scenario tile and thread group, chosen by a tile × group sweep
# on the H100 at the parking sweep's contract configuration, by the time the
# sweep spends in the kernel (PERF.md, Findings)
DEFAULT_TILE = 16
DEFAULT_GROUP = 8
# threads per lane a library is built for, and the threads per CTA (tile ×
# group) its launch bounds allow (csrc/ilqr_kernel.cu MAX_THREADS)
GROUPS = (1, 8, 32)
MAX_THREADS = {1: 256, 8: 512, 32: 512}
# dynamic shared memory one CTA may ask for on sm_90 (227 KB)
SMEM_LIMIT = 232448
N_DERIV = 23  # floats of one stage of the derivative store (csrc/ilqr_kernel.cu ND)

# Kernel launches made by al_ilqr_solve_cuda (one per solve). Tests and
# chip_smoke.py read it to show that a run went through the kernel.
LAUNCHES = 0

LIBRARY = "ilqr_kernel"  # library_name(group) is the file's stem
_SOURCES = [PKG / "csrc" / "ilqr_kernel.cu"]
# the twin's arithmetic rounds after every operation; so does the kernel's
# without contraction into fused multiply-adds (PERF.md, Findings)
NVCC_EXTRA = ("--fmad=false",)


@dataclasses.dataclass(frozen=True)
class BatchedALILQRSolution:
    us: torch.Tensor  # (B, N, 2)
    xs: torch.Tensor  # (B, N + 1, 4)
    viol: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,) bool
    lam: torch.Tensor  # (B, N, nc) AL multipliers (the warm-start handle)
    inner_iters_executed: torch.Tensor  # (B,) the tile's inner iterations


def parking_geometry(params, x_obs, n_circles: int = 3, dtype=None):
    """The kernel's geometry and limit tuples from a
    :class:`~..models.parameters.VehicleParameters` and the obstacle pose:
    ``geom = (KB, LR, offsets, r², obstacle circle centres)`` and
    ``limits = (lb_x, ub_x, lb_u, ub_u)``, the JAX package's values. The
    tuples hold Python floats, so ``dtype`` (the JAX signature's) is not
    read."""
    offsets, r = cover_circle_offsets(params.length, params.width, n_circles, device="cpu")
    ox = tuple(float(v) for v in offsets[:, 0].tolist())
    kb = float(params.axis_rear) / float(params.axis_front + params.axis_rear)
    if x_obs is not None:
        xo = [float(v) for v in x_obs]
        c, s = math.cos(xo[2]), math.sin(xo[2])
        obs = tuple((xo[0] + o * c, xo[1] + o * s) for o in ox)
        r2 = float((2.0 * r) ** 2)
    else:
        obs = ()
        r2 = 0.0
    geom = (kb, float(params.axis_rear), ox, r2, obs)
    limits = (
        tuple(
            float(v)
            for v in (
                params.min_pos_x, params.min_pos_y,
                params.min_heading, params.min_vel,
            )
        ),
        tuple(
            float(v)
            for v in (
                params.max_pos_x, params.max_pos_y,
                params.max_heading, params.max_vel,
            )
        ),
        (float(params.min_drive), -float(params.max_steer)),
        (float(params.max_drive), float(params.max_steer)),
    )
    return geom, limits


def n_constraints(n_circles: int) -> int:
    """Constraint rows per stage: the state and input boxes, then one
    clearance row per circle pair."""
    return 2 * NX + 2 * NU + n_circles * n_circles


def inv_f32(v: float) -> float:
    """The float32 reciprocal of ``v``. Both the twin and the kernel multiply
    by it where the reference divides by the constant ``LR``: XLA compiles a
    division by a constant into that multiplication."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one / torch.tensor(v, dtype=torch.float32))


def _seqsum(rows):
    """Sum over the leading dimension in index order (as the kernel does)."""
    acc = rows[0]
    for r in range(1, rows.shape[0]):
        acc = acc + rows[r]
    return acc


def _relu(a):
    return torch.clamp(a, min=0.0)  # NaN stays NaN, as jnp.maximum(0, ·)


def al_ilqr_tiles_reference(
    x0, u0, pp, lam0, refs=None, dist=None, urefs=None, *, N, n_circ, tile, ts, geom,
    limits, weights, outer_iters, inner_iters, mu_init, mu_scale, mu_max, viol_tol, tol,
):
    """Plain-PyTorch twin of the kernel on stage-major padded operands.

    ``x0`` is ``(4, Bp)``, ``u0`` ``(N, 2, Bp)``, ``pp`` ``(2, Bp)``
    (acceleration, friction), ``lam0`` ``(N, nc, Bp)``, with ``Bp`` a
    multiple of ``tile``; ``refs`` ``(N+1, 4, Bp)``, ``dist`` ``(4, Bp)`` and
    ``urefs`` ``(N, 2, Bp)`` or ``None`` (the mode's operands). Works on ``(Bp/T, T)`` lane views with per-lane
    masks, tile-wide loop exits and the 7 line-search steps as one leading
    dimension. Every operation is the reference kernel's, in its order.
    Returns ``us (N, 2, Bp)``, ``xs (N+1, 4, Bp)``, ``viol (Bp,)``,
    ``converged (Bp,)``, ``lam (N, nc, Bp)`` and the tile's executed inner
    iterations ``(Bp,)``.
    """
    KB, LR, OX, R2, OBS = geom
    LBX, UBX, LBU, UBU = limits
    QD, RD, QN = weights
    dev, f32 = x0.device, torch.float32
    Bp = x0.shape[-1]
    T = tile
    nt = Bp // T
    nc = n_constraints(n_circ)
    P = n_circ * n_circ
    lanes = lambda a: a.reshape(*a.shape[:-1], nt, T)
    cst = lambda v: torch.tensor(v, dtype=f32, device=dev)
    col = lambda v, k=2: cst(v).reshape(-1, *([1] * k))

    x0 = lanes(x0)
    acc, fric = lanes(pp)
    refs = None if refs is None else lanes(refs)
    dist = None if dist is None else lanes(dist)
    urefs = None if urefs is None else lanes(urefs)
    us = lanes(u0).clone()
    lam = lanes(lam0).clone()
    xs = torch.empty(N + 1, NX, nt, T, dtype=f32, device=dev)
    k_s = torch.zeros(N, NU, nt, T, dtype=f32, device=dev)
    K_s = torch.zeros(N, NU * NX, nt, T, dtype=f32, device=dev)
    alpha = col(ALPHAS)  # (A, 1, 1)
    inv_lr = inv_f32(LR)
    KB2 = KB * KB
    lbx, ubx = col(LBX), col(UBX)
    lbu, ubu = col(LBU), col(UBU)
    qd2, rd2 = col([2.0 * q for q in QD]), col([2.0 * r for r in RD])
    if P:
        oxp = [OX[p // n_circ] for p in range(P)]
        qxp = [OBS[p % n_circ][0] for p in range(P)]
        qyp = [OBS[p % n_circ][1] for p in range(P)]

    def dyn(px, py, psi, v, a, dl):
        t = torch.tan(dl)
        den = torch.sqrt(1.0 + KB2 * t * t)
        sinb = KB * t / den
        cosb = 1.0 / den
        sp, cp = torch.sin(psi), torch.cos(psi)
        s_pb = sp * cosb + cp * sinb
        c_pb = cp * cosb - sp * sinb
        xn = (
            px + ts * v * c_pb,
            py + ts * v * s_pb,
            psi + ts * v * sinb * inv_lr,
            v + ts * (acc * a - fric * v),
        )
        if dist is None:
            return xn
        return tuple(xn[i] + dist[i] for i in range(NX))  # the offset after the step

    def rows(px, py, psi, v, a, dl):
        """Constraint rows ``(nc, ...)`` in the reference's order."""
        X = torch.stack([px, py, psi, v])
        U = torch.stack([a, dl])
        k = X.ndim - 1
        out = [X - col(UBX, k), col(LBX, k) - X, U - col(UBU, k), col(LBU, k) - U]
        if P:
            sp, cp = torch.sin(psi), torch.cos(psi)
            ox = col(oxp, k)
            wx = px + ox * cp - col(qxp, k)
            wy = py + ox * sp - col(qyp, k)
            out.append(R2 - (wx * wx + wy * wy))
        return torch.cat(out)

    def quad_x(px, py, psi, v):
        return QD[0] * px * px + QD[1] * py * py + QD[2] * psi * psi + QD[3] * v * v

    def state_cost(x, t):
        """``Qd e e`` of ``e = x`` (``x − refs[t]`` when tracking)."""
        if refs is None:
            return quad_x(*x)
        return quad_x(*(x[i] - refs[t][i] for i in range(NX)))

    def stage_cost(x, u, t, mu):
        c = rows(*x, *u)
        lam_t = lam[t].reshape(nc, *([1] * (c.ndim - 3)), nt, T)
        f = u if urefs is None else (u[0] - urefs[t][0], u[1] - urefs[t][1])
        quad = state_cost(x, t) + (RD[0] * f[0] * f[0] + RD[1] * f[1] * f[1])
        act = _relu(lam_t + mu * c)
        phi = _seqsum(act * act - lam_t * lam_t)
        return quad + phi / (2.0 * mu)

    def total_cost(mu):
        cost = stage_cost(xs[0], us[0], 0, mu)
        for t in range(1, N):
            cost = cost + stage_cost(xs[t], us[t], t, mu)
        return cost + QN * state_cost(xs[N], N)

    def rollout():
        xs[0] = x0
        for t in range(N):
            xs[t + 1] = torch.stack(dyn(*xs[t], *us[t]))

    def stage_derivs(x, u, t, mu):
        """lx (4), lu (2), the upper triangle of lxx and diag(luu); lux = 0."""
        lam_t = lam[t]
        X = torch.stack(list(x))
        act_u = _relu(lam_t[0:NX] + mu * (X - ubx))
        act_l = _relu(lam_t[NX:2 * NX] + mu * (lbx - X))
        lx = list(qd2 * (X if refs is None else X - refs[t]) + act_u - act_l)
        ind = (act_u > 0.0).to(f32) + (act_l > 0.0).to(f32)
        hd = list(qd2 + mu * ind)
        U = torch.stack(list(u))
        b = 2 * NX
        act_u = _relu(lam_t[b:b + NU] + mu * (U - ubu))
        act_l = _relu(lam_t[b + NU:b + 2 * NU] + mu * (lbu - U))
        lu = list(rd2 * (U if urefs is None else U - urefs[t]) + act_u - act_l)
        ind = (act_u > 0.0).to(f32) + (act_l > 0.0).to(f32)
        huu = list(rd2 + mu * ind)
        zero = torch.zeros_like(x[0])
        h01 = h02 = h12 = zero
        if P:
            px, py, psi = x[0], x[1], x[2]
            sp, cp = torch.sin(psi), torch.cos(psi)
            ox = col(oxp)
            ex = -ox * sp
            ey = ox * cp
            wx = px + ox * cp - col(qxp)
            wy = py + ox * sp - col(qyp)
            c = R2 - (wx * wx + wy * wy)
            act = _relu(lam_t[b + 2 * NU:] + mu * c)
            ind = mu * (act > 0.0).to(f32)
            gx = -2.0 * wx
            gy = -2.0 * wy
            gpsi = -2.0 * (wx * ex + wy * ey)
            lx[0] = lx[0] + _seqsum(act * gx)
            lx[1] = lx[1] + _seqsum(act * gy)
            lx[2] = lx[2] + _seqsum(act * gpsi)
            hd[0] = hd[0] + _seqsum(ind * gx * gx - 2.0 * act)
            h01 = h01 + _seqsum(ind * gx * gy)
            h02 = h02 + _seqsum(ind * gx * gpsi - 2.0 * act * ex)
            hd[1] = hd[1] + _seqsum(ind * gy * gy - 2.0 * act)
            h12 = h12 + _seqsum(ind * gy * gpsi - 2.0 * act * ey)
            d2psi = -2.0 * (ox * ox - ox * (wx * cp + wy * sp))
            hd[2] = hd[2] + _seqsum(ind * gpsi * gpsi + act * d2psi)
        hxx = {(i, i): hd[i] for i in range(NX)}
        hxx.update({(0, 1): h01, (0, 2): h02, (1, 2): h12})
        for i, j in ((0, 3), (1, 3), (2, 3)):
            hxx[(i, j)] = zero
        return lx, lu, hxx, huu

    def backward(mu, reg):
        """Riccati sweep over (xs, us); writes the gains, returns (ok, grad)."""
        xN = xs[N] if refs is None else xs[N] - refs[N]
        Vx = [2.0 * QN * QD[i] * xN[i] for i in range(NX)]
        full = lambda v: torch.full((nt, T), v, dtype=f32, device=dev)
        zero = full(0.0)
        Vxx = [
            [full(2.0 * QN * QD[i]) if i == j else zero for j in range(NX)]
            for i in range(NX)
        ]
        ok = torch.ones(nt, T, dtype=torch.bool, device=dev)
        grad = zero
        for t in range(N - 1, -1, -1):
            px, py, psi, v = xs[t]
            a, dl = us[t]
            tn = torch.tan(dl)
            den2 = 1.0 + KB2 * tn * tn
            den = torch.sqrt(den2)
            sinb = KB * tn / den
            cosb = 1.0 / den
            sp, cp = torch.sin(psi), torch.cos(psi)
            s_pb = sp * cosb + cp * sinb
            c_pb = cp * cosb - sp * sinb
            bp = KB * (1.0 + tn * tn) / den2
            a02 = -ts * v * s_pb
            a03 = ts * c_pb
            a12 = ts * v * c_pb
            a13 = ts * s_pb
            a23 = ts * sinb * inv_lr
            a33 = 1.0 - ts * fric
            b01 = -ts * v * s_pb * bp
            b11 = ts * v * c_pb * bp
            b21 = ts * v * cosb * bp * inv_lr
            b30 = ts * acc
            lx, lu, hxx, huu = stage_derivs(xs[t], us[t], t, mu)
            V = lambda i, j: Vxx[i][j]
            Qx = [
                lx[0] + Vx[0],
                lx[1] + Vx[1],
                lx[2] + Vx[2] + a02 * Vx[0] + a12 * Vx[1],
                lx[3] + a03 * Vx[0] + a13 * Vx[1] + a23 * Vx[2] + a33 * Vx[3],
            ]
            Qu0 = lu[0] + b30 * Vx[3]
            Qu1 = lu[1] + b01 * Vx[0] + b11 * Vx[1] + b21 * Vx[2]
            M = [
                [
                    V(i, 0),
                    V(i, 1),
                    V(i, 0) * a02 + V(i, 1) * a12 + V(i, 2),
                    V(i, 0) * a03 + V(i, 1) * a13 + V(i, 2) * a23 + V(i, 3) * a33,
                ]
                for i in range(NX)
            ]
            Qxx = [
                [M[0][j] for j in range(NX)],
                [M[1][j] for j in range(NX)],
                [a02 * M[0][j] + a12 * M[1][j] + M[2][j] for j in range(NX)],
                [
                    a03 * M[0][j] + a13 * M[1][j] + a23 * M[2][j] + a33 * M[3][j]
                    for j in range(NX)
                ],
            ]
            for i in range(NX):
                for j in range(i, NX):
                    h = hxx[(i, j)]
                    Qxx[i][j] = Qxx[i][j] + h
                    if i != j:
                        Qxx[j][i] = Qxx[j][i] + h
            for i in range(NX):
                for j in range(i + 1, NX):
                    sym = 0.5 * (Qxx[i][j] + Qxx[j][i])
                    Qxx[i][j] = sym
                    Qxx[j][i] = sym
            q00 = huu[0] + b30 * b30 * V(3, 3)
            q01 = b30 * (V(3, 0) * b01 + V(3, 1) * b11 + V(3, 2) * b21)
            q11 = huu[1] + (
                b01 * (V(0, 0) * b01 + V(0, 1) * b11 + V(0, 2) * b21)
                + b11 * (V(1, 0) * b01 + V(1, 1) * b11 + V(1, 2) * b21)
                + b21 * (V(2, 0) * b01 + V(2, 1) * b11 + V(2, 2) * b21)
            )
            Qux0 = [b30 * M[3][j] for j in range(NX)]
            Qux1 = [b01 * M[0][j] + b11 * M[1][j] + b21 * M[2][j] for j in range(NX)]
            q00r = q00 + reg
            q11r = q11 + reg
            det = q00r * q11r - q01 * q01
            ok = ok & (q00r > 0.0) & (det > 0.0)
            det_safe = torch.where(det > 0.0, det, torch.ones_like(det))
            i00 = q11r / det_safe
            i11 = q00r / det_safe
            i01 = -q01 / det_safe
            k0 = -(i00 * Qu0 + i01 * Qu1)
            k1 = -(i01 * Qu0 + i11 * Qu1)
            K0 = [-(i00 * Qux0[j] + i01 * Qux1[j]) for j in range(NX)]
            K1 = [-(i01 * Qux0[j] + i11 * Qux1[j]) for j in range(NX)]
            # Vx, Vxx updates with the unregularized Quu
            g0 = q00 * k0 + q01 * k1 + Qu0
            g1 = q01 * k0 + q11 * k1 + Qu1
            Vx = [
                Qx[j] + K0[j] * g0 + K1[j] * g1 + Qux0[j] * k0 + Qux1[j] * k1
                for j in range(NX)
            ]
            KQ0 = [q00 * K0[j] + q01 * K1[j] for j in range(NX)]
            KQ1 = [q01 * K0[j] + q11 * K1[j] for j in range(NX)]
            Vxx = [
                [
                    Qxx[i][j] + K0[i] * KQ0[j] + K1[i] * KQ1[j] + K0[i] * Qux0[j]
                    + K1[i] * Qux1[j] + Qux0[i] * K0[j] + Qux1[i] * K1[j]
                    for j in range(NX)
                ]
                for i in range(NX)
            ]
            k_s[t] = torch.stack([k0, k1])
            K_s[t] = torch.stack(K0 + K1)
            grad = torch.maximum(grad, torch.maximum(Qu0.abs(), Qu1.abs()))
        return ok, grad

    def forward_all(mu):
        """Closed-loop rollouts under u = uh + α k + K (x − xh) for every α
        at once; returns the costs (A, nt, T) and the candidate packs."""
        xs_p = torch.empty(N + 1, NX, len(ALPHAS), nt, T, dtype=f32, device=dev)
        us_p = torch.empty(N, NU, len(ALPHAS), nt, T, dtype=f32, device=dev)
        x = tuple(x0[i].expand(len(ALPHAS), nt, T) for i in range(NX))
        cost = None
        for t in range(N):
            xs_p[t] = torch.stack(x)
            xh, uh, kg, Kg = xs[t], us[t], k_s[t], K_s[t]
            dx = [x[i] - xh[i] for i in range(NX)]
            du0 = alpha * kg[0] + (Kg[0] * dx[0] + Kg[1] * dx[1] + Kg[2] * dx[2] + Kg[3] * dx[3])
            du1 = alpha * kg[1] + (Kg[4] * dx[0] + Kg[5] * dx[1] + Kg[6] * dx[2] + Kg[7] * dx[3])
            u = (uh[0] + du0, uh[1] + du1)
            us_p[t] = torch.stack(u)
            sc = stage_cost(x, u, t, mu)
            cost = sc if cost is None else cost + sc
            x = dyn(*x, *u)
        xs_p[N] = torch.stack(x)
        return cost + QN * state_cost(x, N), xs_p, us_p

    def pick(pack, idx):  # (S, R, A, nt, T) -> (S, R, nt, T) at each lane's α
        i = idx.expand(pack.shape[0], pack.shape[1], 1, nt, T)
        return pack.gather(2, i).squeeze(2)

    def ilqr(mu, active):
        """Levenberg iLQR on the current multipliers for the tiles in
        ``active`` (nt,); returns each tile's executed iterations."""
        nonlocal xs, us
        cost = total_cost(mu)
        reg = torch.full((nt, T), REG_INIT, dtype=f32, device=dev)
        grad = torch.full((nt, T), math.inf, dtype=f32, device=dev)
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
                improved,
                torch.clamp(reg * 0.5, min=REG_MIN),
                torch.clamp(reg * 10.0, max=REG_MAX),
            )
            reg = torch.where(run2, reg_n, reg)
            grad = torch.where(run2, grad_n, grad)
            n_it = n_it + run.long()

    rollout()
    full = lambda v: torch.full((nt, T), v, dtype=f32, device=dev)
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
        v_n = step = lmax = full(0.0)
        for t in range(N):
            c = rows(*xs[t], *us[t])
            lam_n = _relu(lam[t] + mu * c)
            v_n = torch.maximum(v_n, torch.clamp(c, min=0.0).amax(dim=0))
            step = torch.maximum(step, (lam_n - lam[t]).abs().amax(dim=0))
            lmax = torch.maximum(lmax, lam_n.abs().amax(dim=0))
            lam[t] = torch.where(run2, lam_n, lam[t])
        mu_n = torch.where(v_n > viol_tol, torch.clamp(mu * mu_scale, max=mu_max), mu)
        mu = torch.where(run2, mu_n, mu)
        viol = torch.where(run2, v_n, viol)
        lam_step = torch.where(run2, step / (1.0 + lmax), lam_step)
        oi = oi + run.long()

    flat = lambda a: a.reshape(*a.shape[:-2], Bp)
    ni = ni.to(f32)[:, None].expand(nt, T)
    return (
        flat(us), flat(xs), flat(viol), flat(viol < viol_tol), flat(lam), flat(ni)
    )


# Order of the float constants the kernel takes (csrc/ilqr_kernel.cu,
# struct Consts); _consts() fills it.
def _consts(*, ts, geom, limits, weights, mu_init, mu_scale, mu_max, viol_tol,
            tol, n_circ):
    KB, LR, OX, R2, OBS = geom
    LBX, UBX, LBU, UBU = limits
    QD, RD, QN = weights
    pad3 = lambda v: list(v) + [0.0] * (MAX_CIRCLES - len(v))
    return [
        ts, KB, KB * KB, inv_f32(LR), R2,
        *pad3(OX[:n_circ]), *pad3([o[0] for o in OBS]), *pad3([o[1] for o in OBS]),
        *LBX, *UBX, *LBU, *UBU,
        *QD, *RD, QN,
        *(2.0 * q for q in QD), *(2.0 * r for r in RD), *(2.0 * QN * q for q in QD),
        mu_init, mu_scale, mu_max, viol_tol, 0.01 * tol,
        *ALPHAS, REG_INIT, REG_MIN, REG_MAX,
    ]


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    threads: int  # per CTA: tile × group
    smask: int  # bit r: region r lives in shared memory
    smem_bytes: int  # dynamic shared memory per CTA
    work_rows: int  # rows of the (rows, Bp) global workspace


def plan_launch(regions, tile: int, group: int, *, groups, max_threads, smem_limit) -> LaunchPlan:
    """How a lane-group kernel is launched for one tile shape. ``regions``
    are a lane's working set, ``(name, floats, has a home outside the
    workspace)`` in the order the kernel fills shared memory. Regions go to
    shared memory in their order as long as the CTA's ``tile`` lane blocks
    (each padded to an odd float count) fit ``smem_limit``; a region that
    does not fit is skipped and stays in global memory. Raises
    ``ValueError`` for a group not in ``groups`` and for more threads than
    the kernel's launch bounds allow (``max_threads[group]``): a request is
    never shrunk."""
    if group not in groups:
        raise ValueError(f"group must be one of {groups}, not {group}")
    if tile < 1:
        raise ValueError("tile must be positive")
    threads = tile * group
    if threads > max_threads[group]:
        raise ValueError(
            f"tile {tile} × group {group} = {threads} threads per CTA exceeds the "
            f"{max_threads[group]} the kernel's launch bounds allow at this group"
        )
    smask = floats = work_rows = 0
    for r, (_, n, has_home) in enumerate(regions):
        if 4 * tile * ((floats + n) | 1) <= smem_limit:
            smask |= 1 << r
            floats += n
        elif not has_home:
            work_rows += n
    return LaunchPlan(threads, smask, 4 * tile * (floats | 1) if smask else 0, work_rows)


def resolve_group(group, tile: int, default: int, groups, max_threads) -> int:
    """``group``, or for ``None`` the ``default`` when ``tile × default``
    threads fit the launch bounds, else the largest of ``groups`` that fits
    (``default`` again when none does: the launch then refuses the tile)."""
    if group is not None:
        return group
    fits = [g for g in groups if tile * g <= max_threads[g]]
    return default if default in fits or not fits else max(fits)


# A lane's working set by region, in the order shared memory is filled
# (csrc/ilqr_kernel.cu's enum): name, floats per lane, and whether the region
# has a home outside the workspace (an output or an input buffer). The mode's
# operands come last: the regulation mode's regions are the first six alone.
def regions(N: int, nc: int, mode: int = 0) -> tuple:
    base = (
        ("der", N * N_DERIV, False),  # the derivative store
        ("gain", N * NU * (1 + NX), False),  # k and K
        ("xs", (N + 1) * NX, True),
        ("us", N * NU, True),
        ("lam", N * nc, True),
        ("cand", len(ALPHAS) * ((N + 1) * NX + N * NU + 1), False),  # 7 candidates, costs
    )
    if not mode:
        return base
    return base + (
        ("ref", (N + 1) * NX if mode & M_TRACK else 0, True),
        ("uref", N * NU if mode & M_UREF else 0, True),
        ("dist", NX if mode & M_DIST else 0, True),
    )


def launch_plan(N: int, nc: int, tile: int, group: int, mode: int = 0) -> LaunchPlan:
    """:func:`plan_launch` for the parking kernel in operand ``mode``:
    :data:`GROUPS`, :data:`MAX_THREADS`, :data:`SMEM_LIMIT`."""
    return plan_launch(regions(N, nc, mode), tile, group, groups=GROUPS,
                       max_threads=MAX_THREADS, smem_limit=SMEM_LIMIT)


def operand_mode(refs, dist, urefs) -> int:
    """The mode bits of the operands that are given (not ``None``)."""
    return ((refs is not None) * M_TRACK | (dist is not None) * M_DIST
            | (urefs is not None) * M_UREF)


def library_name(group: int) -> str:
    return LIBRARY if group == 1 else f"{LIBRARY}_g{group}"


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.alilqr_tiles_launch
    # 14 buffers and the constants' address, 10 ints, the stream: every
    # pointer a c_void_p (a c_int would cut it to 32 bits)
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.alilqr_error_string.argtypes = [ctypes.c_int]
    lib.alilqr_error_string.restype = ctypes.c_char_p


def _build_library(group: int = 1) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/ilqr_kernel.cu`` for ``group``
    threads per lane."""
    lib = load_library(library_name(group), _SOURCES, _configure,
                       extra_flags=(*NVCC_EXTRA, f"-DALILQR_GROUP={group}"))
    if (lib.alilqr_group(), lib.alilqr_max_threads()) != (group, MAX_THREADS[group]):
        raise RuntimeError(f"{library_name(group)} was not built for group {group}")
    return lib


def _launch(x0, u0, pp, lam0, refs=None, dist=None, urefs=None, *, N, n_circ, tile,
            outer_iters, inner_iters, group=1, **consts):
    global LAUNCHES
    if n_circ not in KERNEL_CIRCLES:
        raise ValueError(f"the kernel takes n_circles in {KERNEL_CIRCLES}, not {n_circ}")
    mode = operand_mode(refs, dist, urefs)
    if mode not in KERNEL_MODES:
        raise ValueError(f"the kernel takes the operand modes {KERNEL_MODES}, not {mode} "
                         "(prepare_tiles fills the missing operands)")
    nc = n_constraints(n_circ)
    plan = launch_plan(N, nc, tile, group, mode)
    for a in (x0, u0, pp, lam0, refs, dist, urefs):
        if a is not None and (a.device != x0.device or a.dtype != torch.float32
                              or not a.is_contiguous()):
            raise ValueError("kernel operands must be contiguous float32 on one device")
    lib = _build_library(group)
    Bp = x0.shape[-1]
    dev = x0.device
    us = torch.empty(N, NU, Bp, dtype=torch.float32, device=dev)
    xs = torch.empty(N + 1, NX, Bp, dtype=torch.float32, device=dev)
    viol = torch.empty(Bp, dtype=torch.float32, device=dev)
    conv = torch.empty(Bp, dtype=torch.float32, device=dev)
    lam = torch.empty(N, nc, Bp, dtype=torch.float32, device=dev)
    ni = torch.empty(Bp, dtype=torch.float32, device=dev)
    work = torch.empty(max(plan.work_rows, 1), Bp, dtype=torch.float32, device=dev)
    values = _consts(n_circ=n_circ, **consts)
    cvals = (ctypes.c_float * len(values))(*values)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda a: None if a is None else a.data_ptr()
    with torch.cuda.device(dev):
        err = lib.alilqr_tiles_launch(
            *(ptr(a) for a in (x0, u0, pp, lam0, refs, dist, urefs, us, xs, viol, conv, lam,
                               ni, work)),
            ctypes.addressof(cvals), len(values), N, n_circ, mode, outer_iters,
            inner_iters, tile, Bp // tile, group, plan.smask, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"AL-iLQR kernel launch failed: {lib.alilqr_error_string(err).decode()}"
        )
    LAUNCHES += 1
    return us, xs, viol, conv > 0.5, lam, ni


def prepare_tiles(x0s, u_init, acc, fric, lam_init, *, N, tile, n_circles, refs=None,
                  dist=None, urefs=None):
    """The kernel's stage-major operands ``[x0, u0, pp, lam0, refs, dist,
    urefs]``, padded to a tile multiple (``ilqr_kernel.py:851-876`` of the
    JAX package): padded lanes get zero state, controls, multipliers and
    mode operands and parameters of 1.0. A mode the kernel is not built for
    (:data:`KERNEL_MODES`) is given as all three operands, the missing ones
    zero; an unused operand is ``None``."""
    B = x0s.shape[0]
    nc = n_constraints(n_circles)
    f32 = torch.float32
    if tile < 1:
        raise ValueError("tile must be positive")
    shapes = {"refs": (B, N + 1, NX), "dist": (B, NX), "urefs": (B, N, NU)}
    given = {"refs": refs, "dist": dist, "urefs": urefs}
    for name, a in given.items():
        if a is not None and tuple(a.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, not {tuple(a.shape)}")
    if operand_mode(refs, dist, urefs) not in KERNEL_MODES:
        given = {k: torch.zeros(shapes[k], dtype=f32, device=x0s.device) if a is None else a
                 for k, a in given.items()}
    if lam_init is None:
        lam_init = torch.zeros(B, N, nc, dtype=f32, device=x0s.device)
    pad = -B % tile
    padded = lambda a, value=0.0: torch.nn.functional.pad(a.to(f32), (0, pad), value=value)
    stage_major = lambda a: None if a is None else padded(
        a.T if a.ndim == 2 else a.permute(1, 2, 0)).contiguous()
    x0 = padded(x0s.T)
    u0 = padded(u_init.permute(1, 2, 0))
    pp = padded(torch.stack([acc, fric]), 1.0)
    lam0 = padded(lam_init.permute(1, 2, 0))
    return [a.contiguous() for a in (x0, u0, pp, lam0)] + [
        stage_major(given[k]) for k in ("refs", "dist", "urefs")]


def _solve_tiled(
    solver, x0s, u_init, acc, fric, refs, dist, urefs, lam_init, *, N, ts,
    geom, limits, weights, n_circles, outer_iters, inner_iters, mu_init,
    mu_scale, mu_max, viol_tol, tol, tile,
):
    """Prepare, run ``solver`` on the padded tiles, return the public layout."""
    if not 0 <= n_circles <= MAX_CIRCLES or len(geom[4]) != n_circles:
        raise ValueError(f"n_circles must be 0..{MAX_CIRCLES} and match the obstacle")
    B = x0s.shape[0]
    args = prepare_tiles(x0s, u_init, acc, fric, lam_init, N=N, tile=tile,
                         n_circles=n_circles, refs=refs, dist=dist, urefs=urefs)
    us, xs, viol, conv, lam, ni = solver(
        *args, N=N, n_circ=n_circles, tile=tile, ts=float(ts), geom=geom,
        limits=limits, weights=weights, outer_iters=outer_iters,
        inner_iters=inner_iters, mu_init=float(mu_init),
        mu_scale=float(mu_scale), mu_max=float(mu_max),
        viol_tol=float(viol_tol), tol=float(tol),
    )
    return BatchedALILQRSolution(
        us=us.permute(2, 0, 1)[:B],
        xs=xs.permute(2, 0, 1)[:B],
        viol=viol[:B],
        converged=conv[:B],
        lam=lam.permute(2, 0, 1)[:B],
        inner_iters_executed=ni[:B],
    )


def al_ilqr_solve_cuda(
    x0s: torch.Tensor,  # (B, 4)
    u_init: torch.Tensor,  # (B, N, 2)
    acc: torch.Tensor,  # (B,) per-scenario acceleration parameter
    fric: torch.Tensor,  # (B,) per-scenario friction parameter
    refs: torch.Tensor | None = None,
    dist: torch.Tensor | None = None,
    urefs: torch.Tensor | None = None,
    lam_init: torch.Tensor | None = None,  # (B, N, nc) multiplier warm start
    *,
    N: int,
    ts: float,
    geom: tuple,  # (KB, LR, offsets, r², obstacle centres or ())
    limits: tuple,  # (lb_x, ub_x, lb_u, ub_u)
    weights: tuple,  # (Qd (4), Rd (2), qn)
    n_circles: int,
    outer_iters: int = 6,
    inner_iters: int = 15,
    mu_init: float = 10.0,
    mu_scale: float = 10.0,
    mu_max: float = 1e8,
    viol_tol: float = 1e-4,
    tol: float = 1e-6,
    tile: int = DEFAULT_TILE,
    group: int | None = None,  # threads per lane on the card; None: DEFAULT_GROUP
) -> BatchedALILQRSolution:
    """Batched AL-iLQR on the parking OCP; the signature and return of the
    JAX package's ``al_ilqr_solve_pallas``, and ``group``.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    twin :func:`al_ilqr_tiles_reference`. One CTA runs one tile with
    ``group`` threads per lane (one of :data:`GROUPS`; :data:`DEFAULT_GROUP`
    when ``None``, or the largest group that fits ``tile`` where that does
    not); the solution does not depend on it. A CTA has ``tile × group``
    threads, and more than :data:`MAX_THREADS` raises ``ValueError``
    (:func:`launch_plan`). The twin ignores a valid ``group``. ``refs``
    (B, N+1, 4), ``dist`` (B, 4) and ``urefs`` (B, N, 2) select the tracking,
    additive-offset and input-reference modes (module docstring).
    """
    group = resolve_group(group, tile, DEFAULT_GROUP, GROUPS, MAX_THREADS)
    if group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, not {group}")
    if x0s.is_cuda:
        # _launch is looked up at call time, so that a run can observe it
        solver = lambda *a, **k: _launch(*a, group=group, **k)
    else:
        solver = al_ilqr_tiles_reference
    return _solve_tiled(
        solver, x0s, u_init, acc, fric, refs, dist, urefs, lam_init, N=N,
        ts=ts, geom=geom, limits=limits, weights=weights, n_circles=n_circles,
        outer_iters=outer_iters, inner_iters=inner_iters, mu_init=mu_init,
        mu_scale=mu_scale, mu_max=mu_max, viol_tol=viol_tol, tol=tol, tile=tile,
    )


_SIGNATURE = inspect.signature(al_ilqr_solve_cuda)


def al_ilqr_solve_twin(*args, **kwargs) -> BatchedALILQRSolution:
    """:func:`al_ilqr_solve_cuda` with the same arguments, always on the
    plain twin and on any device: the reference the kernel is held against
    on the card."""
    bound = _SIGNATURE.bind(*args, **kwargs)
    bound.apply_defaults()
    kw = dict(bound.arguments)
    if kw.pop("group") not in (None, *GROUPS):
        raise ValueError(f"group must be one of {GROUPS}")
    return _solve_tiled(al_ilqr_tiles_reference, **kw)
