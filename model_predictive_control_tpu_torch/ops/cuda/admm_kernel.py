"""Fused batched ADMM for the condensed box-QP: the hand-written CUDA kernel
(``csrc/admm_kernel.cu``), its plain-PyTorch twin and the wrapper.

Replaces ``model_predictive_control_tpu/ops/pallas/admm_kernel.py``
(``_admm_tile_kernel``, wrapper ``admm_solve_pallas``). One launch runs the
whole solve for every scenario tile: the chunk schedule, the exit probe, the
per-tile ρ-ladder moves and the CG active-set polish all happen inside it.

What bounds it on an H100: each ADMM iteration is a ``(T, n+m) @ (n+m, n+m)``
product, ``2·T·(n+m)²`` FP32 FLOPs read from shared memory (12.8 kFLOP per
scenario at the headline n=20, m=60), followed by elementwise work; the
issue of shared-memory loads and FMAs sets the pace. The design
(:func:`launch_plan`):

- a half-warp serves 4 scenario rows, a lane a 4 × ⌈(n+m)/16⌉ block of
  outputs, so every element of ``W`` loaded from shared memory feeds 4 rows;
- a tile is served by half a warp (up to 4 rows), one warp (up to 8) or
  ``⌈T/8⌉`` warps; its exit test, ρ move and CG stop are votes among those
  lanes only (shuffles, and named barriers between the warps of a wide tile);
- persistent CTAs stage ``W`` and ``Wq`` of the initial ρ level once, and
  their tile groups pull tiles from a device counter, so a tile that exits
  early frees its lanes for the next one;
- plain FP32 FMA loops: no bf16 split, no TF32 (the reference measured
  low-precision iteration products collapsing closed-loop success);
- operators whose staged copy does not fit shared memory (``n + m > 128``,
  e.g. the soft-state MPC at N=20, 30 and 100, n + m = 200, 300 and 1,000,
  or the condensed hard box at N=100, 400) take the panel mode
  (:func:`kernel_lanes`): ``⌈(n+m)/256⌉`` warps serve 4 rows, a lane a
  4 × ``⌈(n+m)/(32·warps)⌉`` block, one tile a CTA, and ``W`` and ``Wq``
  stream through a two-stage ring of k-row panels in shared memory
  (``cp.async``), each panel read once per CTA and iteration. No constant
  caps ``n + m``: only the shared memory of one tile (:func:`launch_plan`).

Tile semantics (kept from the reference): exits and ρ are per tile, so ``T``
changes results at the tolerance edge; padded zero rows take part in the last
tile's exit test. :func:`admm_solve_tiles_reference` is the plain twin of the
same tile algorithm; :func:`admm_solve_cuda` takes it only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import inspect

import torch

from ...obs.profiling import span
from ...solvers.qp import QPOperator, QPSolution, _converged, _unscaled_residuals
from ...utils.precision import set_solver_precision
from ._build import PKG, load_library

# Kernel launches made by admm_solve_cuda (one per solve), in all and per
# library (:func:`library_name`: the column count and mode). Tests and
# chip_smoke.py read them to show that a run went through the kernel.
LAUNCHES = 0
LAUNCHES_BY_LIBRARY: dict[str, int] = {}

MAX_CHUNKS = 64  # size of the kernel's chunk-length table (Params.chunk_lens)
MAX_COLS = 8  # columns per lane: n + m <= 16 * MAX_COLS staged, 32 * MAX_COLS a panel warp
MAX_THREADS = 256  # the kernel's launch bounds (registers: up to 255 a thread)
BIG_CTA_THREADS = 1024  # the launch bounds of a panel build for CTAs above MAX_THREADS
PANEL_ROWS = 16  # rows of a panel, halved by launch_plan until the CTA fits
CTA_THREADS = 256  # threads a CTA aims at: as many tile groups as fit
SMEM_LIMIT = 232448  # opt-in shared memory per block on sm_90 (bytes)
# GPU default scenario tile, chosen by a sweep on the H100 at the headline
# configuration (PERF.md, Findings)
DEFAULT_TILE = 8

LIBRARY = "admm_kernel"
_SOURCES = [PKG / "csrc" / "admm_kernel.cu"]


def chunk_lengths(
    iters: int, chunks: int, probe_iters: int, schedule: str
) -> list[int]:
    """The solve's chunk schedule (``admm_kernel.py:185-206`` of the JAX
    package): an optional probe chunk, then uniform or geometric chunks.

    With ``iters <= probe_iters`` the probe is the whole budget."""
    if schedule not in ("uniform", "geometric"):
        raise ValueError(f"unknown schedule {schedule!r}")
    probe = max(0, min(probe_iters, iters))
    rem = iters - probe
    lens = [probe] if probe else []
    if schedule == "geometric":
        nxt = 8.0
        while rem > 0:
            step = min(rem, max(1, int(nxt)))
            lens.append(step)
            rem -= step
            nxt *= 1.6
    elif rem > 0:
        lens += [max(1, rem // chunks)] * chunks
    return lens


def _fused_operator(op: QPOperator):
    """Fused per-level iteration matrices: with ``G = [x | ρz − y]`` one
    ADMM iteration is ``[x̃ | z̃] = G·W + q·Wq``
    (``admm_kernel.py:504-516`` of the JAX package). Built once per operator
    by :func:`kernel_operator`."""
    Minv = op.Minv_stack
    MA = Minv @ op.A_s.T  # (R, n, m)
    AM = op.A_s @ Minv  # (R, m, n)
    AMA = AM @ op.A_s.T  # (R, m, m)
    sig = op.sigma
    W = torch.cat(
        [torch.cat([sig * Minv, sig * MA], dim=2), torch.cat([AM, AMA], dim=2)],
        dim=1,
    )  # (R, n+m, n+m)
    Wq = torch.cat([-Minv, -MA], dim=2)  # (R, n, n+m)
    return W, Wq


def kernel_operator(op: QPOperator) -> tuple:
    """The kernel's operator operands, float32 and contiguous: ``W, Wq, A,
    P, P⁻¹, S, ρ levels, 1/E, 1/(c·D)``. Built at the first solve with
    ``op`` and kept on it (the dataclass is frozen, so beside its fields):
    a closed loop solves 51 times with one operator."""
    cached = vars(op).get("_kernel_operator")
    if cached is None:
        W, Wq = _fused_operator(op)
        cached = tuple(
            a.to(torch.float32).contiguous()
            for a in (W, Wq, op.A_s, op.P_s, op.Pinv_s, op.S, op.rho_levels,
                      1.0 / op.E, 1.0 / (op.c * op.D))
        )
        object.__setattr__(op, "_kernel_operator", cached)
    return cached


def admm_solve_tiles_reference(
    W, Wq, A, P, Pinv, S, rho_levels, Einv, Dcinv, q, l, u, x0, y0, *,
    tile, chunk_lens, probe, max_rho_moves, init_idx, polish, cg_iters,
    eps_abs, alpha,
):
    """Plain-PyTorch twin of the kernel, in scaled space, on a padded batch.

    ``q, x0`` are ``(Bp, n)`` and ``l, u, y0`` are ``(Bp, m)`` with ``Bp`` a
    multiple of ``tile``. Works on ``(Bp/T, T, ·)`` views with per-tile masks
    for the exit, the ρ level and the CG stop. Returns scaled ``(x, z, y)``
    and the executed ADMM iterations per row.
    """
    Bp, n = q.shape
    m = l.shape[1]
    T = tile
    nt = Bp // T
    view = lambda a: a.reshape(nt, T, -1)
    q, l, u, x, y = map(view, (q, l, u, x0, y0))
    tmax = lambda a: a.abs().amax(dim=(1, 2))  # tile-wide max |·| -> (nt,)
    rmax = lambda a: a.amax(dim=2, keepdim=True)  # row max -> (nt, T, 1)
    rsum = lambda a: a.sum(dim=2, keepdim=True)
    col = lambda v: v[:, None, None]  # (nt,) -> (nt, 1, 1) broadcast mask

    scale_u = 1.0 + rmax(q.abs() * Dcinv)
    z = torch.clamp(x @ A.T, l, u)
    q_max = tmax(q)
    log_levels = torch.log(rho_levels)

    idx = torch.full((nt,), init_idx, dtype=torch.long, device=q.device)
    moves = torch.zeros(nt, dtype=torch.long, device=q.device)
    done = torch.zeros(nt, dtype=torch.bool, device=q.device)
    executed = torch.zeros(nt, dtype=q.dtype, device=q.device)
    Ax = torch.zeros_like(l)
    Px = torch.zeros_like(q)
    Aty = torch.zeros_like(q)
    for ci, L in enumerate(chunk_lens):
        active = ~done
        if not bool(active.any()):
            break
        Wt, Wqt = W[idx], Wq[idx]
        rho = rho_levels[idx]
        r3 = col(rho)
        inv_rho = 1.0 / r3
        XZq = q @ Wqt
        a3 = col(active)
        for _ in range(L):
            G = torch.cat([x, r3 * z - y], dim=2)
            XZ = G @ Wt + XZq
            Tx = alpha * XZ[..., :n] + (1.0 - alpha) * x
            Tz = alpha * XZ[..., n:] + (1.0 - alpha) * z
            zn = torch.clamp(Tz + inv_rho * y, l, u)
            yn = y + r3 * (Tz - zn)
            x = torch.where(a3, Tx, x)
            z = torch.where(a3, zn, z)
            y = torch.where(a3, yn, y)
        executed = executed + active.to(q.dtype) * L

        Ax_c, Px_c, Aty_c = x @ A.T, x @ P, y @ A
        rp = tmax(Ax_c - z)
        rd = tmax(Px_c + q + Aty_c)
        rp_rel = rp / torch.clamp(torch.maximum(tmax(Ax_c), tmax(z)), min=1e-10)
        rd_rel = rd / torch.maximum(
            torch.maximum(tmax(Px_c), tmax(Aty_c)), torch.clamp(q_max, min=1e-10)
        )
        target = rho * torch.sqrt(rp_rel / torch.clamp(rd_rel, min=1e-16))
        cand = torch.argmin(
            (log_levels - torch.log(torch.clamp(target, min=1e-12))[:, None]).abs(),
            dim=1,
        )
        rp_u = rmax((Ax_c - z).abs() * Einv)
        rd_u = rmax((Px_c + q + Aty_c).abs() * Dcinv)
        conv = ((rp_u < eps_abs * scale_u) & (rd_u < eps_abs * scale_u)).all(
            dim=2
        ).all(dim=1)
        move = (target > 5.0 * rho) | (5.0 * target < rho)
        move = move & (moves < max_rho_moves) & ~conv & active
        if ci == 0 and probe:
            move = torch.zeros_like(move)
        idx = torch.where(move, cand, idx)
        moves = moves + move.long()
        Ax = torch.where(a3, Ax_c, Ax)
        Px = torch.where(a3, Px_c, Px)
        Aty = torch.where(a3, Aty_c, Aty)
        done = done | (conv & active)

    if polish:
        # matrix-free active-set polish: CG on M ν = −d∘(b + A P⁻¹ q) with
        # M v = d∘(S (d∘v)) + (1−d)∘v, stopped tile-wide
        big = 1e19
        ytol = 1e-6 * torch.clamp(rmax(y.abs()), min=1e-6)
        low = (y < -ytol) & (l > -big)
        up = (y > ytol) & (u < big)
        d = (low | up).to(q.dtype)
        b = torch.where(low, l, torch.where(up, u, torch.zeros_like(u)))
        rhs = -d * (b + (q @ Pinv) @ A.T)
        rs0 = rsum(rhs * rhs)
        nu = torch.zeros_like(rhs)
        r, p, rs = rhs, rhs, rs0
        for _ in range(cg_iters):
            act = (rs / torch.clamp(rs0, min=1e-30)).amax(dim=(1, 2)) > 1e-12
            if not bool(act.any()):
                break
            a3 = col(act)
            Mp = d * ((d * p) @ S) + (1.0 - d) * p
            a_cg = rs / torch.clamp(rsum(p * Mp), min=1e-30)
            nu_n = nu + a_cg * p
            r_n = r - a_cg * Mp
            rs_n = rsum(r_n * r_n)
            p_n = r_n + rs_n / torch.clamp(rs, min=1e-30) * p
            nu = torch.where(a3, nu_n, nu)
            r = torch.where(a3, r_n, r)
            p = torch.where(a3, p_n, p)
            rs = torch.where(a3, rs_n, rs)

        y_p = d * nu
        Aty_p = y_p @ A
        x_p = -((q + Aty_p) @ Pinv)
        Az_p = x_p @ A.T
        z_p = torch.clamp(Az_p, l, u)
        res0 = torch.maximum(rmax((Ax - z).abs()), rmax((Px + q + Aty).abs()))
        res1 = torch.maximum(
            rmax((Az_p - z_p).abs()), rmax((x_p @ P + q + Aty_p).abs())
        )
        stol = 1e-7
        sign_bad = ((low & (y_p > stol)) | (up & (y_p < -stol))).any(
            dim=2, keepdim=True
        )
        finite = torch.isfinite(Az_p).all(dim=2, keepdim=True)
        accept = (res1 < res0) & ~sign_bad & finite
        x = torch.where(accept, x_p, x)
        z = torch.where(accept, z_p, z)
        y = torch.where(accept, y_p, y)

    ni = executed[:, None].expand(nt, T).reshape(Bp)
    return x.reshape(Bp, n), z.reshape(Bp, m), y.reshape(Bp, m), ni


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    threads_per_tile: int  # lanes of a tile: 16 × its quads, or 32 × warps a quad × its quads
    tiles_per_cta: int  # tile groups in one CTA, each pulling its own tiles (1 in the panel mode)
    threads: int  # per CTA
    smem_bytes: int  # dynamic shared memory per CTA
    ctas_per_sm: int | None  # the card's occupancy (None: not asked)
    grid: int | None  # persistent CTAs (None: not asked)
    lanes: int  # lanes of a warp in a quad of 4 rows: 16 (staged operator) or 32 (panel mode)
    cols: int  # columns a lane keeps (:func:`columns`): the library's
    warps_per_quad: int = 1  # warps serving a quad of rows (the panel mode's column split)
    panel_rows: int = 0  # rows of a panel of the ring (the panel mode)
    max_threads: int = MAX_THREADS  # the library's launch bounds

    @property
    def panel(self) -> bool:
        return self.lanes == 32


def _quads_per_tile(tile: int, lanes: int = 16) -> int:
    """Quads of 4 rows that serve a tile. Half-warp quads: one up to 4 rows,
    else an even number (whole warps). Panel-mode quads: one per 4 rows."""
    if lanes == 32:
        return -(-tile // 4)
    return 1 if tile <= 4 else 2 * -(-tile // 8)


def _warps_per_quad(n: int, m: int, lanes: int) -> int:
    """Warps serving a quad of rows: ``⌈(n + m) / 256⌉`` in the panel mode,
    so a lane keeps at most :data:`MAX_COLS` columns; 1 (a half-warp) in the
    staged mode."""
    return -(-(n + m) // (32 * MAX_COLS)) if lanes == 32 else 1


def _padded_cols(n: int, m: int, lanes: int) -> int:
    lq = lanes * _warps_per_quad(n, m, lanes)
    return lq * -(-(n + m) // lq)


def _operator_floats(n: int, m: int, polish: bool, lanes: int, panel_rows: int = 0) -> int:
    """The staged operator in floats (``csrc/admm_kernel.cu::operator_floats``);
    the ring of two panels of ``panel_rows`` rows in the panel mode."""
    Kp = _padded_cols(n, m, lanes)
    if lanes == 32:
        return 2 * panel_rows * Kp
    K = n + m
    op = K * Kp + n * Kp + 2 * m * n + n * n + (m * m + n * n if polish else 0)
    return -(-op // 4) * 4


def _smem_bytes(n: int, m: int, tile: int, polish: bool, groups: int, lanes: int,
                panel_rows: int = 0) -> int:
    qpg = _quads_per_tile(tile, lanes)
    warps = qpg * _warps_per_quad(n, m, lanes) if lanes == 32 else max(1, qpg // 2)
    return 4 * (_operator_floats(n, m, polish, lanes, panel_rows)
                + groups * qpg * 4 * (2 * (n + m) + n + 2 * m) + groups * (2 * warps * 8 + 2))


def kernel_lanes(n: int, m: int, polish: bool) -> int:
    """The kernel's mode for an operator: 16 lanes a quad with the operator
    staged in shared memory where ``n + m <= 16 ×`` :data:`MAX_COLS` and the
    staged operator leaves room for a warp of quads; else the panel mode
    (32 lanes a warp), at any ``n + m``."""
    if n + m <= 16 * MAX_COLS and _smem_bytes(n, m, 1, polish, 2, 16) <= SMEM_LIMIT:
        return 16
    return 32


def launch_plan(n: int, m: int, tile: int, polish: bool, *, n_tiles: int | None = None,
                ctas_per_sm: int | None = None, sms: int | None = None) -> LaunchPlan:
    """How the kernel is launched for ``tile``: its mode
    (:func:`kernel_lanes`), the lanes of a tile, the tile groups a CTA holds,
    its threads and shared memory (``csrc/admm_kernel.cu::smem_floats``: the
    staged operator or the panel ring, per quad of rows ``G``, ``q``, a
    scratch vector, ``l`` and ``u``, per group an exchange area). The staged
    mode holds as many tile groups as fit :data:`CTA_THREADS` and
    :data:`SMEM_LIMIT`; the panel mode one, with panels of
    :data:`PANEL_ROWS` rows halved until the CTA fits, and a build with
    launch bounds of :data:`BIG_CTA_THREADS` where its CTA needs more than
    :data:`MAX_THREADS` threads. Given the card's occupancy (``ctas_per_sm``,
    ``sms``) and ``n_tiles``, also the persistent grid: as many CTAs as the
    card holds at once, fewer when there are fewer tile groups' worth of
    tiles. Raises ``ValueError`` for a tile whose CTA needs more shared
    memory than :data:`SMEM_LIMIT` (in the panel mode with one-row panels:
    that bounds ``n + m``) or more threads than the launch bounds, and for a
    card that holds no such CTA: a request is never shrunk."""
    if tile < 1:
        raise ValueError("tile must be positive")
    lanes = kernel_lanes(n, m, polish)
    qpg = _quads_per_tile(tile, lanes)
    wpq = _warps_per_quad(n, m, lanes)
    per_tile = lanes * wpq * qpg
    warps = qpg * wpq if lanes == 32 else max(1, qpg // 2)
    panel_rows = PANEL_ROWS if lanes == 32 else 0

    def smem(groups):
        return _smem_bytes(n, m, tile, polish, groups, lanes, panel_rows)

    if lanes == 32:
        tiles_per_cta = 1
        while panel_rows > 1 and smem(1) > SMEM_LIMIT:
            panel_rows //= 2
    else:
        # half-warp tiles come in pairs (whole warps); named barriers 1-15
        step = 2 if per_tile == 16 else 1
        most = CTA_THREADS // per_tile if warps == 1 else min(CTA_THREADS // per_tile, 15)
        tiles_per_cta = max(step, most - most % step)
        while tiles_per_cta > step and smem(tiles_per_cta) > SMEM_LIMIT:
            tiles_per_cta -= step
    if smem(tiles_per_cta) > SMEM_LIMIT:
        raise ValueError(
            f"n + m = {n + m} at tile {tile} needs {smem(tiles_per_cta)} bytes of shared memory "
            f"(limit {SMEM_LIMIT})"
        )
    threads = tiles_per_cta * per_tile
    bounds = BIG_CTA_THREADS if lanes == 32 else MAX_THREADS
    if threads > bounds:
        raise ValueError(
            f"tile {tile} needs {threads} threads per CTA (the launch bounds allow {bounds})"
        )
    grid = None
    if ctas_per_sm is not None:
        if ctas_per_sm < 1:
            raise ValueError(f"the card holds no CTA of {threads} threads and "
                             f"{smem(tiles_per_cta)} bytes")
        grid = ctas_per_sm * sms
        if n_tiles is not None:
            grid = max(1, min(grid, -(-n_tiles // tiles_per_cta)))
    return LaunchPlan(per_tile, tiles_per_cta, threads, smem(tiles_per_cta), ctas_per_sm, grid,
                      lanes, columns(n, m, lanes), wpq, panel_rows,
                      MAX_THREADS if threads <= MAX_THREADS else BIG_CTA_THREADS)


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.admm_tiles_launch
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 15 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.admm_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.admm_smem_bytes.restype = ctypes.c_long
    lib.admm_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.c_long, ctypes.c_void_p,
                                                        ctypes.c_void_p]
    lib.admm_occupancy.restype = ctypes.c_int
    lib.admm_error_string.argtypes = [ctypes.c_int]
    lib.admm_error_string.restype = ctypes.c_char_p


def columns(n: int, m: int, lanes: int = 16) -> int:
    """Columns a lane keeps, ``⌈(n + m) / (lanes × warps a quad)⌉``: the
    kernel is built once per column count and mode (``-DADMM_COLS``,
    ``-DADMM_LANES``)."""
    return -(-(n + m) // (lanes * _warps_per_quad(n, m, lanes)))


def library_name(cols: int, lanes: int = 16, max_threads: int = MAX_THREADS) -> str:
    return (f"{LIBRARY}_c{cols}" + ("_panel" if lanes == 32 else "")
            + (f"_t{max_threads}" if max_threads != MAX_THREADS else ""))


def _build_library(cols: int, lanes: int = 16, max_threads: int = MAX_THREADS) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/admm_kernel.cu`` for ``cols``
    columns a lane, ``lanes`` lanes a warp of a quad and launch bounds of
    ``max_threads``."""
    return load_library(library_name(cols, lanes, max_threads), _SOURCES, _configure,
                        (f"-DADMM_COLS={cols}", f"-DADMM_LANES={lanes}",
                         f"-DADMM_MAX_THREADS={max_threads}"))


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"admm kernel {what} failed: {lib.admm_error_string(err).decode()}")


def _launch(W, Wq, A, P, Pinv, S, rho_levels, Einv, Dcinv, q, l, u, x0, y0, *,
            tile, chunk_lens, probe, max_rho_moves, init_idx, polish, cg_iters,
            eps_abs, alpha):
    global LAUNCHES
    Bp, n = q.shape
    m = l.shape[1]
    R = rho_levels.shape[0]
    if len(chunk_lens) > MAX_CHUNKS:
        raise ValueError(f"{len(chunk_lens)} chunks exceed {MAX_CHUNKS}")
    plan = launch_plan(n, m, tile, polish)  # refuses before any build
    args = [W, Wq, A, P, Pinv, S, rho_levels, Einv, Dcinv, q, l, u, x0, y0]
    for a in args:
        if a.device != q.device or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError("kernel operands must be contiguous float32 on one device")
    lib = _build_library(plan.cols, plan.lanes, plan.max_threads)
    n_tiles = Bp // tile
    with torch.cuda.device(q.device):
        occ, sms = ctypes.c_int(0), ctypes.c_int(0)
        _check(lib, lib.admm_occupancy(n, m, plan.threads, plan.smem_bytes,
                                       ctypes.byref(occ), ctypes.byref(sms)), "occupancy query")
        plan = launch_plan(n, m, tile, polish, n_tiles=n_tiles, ctas_per_sm=occ.value,
                           sms=sms.value)
        x = torch.empty(Bp, n, dtype=torch.float32, device=q.device)
        z = torch.empty(Bp, m, dtype=torch.float32, device=q.device)
        y = torch.empty(Bp, m, dtype=torch.float32, device=q.device)
        ni = torch.empty(Bp, dtype=torch.float32, device=q.device)
        next_tile = torch.zeros(1, dtype=torch.int32, device=q.device)  # the tile queue
        lens = (ctypes.c_int * MAX_CHUNKS)(*chunk_lens)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.admm_tiles_launch(
            *(a.data_ptr() for a in args),
            x.data_ptr(), z.data_ptr(), y.data_ptr(), ni.data_ptr(), next_tile.data_ptr(),
            ctypes.addressof(lens),
            len(chunk_lens), int(probe), int(max_rho_moves), int(init_idx),
            int(polish), int(cg_iters), n, m, R, tile, n_tiles, plan.tiles_per_cta,
            plan.panel_rows, plan.threads, plan.grid, float(eps_abs), float(alpha), stream,
        )
    _check(lib, err, "launch")
    LAUNCHES += 1
    name = library_name(plan.cols, plan.lanes, plan.max_threads)
    LAUNCHES_BY_LIBRARY[name] = LAUNCHES_BY_LIBRARY.get(name, 0) + 1
    return x, z, y, ni


def prepare_tiles(
    op, q, l, u, warm_x, warm_y, *, iters, chunks, probe_iters, max_rho_moves,
    schedule, tile, cg_iters, alpha, eps_abs, polish,
):
    """The kernel's operands, in scaled space and padded to a tile multiple,
    as ``(args, kwargs)`` for :func:`admm_solve_tiles_reference` or the
    launch (``admm_kernel.py:465-516`` of the JAX package)."""
    B, n = q.shape
    m = op.A_c.shape[0]
    f32 = torch.float32
    if iters < 1 or tile < 1:
        raise ValueError("iters and tile must be positive")
    c32 = lambda a: a.to(f32).contiguous()
    zeros = lambda k: torch.zeros(B, k, dtype=f32, device=q.device)
    x0 = zeros(n) if warm_x is None else warm_x / op.D
    y0 = zeros(m) if warm_y is None else op.c * warm_y / op.E
    rows = [op.c * op.D * q, op.E * l, op.E * u, x0, y0]
    pad = -B % tile
    if pad:
        rows = [torch.nn.functional.pad(a, (0, 0, 0, pad)) for a in rows]
    args = [*kernel_operator(op), *rows]
    kwargs = dict(
        tile=tile,
        chunk_lens=chunk_lengths(iters, chunks, probe_iters, schedule),
        probe=min(max(probe_iters, 0), iters) > 0,
        max_rho_moves=chunks if max_rho_moves is None else max_rho_moves,
        init_idx=op.rho_levels.shape[0] // 2,
        polish=polish, cg_iters=cg_iters,
        eps_abs=1e-4 if eps_abs is None else float(eps_abs), alpha=float(alpha),
    )
    return [c32(a) for a in args], kwargs


def _solve_tiled(solver, op, q, l, u, warm_x, warm_y, *, return_iters, **kw):
    """Prepare, run ``solver`` on the padded tiles, unscale and finish: the
    spans ``admm.prepare``, ``admm.launch`` and ``admm.finish``."""
    set_solver_precision()
    B = q.shape[0]
    with span("admm.prepare"):
        args, kwargs = prepare_tiles(op, q, l, u, warm_x, warm_y, **kw)
    with span("admm.launch"):
        x_s, z_s, y_s, ni = solver(*args, **kwargs)
    with span("admm.finish"):
        dtype = op.P.dtype
        x = (op.D * x_s[:B]).to(dtype)
        y = (y_s[:B] * op.E / op.c).to(dtype)
        z = (z_s[:B] / op.E).to(dtype)
        rp, rd = _unscaled_residuals(op, x, y, z, q)
        sol = QPSolution(
            x=x, z=z, y=y, prim_res=rp, dual_res=rd,
            converged=_converged(rp, rd, q, kwargs["eps_abs"]), iters=ni[:B],
        )
    return (sol, sol.iters) if return_iters else sol


def admm_solve_cuda(
    op: QPOperator,
    q: torch.Tensor,  # (B, n)
    l: torch.Tensor,  # (B, m)
    u: torch.Tensor,  # (B, m)
    warm_x: torch.Tensor | None = None,  # (B, n) unscaled
    warm_y: torch.Tensor | None = None,  # (B, m) unscaled
    iters: int = 100,
    chunks: int = 2,
    probe_iters: int = 32,
    max_rho_moves: int | None = None,
    schedule: str = "uniform",
    tile: int = DEFAULT_TILE,
    cg_iters: int = 40,
    alpha: float = 1.6,
    eps_abs: float | None = None,
    polish: bool = True,
    return_iters: bool = False,
):
    """Batched ADMM through the fused kernel; the signature and return of the
    JAX package's ``admm_solve_pallas``.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain twin
    :func:`admm_solve_tiles_reference`. The solution's ``iters`` holds the
    executed ADMM iterations per scenario (the tile's count);
    ``return_iters=True`` also returns them, as the JAX package does.
    """
    solver = _launch if q.is_cuda else admm_solve_tiles_reference
    return _solve_tiled(
        solver, op, q, l, u, warm_x, warm_y, iters=iters, chunks=chunks,
        probe_iters=probe_iters, max_rho_moves=max_rho_moves,
        schedule=schedule, tile=tile, cg_iters=cg_iters, alpha=alpha,
        eps_abs=eps_abs, polish=polish, return_iters=return_iters,
    )


def admm_solve_twin(*args, **kwargs):
    """:func:`admm_solve_cuda` with the same arguments, always on the plain
    twin and on any device: the reference the kernel is held against on the
    card."""
    bound = inspect.signature(admm_solve_cuda).bind(*args, **kwargs)
    bound.apply_defaults()
    return _solve_tiled(admm_solve_tiles_reference, **bound.arguments)
