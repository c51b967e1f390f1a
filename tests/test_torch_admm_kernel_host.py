"""The fused ADMM kernel's CUDA source, compiled for the host, against its twin.

``csrc/admm_kernel.cu`` is plain C++ apart from its CUDA qualifiers, its warp
collectives, its named barriers, the tile queue's ``atomicAdd``, the
shared-memory buffer, the panel ring's asynchronous copies and the launch.
Built by g++ with those stubbed, it runs the kernel's arithmetic on the CPU
through the real wrapper (``prepare_tiles``, ``launch_plan``, ``_launch``): a
CTA's threads are host threads; ``__syncwarp``, ``__shfl_*_sync`` and
``__all_sync`` meet at a host barrier of the lanes their mask names (a
half-warp's or the warp's), with an exchange array between them; ``bar.sync
id, count`` is a host barrier of ``count`` threads; the tile counter is a
host atomic; ``__pipeline_memcpy_async`` copies at once and the commit and
wait are no-ops, so a panel overwritten while another thread still reads it
shows as a wrong number. The CTAs of the
persistent grid run one after another, so the first pulls every tile and the
others find the queue empty. A missing barrier or a vote that not every lane
of a tile reaches shows here as a wrong number or a hang (each test has a
time limit).

The host build and the twin sum in different orders (the twin's products
are matmuls; the kernel's chains are fmaf over k, and the host build does not
contract the epilogue into FMAs as nvcc does), so after one iteration x, z
and y agree within 1e-5 of their ∞-norm. At the path's budgets the bars are those of
``tests/test_torch_cuda.py::test_kernel_matches_twin``: executed iterations
and converged masks equal on at least 90% of the rows, x within 2e-2 where
the iterations agree. On the card the kernel is held to the twin by those
tests and by ``chip_smoke.py``.
"""

import contextlib
import ctypes
import functools
import re
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch

import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.ops.cuda import admm_kernel as K

STUB = """
#include <math.h>
#include <string.h>
#include <stdint.h>
#include <algorithm>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __ldg(p) (*(p))
using std::min;
struct Dim { unsigned x; };
static Dim blockIdx, blockDim;
static thread_local Dim threadIdx;
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
alignas(16) float sm[1 << 16];  // the 227 KB a CTA may ask for, and some
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 2; return cudaSuccess; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
// `count` threads meet here (every caller of one barrier passes the same count)
struct Barrier {
  std::mutex mu;
  std::condition_variable cv;
  int n = 0, waiting = 0, phase = 0;
  void arrive(int count) {
    std::unique_lock<std::mutex> lock(mu);
    if (waiting == 0) n = count;
    if (++waiting == n) {
      waiting = 0; ++phase;
      cv.notify_all();
      return;
    }
    const int mine = phase;
    cv.wait(lock, [&] { return phase != mine; });
  }
};
struct Warp {
  Barrier full, half[2];
  uint32_t slot[32];
};
static Warp host_warps[32];  // the largest launch bounds' 1024 threads
static Barrier host_cta, host_named[16];
// the barrier of the lanes `mask` names: a half-warp's or the whole warp's
static inline Barrier& lanes(unsigned mask, int* count) {
  Warp& w = host_warps[threadIdx.x >> 5];
  if (mask == 0xffffffffu) { *count = 32; return w.full; }
  if (mask != 0xffffu && mask != 0xffff0000u) abort();
  *count = 16;
  return w.half[mask == 0xffffu ? 0 : 1];
}
inline void __syncwarp(unsigned mask) { int c; Barrier& b = lanes(mask, &c); b.arrive(c); }
inline void __syncthreads() { host_cta.arrive(blockDim.x); }
inline void host_named_sync(int id, int count) { host_named[id].arrive(count); }
template <class V>
inline V host_exchange(unsigned mask, V v, int src_of_lane, bool xor_lane) {
  int c;
  Barrier& b = lanes(mask, &c);
  Warp& w = host_warps[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  uint32_t bits;
  memcpy(&bits, &v, 4);
  w.slot[lane] = bits;
  b.arrive(c);
  bits = w.slot[xor_lane ? (lane ^ src_of_lane) : src_of_lane];
  b.arrive(c);
  memcpy(&v, &bits, 4);
  return v;
}
template <class V>
inline V __shfl_xor_sync(unsigned mask, V v, int o) { return host_exchange(mask, v, o, true); }
template <class V>
inline V __shfl_sync(unsigned mask, V v, int src) { return host_exchange(mask, v, src, false); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
// cp.async: the copy lands at once; the barrier after the wait orders it
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t bytes, size_t = 0) {
  memcpy(dst, src, bytes);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
"""

GRID = """
template <class Kn>
static void host_grid(Kn kernel, int grid, int threads, const Params& p) {
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b; blockDim.x = threads;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([=] { threadIdx.x = t; kernel(p); });
    for (auto& th : pool) th.join();
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """``(cols, lanes, max_threads) -> library``: the source built for the
    host, once per column count, mode and launch bounds."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = K._SOURCES[0].read_text()
    assert src.count("#include <cuda_pipeline.h>\n") == 1
    src = src.replace("#include <cuda_pipeline.h>\n", "").replace("#include <cuda_runtime.h>", STUB)
    src, n = re.subn(r'asm volatile\("bar\.sync %0, %1;"[^;]*;', "host_named_sync(id, count);", src)
    assert n == 1, "the named barrier of csrc/admm_kernel.cu changed"
    src, n = re.subn(
        r"kernel<<<grid, threads, smem_bytes, \(cudaStream_t\)stream>>>\(p\);",
        "host_grid(kernel, grid, threads, p);", src,
    )
    assert n == 1, "the launch line of csrc/admm_kernel.cu changed"
    marker = "typedef void (*kernel_fn)(const Params);"
    assert src.count(marker) == 1
    src = src.replace(marker, marker + "\n" + GRID)
    d = tmp_path_factory.mktemp("admm_host")
    (d / "k.cpp").write_text(src)

    @functools.lru_cache(maxsize=None)
    def build(cols, lanes=16, max_threads=K.MAX_THREADS):
        lib = d / f"libadmm_c{cols}_l{lanes}_t{max_threads}.so"
        subprocess.run(
            ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", "-w",
             f"-DADMM_COLS={cols}", f"-DADMM_LANES={lanes}", f"-DADMM_MAX_THREADS={max_threads}",
             str(d / "k.cpp"), "-o", str(lib)],
            check=True, capture_output=True,
        )
        lib = ctypes.CDLL(str(lib))
        K._configure(lib)
        return lib

    return build


LIMIT_S = 60  # a launch that takes longer hangs: a barrier not every lane reaches


def _within_limit(*args, **kw):
    """``K._launch`` in a daemon thread; fails the test if it does not
    return within :data:`LIMIT_S`."""
    out = {}

    def run():
        try:
            out["result"] = K._launch(*args, **kw)
        except BaseException as exc:  # re-raised in the test's thread
            out["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(LIMIT_S)
    if t.is_alive():
        pytest.fail(f"the host build did not return within {LIMIT_S} s: a hang")
    if "error" in out:
        raise out["error"]
    return out["result"]


@pytest.fixture
def host_launch(host_lib, monkeypatch):
    """``admm_kernel._launch`` running the host build on CPU tensors, with
    CTAs of 64 threads (several tile groups a CTA at tiles 4 and 8), under
    a time limit."""
    monkeypatch.setattr(K, "_build_library", host_lib)
    monkeypatch.setattr(K, "CTA_THREADS", 64)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return _within_limit


@functools.lru_cache(maxsize=None)
def _ctrl(N, soft=False):
    """The headline controller at horizon ``N``, or (``soft``) the MHE
    loop's slack-softened one, whose operator at N = 20 (n = 60, m = 140)
    and beyond takes the panel mode (as the headline's does at N = 100)."""
    problem = port.session2_problem(N=N)
    if soft:
        return problem, port.make_linear_mpc(problem, iters=200, rho=0.02, soft_state=True,
                                             slack_weight=1e4, device="cpu")
    return problem, port.make_linear_mpc(problem, iters=80, rho=0.035, dtype=torch.float32,
                                         device="cpu")


def _states(B, seed):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(-140.0, -20.0, B), rng.uniform(-15.0, 24.0, B)], axis=1)
    return torch.as_tensor(x, dtype=torch.float32)


def _operands(N, B, seed, warm, soft=False, **kw):
    """The launch's operands for ``B`` session-2 states: cold, or warm from
    a twin presolve shifted one step, as the closed loop launches them."""
    problem, c = _ctrl(N, soft)
    x0 = _states(B, seed)
    q, l, u = c.qp.qp_vectors(x0)
    wx = wy = None
    if warm:
        sol = K.admm_solve_cuda(c.op, q, l, u, iters=160, chunks=4, probe_iters=0, tile=8)
        wx, wy = c._shift_warm(sol.x, sol.y, axis=1)
        x1 = problem.system(torch.float32, "cpu")(x0, sol.x[:, : c.qp.nu])
        q, l, u = c.qp.qp_vectors(x1)
    base = dict(iters=80, chunks=2, probe_iters=8, max_rho_moves=0, schedule="uniform",
                cg_iters=40, alpha=1.6, eps_abs=None, polish=False)
    return K.prepare_tiles(c.op, q, l, u, wx, wy, **{**base, **kw})


def _gate_budget(got, want, B, N, soft=False):
    """The card test's bars on the launch's outputs; x unscaled (``D x``),
    as the card test compares it."""
    D = _ctrl(N, soft)[1].op.D
    x, ni = D * got[0][:B], got[3][:B]
    xr, nir = D * want[0][:B], want[3][:B]
    for a in got:
        assert bool(torch.isfinite(a).all())
    same = ni == nir
    print(f"iterations agree on {same.float().mean().item():.3f} of {B} rows; "
          f"max|dx| where they do {(x - xr)[same].abs().max().item():.2e}")
    assert same.float().mean().item() >= 0.9
    torch.testing.assert_close(x[same], xr[same], rtol=0, atol=2e-2)
    return same


@pytest.mark.parametrize("N", [4, 20])
@pytest.mark.parametrize("tile", [4, 6, 8, 16])
def test_one_iteration_matches_twin(host_launch, N, tile):
    """One iteration from a cold start on a ragged batch: every row of every
    tile is written (at tile 6 a tile's second quad holds two zero rows
    past the tile), x, z and y within 1e-5 of the twin's, relative to each
    output's ∞-norm (the scaled iterates reach ~700 here, where one float32
    ulp is 6e-5)."""
    B = 3 * tile + 1
    args, kw = _operands(N, B, seed=tile, warm=False, iters=1, chunks=1, probe_iters=0,
                         tile=tile)
    got = host_launch(*args, **kw)
    want = K.admm_solve_tiles_reference(*args, **kw)
    for a, b, name in zip(got, want, ("x", "z", "y", "iterations")):
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale, msg=name)


@pytest.mark.parametrize("N", [4, 20])
@pytest.mark.parametrize("tile", [4, 8, 16])
@pytest.mark.parametrize("polish", [False, True])
def test_cold_with_rho_moves_matches_twin(host_launch, N, tile, polish):
    """The presolve's configuration (2× budget in 4 chunks, ρ moves, no
    probe), polish on and off, on a ragged batch: tiles leave the staged
    level and read W from device memory. With the polish at N=20, x is not
    held (as ``chip_smoke.py`` holds the polished presolve on iterations and
    success only): the FP32 CG is chaotic there, and a row whose candidate
    sums in another order may pass or fail the acceptance test (the twin in
    float32 against float64 moves a third of the rows by more than 2e-2)."""
    B = 2 * tile + 3
    args, kw = _operands(N, B, seed=N + tile, warm=False, iters=160, chunks=4, probe_iters=0,
                         max_rho_moves=4, polish=polish, tile=tile)
    got = host_launch(*args, **kw)
    want = K.admm_solve_tiles_reference(*args, **kw)
    if polish and N == 20:
        assert (got[3] == want[3]).float().mean().item() >= 0.9
        assert all(bool(torch.isfinite(a).all()) for a in got)
        return
    _gate_budget(got, want, B, N)


@pytest.mark.parametrize("N", [4, 20])
@pytest.mark.parametrize("tile", [4, 8, 16])
def test_warm_with_probe_matches_twin(host_launch, N, tile):
    """A warm step of the closed loop (80 iterations, probe 8, no ρ moves,
    no polish) on a ragged batch."""
    B = 3 * tile - 1
    args, kw = _operands(N, B, seed=3 * N + tile, warm=True, tile=tile)
    got = host_launch(*args, **kw)
    want = K.admm_solve_tiles_reference(*args, **kw)
    _gate_budget(got, want, B, N)


def _one_iteration(host_launch, N, B, seed, tile, soft):
    """One iteration from a cold start on a ragged batch through the host
    build and the twin: x, z and y within 1e-5 of the twin's, relative to
    each output's ∞-norm."""
    args, kw = _operands(N, B, seed=seed, warm=False, soft=soft, iters=1, chunks=1,
                         probe_iters=0, tile=tile)
    got = host_launch(*args, **kw)
    want = K.admm_solve_tiles_reference(*args, **kw)
    for a, b, name in zip(got, want, ("x", "z", "y", "iterations")):
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale, msg=name)


@pytest.mark.parametrize("tile", [4, 8])
def test_wide_one_iteration_matches_twin(host_launch, tile):
    """The mode that serves the soft-state operator at N = 20 (n + m = 200),
    the panel mode (one warp a quad, W and Wq streamed through the panel
    ring), one iteration from a cold start on a ragged batch."""
    assert K.launch_plan(60, 140, tile, False).panel
    _one_iteration(host_launch, 20, 2 * tile + 1, 40 + tile, tile, soft=True)


@pytest.mark.parametrize("polish", [False, True])
def test_wide_cold_with_rho_moves_matches_twin(host_launch, polish):
    """The panel mode on the MHE loop's presolve at N = 20 (n + m = 200; 4×
    the soft controller's budget in 8 chunks, ρ moves, no probe), polish on
    and off, tile 8, a ragged batch, on the bars of
    :func:`test_cold_with_rho_moves_matches_twin` (the polished N = 20 case
    on iterations only)."""
    B = 11
    args, kw = _operands(20, B, seed=7, warm=False, soft=True, iters=800, chunks=8,
                         probe_iters=0, max_rho_moves=8, polish=polish, tile=8)
    got = host_launch(*args, **kw)
    want = K.admm_solve_tiles_reference(*args, **kw)
    if polish:
        assert (got[3] == want[3]).float().mean().item() >= 0.9
        assert all(bool(torch.isfinite(a).all()) for a in got)
        return
    _gate_budget(got, want, B, 20, soft=True)


@pytest.mark.parametrize("N, soft, tile, warps", [(30, True, 8, 2), (100, False, 8, 2),
                                                  (100, False, 4, 2)])
def test_panel_one_iteration_matches_twin(host_launch, N, soft, tile, warps):
    """The panel mode past 256 columns, where a quad of rows takes two warps
    that split its columns: the soft-state operator at N = 30 (n + m = 300)
    and the condensed hard box at N = 100 (400), one iteration from a cold
    start on a ragged batch."""
    _, c = _ctrl(N, soft)
    plan = K.launch_plan(c.qp.n, c.qp.m, tile, False)
    assert plan.panel and plan.warps_per_quad == warps and plan.tiles_per_cta == 1
    _one_iteration(host_launch, N, 2 * tile + 1, N + tile, tile, soft)


def test_panel_cold_with_rho_moves_matches_twin(host_launch):
    """The soft-state operator at N = 30 (n + m = 300) on the MHE loop's
    presolve settings (4× the budget in 8 chunks, ρ moves, no probe, no
    polish), tile 8, one ragged tile: tiles move their ρ level and stream
    that level's panels. The bars of :func:`_gate_budget`."""
    B = 7
    args, kw = _operands(30, B, seed=2, warm=False, soft=True, iters=800, chunks=8,
                         probe_iters=0, max_rho_moves=8, polish=False, tile=8)
    got = host_launch(*args, **kw)
    want = K.admm_solve_tiles_reference(*args, **kw)
    fixed = K.admm_solve_tiles_reference(*args, **{**kw, "max_rho_moves": 0})
    assert not torch.equal(want[3], fixed[3]), "the tile kept its level"
    _gate_budget(got, want, B, 30, soft=True)


@pytest.mark.parametrize("n, m, tile", [(21, 130, 8), (10, 1100, 8)])
def test_panel_odd_sizes_match_twin(host_launch, n, m, tile):
    """Random operators whose rows are not a multiple of 16 bytes (n + m =
    151: the ring's 4-byte copies) and whose tile needs more than 256
    threads (n + m = 1,110 at tile 8: five warps a quad, the build with
    1,024-thread launch bounds), one iteration on a ragged batch, polished:
    x, z and y within 1e-5 of the twin's (relative to each output's
    ∞-norm)."""
    from model_predictive_control_tpu_torch.solvers.qp import qp_setup

    rng = np.random.default_rng(n + m)
    F = rng.normal(size=(n, n))
    P = torch.as_tensor(F @ F.T / n + np.eye(n))
    A = torch.as_tensor(rng.normal(size=(m, n)) / np.sqrt(n))
    op = qp_setup(P, A, rho=0.1)
    B = 2 * tile + 3
    q = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32)
    l = torch.full((B, m), -0.5)
    u = torch.full((B, m), 0.5)
    args, kw = K.prepare_tiles(op, q, l, u, None, None, iters=2, chunks=1, probe_iters=0,
                               max_rho_moves=0, schedule="uniform", tile=tile, cg_iters=5,
                               alpha=1.6, eps_abs=None, polish=True)
    plan = K.launch_plan(n, m, tile, True)
    assert plan.panel and plan.max_threads == (K.BIG_CTA_THREADS if n + m > 1024 else K.MAX_THREADS)
    got = host_launch(*args, **kw)
    want = K.admm_solve_tiles_reference(*args, **kw)
    for a, b, name in zip(got, want, ("x", "z", "y", "iterations")):
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale, msg=name)


def test_converged_masks_match_through_the_wrapper(host_launch):
    """Through the wrapper's solve (scaling, the launch, the unscaled finish)
    at N=20, tile 8, cold with ρ moves (no polish: its FP32 CG is chaotic at
    N=20, see above): converged masks agree on at least 90% of the rows, x
    within 2e-2 where the iterations agree."""
    _, c = _ctrl(20)
    q, l, u = c.qp.qp_vectors(_states(21, 5))
    kw = dict(iters=160, chunks=4, probe_iters=0, tile=8, polish=False)
    got, ni = K._solve_tiled(host_launch, c.op, q, l, u, None, None, max_rho_moves=None,
                             schedule="uniform", cg_iters=40, alpha=1.6, eps_abs=None,
                             return_iters=True, **kw)
    ref, ni_ref = K.admm_solve_twin(c.op, q, l, u, return_iters=True, **kw)
    same = ni == ni_ref
    assert same.float().mean().item() >= 0.9
    assert (got.converged == ref.converged).float().mean().item() >= 0.9
    torch.testing.assert_close(got.x[same], ref.x[same], rtol=0, atol=2e-2)


@pytest.mark.parametrize(
    "n, m", [(4, 12), (20, 60), (3, 5), (40, 88), (22, 22), (20, 80), (60, 140), (100, 300),
             (90, 210), (300, 700)]
)
@pytest.mark.parametrize("tile", [1, 4, 6, 8, 16, 32])
@pytest.mark.parametrize("polish", [False, True])
def test_launch_plan_matches_the_source(host_lib, n, m, tile, polish):
    """``launch_plan``'s shared memory is the source's ``smem_floats`` in
    the plan's mode. The MHE window (n + m = 44), the rate-limited MPC (100)
    and every operator up to 128 stage the operator; the soft-state MPC at
    N = 20, 30 and 100 (200, 300, 1,000) and the hard box at N = 100 (400)
    take the panel mode, polished or not, with the panel depth that fits.
    Where no panel depth fits, ``launch_plan`` raises, naming the bytes."""
    lib = host_lib(K.columns(20, 60))  # the reckoning does not depend on the build
    try:
        plan = K.launch_plan(n, m, tile, polish)
    except ValueError as exc:
        assert n + m > 128 and tile > 8, exc
        need = lib.admm_smem_bytes(n, m, tile, int(polish), 1, 32, 1)
        assert need > K.SMEM_LIMIT and f"needs {need} bytes" in str(exc)
        return
    assert plan.lanes == (32 if n + m > 128 else 16)
    assert plan.cols == K.columns(n, m, plan.lanes)
    assert plan.smem_bytes == lib.admm_smem_bytes(n, m, tile, int(polish), plan.tiles_per_cta,
                                                  plan.lanes, plan.panel_rows)
    if plan.panel:
        assert plan.smem_bytes <= K.SMEM_LIMIT
        assert plan.panel_rows == K.PANEL_ROWS or lib.admm_smem_bytes(
            n, m, tile, int(polish), 1, 32, 2 * plan.panel_rows) > K.SMEM_LIMIT


@pytest.mark.parametrize("tile", [1, 8])
def test_panel_limit_is_shared_memory(host_lib, tile):
    """No constant caps n + m: ``launch_plan`` returns a plan for the soft
    MPC at N = 100 (n + m = 1,000) at tile 8, and up to the largest n + m
    whose one-row panels and row buffers fit shared memory at the tile; one
    column more raises ``ValueError`` with the bytes the source reckons."""
    lib = host_lib(K.columns(20, 60))
    assert K.launch_plan(300, 700, 8, True).panel
    n = 100
    fits = lambda m: lib.admm_smem_bytes(n, m, tile, 1, 1, 32, 1) <= K.SMEM_LIMIT
    m = 200
    while fits(m + 1):
        m += 1
    plan = K.launch_plan(n, m, tile, True)
    assert plan.panel_rows == 1 and plan.smem_bytes <= K.SMEM_LIMIT
    need = lib.admm_smem_bytes(n, m + 1, tile, 1, 1, 32, 1)
    with pytest.raises(ValueError, match=f"needs {need} bytes of shared memory"):
        K.launch_plan(n, m + 1, tile, True)
