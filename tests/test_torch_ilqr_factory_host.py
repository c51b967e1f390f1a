"""The tracker kernel's CUDA source, compiled for the host, against its twin.

``csrc/ilqr_factory.cu`` is plain C++ apart from its CUDA qualifiers, its
barriers, the shared-memory buffer and the launch. Built by g++ with those
stubbed, it runs the kernel's arithmetic on the CPU through the real wrapper
(``prepare_tiles``, ``launch_plan``, ``_launch``, the constants struct): a
CTA's threads are host threads, ``__syncthreads_and`` and ``__syncwarp`` one
CTA-wide barrier between them, the dynamic shared memory a static buffer. At
group 1 and one lane per tile that is one thread (a tile-wide vote is the
lane's own); at group 8 and two lanes per tile sixteen threads deal the
Jacobian directions and the line-search candidates as on the card, so a
missing barrier or a divergent vote shows here as a wrong number or a hang.
Held against the twin at the same tile after one
inner iteration, both models and both integrators, it must agree bit for bit
where the host's libm agrees with torch (the kinematic tier, whose
transcendentals are sin, cos, tan and sqrt) and within 1e-3 for the Pacejka
tier, whose glibc ``atanf`` and ``tanhf`` round apart from torch's own (2.7e-4
measured on the speed-deficit lane, whose drive bound is active). At the
dynamic sweep's 3 × 8 budget converged masks must agree and controls stay
within 2e-2, the JAX package's bar between its two float32 implementations of
the dynamic tier (``tests/test_pallas_ilqr_dyn.py:205``). On the card the
kernel is held to the twin bit for bit (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import contextlib
import ctypes
import functools
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from model_predictive_control_tpu_torch.experiments.racing import (
    Q_DYNAMIC,
    QN_SCALE,
    R_DYNAMIC,
    ellipse_reference,
)
from model_predictive_control_tpu_torch.models.parameters import VehicleParameters
from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as F
from model_predictive_control_tpu_torch.ops.cuda.ilqr_dyn_kernel import (
    make_pacejka_ode_rows,
    model_tuple,
)
from model_predictive_control_tpu_torch.ops.cuda.parking_factory import make_parking_ode_rows

STUB = """
#include <math.h>
#include <string.h>
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
struct Dim { unsigned x; };
static Dim blockIdx, blockDim;
static thread_local Dim threadIdx;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
// all threads of the CTA meet here; returns the AND of their votes
struct Barrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 1, waiting = 0, phase = 0, acc = 1, result = 1;
  int arrive(int vote) {
    std::unique_lock<std::mutex> lock(m);
    acc &= vote != 0;
    if (++waiting == n) {
      result = acc; acc = 1; waiting = 0; ++phase;
      cv.notify_all();
      return result;
    }
    const int mine = phase;
    cv.wait(lock, [&] { return phase != mine; });
    return result;
  }
};
static Barrier cta;
inline int __syncthreads_and(int vote) { return cta.arrive(vote); }
inline void __syncwarp(unsigned) { cta.arrive(1); }
inline unsigned __activemask() { return 0xffffffffu; }
"""

GRID = """
float lane_blocks[1 << 16];  // the 227 KB a CTA may ask for, and some

template <class K>
static void host_grid(K kernel, int n_tiles, int threads, const Args& g, const Consts& c) {
  for (int b = 0; b < n_tiles; ++b) {
    blockIdx.x = b; blockDim.x = threads; cta.n = threads;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([=] { threadIdx.x = t; kernel(g, c); });
    for (auto& th : pool) th.join();
  }
}
"""

B = 6


def _host_builder(tmp_path_factory, math=False, ext=False):
    """``group -> library``: the source built for the host, once per group;
    with ``math`` its ``tanf``, ``sinf``, ``cosf`` and ``sqrtf`` call back
    into torch (``test_torch_ilqr_kernel_host.py``'s routing: glibc rounds
    some values apart from torch's CPU functions); with ``ext`` the source
    of the factory parking and MHE instantiations
    (``csrc/ilqr_factory_ext.cu``)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    if math:
        from test_torch_ilqr_kernel_host import CALLBACKS, MATH
    src = (F._EXT_SOURCES if ext else F._SOURCES)[0].read_text().replace("#include <cuda_runtime.h>",
                                            STUB + (MATH if math else ""))
    src, n = re.subn(
        r"kernel<<<n_tiles, tile \* GROUP, bytes, s>>>\(g, c\)",
        "host_grid(kernel, n_tiles, tile * GROUP, g, c)", src,
    )
    assert n == 1, "the launch line of csrc/ilqr_factory.cu changed"
    marker = "template <class M, bool RK4>\nstatic int launch_kernel"
    assert src.count(marker) == 1
    src = src.replace(marker, GRID + "\n" + marker)
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "k.cpp").write_text(src)

    @functools.lru_cache(maxsize=None)
    def build(group):
        lib = d / f"libk{group}.so"
        subprocess.run(
            ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", "-w",
             f"-DTRACKER_GROUP={group}", str(d / "k.cpp"), "-o", str(lib)],
            check=True, capture_output=True,
        )
        lib = ctypes.CDLL(str(lib))
        F._configure(lib)
        if math:
            for k, fn in enumerate(CALLBACKS):
                lib.set_host_math(k, fn)
        return lib

    return build


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    return _host_builder(tmp_path_factory)


@pytest.fixture(scope="module")
def routed_host_kernel(tmp_path_factory):
    return _host_builder(tmp_path_factory, math=True)


def _on_host(build, monkeypatch, ext_build=None):
    """``ilqr_factory._launch`` running the host build ``build`` (and
    ``ext_build`` for the second library's instantiations) on CPU tensors."""
    monkeypatch.setattr(F, "_build_library",
                        lambda group=1, ext=False: (ext_build if ext else build)(group))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return F._launch


@pytest.fixture
def host_launch(host_kernel, monkeypatch):
    return _on_host(host_kernel, monkeypatch)


@pytest.fixture
def routed_host_launch(routed_host_kernel, monkeypatch):
    return _on_host(routed_host_kernel, monkeypatch)


def _case(model, seed=0, tile=1):
    rng = np.random.default_rng(seed)
    N = 10 if model == "kinematic" else 6
    dynamic = model == "pacejka"
    ref = ellipse_reference(80, speed=1.2 if dynamic else 0.35, dynamic=dynamic, device="cpu").numpy()
    refs = np.stack([ref[o : o + N + 1] for o in rng.integers(0, 60, B)]).astype(np.float32)
    nx = refs.shape[-1]
    scale = [0.05, 0.05, 0.1, 0.05, 0.01, 0.05] if dynamic else [0.08, 0.08, 0.15, 0.05]
    x0 = (refs[:, 0] + rng.uniform(-1, 1, (B, nx)) * np.array(scale)).astype(np.float32)
    kw = dict(N=N, ts=0.05, limits=((-1.0, -0.384), (1.0, 0.384)), mu_init=10.0, mu_scale=10.0,
              mu_max=1e8, viol_tol=1e-4, tol=1e-6, tile=tile, nu=2, nx=nx)
    if dynamic:
        x0[0, 3] -= 0.6
        kw.update(ode_rows=make_pacejka_ode_rows(model_tuple(VehicleParameters())), state_limits=None,
                  weights=(Q_DYNAMIC, R_DYNAMIC, QN_SCALE))
        par = None
    else:
        par = np.stack([2.0 * (1 + 0.1 * rng.uniform(-1, 1, B)), 1 + 0.1 * rng.uniform(-1, 1, B)], -1)
        par = torch.as_tensor(par.astype(np.float32))
        kw.update(ode_rows=make_parking_ode_rows(0.05 / 0.097, 0.05),
                  state_limits=((-3.0, -2.0, -100.0, -0.5), (3.0, 2.0, 100.0, 0.5)),
                  weights=((40.0, 40.0, 4.0, 1.0), (0.5, 0.5), 5.0))
    args = F.prepare_tiles(torch.as_tensor(x0), torch.zeros(B, N, 2), torch.as_tensor(refs), par, tile=tile)
    return args, kw


@pytest.mark.parametrize(
    "model, integrator, substeps",
    [("kinematic", "euler", 1), ("kinematic", "rk4", 2), ("pacejka", "rk4", 4), ("pacejka", "euler", 1)],
)
def test_host_build_matches_twin(host_launch, model, integrator, substeps):
    args, kw = _case(model)
    kw.update(integrator=integrator, substeps=substeps)
    before = F.LAUNCHES
    for outer, inner, tol in ((1, 1, 0.0 if model == "kinematic" else 1e-3), (3, 8, 2e-2)):
        got = host_launch(*args, outer_iters=outer, inner_iters=inner, **kw)
        want = F.tracker_tiles_reference(*args, outer_iters=outer, inner_iters=inner, **kw)
        assert torch.equal(got[3], want[3])  # converged
        du = (got[0] - want[0]).abs().max().item()
        print(f"{model} {integrator}x{substeps} {outer}x{inner}: max|du| {du:.3e} (tol {tol})")
        assert du <= tol
        if outer == 1:
            assert torch.equal(got[5], want[5])  # executed inner iterations
    assert F.LAUNCHES == before + 2


@pytest.mark.parametrize(
    "model, integrator, substeps",
    [("kinematic", "euler", 1), ("pacejka", "rk4", 4)],
)
@pytest.mark.parametrize("group, tile", [(8, 2), (32, 1)])
def test_host_build_groups_match_group_one(host_launch, model, integrator, substeps, group, tile):
    """A lane's group only deals the work: at the same tile every output of
    the host build is bit for bit the one-thread build's, whatever the
    group, and the twin's gates hold as above."""
    args, kw = _case(model, tile=tile)
    kw.update(integrator=integrator, substeps=substeps, outer_iters=3, inner_iters=8)
    got = host_launch(*args, group=group, **kw)
    one = host_launch(*args, group=1, **kw)
    for a, b, name in zip(got, one, ("us", "xs", "viol", "converged", "lam", "inner iterations")):
        assert torch.equal(a, b), name
    want = F.tracker_tiles_reference(*args, **kw)
    assert torch.equal(got[3], want[3])
    assert (got[0] - want[0]).abs().max().item() <= 2e-2


def test_host_build_without_shared_memory_matches(host_launch, monkeypatch):
    """With no region in shared memory (as at a tile too wide for it) the
    working set lives in the global workspace and the outputs: same bits."""
    args, kw = _case("kinematic", tile=2)
    kw.update(integrator="euler", substeps=1, outer_iters=2, inner_iters=4)
    some = host_launch(*args, group=8, **kw)
    monkeypatch.setattr(F, "SMEM_LIMIT", 8 * 200)  # 200 floats a lane: no room for [A | B]
    nc = 12
    plan = F.launch_plan(4, kw["N"], nc, 2, 8)
    names = [r[0] for r in F.regions(4, kw["N"], nc)]
    assert [names[r] for r in range(7) if plan.smask >> r & 1] == ["gain", "xs", "us"]
    part = host_launch(*args, group=8, **kw)
    monkeypatch.setattr(F, "SMEM_LIMIT", 0)
    assert F.launch_plan(4, kw["N"], nc, 2, 8).smask == 0
    none = host_launch(*args, group=8, **kw)
    for a, b, c in zip(some, part, none):
        assert torch.equal(a, b) and torch.equal(a, c)


def _benchmark_case(case, tile):
    """A benchmark-model solve from ``test_torch_benchmark_models.CASES``
    (regulation, tracking, no input box; nu 1 to 4), prepared for the
    launch at ``tile``."""
    from test_torch_benchmark_models import CASES, TS, case_inputs

    from model_predictive_control_tpu_torch.models import benchmarks as BM

    builder, nx, nu, limits, state_limits, weights, *_ = CASES[case]
    x0, u0, refs, par = (None if a is None else torch.as_tensor(a) for a in case_inputs(case, B))
    args = F.prepare_tiles(x0, u0, refs, par, tile=tile)
    kw = dict(ode_rows=getattr(BM, builder)(), nx=nx, nu=nu, N=u0.shape[1], ts=TS, substeps=2,
              integrator="rk4", limits=limits, state_limits=state_limits, weights=weights,
              mu_init=10.0, mu_scale=10.0, mu_max=1e8, viol_tol=1e-4, tol=1e-6, tile=tile)
    return args, kw


BENCHMARK_CASES = ["cartpole_regulation", "quadrotor_tracking_tilt_box", "quadrotor_no_input_box",
                   "omnibase_regulation", "omnibase_param_mass", "thruster_regulation"]


@pytest.mark.parametrize("case", BENCHMARK_CASES)
def test_host_build_benchmark_models_match_twin(routed_host_launch, case):
    """Each benchmark instantiation of the source (nu = 1 to 4, the three
    Quu solves, regulation, no input box), its transcendentals routed to
    torch, against the twin at one thread per lane: after one inner
    iteration bit for bit, at a 3 × 5 budget converged masks equal and
    controls within 2e-2; then a group of 8 over two lanes a tile gives the
    one-thread build's bits."""
    host_launch = routed_host_launch
    args, kw = _benchmark_case(case, tile=1)
    for outer, inner, tol in ((1, 1, 0.0), (3, 5, 2e-2)):
        got = host_launch(*args, outer_iters=outer, inner_iters=inner, **kw)
        want = F.tracker_tiles_reference(*args, outer_iters=outer, inner_iters=inner, **kw)
        assert torch.equal(got[3], want[3])  # converged
        du = (got[0] - want[0]).abs().max().item()
        print(f"{case} {outer}x{inner}: max|du| {du:.3e} (tol {tol})")
        assert du <= tol
        if outer == 1:
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    args, kw = _benchmark_case(case, tile=2)
    kw.update(outer_iters=2, inner_iters=3)
    got = host_launch(*args, group=8, **kw)
    one = host_launch(*args, group=1, **kw)
    for a, b, name in zip(got, one, ("us", "xs", "viol", "converged", "lam", "inner iterations")):
        assert torch.equal(a, b), name


@pytest.fixture(scope="module")
def routed_ext_kernel(tmp_path_factory):
    return _host_builder(tmp_path_factory, math=True, ext=True)


@pytest.fixture
def ext_host_launch(routed_host_kernel, routed_ext_kernel, monkeypatch):
    return _on_host(routed_host_kernel, monkeypatch, ext_build=routed_ext_kernel)


def _ext_case(case, tile):
    """A launch of one of the second library's instantiations, prepared at
    ``tile``: the factory parking OCP (order 2 with warm multipliers, order 1
    with per-lane weights) or the MHE windows (additive, terminal rows,
    per-stage input weights)."""
    from model_predictive_control_tpu_torch.models.bicycle import make_kinematic_ode_rows
    from model_predictive_control_tpu_torch.estimation_nl import _gated_ode_rows
    from model_predictive_control_tpu_torch.ops.cuda.ilqr_kernel import parking_geometry
    from model_predictive_control_tpu_torch.ops.cuda.parking_factory import make_clearance_rows

    rng = np.random.default_rng(5)
    N = 6
    kw = dict(mu_init=10.0, mu_scale=10.0, mu_max=1e8, viol_tol=1e-4, tol=1e-6, tile=tile)
    if case == "mhe":
        x0 = rng.uniform(-0.5, 0.5, (B, 4))
        x0[:, 3] = 0.3
        exo = np.concatenate([np.ones((B, N, 1)), np.tile([0.2, 0.05], (B, N, 1))], -1)
        exo[:, 0, 0] = 0.0
        refs = np.zeros((B, N + 1, 4))
        refs[:, 0] = x0
        refs[:, 1:, :2] = x0[:, None, :2] + 0.1 * rng.normal(size=(B, N, 2))
        rw = np.concatenate([np.tile([1e4, 1e4, 1e3, 1e2], (B, 1, 1)),
                             np.tile([1e6, 1e6, 1e5, 1e3], (B, N - 1, 1))], 1)
        lims = ((-3.0, -2.0, -7.0, 0.0), (3.0, 2.0, 7.0, 1.0))
        f = lambda a: torch.as_tensor(a, dtype=torch.float32)
        args = F.prepare_tiles(f(x0), torch.zeros(B, N, 4), f(refs), None, tile=tile)
        kw.update(F.prepare_operands(B, tile=tile, exo=f(exo), input_weights_rt=f(rw)),
                  ode_rows=_gated_ode_rows(make_kinematic_ode_rows(0.05 / 0.097, 0.05, 2.0, 1.0), 2),
                  nx=4, nu=4, N=N, ts=0.05, substeps=1, integrator="rk4", limits=None,
                  state_limits=lims, terminal_state_limits=lims, input_mode="additive",
                  weights=((100.0, 100.0, 0.0, 0.0), (0.0,) * 4, 1.0))
        return args, kw
    geom, limits = parking_geometry(VehicleParameters(), (0.25, 0.0, 0.0, 0.0), n_circles=3)
    kb, lr, ox, r2, obs = geom
    x0 = np.array([0.3, -0.1, 0.0, 0.0]) + rng.uniform(-1, 1, (B, 4)) * np.array(
        [0.15, 0.1, 0.3, 0.05])
    par = np.stack([2.0 * (1 + 0.1 * rng.uniform(-1, 1, B)), 1 + 0.1 * rng.uniform(-1, 1, B)], -1)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    order = 2 if case == "parking_order2_lam_init" else 1
    extra = {}
    if order == 2:
        extra["lam_init"] = f(rng.uniform(0, 2, (B, N, 21)) * (rng.uniform(size=(B, N, 21)) < 0.3))
    else:
        extra["weights_rt"] = f(np.array([1.0, 6.0, 0.2, 0.05, 1.0, 0.01, 100.0])
                                * (1 + 0.2 * rng.uniform(-1, 1, (B, 7))))
    args = F.prepare_tiles(f(x0), torch.zeros(B, N, 2), None, f(par), tile=tile)
    kw.update(F.prepare_operands(B, tile=tile, **extra),
              ode_rows=make_parking_ode_rows(kb, lr), nx=4, nu=2, N=N, ts=0.08, substeps=1,
              integrator="euler", limits=(limits[2], limits[3]), state_limits=(limits[0], limits[1]),
              weights=None if order == 1 else ((1.0, 6.0, 0.2, 0.05), (1.0, 0.01), 100.0),
              extra_constraints=make_clearance_rows(tuple(ox), r2, tuple(obs)), n_extra=9,
              extra_deps=(0, 1, 2), extra_order=order)
    return args, kw


EXT_CASES = ["parking_order2_lam_init", "parking_order1_weights_rt", "mhe"]


@pytest.mark.parametrize("case", EXT_CASES)
def test_host_build_ext_instantiations_match_twin(ext_host_launch, case):
    """Each instantiation of the second source (``csrc/ilqr_factory_ext.cu``),
    its transcendentals routed to torch, against the twin at one thread per
    lane: after one inner iteration every output bit for bit; then at tile 2
    a group of 8 gives the one-thread build's bits at a 2 × 3 budget."""
    args, kw = _ext_case(case, tile=1)
    before = dict(F.LAUNCHES_BY_KERNEL)
    got = ext_host_launch(*args, outer_iters=1, inner_iters=1, **kw)
    want = F.tracker_tiles_reference(*args, outer_iters=1, inner_iters=1, **kw)
    for a, b, name in zip(got, want, ("us", "xs", "viol", "converged", "lam", "inner iterations")):
        assert torch.equal(a, b), name
    key = F.instantiation(kw["ode_rows"], kw.get("extra_constraints"), kw.get("extra_order", 2),
                          kw["wrt"] is not None)
    assert key in F.EXT_KERNELS and F.LAUNCHES_BY_KERNEL[key] == before[key] + 1
    args, kw = _ext_case(case, tile=2)
    kw.update(outer_iters=2, inner_iters=3)
    got = ext_host_launch(*args, group=8, **kw)
    one = ext_host_launch(*args, group=1, **kw)
    for a, b, name in zip(got, one, ("us", "xs", "viol", "converged", "lam", "inner iterations")):
        assert torch.equal(a, b), name
