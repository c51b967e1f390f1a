"""The parking AL-iLQR kernel's CUDA source, compiled for the host, against
its twin; and the wrapper's launch reckoning.

``csrc/ilqr_kernel.cu`` is plain C++ apart from its CUDA qualifiers, its
barriers, the shared-memory buffer and the launch. Built by g++ with those
stubbed (the stub of ``test_torch_ilqr_factory_host.py``), it runs the
kernel's arithmetic on the CPU through the real wrapper (``prepare_tiles``,
``launch_plan``, ``_launch``, the constants struct): a CTA's threads are host
threads, ``__syncthreads_and`` and ``__syncwarp`` one CTA-wide barrier
between them, the dynamic shared memory a static buffer. At group 1 a lane is
one thread; at groups 8 and 32 the members deal the derivative pre-pass's
stages, the line-search candidates and the multiplier update as on the card,
so a missing barrier or a vote that not every thread reaches shows here as a
wrong number or a hang. The kernel's transcendentals, ``tanf``, ``sinf``,
``cosf`` and ``sqrtf``, are routed back to torch's CPU functions (one element
at a time: torch's float32 results do not depend on a value's place in its
tensor), because the host's libm rounds some values apart from them (torch's
CPU ``sqrt`` is not even correctly rounded); on the card the kernel and the
twin call the same CUDA functions. Every other operation is the source's own,
so every output is held to the unchanged twin bit for bit, at every group,
with and without the obstacle, cold and warm, and with the working set forced
out of shared memory. On the card the kernel is held to the twin bit for bit
too (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
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
from test_torch_ilqr_factory_host import GRID, STUB

from model_predictive_control_tpu_torch.models.parameters import VehicleParameters
from model_predictive_control_tpu_torch.ops.cuda import ilqr_kernel as K
from model_predictive_control_tpu_torch.solvers.parking import Q_MAIN, QN_SCALE_MAIN, R_MAIN

X_OBS = (0.25, 0.0, 0.0, 0.0)
FIELDS = ("us", "xs", "viol", "converged", "lam", "inner iterations")
B, N = 5, 6

# The four transcendentals of the source, each a call back into torch.
MATH = """
typedef float (*unary_fn)(float);
static unary_fn host_math[4];
extern "C" void set_host_math(int k, unary_fn f) { host_math[k] = f; }
static inline float host_tanf(float a) { return host_math[0](a); }
static inline float host_sinf(float a) { return host_math[1](a); }
static inline float host_cosf(float a) { return host_math[2](a); }
static inline float host_sqrtf(float a) { return host_math[3](a); }
#define tanf host_tanf
#define sinf host_sinf
#define cosf host_cosf
#define sqrtf host_sqrtf
"""
UNARY = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)


def _torch_unary(fn):
    """``fn`` on one float32 value, as the twin computes it, memoized."""
    seen = {}

    def call(a):
        if a not in seen:
            seen[a] = fn(torch.tensor([a], dtype=torch.float32)).item()
        return seen[a]

    return UNARY(call)


CALLBACKS = [_torch_unary(f) for f in (torch.tan, torch.sin, torch.cos, torch.sqrt)]


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``group -> library``: the source built for the host, once per group."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = K._SOURCES[0].read_text().replace("#include <cuda_runtime.h>", STUB + MATH)
    src, n = re.subn(
        r"kernel<<<n_tiles, tile \* GROUP, bytes, s>>>\(g, c\)",
        "host_grid(kernel, n_tiles, tile * GROUP, g, c)", src,
    )
    assert n == 1, "the launch line of csrc/ilqr_kernel.cu changed"
    marker = "template <int NC, int MODE>\nstatic int launch_kernel"
    assert src.count(marker) == 1
    src = src.replace(marker, GRID + "\n" + marker)
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "k.cpp").write_text(src)

    @functools.lru_cache(maxsize=None)
    def build(group):
        lib = d / f"libk{group}.so"
        subprocess.run(
            ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", "-w",
             f"-DALILQR_GROUP={group}", str(d / "k.cpp"), "-o", str(lib)],
            check=True, capture_output=True,
        )
        lib = ctypes.CDLL(str(lib))
        K._configure(lib)
        for k, fn in enumerate(CALLBACKS):
            lib.set_host_math(k, fn)
        return lib

    return build


@pytest.fixture
def host_launch(host_kernel, monkeypatch):
    """``ilqr_kernel._launch`` running the host build on CPU tensors."""
    monkeypatch.setattr(K, "_build_library", lambda group=1: host_kernel(group))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return K._launch


def _case(obstacle=True, tile=4, warm=False, seed=0, outer=6, inner=15):
    """Padded operands and the launch keywords for ``B`` parking lanes at
    horizon ``N``, made with numpy from ``seed`` (starts outside the
    clearance circle, perturbed acceleration and friction)."""
    rng = np.random.default_rng(seed)
    x0 = np.array([0.3, -0.1, 0.0, 0.0]) + rng.uniform(-1, 1, (B, 4)) * np.array([0.2, 0.15, 0.3, 0.05])
    d = x0[:, :2] - np.array(X_OBS[:2])
    r = np.linalg.norm(d, axis=1, keepdims=True)
    x0[:, :2] = np.where(r < 0.22, np.array(X_OBS[:2]) + d / r * 0.22, x0[:, :2])
    n_circ = 3 if obstacle else 0
    nc = K.n_constraints(n_circ)
    u = rng.uniform(-0.3, 0.3, (B, N, 2)) if warm else np.zeros((B, N, 2))
    lam = np.maximum(rng.normal(0.0, 0.05, (B, N, nc)), 0.0) if warm else None
    acc = 2.0 * (1.0 + 0.1 * rng.uniform(-1, 1, B))
    fric = 1.0 + 0.1 * rng.uniform(-1, 1, B)
    t = lambda a: None if a is None else torch.as_tensor(np.asarray(a, np.float32))
    args = K.prepare_tiles(t(x0), t(u), t(acc), t(fric), t(lam), N=N, tile=tile, n_circles=n_circ)
    geom, limits = K.parking_geometry(VehicleParameters(), X_OBS if obstacle else None)
    kw = dict(N=N, n_circ=n_circ, tile=tile, ts=0.08, geom=geom, limits=limits,
              weights=(tuple(Q_MAIN), tuple(R_MAIN), float(QN_SCALE_MAIN)), outer_iters=outer,
              inner_iters=inner, mu_init=10.0, mu_scale=10.0, mu_max=1e8, viol_tol=1e-4, tol=1e-6)
    return args, kw


def _assert_equal(got, want):
    for a, b, name in zip(got, want, FIELDS, strict=True):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("obstacle", [True, False])
@pytest.mark.parametrize("tile", [2, 4])
@pytest.mark.parametrize("group", K.GROUPS)
def test_host_build_matches_twin(host_launch, obstacle, tile, group):
    """The whole solve at the sweep's 6 × 15 budget: every output of the
    host build at every group is the twin's, bit for bit."""
    args, kw = _case(obstacle, tile)
    before = K.LAUNCHES
    got = host_launch(*args, group=group, **kw)
    assert K.LAUNCHES == before + 1
    want = K.al_ilqr_tiles_reference(*args, **kw)
    _assert_equal(got, want)
    assert bool(got[3].any()) and float(got[5].max()) > 1


@pytest.mark.parametrize("group", [1, 8])
def test_host_build_warm_start_matches_twin(host_launch, group):
    """A warm start (controls and multipliers), as the policy's later steps
    launch it."""
    args, kw = _case(tile=4, warm=True, seed=3)
    _assert_equal(host_launch(*args, group=group, **kw), K.al_ilqr_tiles_reference(*args, **kw))


def test_host_build_without_shared_memory_matches(host_launch, monkeypatch):
    """With regions out of shared memory (as at a tile too wide for them)
    the working set lives in the global workspace and the outputs: same
    bits."""
    args, kw = _case(tile=2, outer=3, inner=6)
    want = K.al_ilqr_tiles_reference(*args, **kw)
    nc = K.n_constraints(3)
    assert K.launch_plan(N, nc, 2, 8).smask == 0b111111
    _assert_equal(host_launch(*args, group=8, **kw), want)
    monkeypatch.setattr(K, "SMEM_LIMIT", 8 * 250)  # 250 floats a lane
    plan = K.launch_plan(N, nc, 2, 8)
    names = [r[0] for r in K.regions(N, nc)]
    assert [names[r] for r in range(6) if plan.smask >> r & 1] == ["der", "gain", "xs", "us"]
    assert plan.work_rows == dict((n, f) for n, f, _ in K.regions(N, nc))["cand"]
    _assert_equal(host_launch(*args, group=8, **kw), want)
    monkeypatch.setattr(K, "SMEM_LIMIT", 0)
    plan = K.launch_plan(N, nc, 2, 8)
    assert plan.smask == 0 and plan.smem_bytes == 0 and plan.work_rows == N * (23 + 10) + 7 * 41
    _assert_equal(host_launch(*args, group=8, **kw), want)


# ---------------------------------------------------------------------------
# the tracking, additive-offset and input-reference modes
# ---------------------------------------------------------------------------

MODES = {
    # name: (refs, dist, urefs) given
    "refs": (True, False, False),
    "dist+urefs": (False, True, True),
    "all": (True, True, True),
}


def _mode_case(mode, obstacle=False, tile=4, warm=False, seed=5, outer=3, inner=8):
    """:func:`_case` with the mode's operands: a reference window around a
    forward arc from the start, an offset of a few millimetres a step and a
    small input reference, made with numpy from ``seed``."""
    args, kw = _case(obstacle, tile, warm, seed, outer, inner)
    rng = np.random.default_rng(seed + 100)
    has_ref, has_dist, has_uref = MODES[mode]
    x0 = args[0][:, :B].T.numpy().astype(np.float64)
    t = np.arange(N + 1)[None, :, None]
    ref = x0[:, None, :] + t * np.array([0.01, 0.004, 0.02, 0.0]) + rng.normal(0, 0.01, (B, N + 1, 4))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    extra = dict(
        refs=f32(ref) if has_ref else None,
        dist=f32(rng.uniform(-4e-3, 4e-3, (B, 4))) if has_dist else None,
        urefs=f32(rng.uniform(-0.2, 0.2, (B, N, 2))) if has_uref else None,
    )
    u = args[1][:, :, :B].permute(2, 0, 1)
    lam = args[3][:, :, :B].permute(2, 0, 1)
    n_circ = kw["n_circ"]
    pp = args[2][:, :B]
    args = K.prepare_tiles(args[0][:, :B].T, u, pp[0], pp[1], lam, N=N, tile=tile,
                           n_circles=n_circ, **extra)
    return args, kw


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("group", K.GROUPS)
def test_host_build_modes_match_twin(host_launch, mode, group):
    """Each new mode, cold: every output of the host build at every group
    is the twin's, bit for bit (``dist+urefs`` runs as all three operands,
    the reference zero)."""
    args, kw = _mode_case(mode)
    assert [a is not None for a in args[4:]] == ([True] * 3 if mode != "refs" else [True, False, False])
    want = K.al_ilqr_tiles_reference(*args, **kw)
    _assert_equal(host_launch(*args, group=group, **kw), want)
    assert bool(want[3].any())


@pytest.mark.parametrize("mode", ["refs", "all"])
def test_host_build_modes_warm_and_obstacle_match_twin(host_launch, mode):
    """Warm (controls and multipliers) with the obstacle rows, at group 8."""
    args, kw = _mode_case(mode, obstacle=True, warm=True, seed=7, outer=4, inner=10)
    _assert_equal(host_launch(*args, group=8, **kw), K.al_ilqr_tiles_reference(*args, **kw))


def test_host_build_modes_out_of_shared_memory(host_launch, monkeypatch):
    """The mode's operands read from their inputs (regions out of shared
    memory), then everything out of it: same bits."""
    args, kw = _mode_case("all", tile=2)
    want = K.al_ilqr_tiles_reference(*args, **kw)
    nc = K.n_constraints(0)
    names = [r[0] for r in K.regions(N, nc, K.M_ALL)]
    assert names[6:] == ["ref", "uref", "dist"]
    base = sum(f for _, f, _ in K.regions(N, nc))
    monkeypatch.setattr(K, "SMEM_LIMIT", 8 * (base + 1))  # the regulation regions only
    plan = K.launch_plan(N, nc, 2, 8, K.M_ALL)
    assert plan.smask == 0b000111111 and plan.work_rows == 0
    _assert_equal(host_launch(*args, group=8, **kw), want)
    monkeypatch.setattr(K, "SMEM_LIMIT", 0)
    assert K.launch_plan(N, nc, 2, 8, K.M_ALL).smask == 0
    _assert_equal(host_launch(*args, group=8, **kw), want)


def test_mode_regions_and_refusals(monkeypatch):
    """A lane's extra floats per mode, (N+1)·4 + N·2 + 4 with all three; the
    regulation plan is the six regions' alone; a launch with a mode the
    kernel is not built for raises before any build."""
    n, nc = 15, 12
    extra = lambda mode: sum(f for _, f, _ in K.regions(n, nc, mode)[6:])
    assert extra(K.M_ALL) == (n + 1) * 4 + n * 2 + 4
    assert extra(K.M_TRACK) == (n + 1) * 4
    assert len(K.regions(n, nc)) == 6 and K.launch_plan(n, nc, 16, 8).smask == 0b111111
    assert K.launch_plan(n, nc, 16, 8, K.M_ALL).smask == 0b111111111
    with pytest.raises(ValueError, match="threads per CTA"):
        K.launch_plan(n, nc, 128, 8, K.M_ALL)
    monkeypatch.setattr(K, "_build_library", lambda group=1: pytest.fail("built a library"))
    args, kw = _mode_case("all")
    with pytest.raises(ValueError, match="operand modes"):
        K._launch(*args[:5], None, args[6], group=8, **kw)


# ---------------------------------------------------------------------------
# the wrapper's reckoning (no compiler needed)
# ---------------------------------------------------------------------------


def test_launch_plan_reckons_shared_memory_and_workspace():
    """A lane's working set by region at the sweep's N = 30 with the
    obstacle, what fits the 227 KB of a CTA at each tile, and the global
    workspace for the rest."""
    n, nc = 30, 21
    sizes = {name: f for name, f, _ in K.regions(n, nc)}
    assert sizes == {"der": n * 23, "gain": n * 2 * 5, "xs": (n + 1) * 4, "us": n * 2,
                     "lam": n * nc, "cand": 7 * ((n + 1) * 4 + n * 2 + 1)}
    total = sum(sizes.values())
    assert total == 3099
    # up to tile 16 the whole working set is in shared memory: no workspace
    for tile, group in ((8, 8), (16, 8), (16, 32), (8, 32), (16, 1)):
        plan = K.launch_plan(n, nc, tile, group)
        assert plan == K.LaunchPlan(threads=tile * group, smask=0b111111,
                                    smem_bytes=4 * tile * (total | 1), work_rows=0)
    # at tile 32 the candidates do not fit: they are the workspace, the rest
    # (lane blocks padded to an odd float count) is shared
    plan = K.launch_plan(n, nc, 32, 8)
    floats = total - sizes["cand"]
    assert plan == K.LaunchPlan(threads=256, smask=0b011111, smem_bytes=4 * 32 * (floats | 1),
                                work_rows=sizes["cand"])
    assert plan.smem_bytes <= K.SMEM_LIMIT < 4 * 32 * (total | 1)
    # without the obstacle (12 rows) the same tile keeps fewer floats per lane
    assert K.launch_plan(n, 12, 32, 8).smask == 0b011111
    # at tile 64 a region that does not fit is skipped and a later, smaller
    # one still taken: the derivative store, xs and us are shared
    plan = K.launch_plan(n, nc, 64, 8)
    assert plan.smask == 0b001101 and plan.work_rows == sizes["gain"] + sizes["cand"]
    assert plan.smem_bytes == 4 * 64 * ((sizes["der"] + sizes["xs"] + sizes["us"]) | 1)


@pytest.mark.parametrize(
    "tile, group, message",
    [
        (16, 4, "group must be one of"),
        (16, 16, "group must be one of"),
        (257, 1, "threads per CTA"),
        (128, 8, "threads per CTA"),
        (32, 32, "threads per CTA"),
        (0, 8, "tile must be positive"),
    ],
)
def test_launch_plan_refuses(tile, group, message):
    with pytest.raises(ValueError, match=message):
        K.launch_plan(30, 21, tile, group)


@pytest.mark.parametrize("group", K.GROUPS)
def test_widest_tile_of_each_group_is_taken(group):
    tile = K.MAX_THREADS[group] // group
    assert K.launch_plan(30, 21, tile, group).threads == K.MAX_THREADS[group]
    with pytest.raises(ValueError, match="threads per CTA"):
        K.launch_plan(30, 21, tile + 1, group)


def test_group_resolution():
    """``group=None`` takes the default where the tile allows it, else the
    largest group that fits; an explicit group is kept (and refused by the
    plan when it does not fit)."""
    resolve = lambda tile, group=None: K.resolve_group(group, tile, K.DEFAULT_GROUP, K.GROUPS,
                                                      K.MAX_THREADS)
    assert K.DEFAULT_GROUP in K.GROUPS
    assert K.DEFAULT_TILE * K.DEFAULT_GROUP <= K.MAX_THREADS[K.DEFAULT_GROUP]
    assert resolve(K.DEFAULT_TILE) == K.DEFAULT_GROUP
    assert [resolve(t) for t in (32, 64, 128, 256)] == [8, 8, 1, 1]
    assert resolve(512) == K.DEFAULT_GROUP  # nothing fits: the plan refuses the tile
    for tile in (32, 64, 128, 256):
        K.launch_plan(30, 21, tile, resolve(tile))
    assert resolve(32, 32) == 32
    with pytest.raises(ValueError, match="threads per CTA"):
        K.launch_plan(30, 21, 32, resolve(32, 32))
    assert K.library_name(1) == K.LIBRARY and K.library_name(32) == K.LIBRARY + "_g32"


def test_launch_validates_before_it_builds(monkeypatch):
    """An unknown group, too many threads or an uninstantiated circle count
    raise from ``_launch`` before any library is built, and count no
    launch."""
    monkeypatch.setattr(K, "_build_library", lambda group=1: pytest.fail("built a library"))
    args, kw = _case(tile=4)
    before = K.LAUNCHES
    with pytest.raises(ValueError, match="group must be one of"):
        K._launch(*args, group=3, **kw)
    with pytest.raises(ValueError, match="threads per CTA"):
        K._launch(*args, group=32, **{**kw, "tile": 32})
    with pytest.raises(ValueError, match="n_circles"):
        K._launch(*args, group=8, **{**kw, "n_circ": 2})
    assert K.LAUNCHES == before


def test_group_is_validated_and_ignored_on_the_twin():
    """On CPU tensors a valid group changes nothing (the twin has no
    threads); an unknown one raises all the same."""
    rng = np.random.default_rng(1)
    x0 = torch.as_tensor(np.array([0.3, -0.1, 0.0, 0.0], np.float32) + 0.1 * rng.standard_normal((3, 4)).astype(np.float32))
    u, acc, fric = torch.zeros(3, 5, 2), torch.full((3,), 2.0), torch.full((3,), 1.0)
    geom, limits = K.parking_geometry(VehicleParameters(), X_OBS)
    kw = dict(N=5, ts=0.08, geom=geom, limits=limits, n_circles=3, outer_iters=2, inner_iters=3,
              weights=(tuple(Q_MAIN), tuple(R_MAIN), float(QN_SCALE_MAIN)), tile=4)
    ref = K.al_ilqr_solve_twin(x0, u, acc, fric, **kw)
    for got in (K.al_ilqr_solve_cuda(x0, u, acc, fric, group=32, **kw),
                K.al_ilqr_solve_twin(x0, u, acc, fric, group=1, **kw)):
        for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for solve in (K.al_ilqr_solve_cuda, K.al_ilqr_solve_twin):
        with pytest.raises(ValueError, match="group must be one of"):
            solve(x0, u, acc, fric, group=5, **kw)
