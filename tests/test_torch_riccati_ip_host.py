"""The stagewise-IP kernel's CUDA source, compiled for the host, against its
twin; and the wrapper's launch reckoning.

``csrc/riccati_ip_kernel.cu`` is plain C++ apart from its CUDA qualifiers,
its barriers, the shared-memory buffer and the launch. Built by g++ with
those stubbed (the stub of ``test_torch_ilqr_factory_host.py``), it runs the
kernel's arithmetic on the CPU through the real wrapper
(``prepare_problem``, ``prepare_tiles``, ``launch_plan``, ``_launch``, the
constants and flags): a CTA's threads are host threads, ``__syncthreads``
and ``__syncthreads_and`` one CTA-wide barrier between them, the dynamic
shared memory a static buffer. At group 1 a lane is one thread; at groups 8
and 32 the members deal the stages of every elementwise pass, member 0 runs
the recursions and the group reduces through its exchange area as on the
card, so a missing barrier or a vote that not every thread reaches shows
here as a wrong number or a hang. The kernel has no
transcendental function, only IEEE add, multiply and divide in the twin's
order, so it must agree with the unchanged twin bit for bit: controls,
states, μ, residual, status and executed iterations, for both shipped sizes
((nx, nu) = (2, 1), the long-horizon path, and (3, 2) with a dense R and
infinite bounds), at every group and two tiles, with the working set in
shared memory and out of it. On the card the kernel is held to the twin the
same way (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
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

from model_predictive_control_tpu_torch.ops.cuda import riccati_ip_kernel as K

# the CTA barrier (the stub has the warp barrier and the vote)
BARRIER = """
inline void __syncthreads() { cta.arrive(1); }
"""

LAUNCH = "kernel<<<n_tiles, tile * GROUP, bytes, s>>>(g, c);"
MARKER = "static int launch_kernel("
FIELDS = ("us", "xs", "mu", "prim_res", "success", "iters")

SESSION2 = dict(
    A=[[1.0, 0.3], [0.0, 1.0]], B=[[0.0], [0.3]], Q=np.diag([10.0, 1.0]), R=[[0.01]],
    x_lb=[-150.0, -20.0], x_ub=[1.0, 25.0], u_lb=[-20.0], u_ub=[10.0],
)
SYNTHETIC = dict(  # tests/test_pallas_riccati_ip.py's nx=3 / nu=2 system
    A=[[1.0, 0.1, 0.0], [0.0, 1.0, 0.1], [0.0, 0.0, 0.95]],
    B=[[0.0, 0.005], [0.1, 0.0], [0.0, 0.1]],
    Q=np.diag([5.0, 1.0, 0.5]), R=[[0.1, 0.01], [0.01, 0.2]],
    x_lb=[-4.0, -2.0, -np.inf], x_ub=[4.0, 2.0, 1.5], u_lb=[-1.0, -0.8], u_ub=[1.0, 0.8],
)
ORDER = ("A", "B", "Q", "R", "Pf", "x_lb", "x_ub", "u_lb", "u_ub")
B = 7


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``(nx, nu, group) -> library``: the source built for the host."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = K._SOURCES[0].read_text().replace("#include <cuda_runtime.h>", STUB + BARRIER)
    assert src.count(LAUNCH) == 1, "the launch line of csrc/riccati_ip_kernel.cu changed"
    src = src.replace(LAUNCH, "host_grid(kernel, n_tiles, tile * GROUP, g, c);")
    assert src.count(MARKER) == 1
    src = src.replace(MARKER, GRID + "\n" + MARKER)
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "k.cpp").write_text(src)

    @functools.lru_cache(maxsize=None)
    def build(nx, nu, group):
        lib = d / f"libk_{nx}_{nu}_{group}.so"
        subprocess.run(
            ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", "-w",
             f"-DNX={nx}", f"-DNU={nu}", f"-DIP_GROUP={group}", str(d / "k.cpp"), "-o", str(lib)],
            check=True, capture_output=True,
        )
        lib = ctypes.CDLL(str(lib))
        K._configure(lib)
        return lib

    return build


@pytest.fixture
def host_launch(host_kernel, monkeypatch):
    """``riccati_ip_kernel._launch`` running the host build on CPU tensors."""
    monkeypatch.setattr(K, "_build_library", lambda nx=2, nu=1, group=1: host_kernel(nx, nu, group))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return K._launch


def _states(system, seed):
    rng = np.random.default_rng(seed)
    if system is SESSION2:
        x0 = np.stack([rng.uniform(-140, -20, B), rng.uniform(-15, 24, B)], 1)
        x0[-1] = [50.0, 30.0]  # infeasible: the lane dies and reports failure
    else:
        x0 = rng.uniform(-1, 1, (B, 3)) * np.array([3.5, 1.9, 1.4])
    return torch.as_tensor(x0.astype(np.float32))


def _case(system, N, iters, warm, tile):
    """The launch's operands and keywords for ``B`` lanes of ``system`` at
    horizon ``N`` (``Pf = 2 Q``: the terminal weight's own branch)."""
    data = dict(system, Pf=2.0 * np.asarray(system["Q"]))
    x0 = _states(system, seed=N)
    nu = len(system["u_lb"])
    u_init = None
    if warm:
        rng = np.random.default_rng(1)
        u_init = torch.as_tensor(
            (rng.uniform(-0.5, 0.5, (B, N, nu)) * np.asarray(system["u_ub"])).astype(np.float32)
        )
    kp = K.prepare_problem(*(data[k] for k in ORDER), device="cpu")
    args = K.prepare_tiles(kp, x0, u_init, N=N, tile=tile)
    return args, dict(N=N, problem=kp.problem, iters=iters, tau=0.995, tile=tile)


def _assert_equal(got, want):
    for name, g, w in zip(FIELDS, got, want, strict=True):
        assert torch.equal(g, w), f"{name}: max diff {(g.float() - w.float()).abs().max()}"


CASES = {
    "s2-1it": (SESSION2, 8, 1, False),
    "s2-N8": (SESSION2, 8, 15, False),
    "s2-N40": (SESSION2, 40, 20, False),
    "s2-warm": (SESSION2, 10, 18, True),
    "nx3nu2": (SYNTHETIC, 12, 18, False),
    "nx3nu2-warm": (SYNTHETIC, 12, 18, True),
}


@pytest.mark.parametrize("group", K.GROUPS)
@pytest.mark.parametrize("case", CASES)
def test_host_build_matches_twin(host_launch, case, group):
    """Every output of the host build at every group is the twin's, bit for
    bit, at tile 2 (four CTAs, one padded lane, the infeasible session-2 lane
    dies)."""
    system, N, iters, warm = CASES[case]
    args, kw = _case(system, N, iters, warm, tile=2)
    before = K.LAUNCHES
    got = host_launch(*args, group=group, **kw)
    assert K.LAUNCHES == before + 1
    _assert_equal(got, K.stagewise_ip_tiles_reference(*args, **kw))
    if iters > 1:
        assert got[4].any()  # some lane converged: the polish and the status ran
    if system is SESSION2:
        assert not bool(got[4][B - 1])


@pytest.mark.parametrize("group", K.GROUPS)
@pytest.mark.parametrize("tile", [1, 4])
def test_host_build_at_other_tiles(host_launch, tile, group):
    """The same at one lane per CTA (the vote is the lane's own) and at four
    (the tile-wide exit waits for the slowest lane): the executed iterations
    move with the tile, never with the group."""
    args, kw = _case(SESSION2, 12, 18, False, tile=tile)
    want = K.stagewise_ip_tiles_reference(*args, **kw)
    _assert_equal(host_launch(*args, group=group, **kw), want)


def test_host_build_without_shared_memory_matches(host_launch, monkeypatch):
    """With regions out of shared memory (as at a tile too wide for them)
    the working set lives in the global workspace and the outputs: same
    bits."""
    args, kw = _case(SYNTHETIC, 12, 18, True, tile=2)
    want = K.stagewise_ip_tiles_reference(*args, **kw)
    assert K.launch_plan(12, 3, 2, 2, 8).smask == 0b1111111
    _assert_equal(host_launch(*args, group=8, **kw), want)
    sizes = {name: n for name, n, _ in K.regions(12, 3, 2, 8)}
    # room for the exchange area, the gains, the scratch store and the
    # directions only
    transients = sizes["exchange"] + sizes["gain"] + sizes["scratch"] + sizes["dir"]
    monkeypatch.setattr(K, "SMEM_LIMIT", 8 * (transients + 1))
    plan = K.launch_plan(12, 3, 2, 2, 8)
    assert plan.smask == 0b0001111 and plan.work_rows == sizes["slack"]
    _assert_equal(host_launch(*args, group=8, **kw), want)
    monkeypatch.setattr(K, "SMEM_LIMIT", 0)
    for group in K.GROUPS:
        plan = K.launch_plan(12, 3, 2, 2, group)
        assert plan.smask == 0 and plan.smem_bytes == 0
        assert plan.work_rows == group + transients - sizes["exchange"] + sizes["slack"]
        _assert_equal(host_launch(*args, group=group, **kw), want)


# ---------------------------------------------------------------------------
# the wrapper's reckoning (no compiler needed)
# ---------------------------------------------------------------------------


def test_launch_plan_reckons_shared_memory_and_workspace():
    """A lane's working set by region at the long-horizon N = 100, nx = 2,
    nu = 1, what fits the 227 KB of a CTA at each tile, and the global
    workspace for the rest."""
    n = 100
    sizes = {name: f for name, f, _ in K.regions(n, 2, 1, 8)}
    assert sizes == {"exchange": 8, "gain": n * 6, "scratch": n * 6, "dir": n * 6,
                     "xs": n * 2, "us": n, "slack": n * 12}
    total = sum(sizes.values())
    assert total == 33 * n + 8
    # up to tile 16 the whole working set is in shared memory: no workspace
    for tile, group in ((8, 8), (16, 8), (4, 32), (8, 32), (16, 1)):
        plan = K.launch_plan(n, 2, 1, tile, group)
        floats = total - 8 + group
        assert plan == K.LaunchPlan(threads=tile * group, smask=0b1111111,
                                    smem_bytes=4 * tile * (floats | 1), work_rows=0)
    # at tile 32 the exchange area, the gains, the scratch store and the
    # directions fit (lane blocks padded to an odd float count); the state
    # and the slacks are in global memory, the state at home in the outputs
    plan = K.launch_plan(n, 2, 1, 32, 8)
    floats = sizes["exchange"] + sizes["gain"] + sizes["scratch"] + sizes["dir"]
    assert plan == K.LaunchPlan(threads=256, smask=0b0001111, smem_bytes=4 * 32 * (floats | 1),
                                work_rows=sizes["slack"])
    assert plan.smem_bytes <= K.SMEM_LIMIT < 4 * 32 * ((floats + sizes["us"]) | 1)
    # at tile 64 a region that does not fit is skipped and later, smaller
    # ones still taken: the exchange area, the gains and the state are shared
    plan = K.launch_plan(n, 2, 1, 64, 1)
    assert plan.smask == 0b0110011
    assert plan.work_rows == sizes["scratch"] + sizes["dir"] + sizes["slack"]
    # the nx=3 / nu=2 size at N = 12 fits whole at every tile the bounds take
    assert K.launch_plan(12, 3, 2, 64, 8).smask == 0b1111111


@pytest.mark.parametrize(
    "tile, group, message",
    [
        (16, 4, "group must be one of"),
        (16, 16, "group must be one of"),
        (257, 1, "threads per CTA"),
        (65, 8, "threads per CTA"),
        (32, 32, "threads per CTA"),
        (0, 8, "tile must be positive"),
    ],
)
def test_launch_plan_refuses(tile, group, message):
    with pytest.raises(ValueError, match=message):
        K.launch_plan(100, 2, 1, tile, group)


@pytest.mark.parametrize("group", K.GROUPS)
def test_widest_tile_of_each_group_is_taken(group):
    tile = K.MAX_THREADS[group] // group
    assert K.launch_plan(100, 2, 1, tile, group).threads == K.MAX_THREADS[group]
    with pytest.raises(ValueError, match="threads per CTA"):
        K.launch_plan(100, 2, 1, tile + 1, group)


def test_group_resolution():
    """``group=None`` takes the default where the tile allows it, else the
    largest group that fits; an explicit group is kept (and refused by the
    plan when it does not fit)."""
    resolve = lambda tile, group=None: K.resolve_group(group, tile, K.DEFAULT_GROUP, K.GROUPS,
                                                      K.MAX_THREADS)
    assert K.DEFAULT_GROUP in K.GROUPS
    assert K.DEFAULT_TILE * K.DEFAULT_GROUP <= K.MAX_THREADS[K.DEFAULT_GROUP]
    assert resolve(K.DEFAULT_TILE) == K.DEFAULT_GROUP
    for tile in (8, 16, 64, 128, 256):
        group = resolve(tile)
        fits = [g for g in K.GROUPS if tile * g <= K.MAX_THREADS[g]]
        assert group == (K.DEFAULT_GROUP if K.DEFAULT_GROUP in fits else max(fits))
        K.launch_plan(100, 2, 1, tile, group)
    assert resolve(32, 32) == 32
    with pytest.raises(ValueError, match="threads per CTA"):
        K.launch_plan(100, 2, 1, 32, resolve(32, 32))
    assert K.library_name(2, 1, 1) == "riccati_ip_kernel_nx2_nu1"
    assert K.library_name(3, 2, 8) == "riccati_ip_kernel_nx3_nu2_g8"


def test_launch_validates_before_it_builds(monkeypatch):
    """An unknown group or too many threads raise from ``_launch`` before any
    library is built, and count no launch."""
    monkeypatch.setattr(K, "_build_library", lambda *a, **k: pytest.fail("built a library"))
    args, kw = _case(SESSION2, 6, 3, False, tile=2)
    before = K.LAUNCHES
    with pytest.raises(ValueError, match="group must be one of"):
        K._launch(*args, group=3, **kw)
    with pytest.raises(ValueError, match="threads per CTA"):
        K._launch(*args, group=32, **{**kw, "tile": 32})
    assert K.LAUNCHES == before


def test_group_is_validated_and_ignored_on_the_twin():
    """On CPU tensors a valid group changes nothing (the twin has no
    threads); an unknown one raises all the same, from the wrapper, the twin
    wrapper and the policy."""
    data = dict(SESSION2, Pf=SESSION2["Q"])
    x0 = _states(SESSION2, seed=2)
    kw = dict(N=6, iters=8, tile=4)
    ref = K.stagewise_ip_solve_twin(*(data[k] for k in ORDER), x0, **kw)
    for got in (K.stagewise_ip_solve_cuda(*(data[k] for k in ORDER), x0, group=32, **kw),
                K.stagewise_ip_solve_twin(*(data[k] for k in ORDER), x0, group=1, **kw)):
        for name in ("us", "xs", "mu", "prim_res", "success", "iters_executed"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for solve in (K.stagewise_ip_solve_cuda, K.stagewise_ip_solve_twin):
        with pytest.raises(ValueError, match="group must be one of"):
            solve(*(data[k] for k in ORDER), x0, group=5, **kw)


def test_problem_is_prepared_once_per_policy(monkeypatch):
    """The long-horizon policy equilibrates its problem once, not once per
    step, and its steps solve what the wrapper solves from the raw data."""
    import model_predictive_control_tpu_torch as port

    calls = []
    prepare = K.prepare_problem
    monkeypatch.setattr(K, "prepare_problem", lambda *a, **k: calls.append(1) or prepare(*a, **k))
    problem = port.session2_problem()
    ctrl = port.make_stagewise_mpc(problem, N=6, iters=8, device="cpu")
    policy = ctrl.batched_policy(backend="cuda", tile=4, group=8)
    x0 = _states(SESSION2, seed=3)
    res = port.simulate_batch(x0, problem.system(device="cpu"), 3, policy,
                              ctrl.initial_batch_carry(B, device="cpu"), batched_dynamics=True)
    assert len(calls) == 1
    monkeypatch.setattr(K, "prepare_problem", prepare)
    names = ("A", "B", "Q", "R", "Pf", "x_lb", "x_ub", "u_lb", "u_ub")
    sol = K.stagewise_ip_solve_cuda(*(getattr(ctrl, k).numpy() for k in names), x0,
                                    ctrl.initial_batch_carry(B, device="cpu"), N=6, iters=8, tile=4)
    assert torch.equal(res.inputs[0], sol.us[:, 0])
    kp = prepare(*(getattr(ctrl, k).numpy() for k in names), device="cpu")
    assert K._const_arrays(kp.problem, 6, 0.995) is K._const_arrays(kp.problem, 6, 0.995)
