"""The hand-written CUDA kernels against their plain twins on the card, and
the sweeps that launch them.

These tests need a CUDA device and skip without one. They import neither JAX
nor the JAX package, so they also run where only torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib

import pytest
import torch

import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.ops.cuda import admm_kernel as K
from model_predictive_control_tpu_torch.parallel.batch import random_initial_states

pytestmark = pytest.mark.cuda

N, B, TILE = 8, 64, 8


@pytest.fixture
def ctrl():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    problem = port.session2_problem(N=N)
    return problem, port.make_linear_mpc(
        problem, iters=150, dtype=torch.float32, device="cuda"
    )


def _states(seed=0, batch=B):
    g = torch.Generator().manual_seed(seed)
    p = torch.empty(batch).uniform_(-140.0, -20.0, generator=g)
    v = torch.empty(batch).uniform_(-15.0, 24.0, generator=g)
    return torch.stack([p, v], dim=1).cuda()


@pytest.mark.parametrize("polish", [True, False])
@pytest.mark.parametrize("tile", [4, 8, 16, 32])
def test_kernel_matches_twin(ctrl, polish, tile):
    """Same inputs on the card: executed iterations agree on at least 90% of
    the scenarios, and x agrees within 2e-2 where they do (x in [-20, 10];
    FP32 sums in another order, amplified by the polish's CG). Tile 4 is
    half a warp, 8 one warp, 16 and 32 two and four warps with named
    barriers."""
    _, c = ctrl
    q, l, u = c.qp.qp_vectors(_states())
    kw = dict(iters=300, chunks=4, probe_iters=8, tile=tile, polish=polish,
              return_iters=True)
    before = K.LAUNCHES
    got, ni = K.admm_solve_cuda(c.op, q, l, u, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    ref, ni_ref = K.admm_solve_twin(c.op, q, l, u, **kw)
    same = ni == ni_ref
    assert same.float().mean() >= 0.9
    torch.testing.assert_close(got.x[same], ref.x[same], rtol=0, atol=2e-2)
    assert (got.converged == ref.converged).float().mean() >= 0.95


@pytest.mark.parametrize("tile", [4, 8, 16])
def test_kernel_with_rho_moves_matches_twin(ctrl, tile):
    """The presolve's configuration from a cold start (4 chunks, ρ moves,
    no probe, no polish) on a ragged batch: tiles leave the staged ρ level
    and read W from device memory. The bars of the test above."""
    _, c = ctrl
    q, l, u = c.qp.qp_vectors(_states(seed=4, batch=B - 3))
    kw = dict(iters=300, chunks=4, probe_iters=0, max_rho_moves=4, tile=tile, polish=False,
              return_iters=True)
    got, ni = K.admm_solve_cuda(c.op, q, l, u, **kw)
    ref, ni_ref = K.admm_solve_twin(c.op, q, l, u, **kw)
    assert got.x.shape == (B - 3, c.qp.n)
    same = ni == ni_ref
    assert same.float().mean() >= 0.9
    torch.testing.assert_close(got.x[same], ref.x[same], rtol=0, atol=2e-2)
    assert (got.converged == ref.converged).float().mean() >= 0.95


def test_tile_queue_covers_every_tile_once(ctrl):
    """Persistent CTAs pull tiles from the queue: every row of a batch far
    wider than the grid holds at once gets its executed iterations written,
    and a second launch on the same stream (the wrapper resets the queue)
    gives the same outputs bit for bit."""
    _, c = ctrl
    x0 = _states(seed=5, batch=20000)
    q, l, u = c.qp.qp_vectors(x0)
    args, kw = K.prepare_tiles(c.op, q, l, u, None, None, iters=80, chunks=2, probe_iters=8,
                               max_rho_moves=0, schedule="uniform", tile=8, cg_iters=40,
                               alpha=1.6, eps_abs=None, polish=False)
    first = K._launch(*args, **kw)
    second = K._launch(*args, **kw)
    torch.cuda.synchronize()
    assert bool((first[3] >= 8).all()), "a row's tile was never served"
    twin = K.admm_solve_tiles_reference(*args, **kw)
    assert (first[3] == twin[3]).float().mean() >= 0.9
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


def test_oversize_tile_raises(ctrl):
    _, c = ctrl
    q, l, u = c.qp.qp_vectors(_states(batch=4))
    with pytest.raises(ValueError, match="shared memory"):
        K.admm_solve_cuda(c.op, q, l, u, tile=4096)


def test_closed_loop_kernel_matches_twin(ctrl):
    problem, c = ctrl
    x0 = _states(seed=1)
    x0 = x0[torch.argsort(port.boundary_compaction_key(problem.p_max, x0), stable=True)]
    system = problem.system(torch.float32, "cuda")
    out = {}
    for backend in ("cuda", "twin"):
        carry = c.presolve_batch_carry(x0, iters_mult=3, backend=backend, tile=TILE)
        pol = c.batched_policy(backend=backend, tile=TILE, max_rho_moves=0,
                               polish=False, probe_iters=8)
        out[backend] = port.simulate_batch(x0, system, 12, pol, carry, batched_dynamics=True)
    torch.testing.assert_close(
        out["cuda"].states, out["twin"].states, rtol=0, atol=5e-2
    )


@pytest.fixture
def parking():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from model_predictive_control_tpu_torch.ops.cuda import ilqr_kernel as KI
    from model_predictive_control_tpu_torch.solvers.parking import Q_MAIN, QN_SCALE_MAIN, R_MAIN

    geom, limits = KI.parking_geometry(port.VehicleParameters(), (0.25, 0.0, 0.0, 0.0))
    kw = dict(N=8, ts=0.08, geom=geom, limits=limits, n_circles=3,
              weights=(tuple(Q_MAIN), tuple(R_MAIN), float(QN_SCALE_MAIN)))
    return KI, kw


@pytest.mark.parametrize("tile", [4, 32])
@pytest.mark.parametrize("group", [1, 8, 32])
def test_alilqr_kernel_matches_twin(parking, tile, group):
    """Same inputs on the card: the kernel does the twin's operations in the
    twin's order without FMA contraction, so the two agree bit for bit, with
    one thread per lane or a group of them (a group only deals the work).
    Tile 32 at group 32 is 1,024 threads, beyond the launch bounds: there the
    widest tile the group takes (16) stands in."""
    KI, kw = parking
    tile = min(tile, KI.MAX_THREADS[group] // group)
    g = torch.Generator().manual_seed(2)
    x0 = random_initial_states(
        g, 37, x_obs=(0.25, 0.0, 0.0, 0.0), device="cuda"
    )
    u = 0.1 * torch.randn(37, 8, 2, generator=g).cuda()
    acc, fric = torch.full((37,), 2.0).cuda(), torch.full((37,), 1.0).cuda()
    before = KI.LAUNCHES
    got = KI.al_ilqr_solve_cuda(x0, u, acc, fric, tile=tile, group=group, **kw)
    torch.cuda.synchronize()
    assert KI.LAUNCHES == before + 1
    ref = KI.al_ilqr_solve_twin(x0, u, acc, fric, tile=tile, **kw)
    for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


@pytest.mark.parametrize("mode", ["refs", "dist+urefs", "all"])
@pytest.mark.parametrize("group", [1, 8, 32])
def test_alilqr_modes_match_twin(parking, mode, group):
    """The tracking, offset and input-reference modes (``dist+urefs`` runs
    as all three, the reference zero) on the card: bit for bit with the
    twin, each launch counted."""
    KI, kw = parking
    g = torch.Generator().manual_seed(4)
    B, N = 37, kw["N"]
    x0 = random_initial_states(g, B, x_obs=(0.25, 0.0, 0.0, 0.0), device="cuda")
    extra = {}
    if mode != "dist+urefs":
        extra["refs"] = (x0[:, None] + 0.01 * torch.randn(B, N + 1, 4, generator=g).cuda())
    if mode != "refs":
        extra["dist"] = 4e-3 * torch.randn(B, 4, generator=g).cuda()
        extra["urefs"] = 0.1 * torch.randn(B, N, 2, generator=g).cuda()
    u, acc, fric = torch.zeros(B, N, 2).cuda(), torch.full((B,), 2.0).cuda(), torch.ones(B).cuda()
    before = KI.LAUNCHES
    got = KI.al_ilqr_solve_cuda(x0, u, acc, fric, **extra, tile=8, group=group, **kw)
    torch.cuda.synchronize()
    assert KI.LAUNCHES == before + 1
    ref = KI.al_ilqr_solve_twin(x0, u, acc, fric, **extra, tile=8, **kw)
    for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_offset_free_sweeps_launch_the_kernel(parking):
    """Each step of the crosswind and slope loops is one launch."""
    KI, _ = parking
    before = KI.LAUNCHES
    res, _ = port.wind_sweep(64, 3, device="cuda")
    assert KI.LAUNCHES == before + 3 and res.states.is_cuda
    res, _ = port.offset_free_sweep(64, 3, device="cuda")
    assert KI.LAUNCHES == before + 6 and bool(torch.isfinite(res.states).all())


def test_oversize_alilqr_tile_raises(parking):
    """More threads per CTA (tile × group) than the kernel's launch bounds
    allow: the wrapper raises before anything is built or launched."""
    KI, kw = parking
    x0 = random_initial_states(torch.Generator().manual_seed(3), 5, device="cuda")
    u, acc, fric = torch.zeros(5, 8, 2).cuda(), torch.full((5,), 2.0).cuda(), torch.ones(5).cuda()
    before = KI.LAUNCHES
    for tile, group in ((512, 1), (128, 8), (32, 32)):
        with pytest.raises(ValueError, match="threads per CTA"):
            KI.al_ilqr_solve_cuda(x0, u, acc, fric, tile=tile, group=group, **kw)
    with pytest.raises(ValueError, match="group must be one of"):
        KI.al_ilqr_solve_cuda(x0, u, acc, fric, group=16, **kw)
    assert KI.LAUNCHES == before


def test_parking_sweep_launches_the_kernel(parking):
    KI, _ = parking
    before = KI.LAUNCHES
    res, summary = port.parking_sweep(64, 3, N=8, device="cuda")
    assert KI.LAUNCHES == before + 3
    assert res.states.is_cuda and bool(torch.isfinite(res.states).all())
    assert 0.0 <= summary["success_rate"] <= 1.0
    # the group moves time, never numbers
    for group in (1, 32):
        other, other_summary = port.parking_sweep(64, 3, N=8, group=group, device="cuda")
        assert torch.equal(res.states, other.states)
        assert other_summary == summary
    assert KI.LAUNCHES == before + 9


@pytest.fixture
def tracker():
    """Both tracker instantiations at the racing shapes (N=15), small batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from model_predictive_control_tpu_torch.experiments import racing
    from model_predictive_control_tpu_torch.ops.cuda import ilqr_dyn_kernel as D
    from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as F
    from model_predictive_control_tpu_torch.ops.cuda.parking_factory import make_parking_ode_rows

    g = torch.Generator().manual_seed(4)
    b, n = 45, 15
    off = torch.randint(0, 40, (b,), generator=g).tolist()
    kin_ref = racing.ellipse_reference(60, speed=0.35, dynamic=False, device="cpu")
    dyn_ref = racing.ellipse_reference(60, speed=1.2, dynamic=True, device="cpu")
    kin = dict(
        args=(kin_ref[off, :] + 0.05 * torch.randn(b, 4, generator=g), torch.zeros(b, n, 2),
              torch.stack([kin_ref[o:o + n + 1] for o in off])),
        kw=dict(ode_rows=make_parking_ode_rows(0.05 / 0.097, 0.05), nx=4, nu=2, N=n, ts=0.05,
                substeps=1, integrator="euler", limits=((-1.0, -0.384), (1.0, 0.384)),
                state_limits=((-3.0, -2.0, -100.0, -0.5), (3.0, 2.0, 100.0, 0.5)),
                weights=(racing.Q_KINEMATIC, racing.R_KINEMATIC, racing.QN_SCALE),
                params=torch.stack([torch.full((b,), 2.0), torch.full((b,), 1.0)], -1).cuda(),
                n_params=2),
    )
    dyn = dict(
        args=(dyn_ref[off, :] + 0.03 * torch.randn(b, 6, generator=g), torch.zeros(b, n, 2),
              torch.stack([dyn_ref[o:o + n + 1] for o in off])),
        kw=dict(ode_rows=D.make_pacejka_ode_rows(D.model_tuple(port.VehicleParameters())), nx=6,
                nu=2, N=n, ts=0.05, substeps=4, limits=((-1.0, -0.384), (1.0, 0.384)),
                weights=(racing.Q_DYNAMIC, racing.R_DYNAMIC, racing.QN_SCALE), outer_iters=3,
                inner_iters=8),
    )
    for case in (kin, dyn):
        case["args"] = tuple(a.cuda() for a in case["args"])
    return F, {"kinematic": kin, "pacejka": dyn}


@pytest.mark.parametrize("model", ["kinematic", "pacejka"])
@pytest.mark.parametrize("tile", [8, 32])
@pytest.mark.parametrize("group", [1, 8, 32])
def test_tracker_kernel_matches_twin(tracker, model, tile, group):
    """Same inputs on the card: the kernel does the twin's operations in the
    twin's order without FMA contraction, so the two agree bit for bit, with
    one thread per lane or a group of them (a group only deals the work).
    Tile 32 at group 32 is 1,024 threads, beyond the launch bounds: there the
    widest tile the group takes (16) stands in."""
    F, cases = tracker
    case = cases[model]
    tile = min(tile, F.MAX_THREADS[group] // group)
    before = F.LAUNCHES
    got = F.fused_tracker_solve_cuda(*case["args"], tile=tile, group=group, **case["kw"])
    torch.cuda.synchronize()
    assert F.LAUNCHES == before + 1
    ref = F.fused_tracker_solve_twin(*case["args"], tile=tile, **case["kw"])
    for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_bare_row_function_raises_on_the_card(tracker):
    """A bare row function launches an instantiation generated from it
    (built at first use), bit for bit with the twin and with the hand
    ``kinematic`` instantiation on the same inputs: one float program."""
    F, cases = tracker
    case = cases["kinematic"]
    kw = {**case["kw"], "ode_rows": lambda xr, ur, pr: case["kw"]["ode_rows"].rows(xr, ur, pr)}
    before = F.LAUNCHES
    got = F.fused_tracker_solve_cuda(*case["args"], **kw)
    torch.cuda.synchronize()
    assert F.LAUNCHES == before + 1
    ref = F.fused_tracker_solve_twin(*case["args"], **kw)
    hand = F.fused_tracker_solve_cuda(*case["args"], **case["kw"])
    for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
        assert torch.equal(getattr(got, name), getattr(hand, name)), name


@pytest.mark.parametrize("sweep", ["racing_sweep", "racing_sweep_dynamic"])
def test_racing_sweeps_launch_the_kernel(tracker, sweep):
    F, _ = tracker
    before = F.LAUNCHES
    res, summary = getattr(port, sweep)(64, 3, N=8, device="cuda")
    assert F.LAUNCHES == before + 3
    assert res.states.is_cuda and bool(torch.isfinite(res.states).all())
    assert 0.0 <= summary["success_rate"] <= 1.0
    # the group moves time, never numbers
    other, _ = getattr(port, sweep)(64, 3, N=8, group=1, device="cuda")
    assert F.LAUNCHES == before + 6
    assert torch.equal(res.states, other.states)


@pytest.mark.parametrize("tile", [32, 64])
def test_racing_sweep_dynamic_takes_a_wide_tile(tracker, tile):
    """With only ``tile`` given, the group resolves to the largest one that
    fits the launch bounds (the Pacejka default, 32, does not), and the
    sweep runs with the numbers of any other group at that tile."""
    F, _ = tracker
    before = F.LAUNCHES
    res, summary = port.racing_sweep_dynamic(64, 2, N=8, tile=tile, device="cuda")
    one, _ = port.racing_sweep_dynamic(64, 2, N=8, tile=tile, group=1, device="cuda")
    assert F.LAUNCHES == before + 4
    assert bool(torch.isfinite(res.states).all()) and torch.equal(res.states, one.states)


def test_oversize_tracker_tile_raises(tracker):
    """More threads per CTA (tile × group) than the kernel's launch bounds
    allow: the wrapper raises before anything is built or launched."""
    F, cases = tracker
    case = cases["pacejka"]
    before = F.LAUNCHES
    for tile, group in ((512, 1), (128, 8), (32, 32)):
        with pytest.raises(ValueError, match="threads per CTA"):
            F.fused_tracker_solve_cuda(*case["args"], tile=tile, group=group, **case["kw"])
    with pytest.raises(ValueError, match="group must be one of"):
        F.fused_tracker_solve_cuda(*case["args"], group=4, **case["kw"])
    assert F.LAUNCHES == before


@pytest.mark.parametrize("model", ["kinematic", "pacejka"])
def test_tracker_widest_ctas_launch(tracker, model):
    """The widest CTA each group's launch bounds allow is really launched
    (registers × threads fit the register file) and gives the group-1
    kernel's bits at the same tile."""
    F, cases = tracker
    case = cases[model]
    for group in (8, 16, 32):
        tile = F.MAX_THREADS[group] // group
        got = F.fused_tracker_solve_cuda(*case["args"], tile=tile, group=group, **case["kw"])
        one = F.fused_tracker_solve_cuda(*case["args"], tile=tile, group=1, **case["kw"])
        torch.cuda.synchronize()
        for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
            assert torch.equal(getattr(got, name), getattr(one, name)), (group, name)


@pytest.fixture
def benchmark_models():
    """The tracker kernel's benchmark instantiations at small batch, N=6,
    RK4x2: cart-pole in regulation with a binding force box (nu 1), the
    quadrotor tracking with its tilt box and the same without its input box
    (nu 2), the omnibase in regulation and with a per-lane mass (nu 3), the
    thrust cluster in regulation (nu 4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as F
    from model_predictive_control_tpu_torch.parallel.batch import loiter_reference

    g = torch.Generator().manual_seed(5)
    b, n = 45, 6
    start = lambda *spread: ((2.0 * torch.rand(b, len(spread), generator=g) - 1.0)
                             * torch.tensor(spread))
    big, omni_box = 50.0, ((-12.0, -12.0, -3.0), (12.0, 12.0, 3.0))
    omni_w = ((5.0, 5.0, 1.0, 0.5, 0.5, 0.1), (0.01, 0.01, 0.005), 10.0)
    ref = loiter_reference(60, device="cpu")
    off = torch.randint(0, 40, (b,), generator=g).tolist()
    quad = dict(
        args=(ref[off] + start(0.15, 0.15, 0.1, 0.1, 0.1, 0.1), torch.full((b, n, 2), 2.45),
              torch.stack([ref[o:o + n + 1] for o in off])),
        kw=dict(ode_rows=port.make_planar_quadrotor_ode_rows(),
                limits=((0.0, 0.0), (7.3575, 7.3575)),
                state_limits=((-big, -big, -0.5, -big, -big, -big), (big, big, 0.5, big, big, big)),
                weights=((5.0, 5.0, 1.0, 0.5, 0.5, 0.1), (0.02, 0.02), 10.0), outer_iters=4,
                inner_iters=10))
    cases = {
        "cartpole": dict(
            args=(start(2.0, 0.5, 0.2, 0.2), torch.zeros(b, n, 1), None),
            kw=dict(ode_rows=port.make_cartpole_ode_rows(), limits=((-3.0,), (3.0,)),
                    weights=((1.0, 2.0, 0.1, 0.1), (0.01,), 10.0))),
        "quadrotor": quad,
        "quadrotor_no_input_box": dict(args=quad["args"], kw={**quad["kw"], "limits": None}),
        "omnibase": dict(
            args=(start(2.5, 0.5, 1.0, 0.2, 0.1, 0.3), torch.zeros(b, n, 3), None),
            kw=dict(ode_rows=port.make_omnibase_ode_rows(), limits=omni_box, weights=omni_w)),
        "omnibase_param": dict(
            args=(start(2.5, 0.5, 1.0, 0.2, 0.1, 0.3), torch.zeros(b, n, 3), None),
            kw=dict(ode_rows=port.make_omnibase_param_ode_rows(), limits=omni_box, weights=omni_w,
                    params=(4.0 + 6.0 * torch.rand(b, 1, generator=g)).cuda(), n_params=1)),
        "thruster": dict(
            args=(start(1.5, 1.5, 0.5, 0.5, 0.5, 0.2), torch.zeros(b, n, 4), None),
            kw=dict(ode_rows=port.make_thruster_ode_rows(), limits=((0.0,) * 4, (6.0,) * 4),
                    weights=((5.0, 5.0, 5.0, 0.5, 0.5, 0.5), (0.02,) * 4, 10.0))),
    }
    for case in cases.values():
        model = case["kw"]["ode_rows"]
        case["args"] = tuple(None if a is None else a.cuda() for a in case["args"])
        case["kw"].update(nx=model.nx, nu=model.nu, N=n, ts=0.1, substeps=2)
    return F, cases


BENCHMARK_CASES = ["cartpole", "quadrotor", "quadrotor_no_input_box", "omnibase",
                   "omnibase_param", "thruster"]


@pytest.mark.parametrize("case", BENCHMARK_CASES)
@pytest.mark.parametrize("tile", [8, 32])
@pytest.mark.parametrize("group", [1, 8, 32])
def test_benchmark_models_match_twin(benchmark_models, case, tile, group):
    """Each benchmark instantiation (nu from 1 to 4, regulation and tracking,
    with and without the input box) equals its twin bit for bit at every
    group; tile 32 at group 32 is beyond the launch bounds, tile 16 stands in."""
    F, cases = benchmark_models
    c = cases[case]
    tile = min(tile, F.MAX_THREADS[group] // group)
    kernel = c["kw"]["ode_rows"].kernel
    before = F.LAUNCHES_BY_KERNEL[kernel]
    got = F.fused_tracker_solve_cuda(*c["args"], tile=tile, group=group, **c["kw"])
    torch.cuda.synchronize()
    assert F.LAUNCHES_BY_KERNEL[kernel] == before + 1
    ref = F.fused_tracker_solve_twin(*c["args"], tile=tile, **c["kw"])
    for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


@pytest.mark.parametrize("case", ["cartpole", "thruster"])
def test_benchmark_widest_ctas_launch(benchmark_models, case):
    """The widest CTA of each group launches the narrowest and the widest
    input models and gives the group-1 kernel's bits at the same tile."""
    F, cases = benchmark_models
    c = cases[case]
    for group in (8, 16, 32):
        tile = F.MAX_THREADS[group] // group
        got = F.fused_tracker_solve_cuda(*c["args"], tile=tile, group=group, **c["kw"])
        one = F.fused_tracker_solve_cuda(*c["args"], tile=tile, group=1, **c["kw"])
        torch.cuda.synchronize()
        for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
            assert torch.equal(getattr(got, name), getattr(one, name)), (group, name)


def _generated_matches_twin(F, args, kw):
    """One solve no hand library holds: one launch of an instantiation
    generated from its rows, bit for bit with the twin."""
    generated = lambda: sum(v for k, v in F.LAUNCHES_BY_KERNEL.items() if k.startswith("gen_"))
    before, before_gen = F.LAUNCHES, generated()
    got = F.fused_tracker_solve_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert F.LAUNCHES == before + 1 and generated() == before_gen + 1
    ref = F.fused_tracker_solve_twin(*args, **kw)
    for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_euler_on_an_rk4_only_model_raises(benchmark_models):
    """The benchmark models' libraries hold RK4 only: Euler runs on an
    instantiation generated at first use, bit for bit with the twin."""
    F, cases = benchmark_models
    c = cases["cartpole"]
    _generated_matches_twin(F, c["args"], {**c["kw"], "integrator": "euler"})


def test_no_input_box_on_a_racing_model_raises(tracker):
    """The racing pair's libraries hold the solve with an input box only:
    ``limits=None`` runs on a generated instantiation, bit for bit with the
    twin."""
    F, cases = tracker
    case = cases["kinematic"]
    _generated_matches_twin(F, case["args"], {**case["kw"], "limits": None, "outer_iters": 2,
                                              "inner_iters": 4})


@pytest.mark.parametrize("sweep, kernel", [("quadrotor_sweep", "quadrotor"),
                                           ("thruster_sweep", "thruster")])
def test_loiter_sweeps_launch_the_kernel(benchmark_models, sweep, kernel):
    """One launch a step, through the model's own instantiation; the group
    moves time, never numbers; the kernel loop equals the twin loop."""
    F, _ = benchmark_models
    before = F.LAUNCHES_BY_KERNEL[kernel]
    res, summary = getattr(port, sweep)(64, 3, device="cuda")
    assert F.LAUNCHES_BY_KERNEL[kernel] == before + 3
    assert res.states.is_cuda and bool(torch.isfinite(res.states).all())
    assert summary["success_rate"] == 1.0
    other, _ = getattr(port, sweep)(64, 3, group=1, device="cuda")
    twin, _ = getattr(port, sweep)(64, 3, backend="twin", device="cuda")
    assert torch.equal(res.states, other.states) and torch.equal(res.states, twin.states)


@pytest.fixture
def stagewise():
    """The session-2 family (the long-horizon path's size, nx=2, nu=1) and
    the synthetic nx=3 / nu=2 system with a dense R and infinite bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import numpy as np

    from model_predictive_control_tpu_torch.ops.cuda import riccati_ip_kernel as KR

    session2 = (
        [[1.0, 0.3], [0.0, 1.0]], [[0.0], [0.3]], np.diag([10.0, 1.0]), [[0.01]],
        np.diag([10.0, 1.0]), [-150.0, -20.0], [1.0, 25.0], [-20.0], [10.0],
    )
    synthetic = (
        [[1.0, 0.1, 0.0], [0.0, 1.0, 0.1], [0.0, 0.0, 0.95]],
        [[0.0, 0.005], [0.1, 0.0], [0.0, 0.1]], np.diag([5.0, 1.0, 0.5]),
        [[0.1, 0.01], [0.01, 0.2]], 2.0 * np.diag([5.0, 1.0, 0.5]),
        [-4.0, -2.0, -np.inf], [4.0, 2.0, 1.5], [-1.0, -0.8], [1.0, 0.8],
    )
    g = torch.Generator().manual_seed(5)
    x2 = _states(seed=3, batch=77)
    x2[-1] = torch.tensor([50.0, 30.0])  # infeasible: the lane dies and reports failure
    x3 = ((2.0 * torch.rand(77, 3, generator=g) - 1.0) * torch.tensor([3.5, 1.9, 1.4])).cuda()
    return KR, {"session2": (session2, x2, 40), "synthetic": (synthetic, x3, 12)}


@pytest.mark.parametrize("system", ["session2", "synthetic"])
@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("group", [1, 8, 32])
def test_stagewise_ip_kernel_matches_twin(stagewise, system, tile, group):
    """Same inputs on the card, cold then warm: the kernel does the twin's
    operations in the twin's order without FMA contraction, so the two agree
    bit for bit, executed iterations included, with one thread per lane or a
    group of them (a group only deals the work). Where tile × group exceeds
    the launch bounds, the widest tile the group takes stands in (16 at
    group 32)."""
    KR, cases = stagewise
    tile = min(tile, KR.MAX_THREADS[group] // group)
    data, x0, N = cases[system]
    u_init = None
    for _ in range(2):
        before = KR.LAUNCHES
        got = KR.stagewise_ip_solve_cuda(*data, x0, u_init, N=N, iters=20, tile=tile, group=group)
        torch.cuda.synchronize()
        assert KR.LAUNCHES == before + 1
        ref = KR.stagewise_ip_solve_twin(*data, x0, u_init, N=N, iters=20, tile=tile)
        for name in ("us", "xs", "mu", "prim_res", "success", "iters_executed"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
        assert got.success.float().mean() > 0.9
        u_init = 0.9 * got.us + 0.01
    if system == "session2":
        assert not bool(got.success[-1])


def test_long_horizon_loop_launches_the_kernel(stagewise):
    KR, _ = stagewise
    problem = port.session2_problem()
    ctrl = port.make_stagewise_mpc(problem, N=30, iters=15)  # the card by default
    assert ctrl.A.is_cuda
    x0 = _states(seed=4)
    before = KR.LAUNCHES
    res = port.simulate_batch(
        x0, problem.system(), 4, ctrl.batched_policy(backend="cuda"), ctrl.initial_batch_carry(B),
        batched_dynamics=True
    )
    assert KR.LAUNCHES == before + 4
    assert res.states.is_cuda and bool(torch.isfinite(res.states).all())
    assert res.logs["solver_success"].float().mean() >= 0.99
    ref = port.simulate_batch(
        x0, problem.system(), 4, ctrl.batched_policy(backend="torch"), ctrl.initial_batch_carry(B),
        batched_dynamics=True
    )
    torch.testing.assert_close(res.states, ref.states, rtol=0, atol=2e-3)


def test_long_horizon_loop_at_the_defaults(stagewise):
    """The long-horizon path's own solver (N = 100, 20 iterations) at the
    kernel's default tile and group: one launch per step, states within
    2e-3 of the batched torch solver's (tests/test_pallas_riccati_ip.py:193's
    bar between two float32 implementations)."""
    KR, _ = stagewise
    problem = port.session2_problem()
    ctrl = port.make_stagewise_mpc(problem, N=100, iters=20)
    x0 = _states(seed=6, batch=2 * KR.DEFAULT_TILE + 3)
    carry = ctrl.initial_batch_carry(x0.shape[0])
    before = KR.LAUNCHES
    res = port.simulate_batch(x0, problem.system(), 3, ctrl.batched_policy(backend="cuda"), carry,
                              batched_dynamics=True)
    assert KR.LAUNCHES == before + 3
    assert res.logs["solver_success"].float().mean() >= 0.99
    ref = port.simulate_batch(x0, problem.system(), 3, ctrl.batched_policy(backend="torch"), carry,
                              batched_dynamics=True)
    torch.testing.assert_close(res.states, ref.states, rtol=0, atol=2e-3)


def test_oversize_stagewise_tile_raises(stagewise):
    """More threads per CTA (tile × group) than the kernel's launch bounds
    allow: the wrapper's launch plan raises before anything is built or
    launched."""
    KR, cases = stagewise
    data, x0, N = cases["session2"]
    before = KR.LAUNCHES
    for tile, group in ((1024, None), (512, 1), (128, 8), (32, 32)):
        with pytest.raises(ValueError, match="threads per CTA"):
            KR.stagewise_ip_solve_cuda(*data, x0, N=N, tile=tile, group=group)
    with pytest.raises(ValueError, match="group must be one of"):
        KR.stagewise_ip_solve_cuda(*data, x0, N=N, group=16)
    assert KR.LAUNCHES == before


@pytest.fixture
def soft():
    """The MHE loop's slack-softened controller at N = 20: n = 60, m = 140,
    the ADMM kernel's panel mode (one warp a quad of rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    problem = port.session2_problem(N=20)
    return problem, port.make_linear_mpc(problem, iters=200, rho=0.02, soft_state=True,
                                         slack_weight=1e4)


@pytest.mark.parametrize("polish", [False, True])
@pytest.mark.parametrize("tile", [4, 8, 16])
def test_wide_mode_matches_twin(soft, polish, tile):
    """The mode that serves n + m = 200, the panel mode (a warp a quad of
    rows, W and Wq streamed through shared memory in panels, one tile a
    CTA), on the presolve's configuration (4× budget in 8 chunks, ρ moves)
    on a ragged batch, and the warm step after it: the bars of
    test_kernel_matches_twin (iterations agree on 90% of the scenarios, x
    within 2e-2 where they do; the polished solve on iterations and its
    success only, its FP32 CG being chaotic at N = 20)."""
    problem, c = soft
    assert K.launch_plan(c.qp.n, c.qp.m, tile, polish).panel
    x0 = _states(seed=7, batch=B - 5)
    q, l, u = c.qp.qp_vectors(x0)
    kw = dict(iters=800, chunks=8, probe_iters=0, tile=tile, polish=polish, return_iters=True)
    before = K.LAUNCHES
    got, ni = K.admm_solve_cuda(c.op, q, l, u, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    ref, ni_ref = K.admm_solve_twin(c.op, q, l, u, **kw)
    same = ni == ni_ref
    assert same.float().mean() >= 0.9
    if polish:
        assert abs(got.converged.float().mean() - ref.converged.float().mean()) <= 0.05
    else:
        torch.testing.assert_close(got.x[same], ref.x[same], rtol=0, atol=2e-2)
    x1 = problem.system()(x0, ref.x[:, :1])
    wx, wy = c._shift_warm(ref.x, ref.y, axis=1)
    q1, l1, u1 = c.qp.qp_vectors(x1)
    kw = dict(iters=200, tile=tile, polish=polish, return_iters=True)
    got, ni = K.admm_solve_cuda(c.op, q1, l1, u1, wx, wy, **kw)
    ref, ni_ref = K.admm_solve_twin(c.op, q1, l1, u1, wx, wy, **kw)
    same = ni == ni_ref
    assert same.float().mean() >= 0.9
    if not polish:
        torch.testing.assert_close(got.x[same], ref.x[same], rtol=0, atol=2e-2)


def _panel_ctrl(N, soft_state):
    """The soft MPC at the MHE loop's settings, or the hard box at the
    defaults, at horizon N on the card."""
    problem = port.session2_problem(N=N)
    if soft_state:
        return problem, port.make_linear_mpc(problem, iters=200, rho=0.02, soft_state=True,
                                             slack_weight=1e4)
    return problem, port.make_linear_mpc(problem, solver="admm")


@pytest.mark.parametrize("N, soft_state, tile", [(30, True, 8), (100, False, 8), (100, False, 4)])
def test_panel_one_iteration_matches_twin(soft, N, soft_state, tile):
    """The panel mode past 256 columns (two warps a quad): the soft MPC at
    N = 30 (n + m = 300) and the hard box at N = 100 (400), one iteration
    from a cold start on a ragged batch: x, z and y within 1e-5 of each
    output's ∞-norm (tests/test_torch_admm_kernel_host.py's bar)."""
    _, c = _panel_ctrl(N, soft_state)
    assert K.launch_plan(c.qp.n, c.qp.m, tile, False).warps_per_quad == 2
    q, l, u = c.qp.qp_vectors(_states(seed=N + tile, batch=2 * tile + 1))
    args, kw = K.prepare_tiles(c.op, q, l, u, None, None, iters=1, chunks=1, probe_iters=0,
                               max_rho_moves=0, schedule="uniform", tile=tile, cg_iters=40,
                               alpha=1.6, eps_abs=None, polish=False)
    got = K._launch(*args, **kw)
    want = K.admm_solve_tiles_reference(*args, **kw)
    for a, b, name in zip(got, want, ("x", "z", "y", "iterations")):
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale, msg=name)


def test_panel_cold_with_rho_moves_matches_twin(soft):
    """The soft MPC at N = 30 (n + m = 300) on the MHE loop's presolve
    settings without the polish (4× budget in 8 chunks, ρ moves, no probe),
    tile 8, a ragged batch of 32 tiles: executed iterations agree on 90% of
    the scenarios, converged masks on 95% (test_kernel_matches_twin's bars),
    and x within 2e-2 where the iterations agree on a tile that exited
    before its budget. A tile that runs the whole budget has not converged,
    and its ρ moves decide on residuals near float32's noise floor: on the
    card one tile of this batch takes a move the twin does not and ends 1.6
    away in x, while its twin and the twin's float64 run agree."""
    _, c = _panel_ctrl(30, True)
    q, l, u = c.qp.qp_vectors(_states(seed=9, batch=253))
    kw = dict(iters=800, chunks=8, probe_iters=0, max_rho_moves=8, tile=8, polish=False,
              return_iters=True)
    got, ni = K.admm_solve_cuda(c.op, q, l, u, **kw)
    ref, ni_ref = K.admm_solve_twin(c.op, q, l, u, **kw)
    same = ni == ni_ref
    assert same.float().mean() >= 0.9
    exited = same & (ni < kw["iters"])
    assert exited.float().mean() >= 0.5
    torch.testing.assert_close(got.x[exited], ref.x[exited], rtol=0, atol=2e-2)
    assert (got.converged == ref.converged).float().mean() >= 0.95


def test_panel_depth_leaves_results_unchanged(soft, monkeypatch):
    """The panel ring's depth changes where the CTA waits, not what it
    computes: the soft MPC at N = 30 (n + m = 300) on its presolve settings
    gives the same outputs bit for bit with panels of 16, 4 and 1 rows (a
    stage overwritten while a warp still reads it would show here)."""
    _, c = _panel_ctrl(30, True)
    q, l, u = c.qp.qp_vectors(_states(seed=9, batch=253))
    args, kw = K.prepare_tiles(c.op, q, l, u, None, None, iters=800, chunks=8, probe_iters=0,
                               max_rho_moves=8, schedule="uniform", tile=8, cg_iters=40,
                               alpha=1.6, eps_abs=None, polish=True)
    outs = {}
    for rows in (16, 4, 1):
        monkeypatch.setattr(K, "PANEL_ROWS", rows)
        assert K.launch_plan(c.qp.n, c.qp.m, 8, True).panel_rows == rows
        outs[rows] = K._launch(*args, **kw)
    for rows in (4, 1):
        assert all(torch.equal(a, b) for a, b in zip(outs[rows], outs[16]))


@pytest.mark.parametrize("n, m", [(21, 130), (10, 1100)])
def test_panel_odd_sizes_match_twin(soft, n, m):
    """Random operators whose rows are not a multiple of 16 bytes (n + m =
    151, the ring's 4-byte copies) and whose tile needs more than 256
    threads (1,110 at tile 8: five warps a quad, the build with 1,024-thread
    launch bounds), two iterations and the polish: x, z and y within 1e-5 of
    each output's ∞-norm."""
    from model_predictive_control_tpu_torch.solvers.qp import qp_setup

    g = torch.Generator().manual_seed(n + m)
    F = torch.randn(n, n, generator=g, dtype=torch.float64)
    P = (F @ F.T / n + torch.eye(n, dtype=torch.float64)).cuda()
    A = (torch.randn(m, n, generator=g, dtype=torch.float64) / n**0.5).cuda()
    op = qp_setup(P, A, rho=0.1)
    q = torch.randn(19, n, generator=g).cuda()
    l, u = torch.full((19, m), -0.5, device="cuda"), torch.full((19, m), 0.5, device="cuda")
    args, kw = K.prepare_tiles(op, q, l, u, None, None, iters=2, chunks=1, probe_iters=0,
                               max_rho_moves=0, schedule="uniform", tile=8, cg_iters=5,
                               alpha=1.6, eps_abs=None, polish=True)
    got = K._launch(*args, **kw)
    want = K.admm_solve_tiles_reference(*args, **kw)
    for a, b, name in zip(got, want, ("x", "z", "y", "iterations")):
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale, msg=name)


def test_mhe_windows_kernel_matches_twin(soft, monkeypatch):
    """The MHE loop's own windows (n + m = 44, a staged build): its first
    two batches at 256 scenarios, cold and warm from the first's solution,
    through the kernel and the twin, with the loop's polish and without:
    the bars of test_kernel_matches_twin (iterations agree on 90% of the
    scenarios, x within 2e-2 where they do; the polished solve on
    iterations and success only)."""
    from model_predictive_control_tpu_torch import estimation
    from model_predictive_control_tpu_torch.parallel import batch as PB

    seen = []
    solve = estimation.MHE.solve_batch

    def spy(self, xbars, us, ys, *args, warm=None, **kw):
        l, u, _ = self._bounds(us)
        seen.append((self, self._linear_term(xbars, us, ys), l, u, warm))
        return solve(self, xbars, us, ys, *args, warm=warm, **kw)

    monkeypatch.setattr(estimation.MHE, "solve_batch", spy)
    PB.mhe_loop_sweep(256, 2)
    assert len(seen) == 2
    for mhe, q, l, u, (wx, wy) in seen:
        assert not K.launch_plan(q.shape[1], l.shape[1], K.DEFAULT_TILE, True).panel
        for polish in (True, False):
            kw = dict(iters=mhe.iters, polish=polish, return_iters=True)
            got, ni = K.admm_solve_cuda(mhe.op, q, l, u, wx, wy, **kw)
            ref, ni_ref = K.admm_solve_twin(mhe.op, q, l, u, wx, wy, **kw)
            same = ni == ni_ref
            assert same.float().mean() >= 0.9
            if polish:
                assert abs(got.converged.float().mean() - ref.converged.float().mean()) <= 0.05
            else:
                torch.testing.assert_close(got.x[same], ref.x[same], rtol=0, atol=2e-2)


@pytest.mark.parametrize("path", ["tube", "stochastic", "mhe_loop"])
def test_new_sweeps_kernel_matches_twin(soft, path, monkeypatch):
    """Each sweep of the robust, stochastic and output-feedback tiers, 64
    scenarios × 3 steps on the same scenarios through the kernel, the twin
    and the twin's algorithm in float64 (the witness): one launch per solve
    (the MHE loop: two a step, the MHE windows and the soft MPC in the panel
    mode). Held as chip_smoke.py holds them: every final state within 5e-2
    of the twin's or of the witness's (two float32 programs stop at
    different points of a loose solve's band; the witness tells which one
    rounding moved), success masks equal on 95% of the entries."""
    from model_predictive_control_tpu_torch.parallel import batch as PB

    sweep = getattr(PB, f"{path}_sweep")
    kw = dict(batch=64, steps=3)
    before = K.LAUNCHES
    res_k, _ = sweep(**kw, backend="cuda")
    torch.cuda.synchronize()
    assert K.LAUNCHES - before == (2 * 3 + 1 if path == "mhe_loop" else 3 + 1)
    res_t, _ = sweep(**kw, backend="twin")
    plain = K.admm_solve_tiles_reference
    monkeypatch.setattr(K, "admm_solve_tiles_reference", lambda *a, **k: tuple(
        o.float() for o in plain(*(t.double() for t in a), **k)))
    res_w, _ = sweep(**kw, backend="twin")
    assert K.LAUNCHES - before == (2 * 3 + 1 if path == "mhe_loop" else 3 + 1)
    assert res_k.states.is_cuda and bool(torch.isfinite(res_k.states).all())
    d_final = lambda r: (res_k.states[-1] - r.states[-1]).abs().amax(dim=1)
    assert torch.minimum(d_final(res_t), d_final(res_w)).max() <= 5e-2
    success = res_k.logs["solver_success"] == res_t.logs["solver_success"]
    assert success.float().mean() >= 0.95


def test_offset_free_and_rate_policies_kernel_match_twin(soft):
    """One step of the offset-free and the rate-limited batched policies
    (n + m = 80 and 100, staged) through the kernel and the twin: inputs
    within 5e-2, one launch each."""
    from model_predictive_control_tpu_torch.solvers.offset_free import make_offset_free_mpc
    from model_predictive_control_tpu_torch.solvers.rate_mpc import make_rate_limited_mpc

    x0 = _states(seed=9)
    of = make_offset_free_mpc(port.session2_problem(N=20), r=-5.0, iters=300)
    rate = make_rate_limited_mpc(port.session2_problem(N=20), du_max=3.0, iters=400)
    for ctrl, carry in ((of, of.initial_batch_carry(x0)), (rate, rate.initial_batch_carry(B))):
        before = K.LAUNCHES
        u_k, _, aux_k = ctrl.batched_policy(backend="cuda")(x0, 0, carry)
        torch.cuda.synchronize()
        assert K.LAUNCHES == before + 1
        u_t, _, aux_t = ctrl.batched_policy(backend="twin")(x0, 0, carry)
        torch.testing.assert_close(u_k, u_t, rtol=0, atol=5e-2)


@pytest.fixture
def factory_cases():
    """The second library's instantiations at small batch: the factory
    parking OCP (N=12; order 2 with warm multipliers, order 1 with per-lane
    weights, order 2 with per-lane weights equal to the constants, order 1)
    and the MHE windows (M=10, additive, terminal rows). Each case is a
    function of the group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from model_predictive_control_tpu_torch.estimation_nl import NonlinearMHE
    from model_predictive_control_tpu_torch.models.bicycle import (
        kinematic_bicycle_ode,
        make_kinematic_ode_rows,
    )
    from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as F
    from model_predictive_control_tpu_torch.ops.cuda.ilqr_kernel import parking_geometry
    from model_predictive_control_tpu_torch.ops.cuda.parking_factory import (
        al_ilqr_parking_solve_factory,
    )
    from model_predictive_control_tpu_torch.ops.integrators import rk4

    g = torch.Generator().manual_seed(7)
    b, n = 48, 12
    x0 = random_initial_states(g, b, x_obs=(0.25, 0.0, 0.0, 0.0), device="cuda")
    geom, limits = parking_geometry(port.VehicleParameters(), (0.25, 0.0, 0.0, 0.0))
    w = ((1.0, 6.0, 0.2, 0.05), (1.0, 0.01), 100.0)
    wrow = torch.tensor([*w[0], *w[1], w[2]]).expand(b, 7)
    lam = (torch.rand(b, n, 21, generator=g) * (torch.rand(b, n, 21, generator=g) < 0.3)).cuda()

    def park(**kw):
        return lambda group: al_ilqr_parking_solve_factory(
            x0, torch.zeros(b, n, 2, device="cuda"), torch.full((b,), 2.0, device="cuda"),
            torch.full((b,), 1.0, device="cuda"), N=n, ts=0.08, geom=geom, limits=limits,
            outer_iters=3, inner_iters=6, group=group, **kw)

    cases = {
        "kinematic_clearance_o2": park(weights=w, lam_init=lam),
        "kinematic_clearance_o1_wrt": park(
            weights_rt=(wrow * (1 + 0.2 * (torch.rand(b, 7, generator=g) - 0.5))).cuda(),
            extra_order=1),
        "kinematic_clearance_o2_wrt": park(weights_rt=wrow.contiguous().cuda()),
        "kinematic_clearance_o1": park(weights=w, extra_order=1),
    }
    p = port.VehicleParameters()
    M = 10
    mhe = NonlinearMHE(rk4(lambda x, u: kinematic_bicycle_ode(p, x, u), 0.05), lambda x: x[:2],
                       torch.diag(torch.tensor([1e-6, 1e-6, 1e-5, 1e-3])).cuda(),
                       0.01 * torch.eye(2).cuda(),
                       torch.diag(torch.tensor([1e-4, 1e-4, 1e-3, 1e-2])).cuda(), M, nx=4,
                       x_min=[-3.0, -2.0, -7.0, 0.0], x_max=[3.0, 2.0, 7.0, 1.0])
    rows = make_kinematic_ode_rows(p.axis_rear / (p.axis_front + p.axis_rear), p.axis_rear,
                                   p.acceleration, p.friction)
    xw = torch.rand(b, 4, generator=g) - 0.5
    xw[:, 3] = 0.3
    us = torch.tensor([[0.2, 0.05]]).repeat(b, M, 1)
    ys = xw[:, None, :2] + 0.1 * torch.randn(b, M + 1, 2, generator=g)
    cases["gated_kinematic"] = lambda group: mhe.solve_batch_fused(
        xw.cuda(), us.cuda(), ys.cuda(), ode_rows=rows, ts=0.05, obs_indices=(0, 1),
        group=group)
    return F, cases


@contextlib.contextmanager
def _on_the_twin(F):
    """Within the block the factory parking solve and the MHE windows run
    the kernel's twin on the card's tensors."""
    from model_predictive_control_tpu_torch import estimation_nl
    from model_predictive_control_tpu_torch.ops.cuda import parking_factory

    twin = lambda *a, group=None, **k: F.fused_tracker_solve_twin(*a, **k)
    parking_factory.fused_tracker_solve_cuda = estimation_nl.fused_tracker_solve_cuda = twin
    try:
        yield
    finally:
        parking_factory.fused_tracker_solve_cuda = F.fused_tracker_solve_cuda
        estimation_nl.fused_tracker_solve_cuda = F.fused_tracker_solve_cuda


def _outputs(sol):
    if isinstance(sol, tuple):
        return sol
    return tuple(getattr(sol, f) for f in ("us", "xs", "viol", "converged", "lam",
                                           "inner_iters_executed"))


@pytest.mark.parametrize("case", ["kinematic_clearance_o2", "kinematic_clearance_o1_wrt",
                                  "kinematic_clearance_o2_wrt", "kinematic_clearance_o1",
                                  "gated_kinematic"])
@pytest.mark.parametrize("group", [1, 8, 32])
def test_factory_instantiations_match_twin(factory_cases, case, group):
    """Each instantiation of the second library (factory parking at both
    derivative orders, with constant and per-lane weights and warm
    multipliers; the MHE windows) against the twin on the same inputs: every
    output bit for bit, whatever the group; one launch, through its own
    instantiation."""
    F, cases = factory_cases
    before = F.LAUNCHES_BY_KERNEL[case]
    got = _outputs(cases[case](group))
    torch.cuda.synchronize()
    assert F.LAUNCHES_BY_KERNEL[case] == before + 1
    with _on_the_twin(F):
        ref = _outputs(cases[case](group))
    for k, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a, b), k


def test_factory_parking_sweep_launches_the_kernel(factory_cases):
    """``parking_sweep(backend="factory")``: one launch a step of the order-2
    clearance instantiation; the kernel loop equals the twin loop."""
    F, _ = factory_cases
    before = F.LAUNCHES_BY_KERNEL["kinematic_clearance_o2"]
    res, _ = port.parking_sweep(64, 3, N=12, backend="factory", inner_iters=6, device="cuda")
    assert F.LAUNCHES_BY_KERNEL["kinematic_clearance_o2"] == before + 3
    assert res.states.is_cuda and bool(torch.isfinite(res.states).all())
    with _on_the_twin(F):
        twin, _ = port.parking_sweep(64, 3, N=12, backend="factory", inner_iters=6,
                                     device="cuda")
    assert torch.equal(res.states, twin.states)


def test_unbuilt_factory_combinations_raise_on_the_card(factory_cases):
    """A combination no hand library holds (the clearances with RK4) runs on
    an instantiation generated at first use, bit for bit with the twin (a
    2 × 3 budget: the twin's nested duals are slow)."""
    from model_predictive_control_tpu_torch.ops.cuda.ilqr_kernel import parking_geometry
    from model_predictive_control_tpu_torch.ops.cuda.parking_factory import (
        make_clearance_rows,
        make_parking_ode_rows,
    )

    F, _ = factory_cases
    geom, limits = parking_geometry(port.VehicleParameters(), (0.25, 0.0, 0.0, 0.0))
    kb, lr, ox, r2, obs = geom
    g = torch.Generator().manual_seed(2)
    x0 = (torch.tensor([0.3, -0.1, 0.0, 0.0]) + 0.05 * torch.randn(16, 4, generator=g)).cuda()
    _generated_matches_twin(F, (x0, torch.zeros(16, 6, 2, device="cuda")), dict(
        ode_rows=make_parking_ode_rows(kb, lr), nx=4, nu=2, N=6, ts=0.08, substeps=1,
        integrator="rk4", limits=limits[2:], state_limits=limits[:2],
        weights=((1.0,) * 4, (1.0,) * 2, 1.0),
        extra_constraints=make_clearance_rows(tuple(ox), r2, tuple(obs)), n_extra=9,
        extra_deps=(0, 1, 2), params=torch.ones(16, 2, device="cuda"), n_params=2,
        outer_iters=2, inner_iters=3))


@pytest.mark.parametrize("group", [1, 8])
def test_kinematic_wrt_matches_twin(group):
    """The no-obstacle parking OCP with per-lane weights (``kinematic_wrt``,
    the tuning layer's fused forward) on 64 lanes: N=8, Euler, ts 0.05,
    weights from a seeded θ, the 8 × 30 budget, tile 16; every output bit for
    bit with the twin, one launch through its own instantiation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as F
    from model_predictive_control_tpu_torch.ops.cuda.ilqr_kernel import parking_geometry
    from model_predictive_control_tpu_torch.ops.cuda.parking_factory import (
        al_ilqr_parking_solve_factory,
    )

    g = torch.Generator().manual_seed(13)
    b, n = 64, 8
    x0 = (torch.tensor([0.6, -0.25, 0.0, 0.0])
          + torch.tensor([0.2, 0.15, 0.3, 0.05]) * (2 * torch.rand(b, 4, generator=g) - 1)).cuda()
    theta = torch.log(torch.tensor([1.0, 3.0, 0.1, 0.01, 1.0, 0.01])) + 0.2 * torch.randn(6, generator=g)
    w = torch.cat([theta.exp(), torch.tensor([10.0])]).expand(b, 7).contiguous().cuda()
    geom, limits = parking_geometry(port.VehicleParameters(), None)

    def solve():
        return al_ilqr_parking_solve_factory(
            x0, torch.zeros(b, n, 2, device="cuda"), torch.full((b,), 2.0, device="cuda"),
            torch.full((b,), 1.0, device="cuda"), N=n, ts=0.05, geom=geom, limits=limits,
            weights_rt=w, n_circles=0, outer_iters=8, inner_iters=30, tile=16, group=group)

    before = F.LAUNCHES_BY_KERNEL["kinematic_wrt"]
    got = _outputs(solve())
    torch.cuda.synchronize()
    assert F.LAUNCHES_BY_KERNEL["kinematic_wrt"] == before + 1
    with _on_the_twin(F):
        ref = _outputs(solve())
    assert got[4].shape == (b, n, 12)
    for k, (a, r) in enumerate(zip(got, ref)):
        assert torch.equal(a, r), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_admm_graphed_iterations_match_eager(ctrl, dtype):
    """Without autograd the plain ADMM solve's iterations replay a CUDA
    graph (captured once per shape, reused across operators); with autograd
    they run eagerly. Both run the same kernels in the same order: the two
    solutions agree to 1e-6 (float32) / 1e-12 (float64) of 1 + max|x|, on a
    second operator too, which reuses the graph."""
    from model_predictive_control_tpu_torch.solvers import qp

    problem, _ = ctrl
    for r in (1.0, 0.3):
        c = port.make_linear_mpc(problem, iters=150, dtype=dtype, device="cuda")
        op = qp.qp_setup(c.op.P * r, c.op.A_c, rho=0.1)
        q, l, u = (a.to(dtype) for a in c.qp.qp_vectors(_states(batch=16).to(dtype)))
        with torch.no_grad():
            graphed = qp.admm_solve(op, q, l, u, iters=100)
        with torch.enable_grad():
            eager = qp.admm_solve(op, q, l, u, iters=100)
        tol = (1e-6 if dtype == torch.float32 else 1e-12) * (1.0 + eager.x.abs().max().item())
        for a, b in ((graphed.x, eager.x), (graphed.y, eager.y), (graphed.z, eager.z)):
            torch.testing.assert_close(a, b, rtol=0, atol=tol)
    assert len(qp._ITERATION_GRAPHS) >= 1
