"""The fused tracker kernel's plain twin (the port, on the CPU) against the
JAX package's ``fused_tracker_solve`` in interpret mode, at the same tile:
the kinematic racing configuration (row-form bicycle with per-scenario
``(acc, fric)``, Euler prediction, input and state boxes, tracking). The
Pacejka configuration is in ``test_torch_ilqr_factory_dyn.py``.

Inputs are made with numpy from a fixed seed and given to both. Gates:
converged masks and executed inner iterations equal; ``us`` and ``xs``
within 1e-5 after one inner iteration; at the sweep's 6 × 15 budget within
5e-3, the JAX package's own gate between two float32 implementations of
this OCP (``tests/test_racing_sweep.py:81``). The budget is chaotic at the
1e-4 level: on these inputs, moving x0 by one ulp moves the twin's own
controls by up to 2.1e-4 (``sweep_budget``) and 5.6e-4 (``ragged``), more
than the twin differs from the JAX kernel (1.7e-4 and 1.6e-4), while after
one iteration the two agree within 6e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_predictive_control_tpu.experiments.racing import ellipse_reference as jax_ellipse
from model_predictive_control_tpu.ops.pallas.ilqr_factory import fused_tracker_solve
from model_predictive_control_tpu.ops.pallas.parking_factory import (
    make_parking_ode_rows as jax_kinematic_rows,
)

from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as F
from model_predictive_control_tpu_torch.ops.cuda.parking_factory import make_parking_ode_rows

KB, LR = 0.05 / (0.047 + 0.05), 0.05
U_LIMS = ((-1.0, -0.384), (1.0, 0.384))
X_LIMS = ((-3.0, -2.0, -100.0, -0.5), (3.0, 2.0, 100.0, 0.5))
WEIGHTS = ((40.0, 40.0, 4.0, 1.0), (0.5, 0.5), 5.0)

CASES = {
    # name: (B, N, tile, outer, inner, tol)
    "one_iteration": (8, 10, 8, 1, 1, 1e-5),
    "sweep_budget": (8, 10, 8, 6, 15, 5e-3),
    "ragged_B5_tile4": (5, 6, 4, 6, 15, 5e-3),
}


def _inputs(B, N, seed=0):
    """Tracking windows at random points of the lap, starts scattered around
    them as the sweep scatters them, perturbed (acc, fric)."""
    rng = np.random.default_rng(seed)
    ref = np.asarray(jax_ellipse(80, speed=0.35, ts=0.05, dynamic=False, dtype=jnp.float32))
    refs = np.stack([ref[o : o + N + 1] for o in rng.integers(0, 60, B)])
    x0 = refs[:, 0] + rng.uniform(-1, 1, (B, 4)) * np.array([0.08, 0.08, 0.15, 0.05])
    x0[:, 3] = np.clip(x0[:, 3], 0.0, 0.5)
    par = np.stack([2.0 * (1 + 0.1 * rng.uniform(-1, 1, B)), 1 + 0.1 * rng.uniform(-1, 1, B)], -1)
    return [np.asarray(a, np.float32) for a in (x0, np.zeros((B, N, 2)), refs, par)]


def _config(N, tile, outer, inner):
    return dict(
        nx=4, nu=2, N=N, ts=0.05, substeps=1, integrator="euler", limits=U_LIMS,
        state_limits=X_LIMS, weights=WEIGHTS, n_params=2, outer_iters=outer,
        inner_iters=inner, viol_tol=1e-4, tile=tile,
    )


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_pallas_tracker(case):
    B, N, tile, outer, inner, tol = CASES[case]
    x0, u0, refs, par = _inputs(B, N)
    kw = _config(N, tile, outer, inner)
    ref = fused_tracker_solve(
        jnp.asarray(x0), jnp.asarray(u0), jnp.asarray(refs),
        ode_rows=jax_kinematic_rows(KB, LR), params=jnp.asarray(par), **kw,
    )
    t = torch.as_tensor
    got = F.fused_tracker_solve_cuda(
        t(x0), t(u0), t(refs), ode_rows=make_parking_ode_rows(KB, LR), params=t(par), **kw
    )
    assert got.us.shape == (B, N, 2) and got.xs.shape == (B, N + 1, 4)
    assert got.lam.shape == (B, N, 12) and got.viol.shape == (B,)
    assert got.converged.dtype == torch.bool
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(
        got.inner_iters_executed.numpy(), np.asarray(ref.inner_iters_executed)
    )
    du = np.abs(got.us.numpy() - np.asarray(ref.us)).max()
    dx = np.abs(got.xs.numpy() - np.asarray(ref.xs)).max()
    print(f"{case}: max|us - us_jax| {du:.3e}, max|xs - xs_jax| {dx:.3e} (tol {tol})")
    assert du <= tol and dx <= tol


def test_bare_row_function_runs_on_the_twin():
    """A row function without a C++ instantiation runs on the twin (CPU
    tensors) through make_fused_tracker, and gives the tracker model's
    numbers."""
    x0, u0, refs, par = (torch.as_tensor(a) for a in _inputs(4, 5, seed=1))
    model = make_parking_ode_rows(KB, LR)
    kw = _config(5, 4, 2, 3)
    bare = F.make_fused_tracker(lambda xr, ur, pr: model.rows(xr, ur, pr), **kw)
    got = bare(x0, u0, refs, params=par)
    ref = F.fused_tracker_solve_twin(x0, u0, refs, ode_rows=model, params=par, **kw)
    for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


@pytest.mark.parametrize(
    "extra, tol",
    [({"refs": None}, 1e-5), ({"refs": None}, 5e-3), ({"limits": None}, 1e-5),
     ({"limits": None}, 5e-3)],
    ids=["regulation_one_iteration", "regulation_budget", "no_input_box_one_iteration",
         "no_input_box_budget"],
)
def test_regulation_and_no_input_box_match_pallas_tracker(extra, tol):
    """The kinematic configuration in regulation (``refs=None``: x costed
    against the origin) and without its input box (``limits=None``: the state
    box's rows alone), twin against the JAX kernel in interpret mode: after
    one inner iteration within 1e-5, at a 3 × 5 budget within 5e-3; converged
    masks and executed inner iterations equal."""
    B, N, tile = 5, 6, 4
    x0, u0, refs, par = _inputs(B, N)
    outer, inner = (1, 1) if tol == 1e-5 else (3, 5)
    kw = {**_config(N, tile, outer, inner), "refs": refs, **extra}
    j = lambda a: None if a is None else jnp.asarray(a)
    ref = fused_tracker_solve(
        jnp.asarray(x0), jnp.asarray(u0), ode_rows=jax_kinematic_rows(KB, LR),
        params=jnp.asarray(par), **{**kw, "refs": j(kw["refs"])},
    )
    t = lambda a: None if a is None else torch.as_tensor(a)
    got = F.fused_tracker_solve_cuda(
        t(x0), t(u0), ode_rows=make_parking_ode_rows(KB, LR), params=t(par),
        **{**kw, "refs": t(kw["refs"])},
    )
    assert got.lam.shape == (B, N, 8 if "limits" in extra else 12)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(
        got.inner_iters_executed.numpy(), np.asarray(ref.inner_iters_executed)
    )
    du = np.abs(got.us.numpy() - np.asarray(ref.us)).max()
    dx = np.abs(got.xs.numpy() - np.asarray(ref.xs)).max()
    print(f"{extra}: max|us - us_jax| {du:.3e}, max|xs - xs_jax| {dx:.3e} (tol {tol})")
    assert du <= tol and dx <= tol


def _disc_row(xr, ur, pr):
    """One keep-out disc on (px, py) near the lap, c = r² − ‖p − q‖² ≤ 0:
    plain arithmetic, so the same function serves both packages."""
    wx = xr[0] - 0.25
    wy = xr[1] - 0.05
    return (0.0225 - (wx * wx + wy * wy),)


def _operand_case(case, B, N):
    """(JAX keywords, port keywords, model pair) of one operand's case on
    the kinematic racing configuration, from seeded numpy inputs."""
    x0, u0, refs, par = _inputs(B, N, seed=3)
    rng = np.random.default_rng(4)
    jkw, tkw = {}, {}
    rows = (jax_kinematic_rows(KB, LR), make_parking_ode_rows(KB, LR))
    if case == "extra_constraints":
        jkw = tkw = dict(extra_constraints=_disc_row, n_extra=1, extra_deps="x")
    elif case == "lam_init":
        lam = (rng.uniform(0, 2, (B, N, 12)) * (rng.uniform(size=(B, N, 12)) < 0.3)).astype(np.float32)
        jkw, tkw = dict(lam_init=jnp.asarray(lam)), dict(lam_init=torch.as_tensor(lam))
    elif case == "weights_rt":
        w = np.array([*WEIGHTS[0], *WEIGHTS[1], WEIGHTS[2]])
        w = (w * (1 + 0.2 * rng.uniform(-1, 1, (B, 7)))).astype(np.float32)
        jkw, tkw = dict(weights=None, weights_rt=jnp.asarray(w)), dict(weights=None,
                                                                       weights_rt=torch.as_tensor(w))
    elif case == "input_mode":
        # the gated kinematic model in the additive mode (the MHE windows'
        # shape): exogenous (γ, a, δ), per-stage input weights
        from model_predictive_control_tpu.estimation_nl import _gated_ode_rows as jax_gated
        from model_predictive_control_tpu.models.bicycle import make_kinematic_ode_rows as jax_rows

        from model_predictive_control_tpu_torch.estimation_nl import _gated_ode_rows
        from model_predictive_control_tpu_torch.models.bicycle import make_kinematic_ode_rows

        rows = (jax_gated(jax_rows(KB, LR, 2.0, 1.0), 2),
                _gated_ode_rows(make_kinematic_ode_rows(KB, LR, 2.0, 1.0), 2))
        exo = np.concatenate([np.ones((B, N, 1)), rng.uniform(-0.3, 0.3, (B, N, 2))], -1)
        exo[:, 0, 0] = 0.0
        rw = rng.uniform(1.0, 100.0, (B, N, 4))
        u0 = np.zeros((B, N, 4), np.float32)
        exo, rw = exo.astype(np.float32), rw.astype(np.float32)
        common = dict(nu=4, limits=None, n_params=0, input_mode="additive", n_exo=3,
                      weights=((40.0, 40.0, 0.0, 0.0), (0.0,) * 4, 1.0))
        jkw = dict(common, exo=jnp.asarray(exo), input_weights_rt=jnp.asarray(rw))
        tkw = dict(common, exo=torch.as_tensor(exo), input_weights_rt=torch.as_tensor(rw))
        par = None
    elif case == "terminal_state_limits":
        jkw = tkw = dict(terminal_state_limits=((-3.0, -2.0, -100.0, 0.0), (3.0, 2.0, 100.0, 0.35)))
    return x0, u0, refs, par, jkw, tkw, rows


OPERAND_CASES = ["extra_constraints", "lam_init", "weights_rt", "input_mode",
                 "terminal_state_limits"]


@pytest.mark.parametrize("case", OPERAND_CASES)
def test_operands_match_pallas_tracker(case):
    """Each operand the port once refused, on the kinematic racing
    configuration (the additive mode on the gated kinematic model), twin
    against the JAX kernel in interpret mode after one inner iteration: us
    and xs within 1e-5, lam within 1e-5 of its largest entry, converged masks
    and executed inner iterations equal; lam has a row N with terminal
    rows."""
    B, N, tile = 5, 6, 4
    x0, u0, refs, par, jkw, tkw, (jrows, trows) = _operand_case(case, B, N)
    kw = {**_config(N, tile, 1, 1), "viol_tol": 1e-4}
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.as_tensor(a)
    if par is None:
        kw["n_params"] = 0
    ref = fused_tracker_solve(j(x0), j(u0), j(refs), ode_rows=jrows, params=j(par), **{**kw, **jkw})
    got = F.fused_tracker_solve_cuda(t(x0), t(u0), t(refs), ode_rows=trows, params=t(par),
                                     **{**kw, **tkw})
    n_lam = N + 1 if case == "terminal_state_limits" else N
    assert got.lam.shape == np.asarray(ref.lam).shape and got.lam.shape[1] == n_lam
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(got.inner_iters_executed.numpy(),
                                  np.asarray(ref.inner_iters_executed))
    for name in ("us", "xs", "lam"):
        want = np.asarray(getattr(ref, name))
        d = np.abs(getattr(got, name).numpy() - want).max()
        # multipliers grow with mu: held relative to their largest
        bar = 1e-5 * max(1.0, np.abs(want).max()) if name == "lam" else 1e-5
        print(f"{case}: max|{name} - {name}_jax| {d:.3e} (tol {bar:.3e})")
        assert d <= bar, name


@pytest.mark.parametrize(
    "extra, message",
    [
        ({"extra_constraints": _disc_row}, "requires n_extra > 0"),
        ({"extra_deps": "u"}, "extra_deps must be"),
        ({"input_mode": "additive"}, "requires nu == nx"),
        ({"input_mode": "additive", "nu": 4, "limits": None, "ode_rows": lambda *a: a[0]},
         "requires exo / n_exo"),
        ({"input_mode": "sideways"}, "input_mode must be"),
        ({"limits": None, "state_limits": None, "extra_constraints": _disc_row, "n_extra": 1,
          "terminal_state_limits": X_LIMS}, "nc >= 2\\*nx"),
        ({"weights": None}, "exactly one of weights / weights_rt"),
        ({"weights_rt": torch.ones(2, 7)}, "exactly one of weights / weights_rt"),
        ({"weights": None, "weights_rt": torch.ones(2, 6)}, "weights_rt must be"),
    ],
)
def test_jax_refusals_raise(extra, message):
    """Where the JAX package's ``fused_tracker_solve`` raises ``ValueError``
    (``ilqr_factory.py:1315-1358``), the port raises it too, on the twin and
    before any launch."""
    x0, u0, refs, par = (torch.as_tensor(a) for a in _inputs(2, 4))
    kw = {**_config(4, 4, 1, 1), "refs": refs, "ode_rows": make_parking_ode_rows(KB, LR),
          **extra}
    with pytest.raises(ValueError, match=message):
        F.fused_tracker_solve_cuda(x0, u0, params=par, **kw)


def test_other_input_widths_raise():
    """1 <= nu <= 8, as the JAX kernel (``ilqr_factory.py:1308``); and at
    least one box."""
    x0, u0, refs, par = (torch.as_tensor(a) for a in _inputs(2, 4))
    kw = {**_config(4, 4, 1, 1), "nu": 9}
    with pytest.raises(NotImplementedError, match="nu <= 8"):
        F.fused_tracker_solve_cuda(x0, u0, refs, ode_rows=lambda *a: a[0], params=par, **kw)
    kw = {**_config(4, 4, 1, 1), "limits": None, "state_limits": None}
    with pytest.raises(ValueError, match="at least one constraint row"):
        F.fused_tracker_solve_cuda(x0, u0, refs, ode_rows=make_parking_ode_rows(KB, LR),
                                   params=par, **kw)


# ---------------------------------------------------------------------------
# thread groups: the wrapper's reckoning (no card needed)
# ---------------------------------------------------------------------------

RACING_SHAPES = {"kinematic": (4, 15, 12), "pacejka": (6, 15, 4)}  # nx, N, nc


@pytest.mark.parametrize("model", list(RACING_SHAPES))
def test_launch_plan_reckons_shared_memory_and_workspace(model):
    """A lane's working set by region, what fits the 227 KB of a CTA at each
    tile, and the global workspace for the rest."""
    nx, N, nc = RACING_SHAPES[model]
    sizes = dict((name, n) for name, n, _ in F.regions(nx, N, nc))
    assert sizes == {
        "ab": N * nx * (nx + 2), "gain": N * 2 * (1 + nx), "xs": (N + 1) * nx, "us": N * 2,
        "lam": N * nc, "ref": (N + 1) * nx, "cand": 7 * ((N + 1) * nx + N * 2 + 1),
    }
    total = sum(sizes.values())
    assert total == {"kinematic": 1513, "pacejka": 2101}[model]
    # a narrow tile keeps the whole working set in shared memory: no workspace
    plan = F.launch_plan(nx, N, nc, 8, 32)
    assert plan == F.LaunchPlan(threads=256, smask=0b1111111, smem_bytes=4 * 8 * (total | 1),
                                work_rows=0)
    # at tile 64 it does not fit: regions are taken in order while they fit, a
    # lane's block is padded to an odd float count, the rest of the workspace
    # regions (never xs, us, lam, refs: they have their own buffers) is global
    plan = F.launch_plan(nx, N, nc, 64, 8)
    names = [name for name, _, _ in F.regions(nx, N, nc)]
    shared = [names[r] for r in range(7) if plan.smask >> r & 1]
    assert shared == {"kinematic": ["ab", "gain", "xs", "us", "lam", "ref"],
                      "pacejka": ["ab", "xs", "us", "lam"]}[model]
    floats = sum(sizes[n] for n in shared)
    assert plan.smem_bytes == 4 * 64 * (floats | 1) <= F.SMEM_LIMIT
    assert plan.threads == 512
    assert plan.work_rows == sum(sizes[n] for n in ("ab", "gain", "cand") if n not in shared)
    # the next region would not have fitted
    skipped = next(n for n in names if n not in shared)
    assert 4 * 64 * ((floats + sizes[skipped]) | 1) > F.SMEM_LIMIT


@pytest.mark.parametrize(
    "tile, group, message",
    [
        (64, 4, "group must be one of"),
        (64, 0, "group must be one of"),
        (512, 1, "threads per CTA"),
        (128, 8, "threads per CTA"),
        (64, 16, "threads per CTA"),
        (32, 32, "threads per CTA"),
        (0, 8, "tile must be positive"),
    ],
)
def test_launch_plan_refuses(tile, group, message):
    with pytest.raises(ValueError, match=message):
        F.launch_plan(6, 15, 4, tile, group)


@pytest.mark.parametrize("group", F.GROUPS)
def test_widest_tile_of_each_group_is_taken(group):
    tile = F.MAX_THREADS[group] // group
    assert F.launch_plan(6, 15, 4, tile, group).threads == F.MAX_THREADS[group]
    with pytest.raises(ValueError, match="threads per CTA"):
        F.launch_plan(6, 15, 4, tile + 1, group)


def test_launch_validates_before_it_builds(monkeypatch):
    """An unknown group or too many threads raise from ``_launch`` before any
    library is built, and count no launch."""
    monkeypatch.setattr(F, "_build_library", lambda group=1: pytest.fail("built a library"))
    x0, u0, refs, par = (torch.as_tensor(a) for a in _inputs(4, 5))
    args = F.prepare_tiles(x0, u0, refs, par, tile=4)
    kw = {k: v for k, v in _config(5, 4, 1, 1).items() if k not in ("n_params", "viol_tol")}
    kw.update(ode_rows=make_parking_ode_rows(KB, LR), mu_init=10.0, mu_scale=10.0, mu_max=1e8,
              viol_tol=1e-4, tol=1e-6)
    before = F.LAUNCHES
    with pytest.raises(ValueError, match="group must be one of"):
        F._launch(*args, group=3, **kw)
    with pytest.raises(ValueError, match="threads per CTA"):
        F._launch(*args, group=32, **{**kw, "tile": 64})
    assert F.LAUNCHES == before


def test_group_is_validated_and_ignored_on_the_twin():
    """On CPU tensors a valid group changes nothing (the twin has no
    threads); an unknown one raises all the same."""
    x0, u0, refs, par = (torch.as_tensor(a) for a in _inputs(4, 5, seed=2))
    model = make_parking_ode_rows(KB, LR)
    kw = _config(5, 4, 2, 3)
    ref = F.fused_tracker_solve_twin(x0, u0, refs, ode_rows=model, params=par, **kw)
    step = F.make_fused_tracker(model, group=32, **kw)
    assert step.keywords["group"] == 32 and step.keywords["tile"] == 4
    for got in (step(x0, u0, refs, params=par),
                F.fused_tracker_solve_twin(x0, u0, refs, ode_rows=model, params=par, group=8, **kw)):
        for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for solve in (F.fused_tracker_solve_cuda, F.fused_tracker_solve_twin):
        with pytest.raises(ValueError, match="group must be one of"):
            solve(x0, u0, refs, ode_rows=model, params=par, group=5, **kw)


def test_default_groups_fit_the_default_tile():
    assert set(F.DEFAULT_GROUP) == {"kinematic", "pacejka", "cartpole", "quadrotor", "omnibase",
                                    "omnibase_param", "thruster", "kinematic_clearance_o2",
                                    "kinematic_clearance_o2_wrt", "kinematic_clearance_o1",
                                    "kinematic_clearance_o1_wrt", "gated_kinematic"}
    assert set(F.EXT_KERNELS) | set(F.BASE_KERNELS) == set(F.DEFAULT_GROUP)
    for group in F.DEFAULT_GROUP.values():
        assert group in F.GROUPS and F.DEFAULT_TILE * group <= F.MAX_THREADS[group]
    assert F.library_name(1) == F.LIBRARY and F.library_name(16) == F.LIBRARY + "_g16"
    assert F.library_name(8, ext=True) == F.LIBRARY + "_ext_g8"


@pytest.mark.parametrize("tile, group", [(32, 16), (64, 8)])
def test_racing_sweep_dynamic_resolves_a_group_that_fits(monkeypatch, tile, group):
    """With only ``tile`` given, the Pacejka default (32 threads per lane)
    does not fit tiles 32 and 64 (512 threads per CTA at most): ``group=None``
    then resolves to the largest group that fits, which ``launch_plan``
    accepts; an explicit oversize group is still refused."""
    import model_predictive_control_tpu_torch as port

    seen = []
    resolve = F.resolve_group
    monkeypatch.setattr(F, "resolve_group", lambda *a: seen.append(resolve(*a)) or seen[-1])
    _, summary = port.racing_sweep_dynamic(3, 1, N=4, tile=tile, device="cpu")
    assert seen == [group] and summary["steps"] == 1
    assert F.launch_plan(6, 4, 4, tile, group).threads == F.MAX_THREADS[group]
    assert F.resolve_group(None, F.DEFAULT_TILE, 32, F.GROUPS, F.MAX_THREADS) == 32
    assert F.resolve_group(32, tile, 32, F.GROUPS, F.MAX_THREADS) == 32
    with pytest.raises(ValueError, match="threads per CTA"):
        F.launch_plan(6, 4, 4, tile, 32)


def test_unbuilt_combinations_raise_before_the_build(monkeypatch):
    """On the card a solve no library holds raises ``NotImplementedError``
    before any build and counts no launch: a multiplier warm start or
    terminal rows on the racing library's instantiations, per-lane weights
    on a model without such an instantiation (the twin takes all of them)."""
    monkeypatch.setattr(F, "_build_library", lambda *a, **k: pytest.fail("built a library"))
    x0, u0, refs, par = (torch.as_tensor(a) for a in _inputs(4, 5))
    args = F.prepare_tiles(x0, u0, refs, par, tile=4)
    kw = {k: v for k, v in _config(5, 4, 1, 1).items() if k not in ("n_params", "viol_tol")}
    kw.update(ode_rows=make_parking_ode_rows(KB, LR), mu_init=10.0, mu_scale=10.0, mu_max=1e8,
              viol_tol=1e-4, tol=1e-6)
    before = F.LAUNCHES
    with pytest.raises(NotImplementedError, match="warm start"):
        F._launch(*args, lam0=torch.zeros(5, 12, 4), **kw)
    with pytest.raises(NotImplementedError, match="terminal rows"):
        F._launch(*args, terminal_state_limits=X_LIMS, **kw)
    with pytest.raises(NotImplementedError, match="no instantiation 'kinematic_wrt'"):
        F._launch(*args, **{**kw, "weights": None}, wrt=torch.ones(7, 4))
    assert F.LAUNCHES == before
