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
    "extra, item",
    [
        ({"refs": None}, "S4.3"),
        ({"extra_constraints": lambda xr, ur, pr: (xr[0],), "n_extra": 1}, "S4.3"),
        ({"lam_init": torch.zeros(2, 4, 12)}, "S4.3"),
        ({"limits": None}, "S4.3"),
        ({"weights_rt": torch.ones(2, 7)}, "S5"),
        ({"input_mode": "additive"}, "S4.4"),
        ({"terminal_state_limits": X_LIMS}, "S4.4"),
    ],
)
def test_unported_options_raise(extra, item):
    x0, u0, refs, par = (torch.as_tensor(a) for a in _inputs(2, 4))
    kw = {**_config(4, 4, 1, 1), "refs": refs, **extra}
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        F.fused_tracker_solve_cuda(
            x0, u0, ode_rows=make_parking_ode_rows(KB, LR), params=par, **kw
        )


def test_other_input_widths_raise():
    x0, u0, refs, par = (torch.as_tensor(a) for a in _inputs(2, 4))
    kw = {**_config(4, 4, 1, 1), "nu": 3}
    with pytest.raises(NotImplementedError, match="ROADMAP S4.3"):
        F.fused_tracker_solve_cuda(x0, u0, refs, ode_rows=lambda *a: a[0], params=par, **kw)


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
    assert set(F.DEFAULT_GROUP) == {"kinematic", "pacejka"}
    for group in F.DEFAULT_GROUP.values():
        assert group in F.GROUPS and F.DEFAULT_TILE * group <= F.MAX_THREADS[group]
    assert F.library_name(1) == F.LIBRARY and F.library_name(16) == F.LIBRARY + "_g16"


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
