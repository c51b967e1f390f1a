"""The benchmark models of the fused tracker (the port's ``models/
benchmarks.py``) and the tracker twin's new shapes against the JAX package.

- The constants equal JAX's; each builder is cached on its parameters.
- Each model's rows at float64 against JAX's rows, within 1e-6 of each row's
  scale (the port multiplies by float32 reciprocals of constant masses and
  inertias, as XLA compiles the reference's divisions).
- Each model's step Jacobians by the twin's dual numbers (what the kernel
  computes) against ``jax.jacfwd`` of the JAX RK4×2 step in float64, within
  1e-5 of the largest entry.
- The twin (``fused_tracker_solve_cuda`` on CPU tensors) against the JAX
  ``fused_tracker_solve`` in interpret mode, at the same tile, on inputs made
  with numpy from a seed: cart-pole in regulation (nu = 1, a binding force
  box), the quadrotor tracking with the tilt state box (nu = 2) and the same
  without an input box (``limits=None``). Gates: converged masks and
  executed inner iterations equal; ``us`` and ``xs`` within 1e-5 after one
  inner iteration, within 5e-3 at a 3 × 5 budget (the JAX package's gate
  between two float32 implementations). At the 6 × 15 budget these solves
  run all 90 inner iterations and are chaotic: moving x0 by one ulp moves the
  twin's own controls by 8e-3 (cart-pole) and 1.2e-2 (omnibase), more than
  the gate, while at 3 × 5 it moves them by 1e-6. The wide inputs (nu = 3,
  4) are in ``test_torch_benchmark_wide.py``.
- Regulation (``refs=None``) equals tracking a zero reference, as in
  ``tests/test_ilqr_factory_wide.py:137`` (here bit for bit: x − 0 is x).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_predictive_control_tpu.models import benchmarks as JB
from model_predictive_control_tpu.ops.integrators import rk4_fine as jax_rk4_fine
from model_predictive_control_tpu.ops.pallas.ilqr_factory import fused_tracker_solve

from model_predictive_control_tpu_torch.models import benchmarks as PB
from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as F

TS, SUB, TILE = 0.1, 2, 4
TOL_ROWS = 1e-6
TOL_JAC = 1e-5
ONE_ITERATION, BUDGET = (1, 1, 1e-5), (3, 5, 5e-3)  # outer, inner, tolerance
BIG = 50.0

MODELS = {
    # name: (builder, nx, nu, n_params, input spread)
    "cartpole": ("make_cartpole_ode_rows", 4, 1, 0, 8.0),
    "quadrotor": ("make_planar_quadrotor_ode_rows", 6, 2, 0, 8.0),
    "omnibase": ("make_omnibase_ode_rows", 6, 3, 0, 12.0),
    "omnibase_param": ("make_omnibase_param_ode_rows", 6, 3, 1, 12.0),
    "thruster": ("make_thruster_ode_rows", 6, 4, 0, 6.0),
}

# solve cases: (builder, nx, nu, limits, state limits, weights, track, start
# spread, per-lane mass range)
CASES = {
    "cartpole_regulation": (
        "make_cartpole_ode_rows", 4, 1, ((-3.0,), (3.0,)), None,
        ((1.0, 2.0, 0.1, 0.1), (0.01,), 10.0), False, (2.0, 0.5, 0.2, 0.2), None),
    "quadrotor_tracking_tilt_box": (
        "make_planar_quadrotor_ode_rows", 6, 2, ((0.0, 0.0), (7.3575, 7.3575)),
        ((-BIG, -BIG, -0.4, -BIG, -BIG, -BIG), (BIG, BIG, 0.4, BIG, BIG, BIG)),
        ((5.0, 5.0, 1.0, 0.5, 0.5, 0.1), (0.02, 0.02), 10.0), True,
        (0.8, 0.4, 0.3, 0.5, 0.1, 0.1), None),
    "quadrotor_no_input_box": (
        "make_planar_quadrotor_ode_rows", 6, 2, None,
        ((-BIG, -BIG, -0.4, -BIG, -BIG, -BIG), (BIG, BIG, 0.4, BIG, BIG, BIG)),
        ((5.0, 5.0, 1.0, 0.5, 0.5, 0.1), (0.02, 0.02), 10.0), True,
        (0.8, 0.4, 0.3, 0.5, 0.1, 0.1), None),
    "omnibase_regulation": (
        "make_omnibase_ode_rows", 6, 3, ((-12.0, -12.0, -3.0), (12.0, 12.0, 3.0)), None,
        ((5.0, 5.0, 1.0, 0.5, 0.5, 0.1), (0.01, 0.01, 0.005), 10.0), False,
        (2.5, 0.5, 1.0, 0.2, 0.1, 0.3), None),
    "omnibase_param_mass": (
        "make_omnibase_param_ode_rows", 6, 3, ((-12.0, -12.0, -3.0), (12.0, 12.0, 3.0)), None,
        ((5.0, 5.0, 1.0, 0.5, 0.5, 0.1), (0.01, 0.01, 0.005), 10.0), False,
        (2.5, 0.5, 1.0, 0.2, 0.1, 0.3), (4.0, 10.0)),
    "thruster_regulation": (
        "make_thruster_ode_rows", 6, 4, ((0.0,) * 4, (6.0,) * 4), None,
        ((5.0, 5.0, 5.0, 0.5, 0.5, 0.5), (0.02,) * 4, 10.0), False,
        (1.5, 1.5, 0.5, 0.5, 0.5, 0.2), None),
}


def test_constants_match_jax():
    for name in ("NX_CARTPOLE", "NU_CARTPOLE", "NX_QUADROTOR", "NU_QUADROTOR", "NX_OMNIBASE",
                 "NU_OMNIBASE", "NX_THRUSTER", "NU_THRUSTER", "CARTPOLE_PARAMS",
                 "QUADROTOR_PARAMS", "OMNIBASE_PARAMS", "THRUSTER_PARAMS"):
        assert getattr(PB, name) == getattr(JB, name), name


@pytest.mark.parametrize("name", list(MODELS))
def test_builders_are_cached_tracker_models(name):
    builder, nx, nu, n_params, _ = MODELS[name]
    model = getattr(PB, builder)()
    assert model is getattr(PB, builder)()
    assert isinstance(model, F.TrackerModel) and model.kernel == name
    assert (model.nx, model.nu, model.n_params) == (nx, nu, n_params)
    assert len(model.consts) <= F.MAX_CONSTS and name in F.DEFAULT_GROUP


def _inputs(name, B=16, seed=0):
    _, nx, nu, n_params, u_spread = MODELS[name]
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, nx)) * 1.5
    u = rng.uniform(0 if name == "thruster" else -1, 1, (B, nu)) * u_spread
    p = rng.uniform(4.0, 10.0, (B, n_params))
    return x, u, p


def _rows(rows, args, lib):
    as_rows = (lambda a: tuple(torch.as_tensor(a[:, i]) for i in range(a.shape[1]))) if lib == "torch" \
        else (lambda a: tuple(jnp.asarray(a[:, i]) for i in range(a.shape[1])))
    out = rows(*(as_rows(a) for a in args))
    return np.stack([np.asarray(o) for o in out], 1)


@pytest.mark.parametrize("name", list(MODELS))
def test_rows_match_jax(name):
    builder, *_, n_params, _ = MODELS[name]
    x, u, p = _inputs(name)
    args = (x, u, p) if n_params else (x, u)
    got = _rows(getattr(PB, builder)(), args, "torch")
    ref = _rows(getattr(JB, builder)(), args, "jax")
    scale = np.maximum(np.abs(ref).max(axis=0), 1.0)
    assert np.all(np.abs(got - ref).max(axis=0) / scale <= TOL_ROWS)


@pytest.mark.parametrize("name", list(MODELS))
def test_step_jacobians_match_jacfwd(name):
    builder, nx, nu, n_params, _ = MODELS[name]
    x, u, p = _inputs(name, seed=1)
    rows_j = getattr(JB, builder)()

    def step(xx, uu, pp):
        call = (lambda a, b: rows_j(tuple(a), tuple(b), tuple(pp))) if n_params \
            else (lambda a, b: rows_j(tuple(a), tuple(b)))
        return jax_rk4_fine(lambda a, b: jnp.stack(call(a, b)), TS, substeps=SUB)(xx, uu)

    A_ref, B_ref = jax.vmap(jax.jacfwd(step, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(p))  # float64 (tests/conftest.py)
    pr = tuple(torch.as_tensor(p[:, i]) for i in range(n_params)) if n_params else None
    A, Bm = F.step_jacobian(getattr(PB, builder)(), tuple(torch.as_tensor(x[:, i]) for i in range(nx)),
                            tuple(torch.as_tensor(u[:, j]) for j in range(nu)), pr, ts=TS,
                            substeps=SUB, integrator="rk4")
    for got, ref in ((A.permute(2, 0, 1).numpy(), np.asarray(A_ref)),
                     (Bm.permute(2, 0, 1).numpy(), np.asarray(B_ref))):
        err = np.abs(got - ref).max() / np.abs(ref).max()
        print(f"{name}: max|J - jacfwd| / max|J| = {err:.2e} (tol {TOL_JAC})")
        assert err <= TOL_JAC


def case_inputs(case, B=5, N=6, seed=0):
    """A case's starts (and, tracking, windows of the loiter circle around
    them; per-lane masses), float32, from a numpy generator."""
    builder, nx, nu, _, _, _, track, spread, masses = CASES[case]
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, (B, nx)) * np.array(spread)
    refs = None
    if track:
        t = (rng.integers(0, 60, B)[:, None] + np.arange(N + 1)) * TS
        om = 2 * np.pi / 12.0
        zero = np.zeros_like(t)
        refs = np.stack([np.sin(om * t), 1 - np.cos(om * t), zero, om * np.cos(om * t),
                         om * np.sin(om * t), zero], -1).astype(np.float32)
        x0 = x0 + refs[:, 0]
    par = None if masses is None else rng.uniform(*masses, (B, 1)).astype(np.float32)
    return x0.astype(np.float32), np.zeros((B, N, nu), np.float32), refs, par


def solve_both(case, budget, B=5, N=6):
    """The JAX kernel (interpret mode) and the port's twin on one case."""
    builder, nx, nu, limits, state_limits, weights, _, _, masses = CASES[case]
    outer, inner, _ = budget
    x0, u0, refs, par = case_inputs(case, B, N)
    kw = dict(nx=nx, nu=nu, N=N, ts=TS, substeps=SUB, limits=limits, state_limits=state_limits,
              weights=weights, n_params=0 if par is None else 1, outer_iters=outer,
              inner_iters=inner, viol_tol=1e-4, tile=TILE)
    j = lambda a: None if a is None else jnp.asarray(a)
    ref = fused_tracker_solve(j(x0), j(u0), j(refs), ode_rows=getattr(JB, builder)(),
                              params=j(par), interpret=True, **kw)
    t = lambda a: None if a is None else torch.as_tensor(a)
    got = F.fused_tracker_solve_cuda(t(x0), t(u0), t(refs), ode_rows=getattr(PB, builder)(),
                                     params=t(par), **kw)
    return got, ref


def check_against_jax(case, budget):
    _, nx, nu, limits, state_limits, *_ = CASES[case]
    B, N = 5, 6
    got, ref = solve_both(case, budget, B, N)
    nc = (2 * nu if limits is not None else 0) + (2 * nx if state_limits is not None else 0)
    assert got.us.shape == (B, N, nu) and got.xs.shape == (B, N + 1, nx)
    assert got.lam.shape == (B, N, nc)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(got.inner_iters_executed.numpy(),
                                  np.asarray(ref.inner_iters_executed))
    du = np.abs(got.us.numpy() - np.asarray(ref.us)).max()
    dx = np.abs(got.xs.numpy() - np.asarray(ref.xs)).max()
    tol = budget[2]
    print(f"{case} {budget[0]}x{budget[1]}: max|us - us_jax| {du:.3e}, max|xs - xs_jax| "
          f"{dx:.3e} (tol {tol})")
    assert du <= tol and dx <= tol
    return got


@pytest.mark.parametrize("budget", [ONE_ITERATION, BUDGET], ids=["one_iteration", "budget"])
@pytest.mark.parametrize("case", ["cartpole_regulation", "quadrotor_tracking_tilt_box",
                                  "quadrotor_no_input_box"])
def test_twin_matches_pallas_tracker(case, budget):
    got = check_against_jax(case, budget)
    if case == "cartpole_regulation" and budget is BUDGET:
        assert got.us.abs().max().item() >= 3.0 - 1e-3  # the force box binds


def test_regulation_equals_zero_reference_tracking():
    builder, nx, nu, limits, state_limits, weights, *_ = CASES["omnibase_regulation"]
    x0, u0, _, _ = (torch.as_tensor(a) if a is not None else None
                    for a in case_inputs("omnibase_regulation", 2))
    step = F.make_fused_tracker(getattr(PB, builder)(), nx, nu, N=6, ts=TS, substeps=SUB,
                                limits=limits, weights=weights, outer_iters=6, inner_iters=15,
                                viol_tol=1e-4, tile=TILE)
    reg = step(x0, u0)
    trk = step(x0, u0, torch.zeros(2, 7, nx))
    for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
        a, b = getattr(reg, name), getattr(trk, name)
        assert torch.allclose(a.float(), b.float(), rtol=0, atol=1e-6), name
        assert torch.equal(a, b), name
