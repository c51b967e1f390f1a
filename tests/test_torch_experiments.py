"""The port's experiment drivers against the JAX package's
(``tests/test_experiments.py``'s counterpart), at the JAX tests' sizes or
smaller, on the same inputs: float64 on both sides held within 1e-8 (1e-6
where a per-scenario AL-iLQR or SQP iterates), float32 within 1e-4; where
the random draws differ by construction (the estimation demo's noises are
``jax.random``'s), the JAX draws are passed to the port. The JAX side of
each comparison runs once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_predictive_control_tpu.experiments import estimation_demo as jax_est
from model_predictive_control_tpu.experiments import racing as jax_racing
from model_predictive_control_tpu.experiments import robust_demo as jax_robust
from model_predictive_control_tpu.experiments import session1 as jax_s1
from model_predictive_control_tpu.experiments import session23 as jax_s23
from model_predictive_control_tpu.experiments import session4 as jax_s4

from model_predictive_control_tpu_torch.experiments import estimation_demo, racing, robust_demo
from model_predictive_control_tpu_torch.experiments import session1, session23, session4

F64 = dict(dtype=torch.float64, device="cpu")
TOL = 1e-8


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_horizon_sweep_matches_jax():
    got = session1.horizon_sweep(horizons=(4, 10), steps=30, **F64)
    want = jax_s1.horizon_sweep(horizons=(4, 10), steps=30, dtype=jnp.float64)
    for N in (4, 10):
        assert got[N]["unstable"] == want[N]["unstable"]
        close(got[N]["states"], want[N]["states"])
        close(got[N]["predictions"], want[N]["predictions"])
        close(got[N]["cost_to_go"], want[N]["cost_to_go"])
    assert got[4]["unstable"] is True and got[10]["unstable"] is False
    assert got[10]["predictions"].shape == (30, 11, 2)


def test_cost_to_go_comparison_matches_jax():
    hs, finite, v_inf, K_inf = session1.cost_to_go_comparison(horizons=range(1, 10), **F64)
    jhs, jfinite, jv_inf, jK_inf = jax_s1.cost_to_go_comparison(horizons=range(1, 10),
                                                                dtype=jnp.float64)
    assert hs == jhs
    close(finite, jfinite)
    close(v_inf, jv_inf)
    close(K_inf, jK_inf)


@pytest.mark.parametrize("session", [2, 3])
def test_closed_loop_linear_mpc_matches_jax(session):
    res, _, _ = session23.closed_loop_linear_mpc(session=session, N=10, steps=30, iters=150,
                                                 **F64)
    want, _, _ = jax_s23.closed_loop_linear_mpc(session=session, N=10, steps=30, iters=150,
                                                dtype=jnp.float64)
    close(res.states, want.states)
    close(res.inputs, want.inputs)
    np.testing.assert_array_equal(res.logs["solver_success"].numpy(),
                                  np.asarray(want.logs["solver_success"]))


def test_session23_run_summary_float32():
    """The driver's float32 summary (the CLI's) against the JAX driver's:
    the same keys, the checks equal, the final state within 1e-4 of its
    scale."""
    got = session23.run(session=2, N=10, steps=30, iters=150, device="cpu")
    want = jax_s23.run(session=2, N=10, steps=30, iters=150)
    assert got.keys() == want.keys()
    assert got["constraints_respected"] == want["constraints_respected"] is True
    assert got["success_rate"] > 0.9 and abs(got["final_state"][0]) < 1.5
    scale = 1.0 + np.abs(want["final_state"]).max()
    np.testing.assert_allclose(got["final_state"], want["final_state"], atol=1e-4 * scale)


def test_integrator_accuracy_matches_jax():
    got = session4.integrator_accuracy(ts_values=(0.1,), steps=40, **F64)[0.1]
    want = jax_s4.integrator_accuracy(ts_values=(0.1,), steps=40, dtype=jnp.float64)[0.1]
    for name in ("euler", "heun", "rk4"):
        close(got[name], want[name])
    assert got["euler"].max() > got["heun"].max() > got["rk4"].max()


def test_relative_error_formula():
    a = np.array([[2.0, 0.0], [4.0, 0.0]])
    b = np.array([[1.0, 0.0], [4.0, 0.0]])
    np.testing.assert_allclose(session4.relative_error(a, b), [1.0 / 3.0, 0.0])
    np.testing.assert_array_equal(session4.relative_error(a, b), jax_s4.relative_error(a, b))


def test_scenario_constants_match_jax():
    for name in ("MAIN_X0", "MAIN_X_OBS", "MAIN_N", "MAIN_TS", "MAIN_STEPS", "SOL_X0", "SOL_N",
                 "SOL_TS", "SOL_STEPS", "MISMATCH_FRICTION", "EXACT_SUBSTEPS"):
        assert getattr(session4, name) == getattr(jax_s4, name), name
    for name in ("W_HALF", "SIGMA_V", "EPS", "BIAS", "R_POS", "SLOPE_ACCEL"):
        np.testing.assert_array_equal(getattr(robust_demo, name), getattr(jax_robust, name))


@pytest.mark.parametrize("name", ["open_loop_parking", "mismatch_open_loop"])
def test_open_loop_parking_matches_jax(name):
    u, xa, xb, rel = getattr(session4, name)(N=12, ts=0.1, sqp_iters=6, **F64)
    ju, jxa, jxb, jrel = getattr(jax_s4, name)(N=12, ts=0.1, sqp_iters=6, dtype=jnp.float64)
    assert u.shape == (12, 2) and xa.shape == xb.shape == (13, 4) and rel.shape == (13,)
    for a, b in ((u, ju), (xa, jxa), (xb, jxb), (rel, jrel)):
        close(a, b, 1e-6)
    assert float(u[:, 0].abs().max()) <= 1.0 + 1e-4
    if name == "mismatch_open_loop":
        assert rel[1:].max() > 0.0


@pytest.mark.parametrize("variant, solver", [("sol", "sqp"), ("main", "sqp")])
def test_closed_loop_parking_matches_jax(variant, solver):
    res, _, _ = session4.closed_loop_parking(variant=variant, steps=2, sqp_iters=2, qp_iters=10,
                                             solver=solver, **F64)
    want, _, _ = jax_s4.closed_loop_parking(variant=variant, steps=2, sqp_iters=2, qp_iters=10,
                                            solver=solver, dtype=jnp.float64)
    close(res.states, want.states, 1e-6)
    close(res.inputs, want.inputs, 1e-6)
    start = session4.SOL_X0 if variant == "sol" else session4.MAIN_X0
    np.testing.assert_array_equal(res.states[0].numpy(), np.asarray(start))


def test_estimation_demo_on_the_jax_draws():
    """The demo on the JAX driver's own noises (``jax.random`` from the
    seed), float64: every summary field equal to the JAX one's 5 digits."""
    steps, seed = 30, 0
    kw, kv = jax.random.split(jax.random.PRNGKey(seed))
    ws = 0.02 * jax.random.normal(kw, (steps, 2), jnp.float64)
    vs = 0.1 * jax.random.normal(kv, (steps, 1), jnp.float64)
    got = estimation_demo.run(N=10, steps=steps, seed=seed, noise=(ws, vs), **F64)
    want = jax_est.run(N=10, steps=steps, seed=seed, dtype=jnp.float64)
    assert got.keys() == want.keys()
    assert got["experiment"] == want["experiment"]
    for k in want.keys() - {"experiment"}:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, err_msg=k)
    # the port's own draws (a torch generator) give a run of the same quality
    own = estimation_demo.run(N=10, steps=steps, generator=torch.Generator().manual_seed(3),
                              **F64)
    assert own["success_rate"] == 1.0 and own["est_rmse_pos"] < 0.1


def test_robust_demo_matches_jax():
    """Sections 1-3 on the same numpy draws, float64: every summary field
    within 1e-8 (the violation shares exactly)."""
    _, got = robust_demo.run(batch=4, steps=8, iters=120, nonlinear=False, **F64)
    _, want = jax_robust.run(batch=4, steps=8, iters=120, nonlinear=False, dtype=jnp.float64)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k])
    assert got["bounded.tube_violation_frac"] == 0.0


def test_nonlinear_offset_free_demo_matches_jax():
    got = robust_demo.nonlinear_offset_free_demo(steps=2, N=6, **F64)
    want = jax_robust.nonlinear_offset_free_demo(steps=2, N=6, dtype=jnp.float64)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k], 1e-6)


@pytest.mark.parametrize("dynamic", [False, True])
def test_racing_run_matches_jax(dynamic):
    steps, N = (2, 4) if dynamic else (3, 5)
    res, got = racing.run(steps=steps, N=N, dynamic=dynamic, **F64)
    jres, want = jax_racing.run(steps=steps, N=N, dynamic=dynamic, dtype=jnp.float64)
    assert got.keys() == want.keys()
    close(res.states, jres.states, 1e-6)
    for k in ("mean_tracking_error_m", "max_tracking_error_m", "success_rate"):
        close(got[k], want[k], 1e-6)
    assert got["unstable"] == want["unstable"]


def test_crosswind_comparison_matches_jax():
    got = racing.crosswind_comparison(steps=3, N=5, **F64)
    want = jax_racing.crosswind_comparison(steps=3, N=5, dtype=jnp.float64)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k], 1e-6)


def test_experiment_entry_points_raise_for_nothing():
    """``experiments/racing.py`` has no refusal left."""
    import inspect

    assert "NotImplementedError" not in inspect.getsource(racing)
    assert dataclasses.is_dataclass(racing.VehicleParameters())
