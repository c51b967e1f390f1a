"""The port's weight tuning against the JAX package's.

Linear tier (float64): the closed-loop cost and its gradient through the
implicit ADMM solve agree within 1e-6 relative, and three Adam updates give
JAX's parameters within 1e-6 (``torch.optim.Adam`` is ``optax.adam``).

Parking tier: the fused forward's solve (the tracker kernel's twin here)
against the JAX package's ``make_fused_parking_forward`` on its Pallas
factory in interpret mode, at JAX's tile and a 4 × 2 budget where the two
float32 solves step alike (ROADMAP queue 3, PR 12): controls within 1.5e-6,
the multipliers in ``make_parking_ilqr``'s row order. The fused-forward
closed-loop loss and gradient against JAX's per-scenario (XLA) forward at
JAX's own bar (``tests/test_implicit_fused.py:70-86``): the kernel solves in
float32 to a 1e-4 AL tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu import tuning as TJ
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.convert import tune_result_from_jax, tuning_theta_from_jax
from model_predictive_control_tpu_torch.experiments import tuning as experiment

REL = 1e-6


def _linear_setup(B=3):
    rng = np.random.default_rng(3)
    x0s = np.stack([rng.uniform(-10.0, -2.0, B), rng.uniform(-2.0, 5.0, B)], axis=1)
    return x0s, np.diag([2.0, 6.0]), np.array([[1.5]])


@pytest.fixture(scope="module")
def linear_jax():
    """JAX's closed-loop cost and gradient (N=6, 4 steps, 3 starts) and three
    Adam updates from the session-2 weights."""
    x0s, tQ, tR = _linear_setup()
    problem = mpc.session2_problem(N=6)
    loss = TJ.make_closed_loop_cost(problem, jnp.asarray(x0s), 4, jnp.asarray(tQ),
                                    jnp.asarray(tR), iters=300)
    theta = jnp.log(jnp.asarray([4.0, 2.0, 0.1]))
    val, g = jax.jit(jax.value_and_grad(loss))(theta)
    res = TJ.tune_mpc_weights(problem, jnp.asarray(x0s), 4, jnp.asarray(tQ), jnp.asarray(tR),
                              updates=3, learning_rate=0.3, iters=300)
    return float(val), np.asarray(g), res


def test_closed_loop_cost_and_gradient_match_jax(linear_jax):
    val_j, g_j, _ = linear_jax
    x0s, tQ, tR = _linear_setup()
    loss = port.make_closed_loop_cost(port.session2_problem(N=6), torch.as_tensor(x0s), 4,
                                      torch.as_tensor(tQ), torch.as_tensor(tR), iters=300)
    theta = torch.log(torch.tensor([4.0, 2.0, 0.1], dtype=torch.float64)).requires_grad_(True)
    val = loss(theta)
    (g,) = torch.autograd.grad(val, theta)
    assert abs(float(val) - val_j) <= REL * (1.0 + abs(val_j))
    np.testing.assert_allclose(g.numpy(), g_j, rtol=0, atol=REL * (1.0 + np.abs(g_j).max()))


def test_three_adam_updates_match_optax(linear_jax):
    *_, res_j = linear_jax
    x0s, tQ, tR = _linear_setup()
    res = port.tune_mpc_weights(port.session2_problem(N=6), torch.as_tensor(x0s), 4,
                                torch.as_tensor(tQ), torch.as_tensor(tR), updates=3,
                                learning_rate=0.3, iters=300)
    want = tune_result_from_jax(res_j, device="cpu")
    assert res.losses.shape == (4,) and res.grads.shape == (3, 3)
    for name in ("theta", "Q", "R", "losses", "grads"):
        a, b = getattr(res, name), getattr(want, name)
        torch.testing.assert_close(a, b, rtol=0, atol=REL * (1.0 + float(b.abs().max())),
                                   msg=name)


def test_experiment_runs_and_reduces_the_cost():
    """``experiments/tuning.run`` on the CPU at a cut size: the summary's
    keys, and a cost that falls."""
    summary = experiment.run(N=6, steps=6, batch=3, updates=3, iters=300, dtype=torch.float64,
                             device="cpu")
    assert summary["experiment"] == "tuning" and summary["updates"] == 3
    assert summary["reduction"] > 0.0 and np.isfinite(summary["final_loss"])


PARK_X0S = np.array([[0.3, -0.1, 0.0, 0.0], [0.15, -0.2, -0.2, -0.02], [0.45, 0.12, 0.3, 0.05]])
TRUE_Q, TRUE_R = np.array([1.0, 3.0, 0.1, 0.01]), np.array([1.0, 0.01])
THETA = {"logQ": np.log([0.8, 2.0, 0.15, 0.02]), "logR": np.log([0.7, 0.02])}
JAX_TILE = 8  # tests/test_implicit_fused.py's tile: min(8, 128) in JAX's forward


def test_fused_forward_twin_matches_jax_factory():
    """The fused forward's solve at B=3, N=6, budget 4 × 2, tile 8: controls
    within 1.5e-6 of JAX's, the multipliers permuted to the OCP's row order
    alike, and the states and cost re-derived in float64."""
    N = 6
    kw = dict(N=N, ts=0.05, outer_iters=4, inner_iters=2, tile=JAX_TILE)
    sol_j = TJ.make_fused_parking_forward(**kw)(
        {k: jnp.asarray(v) for k, v in THETA.items()}, jnp.asarray(PARK_X0S),
        jnp.zeros((3, N, 2)))
    sol = port.make_fused_parking_forward(**kw)(
        tuning_theta_from_jax(THETA, device="cpu"), torch.as_tensor(PARK_X0S),
        torch.zeros(3, N, 2, dtype=torch.float64))
    assert sol.us.dtype == torch.float64 and sol.lams.shape == (3, N, 12)
    np.testing.assert_allclose(sol.us.numpy(), np.asarray(sol_j.us), rtol=0, atol=1.5e-6)
    np.testing.assert_allclose(sol.lams.numpy(), np.asarray(sol_j.lams), rtol=0, atol=1e-4)
    np.testing.assert_allclose(sol.xs.numpy(), np.asarray(sol_j.xs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sol.cost.numpy(), np.asarray(sol_j.cost), rtol=1e-5)
    np.testing.assert_array_equal(sol.converged.numpy(), np.asarray(sol_j.converged))


def test_fused_forward_loss_and_gradient_match_jax_xla_forward():
    """The fused-forward closed-loop loss (the kernel's twin) against JAX's
    per-scenario XLA forward, value and θ gradient, at 2 starts × 2 steps,
    N=4."""
    x0s, kw = PARK_X0S[:2], dict(steps=2, N=4, ts=0.05, outer_iters=8, inner_iters=30)
    loss_j = TJ.make_parking_closed_loop_cost(jnp.asarray(x0s), true_Q=jnp.asarray(TRUE_Q),
                                              true_R=jnp.asarray(TRUE_R), **kw)
    vx, gx = jax.jit(jax.value_and_grad(loss_j))({k: jnp.asarray(v) for k, v in THETA.items()})
    loss = port.make_parking_closed_loop_cost(torch.as_tensor(x0s), true_Q=TRUE_Q, true_R=TRUE_R,
                                              forward="fused", tile=JAX_TILE, **kw)
    theta = {k: v.requires_grad_(True) for k, v in
             tuning_theta_from_jax(THETA, device="cpu").items()}
    val = loss(theta)
    g = torch.autograd.grad(val, [theta["logQ"], theta["logR"]])
    assert abs(float(val) - float(vx)) <= 1e-3 * (1.0 + abs(float(vx)))
    for got, key in zip(g, ("logQ", "logR")):
        np.testing.assert_allclose(got.numpy(), np.asarray(gx[key]), rtol=5e-2, atol=5e-3)


def test_tune_parking_weights_fused_lowers_the_loss():
    """Two Adam updates on the fused forward at a cut size: finite losses,
    the trace's length, and the last below the first."""
    out = port.tune_parking_weights(torch.as_tensor(PARK_X0S[:2]), 2, TRUE_Q, TRUE_R, updates=2,
                                    learning_rate=0.15, N=4, forward="fused", tile=JAX_TILE)
    losses = out["losses"]
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    assert float(losses[-1]) < float(losses[0])
    assert set(out["theta"]) == {"logQ", "logR"} and out["Q"].shape == (4,)
