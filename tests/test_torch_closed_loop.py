"""The port's main path as a whole against the JAX closed loop: sorted by the
compaction key, cold presolve, then 12 receding-horizon steps through the
fused-kernel policy (the port's twin on the CPU, the JAX Pallas kernel in
interpret mode), same operator, same tile.

Gates are those of test_batched_closed_loop_matches_scalar_path: states
within 5e-2, inputs within 3e-2 (two paths may sit on different sides of an
active bound mid-transient); success masks agree on at least 95% of the
(step, scenario) entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.control.batch_loop import simulate_batch as jax_simulate
from model_predictive_control_tpu.parallel.batch import (
    boundary_compaction_key as jax_key,
)
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.convert import from_jax_arrays
from model_predictive_control_tpu_torch.ops.condensed import CondensedQP
from model_predictive_control_tpu_torch.solvers.linear_mpc import LinearMPC
from model_predictive_control_tpu_torch.solvers.qp import QPOperator

B, STEPS, TILE, N, ITERS = 16, 12, 8, 8, 150

POLICIES = {
    # the JAX closed-loop test's policy: adaptive ρ, polish on
    "polished": dict(),
    # the main path's warm-loop flags: fixed ρ, no polish, 8-iteration probe
    "hot": dict(max_rho_moves=0, polish=False, probe_iters=8),
}


@pytest.fixture(scope="module")
def setup():
    problem = mpc.session2_problem(N=N)
    ctrl_j = mpc.make_linear_mpc(problem, iters=ITERS, dtype=jnp.float32)
    ctrl_t = LinearMPC(
        qp=from_jax_arrays(ctrl_j.qp, CondensedQP, device="cpu"),
        op=from_jax_arrays(ctrl_j.op, QPOperator, device="cpu"),
        iters=ITERS,
    )
    rng = np.random.default_rng(0)
    x0 = np.stack(
        [rng.uniform(-140, -20, B), rng.uniform(-15, 24, B)], axis=1
    ).astype(np.float32)
    return problem, ctrl_j, ctrl_t, x0


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_closed_loop_matches_jax(setup, policy):
    problem, ctrl_j, ctrl_t, x0 = setup
    kw = POLICIES[policy]

    xj = jnp.asarray(x0)
    xj = xj[jnp.argsort(jax_key(problem.p_max, xj))]
    carry_j = ctrl_j.presolve_batch_carry(xj, iters_mult=3, tile=TILE)
    ref = jax_simulate(
        xj, problem.system(jnp.float32), STEPS,
        ctrl_j.batched_policy(backend="pallas", tile=TILE, **kw), carry_j,
    )

    xt = torch.as_tensor(x0)
    xt = xt[torch.argsort(port.boundary_compaction_key(problem.p_max, xt), stable=True)]
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    carry_t = ctrl_t.presolve_batch_carry(xt, iters_mult=3, tile=TILE)
    system = port.session2_problem(N=N).system(device="cpu")
    got = port.simulate_batch(
        xt, system, STEPS, ctrl_t.batched_policy(tile=TILE, **kw), carry_t, batched_dynamics=True
    )

    assert got.states.shape == (STEPS + 1, B, 2)
    assert got.inputs.shape == (STEPS, B, 1)
    assert got.logs["solver_success"].shape == (STEPS, B)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), atol=5e-2)
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=3e-2)
    s_ref = np.asarray(ref.logs["solver_success"])
    s_got = got.logs["solver_success"].numpy()
    assert (s_ref == s_got).mean() >= 0.95
    assert s_got.mean() > 0.8


def test_xla_backend_matches_jax(setup):
    """backend="xla": the per-scenario batched admm_solve drives the same
    loop and follows JAX's vmap(admm_solve) backend."""
    problem, ctrl_j, ctrl_t, _ = setup
    x0 = np.asarray([[-80.0, 10.0], [-50.0, -5.0]], np.float32)
    ref = jax_simulate(
        jnp.asarray(x0), problem.system(jnp.float32), 8,
        ctrl_j.batched_policy(backend="xla"), ctrl_j.initial_batch_carry(2),
    )
    got = port.simulate_batch(
        torch.as_tensor(x0), port.session2_problem(N=N).system(device="cpu"), 8,
        ctrl_t.batched_policy(backend="xla"), ctrl_t.initial_batch_carry(2, device="cpu"),
        batched_dynamics=True,
    )
    np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), atol=5e-2)
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=3e-2)
    assert got.logs["solver_success"][2:].float().mean() > 0.9


def test_unported_options_raise():
    """What the port still lacks raises, naming its ROADMAP item: the
    differentiable policy (S5) and the parallel-in-horizon stagewise solver
    (S6). The linear MPC options of S2 build."""
    problem = port.session2_problem(N=4)
    ctrl = port.make_linear_mpc(problem, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP S5"):
        ctrl.policy(differentiable=True)
    with pytest.raises(NotImplementedError, match="ROADMAP S5"):
        ctrl.solve(torch.zeros(2), implicit=True)
    with pytest.raises(NotImplementedError, match="ROADMAP S6"):
        port.make_stagewise_mpc(problem, parallel=True, device="cpu")
    for kw in ({"terminal": "dare"}, {"soft_state": True}, {"terminal_set": True},
               {"solver": "pdip"}, {"x_ref": (-1.0, 0.0)}):
        port.make_linear_mpc(problem, device="cpu", **kw)


def test_port_builds_the_same_controller():
    """make_linear_mpc in the port builds the JAX controller's QP family and
    operator (float64 build on both sides)."""
    problem = mpc.session2_problem(N=N)
    ref = mpc.make_linear_mpc(problem, iters=80, rho=0.035, dtype=jnp.float64)
    got = port.make_linear_mpc(
        port.session2_problem(N=N), iters=80, rho=0.035, dtype=torch.float64, device="cpu"
    )
    np.testing.assert_allclose(got.qp.P.numpy(), np.asarray(ref.qp.P), atol=1e-10)
    for name in ("D", "E", "Minv_stack", "S"):
        r = np.asarray(getattr(ref.op, name))
        np.testing.assert_allclose(
            getattr(got.op, name).numpy(), r, atol=1e-9 * np.abs(r).max()
        )


@pytest.mark.parametrize("batched", [False, True])
def test_per_scenario_dynamics_are_vmapped_like_jax(batched):
    """``batched_dynamics=False`` maps a per-scenario plant over the batch, as
    the JAX loop ``vmap``s it; ``True`` hands it the batch. At B = nx a
    plant that indexes ``x[0]`` as a state component tells the two apart:
    f(x, u) = [x₀ + 0.1·x₁, x₁ + 0.1·u₀], u = −v, from [[2, 1], [3, −1]]."""
    x0 = np.asarray([[2.0, 1.0], [3.0, -1.0]], np.float32)
    f_j = lambda x, u: jnp.stack([x[0] + 0.1 * x[1], x[1] + 0.1 * u[0]])
    f_t = lambda x, u: torch.stack([x[0] + 0.1 * x[1], x[1] + 0.1 * u[0]])
    policy = lambda x, t, c: (-x[:, 1:], c, {"v": x[:, 1]})  # either array type
    ref = jax_simulate(jnp.asarray(x0), f_j, 3, policy, (), batched_dynamics=batched)
    got = port.simulate_batch(torch.as_tensor(x0), f_t, 3, policy, (), batched_dynamics=batched)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.logs["v"].numpy(), np.asarray(ref.logs["v"]), rtol=0, atol=1e-6)
    if not batched:  # one step of the per-scenario plant, by hand
        np.testing.assert_allclose(got.states[1].numpy(), [[2.1, 0.9], [2.9, -0.9]], atol=1e-6)
