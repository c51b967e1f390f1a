"""The parking OCPs and their controllers (``solvers/parking.py``,
``solvers/sqp.py``) and the per-scenario route of the parking policy and
sweep, against the JAX package's, in float64 on the scenarios of
``tests/test_parking.py`` (the obstacle and the plain OCP) at reduced
iterations.

Tolerances: the OCP functions (residual, constraints, dynamics, costs,
constraint rows) within 1e-12; SQP and AL-iLQR solves and the receding-
horizon closed loops within 1e-6 in u and states (the same algorithms; the
interior point's LU solves round apart from XLA's); the per-scenario parking
policy with a perturbed ``length`` (the route JAX falls back to) within
1e-6. ``parking_sweep(u_seed=...)`` equals the closed loop run from that
seeded carry.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.parallel.batch import batched_parking_policy as jax_policy
from model_predictive_control_tpu.solvers import parking as JP
from model_predictive_control_tpu.solvers.sqp import sqp_solve as jax_sqp_solve

import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.models.bicycle import kinematic_bicycle_ode
from model_predictive_control_tpu_torch.models.parameters import VehicleParameters
from model_predictive_control_tpu_torch.ops.integrators import rk4_fine
from model_predictive_control_tpu_torch.parallel import batch as PB
from model_predictive_control_tpu_torch.solvers import parking as TP

X0 = np.array([0.3, -0.1, 0.0, 0.0])
X_OBS = (0.25, 0.0, 0.0, 0.0)
CASES = {"obstacle": (8, 0.08, X_OBS), "plain": (6, 0.05, None)}


def _both(case, maker):
    N, ts, obs = CASES[case]
    t = getattr(TP, maker)(VehicleParameters(), N, ts, x_obs=obs, dtype=torch.float64,
                           device="cpu")
    j = getattr(JP, maker)(mpc.VehicleParameters(), N, ts,
                           x_obs=None if obs is None else jnp.asarray(obs), dtype=jnp.float64)
    return N, t, j


@pytest.mark.parametrize("case", list(CASES))
def test_ocp_functions_match_jax(case):
    N, ocp, jocp = _both(case, "make_parking_ocp")
    rng = np.random.default_rng(0)
    u = rng.uniform(-0.5, 0.5, 2 * N)
    tu, tx = torch.tensor(u)[None], torch.tensor(X0)[None]
    r = torch.func.vmap(ocp.residual)(tu, tx, {})[0]
    c = torch.func.vmap(ocp.constraints)(tu, tx, {})[0]
    np.testing.assert_allclose(r.numpy(), np.asarray(jocp.residual(jnp.asarray(u), jnp.asarray(X0))),
                               atol=1e-12)
    np.testing.assert_allclose(c.numpy(), np.asarray(jocp.constraints(jnp.asarray(u),
                                                                      jnp.asarray(X0))), atol=1e-12)
    for name in ("l_c", "u_c", "l_u", "u_u"):
        np.testing.assert_array_equal(getattr(ocp, name).numpy(), np.asarray(getattr(jocp, name)))

    N, (prob, cons, nc), (jprob, jcons, jnc) = _both(case, "make_parking_ilqr")
    assert nc == jnc
    x, uu = torch.tensor(X0) + 0.1, torch.tensor([0.3, -0.2], dtype=torch.float64)
    jx, ju = jnp.asarray(x.numpy()), jnp.asarray(uu.numpy())
    np.testing.assert_allclose(prob.dynamics(x, uu, {}).numpy(),
                               np.asarray(jprob.dynamics(jx, ju, 0)), atol=1e-12)
    assert abs(prob.stage_cost(x, uu, {}, {}).item() - float(jprob.stage_cost(jx, ju, 0))) < 1e-12
    assert abs(prob.terminal_cost(x, {}).item() - float(jprob.terminal_cost(jx))) < 1e-12
    np.testing.assert_allclose(cons(x, uu, {}, {}).numpy(), np.asarray(jcons(jx, ju, 0)),
                               atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_sqp_solve_matches_jax(case):
    N, ocp, jocp = _both(case, "make_parking_ocp")
    sol = port.sqp_solve(ocp, torch.tensor(X0)[None], iters=6, qp_iters=20)
    ref = jax_sqp_solve(jocp, jnp.asarray(X0), iters=6, qp_iters=20)
    assert sol.u.shape == (1, 2 * N)
    np.testing.assert_allclose(sol.u[0].numpy(), np.asarray(ref.u), atol=1e-6)
    assert abs(sol.cost[0].item() - float(ref.cost)) < 1e-6
    np.testing.assert_allclose(sol.kkt_res[0].item(), float(ref.kkt_res), rtol=1e-4, atol=1e-9)
    assert bool(sol.converged[0]) == bool(ref.converged)


def _closed_loop(ctrl, jctrl, steps, carry_dtype):
    plant = rk4_fine(lambda x, u: kinematic_bicycle_ode(VehicleParameters(), x, u), 0.08)
    got = port.simulate(torch.tensor(X0), plant, steps, ctrl.policy(),
                        ctrl.initial_carry(torch.float64, "cpu"))
    jplant = mpc.ops.integrators.rk4_fine(
        lambda x, u: mpc.models.bicycle.kinematic_bicycle_ode(mpc.VehicleParameters(), x, u), 0.08)
    ref = mpc.simulate(jnp.asarray(X0), jplant, steps=steps, policy=jctrl.policy(),
                       policy_carry=jctrl.initial_carry(carry_dtype))
    return got, ref


def test_ilqr_mpc_closed_loop_matches_jax():
    N, (prob, cons, nc), (jprob, jcons, jnc) = _both("obstacle", "make_parking_ilqr")
    got, ref = _closed_loop(TP.ILQRMPC(prob, cons, nc, outer_iters=4, inner_iters=10),
                            JP.ILQRMPC(jprob, jcons, jnc, outer_iters=4, inner_iters=10), 3,
                            jnp.float64)
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=1e-6)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), atol=1e-6)
    np.testing.assert_array_equal(got.logs["solver_success"].numpy(),
                                  np.asarray(ref.logs["solver_success"]))


def test_nonlinear_mpc_closed_loop_matches_jax():
    N, ocp, jocp = _both("plain", "make_parking_ocp")
    got, ref = _closed_loop(TP.NonlinearMPC(ocp, sqp_iters=5, qp_iters=20),
                            JP.NonlinearMPC(jocp, sqp_iters=5, qp_iters=20), 2, jnp.float64)
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=1e-6)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), atol=1e-6)


@pytest.mark.parametrize("solver, backend", [("sqp", "cuda"), ("ilqr", "torch")])
def test_per_scenario_policy_matches_jax(solver, backend):
    """The per-scenario route with a perturbed ``length`` (JAX falls back to
    it from the kernel) in float64: one policy step of 3 scenarios."""
    N, B = 6, 3
    lengths = np.array([0.15, 0.17, 0.19])
    jparams = dataclasses.replace(mpc.VehicleParameters(), length=jnp.asarray(lengths))
    tparams = dataclasses.replace(VehicleParameters(), length=torch.tensor(lengths))
    rng = np.random.default_rng(1)
    # starts outside the clearance circle, as the sweep draws them (a start
    # in collision makes the QP subproblem infeasible in both packages)
    x = PB.project_clear(torch.tensor(X0 + rng.uniform(-0.05, 0.05, (B, 4))), X_OBS, 0.22).numpy()
    kw = dict(N=N, ts=0.08, x_obs=X_OBS, solver=solver, sqp_iters=4, qp_iters=20,
              outer_iters=3, inner_iters=6)
    pol = PB.batched_parking_policy(tparams, backend=backend, dtype=torch.float64, **kw)
    jpol = jax_policy(jparams, backend="xla", dtype=jnp.float64, **{**kw, "x_obs": jnp.asarray(X_OBS)})
    carry = pol.initial_carry(B, device="cpu")
    assert carry.shape == (B, N * 2) and carry.dtype == torch.float64
    u, warm, aux = pol(torch.tensor(x), 0, carry)
    ju, jwarm, jaux = jpol(jnp.asarray(x), 0, jnp.zeros((B, N * 2)))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-6)
    np.testing.assert_allclose(warm.numpy(), np.asarray(jwarm), atol=1e-6)
    np.testing.assert_array_equal(aux["solver_success"].numpy(), np.asarray(jaux["solver_success"]))
    assert bool(torch.isfinite(aux["viol"]).all())


def test_kernel_request_it_cannot_serve_raises():
    """A kernel backend with another dtype or a field the kernel has no
    operand for raises, naming the per-scenario route (the JAX package falls
    back to it); ``backend="torch"`` takes both (carry: controls alone); the
    kernel takes per-scenario acceleration and friction (carry with λ)."""
    base = VehicleParameters()
    knows = dataclasses.replace(base, acceleration=torch.full((2,), 2.0),
                                friction=torch.full((2,), 0.5))
    kernel = PB.batched_parking_policy(knows, 4, 0.08)
    assert isinstance(kernel.initial_carry(2, device="cpu"), tuple)
    for params, dtype, match in (
            (base, torch.float64, "float32 only"),
            (dataclasses.replace(base, width=torch.full((2,), 0.08)), torch.float32, "width")):
        for backend in ("cuda", "twin"):
            with pytest.raises(ValueError, match=f"{match}.*backend='torch'"):
                PB.batched_parking_policy(params, 4, 0.08, backend=backend, dtype=dtype)
        pol = PB.batched_parking_policy(params, 4, 0.08, backend="torch", dtype=dtype)
        assert not isinstance(pol.initial_carry(2, device="cpu"), tuple)
    with pytest.raises(ValueError, match="backend='torch'"):
        PB.batched_parking_policy(base, 4, 0.08, backend="xla")


def test_parking_sweep_u_seed():
    """``u_seed`` replaces the step-0 warm controls (the multipliers stay
    zero): the sweep equals the closed loop from that seeded carry."""
    B, N, steps = 2, 4, 2
    seed = torch.tensor(np.random.default_rng(2).uniform(-0.2, 0.2, (B, N, 2)), dtype=torch.float32)
    kw = dict(N=N, outer_iters=2, inner_iters=3, plant_substeps=2, device="cpu")
    res, _ = port.parking_sweep(B, steps, u_seed=seed, **kw)
    plain, _ = port.parking_sweep(B, steps, **kw)
    g = torch.Generator().manual_seed(0)
    plant = PB.perturb_parameters(g, VehicleParameters(), B, device="cpu")
    x0 = PB.random_initial_states(g, B, x_obs=X_OBS, device="cpu")
    pol = PB.batched_parking_policy(VehicleParameters(), N, 0.08, x_obs=X_OBS, outer_iters=2,
                                    inner_iters=3)
    carry = (seed.reshape(B, N * 2), pol.initial_carry(B, device="cpu")[1])
    want = port.simulate_batch(x0, PB.batched_plant(plant, 0.08, substeps=2), steps, pol, carry,
                               batched_dynamics=True)
    assert torch.equal(res.states, want.states) and not torch.equal(res.states, plain.states)
