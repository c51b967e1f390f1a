"""The slack-softened controller's batched closed loop in the port against
the JAX package, from 16 starts near the braking wall where the slacks
engage, each backend against the JAX backend of the same algorithm (as
tests/test_torch_closed_loop.py pairs them): the port's twin of the fused
kernel (``backend="cuda"`` on CPU tensors) against the JAX Pallas kernel in
interpret mode, float32, and the port's per-scenario path against JAX's
(``backend="xla"``), float64. The two algorithms exit at different iterates within
the success tolerance ``1e-4·(1 + ‖q‖∞)``, and in closed loop that moves a
few scenarios by up to 0.8 between JAX's own two backends here, so a
kernel path is not held to the per-scenario path.

Bars are tests/test_torch_closed_loop.py's: states within 5e-2, inputs
within 3e-2, success masks equal on at least 95% of the (step, scenario)
entries. The slacks' maxima within 5e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.control.batch_loop import simulate_batch as jax_simulate
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.convert import from_jax_arrays
from model_predictive_control_tpu_torch.ops.condensed import CondensedQP, SoftCondensedQP
from model_predictive_control_tpu_torch.solvers.linear_mpc import LinearMPC
from model_predictive_control_tpu_torch.solvers.qp import QPOperator

B, STEPS, TILE, N, ITERS = 16, 12, 8, 8, 200


@pytest.fixture(scope="module")
def setup():
    """The JAX soft controller (float32, the default slack weights) and the
    port's on the same QP data and operator (copied across), and 16
    starts."""
    problem = mpc.session2_problem(N=N)
    ctrl_j = mpc.make_linear_mpc(problem, iters=ITERS, dtype=jnp.float32, soft_state=True)
    base = from_jax_arrays(ctrl_j.qp.base, CondensedQP, device="cpu")
    qp = SoftCondensedQP(P=torch.as_tensor(np.array(ctrl_j.qp.P)),
                         A_c=torch.as_tensor(np.array(ctrl_j.qp.A_c)), base=base,
                         slack_linear=float(ctrl_j.qp.slack_linear))
    ctrl_t = LinearMPC(qp=qp, op=from_jax_arrays(ctrl_j.op, QPOperator, device="cpu"),
                       iters=ITERS, soft=True)
    rng = np.random.default_rng(3)
    x0 = np.stack([rng.uniform(-40.0, 0.5, B), rng.uniform(5.0, 24.0, B)], axis=1)
    return problem, ctrl_j, ctrl_t, x0.astype(np.float32)


def _port_loop(problem, ctrl_t, x0, backend="cuda", dtype=torch.float32):
    xt = torch.as_tensor(x0)
    carry = ctrl_t.presolve_batch_carry(xt, iters_mult=3, backend=backend, tile=TILE)
    system = port.session2_problem(N=N).system(dtype, device="cpu")
    return port.simulate_batch(xt, system, STEPS,
                               ctrl_t.batched_policy(backend=backend, tile=TILE), carry)


def _gate(got, ref):
    np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), atol=5e-2)
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=3e-2)
    s_ref = np.asarray(ref.logs["solver_success"])
    s_got = got.logs["solver_success"].numpy()
    assert (s_ref == s_got).mean() >= 0.95
    np.testing.assert_allclose(got.logs["max_slack"].numpy(), np.asarray(ref.logs["max_slack"]),
                               atol=5e-2)
    assert float(got.logs["max_slack"].max()) > 1e-2  # the slacks engaged


def test_xla_backend_matches_jax_xla_backend(setup):
    """The per-scenario path in float64 on both sides. In float32 its
    warm-started solves stop at iterates that differ within the success
    tolerance, and three of the 16 scenarios move by up to 0.8 in closed loop
    (as between JAX's own two backends); in float64 the two packages agree
    to 1e-12."""
    problem, _, _, x0 = setup
    ctrl_j = mpc.make_linear_mpc(problem, iters=ITERS, dtype=jnp.float64, soft_state=True)
    ctrl_t = port.make_linear_mpc(port.session2_problem(N=N), iters=ITERS, dtype=torch.float64,
                                  soft_state=True, device="cpu")
    x0 = x0.astype(np.float64)
    ref = jax_simulate(
        jnp.asarray(x0), problem.system(jnp.float64), STEPS,
        ctrl_j.batched_policy(backend="xla"),
        ctrl_j.presolve_batch_carry(jnp.asarray(x0), iters_mult=3, backend="xla"),
    )
    _gate(_port_loop(problem, ctrl_t, x0, backend="xla", dtype=torch.float64), ref)


def test_twin_matches_jax_pallas_interpret(setup):
    problem, ctrl_j, ctrl_t, x0 = setup
    xj = jnp.asarray(x0)
    ref = jax_simulate(
        xj, problem.system(jnp.float32), STEPS,
        ctrl_j.batched_policy(backend="pallas", tile=TILE),
        ctrl_j.presolve_batch_carry(xj, iters_mult=3, tile=TILE),
    )
    _gate(_port_loop(problem, ctrl_t, x0), ref)
