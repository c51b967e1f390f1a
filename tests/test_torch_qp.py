"""Port parity: Ruiz scaling, operator setup and the batched per-scenario
ADMM path against the JAX package and the float64 oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.oracle.qp_oracle import solve_qp_np
from model_predictive_control_tpu.solvers import qp as jqp
from model_predictive_control_tpu_torch.convert import from_jax_arrays
from model_predictive_control_tpu_torch.solvers.qp import (
    QPOperator,
    admm_solve,
    qp_setup,
    ruiz_equilibrate,
)

from tests.test_qp import random_qp

f64 = torch.float64


def _mpc_qp():
    ctrl = mpc.make_linear_mpc(mpc.session2_problem(N=8), dtype=jnp.float64)
    return np.array(ctrl.qp.P), np.array(ctrl.qp.A_c)


def _qp_data(kind):
    if kind == "mpc":
        return _mpc_qp()
    P, A, *_ = random_qp(np.random.default_rng(0))
    return P, A


@pytest.mark.parametrize("kind", ["random", "mpc"])
def test_ruiz_equilibrate_matches_jax(kind):
    P, A = _qp_data(kind)
    ref = jqp.ruiz_equilibrate(jnp.asarray(P), jnp.asarray(A))
    got = ruiz_equilibrate(torch.as_tensor(P), torch.as_tensor(A))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)


@pytest.mark.parametrize("kind", ["random", "mpc"])
def test_qp_setup_matches_jax(kind):
    """Float64 operators agree to 1e-9 relative to each array's own scale:
    the ρ-ladder inverses carry the matrices' condition numbers."""
    P, A = _qp_data(kind)
    ref = jqp.qp_setup(jnp.asarray(P), jnp.asarray(A), rho=0.035)
    got = qp_setup(torch.as_tensor(P), torch.as_tensor(A), rho=0.035)
    assert got.rho_init_idx == int(ref.rho_init_idx)
    for name in ("P_s", "A_s", "D", "E", "c", "rho_levels", "sigma",
                 "Minv_stack", "Pinv_s", "S"):
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        np.testing.assert_allclose(
            g, r, rtol=0, atol=1e-9 * max(1.0, np.abs(r).max()), err_msg=name
        )


def _batched(seed, B=8, one_sided=True):
    rng = np.random.default_rng(seed)
    P, A, _, l, u = random_qp(rng, one_sided=one_sided)
    qs = rng.normal(size=(B, P.shape[0]))
    return P, A, qs, np.tile(l, (B, 1)), np.tile(u, (B, 1))


@pytest.mark.parametrize("seed", [0, 1, 3, 4])
def test_batched_admm_matches_jax_and_oracle(seed):
    """Same operator (converted from JAX), same inputs, float64: the batched
    port matches vmap(admm_solve) and the oracle within 2e-4."""
    P, A, qs, ls, us = _batched(seed)
    op_j = jqp.qp_setup(jnp.asarray(P), jnp.asarray(A))
    op_t = from_jax_arrays(op_j, QPOperator, dtype=f64, device="cpu")
    ref = jax.vmap(lambda q, l, u: jqp.admm_solve(op_j, q, l, u, iters=400))(
        *map(jnp.asarray, (qs, ls, us))
    )
    got = admm_solve(op_t, *map(torch.as_tensor, (qs, ls, us)), iters=400)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=2e-4)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert got.converged.all()
    for i in range(qs.shape[0]):
        x_ref, _ = solve_qp_np(P, qs[i], A, ls[i], us[i])
        np.testing.assert_allclose(got.x[i].numpy(), x_ref, atol=2e-4)


def test_batched_admm_warm_start_float32():
    """Float32 with a warm start and no polish, as the closed loop runs it."""
    P, A, qs, ls, us = _batched(5, one_sided=False)
    op_j = jqp.qp_setup(jnp.asarray(P, jnp.float32), jnp.asarray(A, jnp.float32))
    op_t = from_jax_arrays(op_j, QPOperator, device="cpu")
    j32 = lambda a: jnp.asarray(a, jnp.float32)
    t32 = lambda a: torch.as_tensor(np.array(a), dtype=torch.float32)
    cold = jax.vmap(lambda q, l, u: jqp.admm_solve(op_j, q, l, u, iters=300))(
        *map(j32, (qs, ls, us))
    )
    ref = jax.vmap(
        lambda q, l, u, wx, wy: jqp.admm_solve(
            op_j, q, l, u, iters=40, polish=False, warm=(wx, wy)
        )
    )(*map(j32, (qs, ls, us)), cold.x, cold.y)
    got = admm_solve(
        op_t, *map(t32, (qs, ls, us)), iters=40, polish=False,
        warm=(t32(np.asarray(cold.x)), t32(np.asarray(cold.y))),
    )
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=2e-4)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
