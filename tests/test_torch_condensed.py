"""Port parity: prediction matrices, condensed QP and the per-scenario QP
vectors against the JAX package, in float64 (atol 1e-10)."""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.parallel.batch import (
    boundary_compaction_key as jax_key,
)
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.models.linear import session2_dynamics
from model_predictive_control_tpu_torch.ops.condensed import (
    build_condensed_qp,
    prediction_matrices,
)

ATOL = 1e-10
f64 = torch.float64


def _system(rng, nx=3, nu=2):
    A = np.eye(nx) + 0.2 * rng.normal(size=(nx, nx))
    B = rng.normal(size=(nx, nu))
    return A, B


def _both(a):
    return jnp.asarray(a), torch.as_tensor(a, dtype=f64)


@pytest.mark.parametrize("N", [1, 4, 8])
def test_prediction_matrices_match_jax(N):
    A, B = _system(np.random.default_rng(N))
    Phi_j, Gam_j = mpc.prediction_matrices(jnp.asarray(A), jnp.asarray(B), N)
    Phi_t, Gam_t = prediction_matrices(*map(lambda a: torch.as_tensor(a), (A, B)), N)
    np.testing.assert_allclose(Phi_t.numpy(), np.asarray(Phi_j), atol=ATOL)
    np.testing.assert_allclose(Gam_t.numpy(), np.asarray(Gam_j), atol=ATOL)


def _condensed_pair(N=8, seed=0):
    rng = np.random.default_rng(seed)
    A, B = _system(rng)
    nx, nu = B.shape
    L = rng.normal(size=(nx, nx))
    Q = L @ L.T + np.eye(nx)
    R = np.diag(rng.uniform(0.1, 1.0, nu))
    QN = 2.0 * Q
    box = dict(
        u_min=-rng.uniform(1, 2, nu), u_max=rng.uniform(1, 2, nu),
        x_min=-rng.uniform(5, 9, nx), x_max=rng.uniform(5, 9, nx),
    )
    qp_j = mpc.build_condensed_qp(
        *map(jnp.asarray, (A, B, Q, R, QN)), N,
        **{k: jnp.asarray(v) for k, v in box.items()},
    )
    t = lambda a: torch.as_tensor(a, dtype=f64)
    qp_t = build_condensed_qp(
        *map(t, (A, B, Q, R, QN)), N, **{k: t(v) for k, v in box.items()}
    )
    return qp_j, qp_t, rng


def test_build_condensed_qp_matches_jax():
    qp_j, qp_t, _ = _condensed_pair()
    for name in ("P", "A_c", "Phi", "Gamma", "QG", "q_x0", "q_const",
                 "u_lb", "u_ub", "x_lb", "x_ub"):
        np.testing.assert_allclose(
            getattr(qp_t, name).numpy(), np.asarray(getattr(qp_j, name)),
            atol=ATOL, err_msg=name,
        )
    assert (qp_t.N, qp_t.nx, qp_t.nu, qp_t.n, qp_t.m) == (
        qp_j.N, qp_j.nx, qp_j.nu, qp_j.n, qp_j.m
    )


def test_qp_vectors_batched_match_jax():
    qp_j, qp_t, rng = _condensed_pair(seed=3)
    x0 = rng.normal(size=(16, qp_t.nx)) * 4.0
    import jax

    ref = jax.vmap(qp_j.qp_vectors)(jnp.asarray(x0))
    got = qp_t.qp_vectors(torch.as_tensor(x0))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)


def test_session2_dynamics_steps_a_batch():
    sys_j = mpc.session2_dynamics(0.3, dtype=jnp.float64)
    sys_t = session2_dynamics(0.3, dtype=f64, device="cpu")
    rng = np.random.default_rng(1)
    x, u = rng.normal(size=(5, 2)), rng.normal(size=(5, 1))
    ref = np.stack([np.asarray(sys_j(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(x, u)])
    np.testing.assert_allclose(sys_t(*map(torch.as_tensor, (x, u))).numpy(), ref, atol=ATOL)


def test_compaction_order_matches_jnp_argsort():
    """Ties included: a stable torch.argsort gives jnp.argsort's lane order."""
    rng = np.random.default_rng(0)
    x0 = np.stack([rng.uniform(-140, -20, 64), rng.uniform(-15, 24, 64)], 1)
    x0[::4, 1] = -3.0  # v <= 0 rows with equal p tie on the key
    x0[::4, 0] = -50.0
    x0 = x0.astype(np.float32)
    order_j = np.asarray(jnp.argsort(jax_key(1.0, jnp.asarray(x0))))
    key_t = port.boundary_compaction_key(1.0, torch.as_tensor(x0))
    np.testing.assert_array_equal(torch.argsort(key_t, stable=True).numpy(), order_j)


def test_port_imports_no_jax():
    code = (
        "import sys, model_predictive_control_tpu_torch, "
        "model_predictive_control_tpu_torch.convert, "
        "model_predictive_control_tpu_torch.ops.cuda.ilqr_kernel, "
        "model_predictive_control_tpu_torch.parallel.batch, "
        "model_predictive_control_tpu_torch.oracle, "
        "model_predictive_control_tpu_torch.oracle._native_build, "
        "model_predictive_control_tpu_torch.oracle.lqr_oracle, "
        "model_predictive_control_tpu_torch.oracle.mpc_oracle, "
        "model_predictive_control_tpu_torch.oracle.native_nlp, "
        "model_predictive_control_tpu_torch.oracle.native_qp, "
        "model_predictive_control_tpu_torch.oracle.parking_oracle, "
        "model_predictive_control_tpu_torch.oracle.qp_oracle; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('model_predictive_control_tpu.') "
        "or m == 'model_predictive_control_tpu']; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=pathlib.Path(__file__).resolve().parents[1],
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
