"""The port's offset-free and rate-limited controllers against the JAX
package on the same inputs.

Gates:
- the set-up (the augmented observer gain, the target maps, the rate QP's
  Hessian, constraint stack and bounds) within 1e-9, float64 on both sides;
- the single-scenario policies in closed loop, float64 ADMM on both sides:
  u within 1e-4 (ROADMAP's bar for u-trajectories against the float64
  oracles), and the JAX tests' own outcomes (the offset removed and the
  bias found within 1e-3; the rate bound held within 1e-5);
- the batched policies: the per-scenario path (``backend="xla"``) in
  float64 against JAX's within 1e-4; the fused kernel's twin (float32)
  against the JAX Pallas kernel in interpret mode on
  tests/test_torch_closed_loop.py's bars (states 5e-2, inputs 3e-2; the
  rate-limited loop on its JAX test's outcomes and band) and the JAX tests'
  outcomes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.control.batch_loop import simulate_batch as jax_simulate
from model_predictive_control_tpu.solvers.offset_free import make_offset_free_mpc as jax_of
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.control.simulate import simulate
from model_predictive_control_tpu_torch.solvers.offset_free import make_offset_free_mpc
from model_predictive_control_tpu_torch.solvers.rate_mpc import make_rate_limited_mpc

D_TRUE, R_POS = 1.5, -5.0
X0 = np.array([-20.0, 0.0])


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want[np.isfinite(want)]).max()))


def _offset_free(dtype_j=jnp.float64, dtype_t=torch.float64, N=8):
    cj = jax_of(mpc.session2_problem(N=N), r=R_POS, iters=300, dtype=dtype_j)
    ct = make_offset_free_mpc(port.session2_problem(N=N), r=R_POS, iters=300, dtype=dtype_t,
                              device="cpu")
    return cj, ct


def test_offset_free_builds_the_same_observer_and_targets():
    cj, ct = _offset_free()
    for name in ("L", "T_d", "T_r", "r", "Bd", "Cd"):
        _close(getattr(ct, name), getattr(cj, name), 1e-9)
    _close(ct.inner.terminal_P, cj.inner.terminal_P, 1e-9)
    with pytest.raises(ValueError, match="singular"):
        make_offset_free_mpc(port.session2_problem(N=8), r=0.0, H=[[0.0, 0.0]], device="cpu")


def test_offset_free_policy_matches_jax():
    """80 steps on a plant with an actuator bias of 1.5."""
    cj, ct = _offset_free()
    sj = mpc.session2_problem(N=8).system(jnp.float64)
    st = port.session2_problem(N=8).system(torch.float64, "cpu")
    ref = mpc.simulate(jnp.asarray(X0), lambda x, u: sj.A @ x + sj.B @ (u + D_TRUE), 80,
                       cj.policy(), cj.initial_carry(jnp.asarray(X0), jnp.float64))
    got = simulate(torch.as_tensor(X0), lambda x, u: st.A @ x + st.B @ (u + D_TRUE), 80,
                   ct.policy(), ct.initial_carry(X0, torch.float64))
    assert set(got.logs) == set(ref.logs)
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=1e-4)
    assert bool(got.logs["solver_success"].all())
    assert np.abs(got.states[-10:, 0].numpy() - R_POS).max() < 1e-3
    assert abs(float(got.logs["disturbance_estimate"][-1, 0]) - D_TRUE) < 1e-3


def test_offset_free_batched_over_bias_realizations():
    """Five bias levels, 60 steps: the per-scenario path in float64 within
    1e-4 of JAX's; the twin of the fused kernel (float32, tile 4) against
    the JAX Pallas kernel in interpret mode, each bias found and the
    reference held within 1e-2."""
    ds = np.array([-2.0, -0.5, 0.0, 1.0, 2.5])
    x0 = np.tile(X0, (5, 1))
    for dtype_j, dtype_t, backend_j, backend_t in ((jnp.float64, torch.float64, "xla", "xla"),
                                                   (jnp.float32, torch.float32, "pallas", "cuda")):
        cj, ct = _offset_free(dtype_j, dtype_t)
        sj = mpc.session2_problem(N=8).system(dtype_j)
        st = port.session2_problem(N=8).system(dtype_t, "cpu")
        dj, dt = jnp.asarray(ds, dtype_j), torch.as_tensor(ds, dtype=dtype_t)
        kw = {"tile": 4} if backend_j == "pallas" else {}
        ref = jax_simulate(jnp.asarray(x0, dtype_j), lambda x, u: x @ sj.A.T + (u + dj[:, None]) @ sj.B.T,
                           60, cj.batched_policy(backend=backend_j, **kw),
                           cj.initial_batch_carry(jnp.asarray(x0, dtype_j), dtype=dtype_j),
                           batched_dynamics=True)
        got = port.simulate_batch(torch.as_tensor(x0, dtype=dtype_t),
                                  lambda x, u: st(x, u + dt[:, None]), 60,
                                  ct.batched_policy(backend=backend_t, tile=4),
                                  ct.initial_batch_carry(torch.as_tensor(x0, dtype=dtype_t),
                                                         dtype=dtype_t), batched_dynamics=True)
        if backend_j == "xla":
            np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=1e-4)
        else:
            np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), atol=5e-2)
            np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=3e-2)
        np.testing.assert_allclose(got.states[-1, :, 0].numpy(), R_POS, atol=1e-2)
        np.testing.assert_allclose(got.logs["disturbance_estimate"][-1, :, 0].numpy(), ds,
                                   atol=1e-2)


def _rate(N, du_max, du_weight=None, iters=400, dtype_j=jnp.float64, dtype_t=torch.float64):
    cj = mpc.make_rate_limited_mpc(mpc.session2_problem(N=N), du_max=du_max, du_weight=du_weight,
                                   iters=iters, dtype=dtype_j)
    ct = make_rate_limited_mpc(port.session2_problem(N=N), du_max=du_max, du_weight=du_weight,
                               iters=iters, dtype=dtype_t, device="cpu")
    return cj, ct


@pytest.mark.parametrize("du_weight", [None, 0.5])
def test_rate_qp_and_solve_match_jax(du_weight):
    """The rate QP at N=20 (n + m = 100: the fused kernel's staged mode at
    7 columns) and a single solve."""
    cj, ct = _rate(20, 3.0, du_weight)
    for name in ("P", "A_c", "D", "q_uprev", "du_lb", "du_ub"):
        _close(getattr(ct.qp, name), getattr(cj.qp, name), 1e-9)
    for name in ("D", "E", "Minv_stack"):
        _close(getattr(ct.op, name), getattr(cj.op, name), 1e-9)
    x0, u_prev = np.array([-60.0, 5.0]), np.array([2.0])
    u_r, sol_r = cj.solve(jnp.asarray(x0), jnp.asarray(u_prev))
    u_g, sol_g = ct.solve(torch.as_tensor(x0), torch.as_tensor(u_prev))
    assert bool(sol_g.converged) and bool(sol_r.converged)
    np.testing.assert_allclose(u_g.numpy(), np.asarray(u_r), atol=1e-4)


def test_rate_policy_honors_the_bound_like_jax():
    cj, ct = _rate(20, 3.0)
    sj = mpc.session2_problem(N=20).system(jnp.float64)
    st = port.session2_problem(N=20).system(torch.float64, "cpu")
    ref = mpc.simulate(jnp.asarray([-60.0, 5.0]), sj, 60, cj.policy(),
                       cj.initial_carry(dtype=jnp.float64))
    got = simulate(torch.tensor([-60.0, 5.0], dtype=torch.float64), st, 60, ct.policy(),
                   ct.initial_carry(dtype=torch.float64, device="cpu"))
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=1e-4)
    assert bool(got.logs["solver_success"].all())
    assert float(got.logs["du"].abs().max()) <= 3.0 + 1e-5


def test_rate_batched_policy_matches_jax():
    """Three scenarios × 40 steps at N=12 (tests/test_rate_mpc.py's): the
    per-scenario path in float64 within 1e-4 of JAX's; the twin (float32,
    tile 4) held, as the JAX test holds the JAX kernel, on its outcomes
    beside the JAX kernel's in interpret mode: success at every step, the
    rate bound within 0.2 (the band tests/test_rate_mpc.py:103-105 names:
    the tile-batched path converges to ``eps_abs·scale`` ≈ 0.2 on the early
    cold steps), regulation, and the final states of both kernels within
    that band. Mid-run the two kernels (FP32 against bf16×3 products) stop
    at different points of the band and their inputs part by up to 0.6."""
    x0s = np.array([[-50.0, 4.0], [-30.0, -2.0], [-60.0, 6.0]])
    for dtype_j, dtype_t, backend_j, backend_t in ((jnp.float64, torch.float64, "xla", "xla"),
                                                   (jnp.float32, torch.float32, "pallas", "cuda")):
        cj, ct = _rate(12, 4.0, dtype_j=dtype_j, dtype_t=dtype_t)
        ref = jax_simulate(jnp.asarray(x0s, dtype_j), mpc.session2_problem(N=12).system(dtype_j),
                           40, cj.batched_policy(backend=backend_j, tile=4),
                           cj.initial_batch_carry(3, dtype=dtype_j))
        got = port.simulate_batch(torch.as_tensor(x0s, dtype=dtype_t),
                                  port.session2_problem(N=12).system(dtype_t, "cpu"), 40,
                                  ct.batched_policy(backend=backend_t, tile=4),
                                  ct.initial_batch_carry(3, dtype=dtype_t, device="cpu"),
                                  batched_dynamics=True)
        if backend_j == "xla":
            np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=1e-4)
        else:
            np.testing.assert_allclose(got.states[-1].numpy(), np.asarray(ref.states[-1]),
                                       atol=0.2)
            assert float(got.logs["du"].abs().max()) <= 4.0 + 0.2
            assert bool(np.asarray(ref.logs["solver_success"]).all())
        assert bool(got.logs["solver_success"].all())
        assert float(torch.linalg.vector_norm(got.states[-1], dim=1).max()) < 2.0
