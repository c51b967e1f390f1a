"""The port's Riccati layer, LQR controllers and single-scenario simulation
against the JAX package on the same numpy-made inputs.

Gates: the Riccati recursion, the DARE (SDA), its residual, the gains, the
finite- and infinite-horizon solutions, the cost-to-go and the invariant LQR
terminal set at float64 within 1e-9 (both packages run the same float64
program; tests/test_lqr.py holds the JAX side to LAPACK at 1e-10). The
closed-loop ``simulate`` and the open-loop ``rollout`` at float32 within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.solvers.lqr import lqr_terminal_set as jax_terminal_set
from model_predictive_control_tpu_torch.control import simulate as S
from model_predictive_control_tpu_torch.models.linear import LinearSystem
from model_predictive_control_tpu_torch.ops import riccati as RT
from model_predictive_control_tpu_torch.solvers import lqr as L

TOL64, TOL32 = 1e-9, 1e-5


def _setup(seed=0, nx=3, nu=2):
    """A random stabilizable system, SPD weights."""
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.3 * rng.normal(size=(nx, nx))
    B = rng.normal(size=(nx, nu))
    Mq = rng.normal(size=(nx, nx))
    Q = Mq @ Mq.T + 0.5 * np.eye(nx)
    R = np.diag(rng.uniform(0.1, 1.0, nu))
    return A, B, Q, R


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol * max(1.0, np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("seed", [0, 1])
def test_riccati_recursion_and_gain(seed):
    A, B, Q, R = _setup(seed)
    P_j, K_j = mpc.riccati_recursion(*map(jnp.asarray, (A, B, Q, R, Q)), 15)
    P_t, K_t = RT.riccati_recursion(*map(_t, (A, B, Q, R, Q)), 15)
    assert P_t.shape == (16, 3, 3) and K_t.shape == (15, 2, 3)
    _close(P_t, P_j, TOL64)
    _close(K_t, K_j, TOL64)
    _close(RT.lqr_gain(*map(_t, (A, B, R, Q))), mpc.lqr_gain(*map(jnp.asarray, (A, B, R, Q))),
           TOL64)


@pytest.mark.parametrize("seed", [0, 1])
def test_dare_sda_and_residual(seed):
    A, B, Q, R = _setup(seed)
    P_j = mpc.dare_sda(*map(jnp.asarray, (A, B, Q, R)))
    P_t = RT.dare_sda(*map(_t, (A, B, Q, R)))
    _close(P_t, P_j, TOL64)
    res = RT.dare_residual(*map(_t, (A, B, Q, R)), P_t)
    assert float(res) < 1e-8 * np.abs(np.asarray(P_j)).max()
    _close(res, mpc.dare_residual(*map(jnp.asarray, (A, B, Q, R)), P_j), TOL64)


def test_finite_and_infinite_horizon_solutions():
    A, B, Q, R = _setup(2)
    sys_j = mpc.LinearSystem(A=jnp.asarray(A), B=jnp.asarray(B))
    sys_t = LinearSystem(A=_t(A), B=_t(B))
    fin_j = mpc.solve_finite_horizon(sys_j, jnp.asarray(Q), jnp.asarray(R), jnp.asarray(Q), 12)
    fin_t = L.solve_finite_horizon(sys_t, _t(Q), _t(R), _t(Q), 12)
    inf_j = mpc.solve_infinite_horizon(sys_j, jnp.asarray(Q), jnp.asarray(R))
    inf_t = L.solve_infinite_horizon(sys_t, _t(Q), _t(R))
    for got, want in ((fin_t.P, fin_j.P), (fin_t.K, fin_j.K), (inf_t.P, inf_j.P),
                      (inf_t.K, inf_j.K)):
        _close(got, want, TOL64)
    x0 = np.array([1.0, -2.0, 0.5])
    _close(L.cost_to_go(fin_t, _t(x0)), mpc.cost_to_go(fin_j, jnp.asarray(x0)), TOL64)
    # the O(log N) recursion (S6) gives the JAX package's parallel solution
    par_j = mpc.solve_finite_horizon(sys_j, jnp.asarray(Q), jnp.asarray(R), jnp.asarray(Q), 12,
                                     parallel=True)
    par_t = L.solve_finite_horizon(sys_t, _t(Q), _t(R), _t(Q), 12, parallel=True)
    for got, want in ((par_t.P, par_j.P), (par_t.K, par_j.K), (par_t.P, fin_j.P)):
        _close(got, want, TOL64)


@pytest.mark.parametrize("bounded_inputs", [True, False])
def test_lqr_terminal_set(bounded_inputs):
    """P, K, the level α and the inner box d; an infinite bound is skipped."""
    A, B, Q, R = _setup(3, nx=2, nu=1)
    x_lb, x_ub = np.array([-5.0, -np.inf]), np.array([4.0, 3.0])
    u_lb, u_ub = (np.array([-1.0]), np.array([2.0])) if bounded_inputs else (
        np.array([-np.inf]), np.array([np.inf]))
    args = (A, B, Q, R, x_lb, x_ub, u_lb, u_ub)
    want = jax_terminal_set(*map(jnp.asarray, args))
    got = L.lqr_terminal_set(*map(_t, args))
    for g, w in zip(got, want):
        _close(g, w, TOL64)


def test_policies_and_simulate_float32():
    """The receding-horizon and prediction policies in closed loop, float32:
    states, inputs and the instability flag; N=4 goes unstable on the
    session-1 double integrator as in tests/test_lqr.py."""
    sys_j = mpc.double_integrator_discrete(0.5, dtype=jnp.float32)
    C = np.array([[1.0, -2.0 / 3.0]])
    Q = C.T @ C + 1e-3 * np.eye(2)
    R = np.array([[0.1]])
    sys_t = LinearSystem(A=_t(sys_j.A, torch.float32), B=_t(sys_j.B, torch.float32))
    x0 = np.array([10.0, 10.0], np.float32)
    for N, steps in ((10, 30), (4, 30)):
        sol_j = mpc.solve_finite_horizon(sys_j, jnp.asarray(Q, jnp.float32),
                                         jnp.asarray(R, jnp.float32), jnp.asarray(Q, jnp.float32), N)
        sol_t = L.solve_finite_horizon(sys_t, _t(Q, torch.float32), _t(R, torch.float32),
                                       _t(Q, torch.float32), N)
        for pol_j, pol_t, n in ((mpc.receding_horizon_policy(sol_j), L.receding_horizon_policy(sol_t),
                                 steps),
                                (mpc.prediction_policy(sol_j), L.prediction_policy(sol_t), N)):
            ref = mpc.simulate(jnp.asarray(x0), sys_j, steps=n, policy=pol_j)
            got = S.simulate(torch.as_tensor(x0), sys_t, n, pol_t)
            assert got.states.shape == (n + 1, 2) and got.inputs.shape == (n, 1)
            scale = max(1.0, np.abs(np.asarray(ref.states)).max())
            np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), rtol=0,
                                       atol=TOL32 * scale)
            assert bool(got.unstable) == bool(ref.unstable)
    assert bool(got.unstable) is False  # N=4 prediction policy stops at 4 steps
    ref = mpc.simulate(jnp.asarray(x0), sys_j, steps=30,
                       policy=mpc.receding_horizon_policy(sol_j))
    assert bool(ref.unstable)


def test_rollout_open_loop_and_disturbances():
    """``rollout``, ``open_loop_policy``, ``policy_from_law`` and additive
    disturbances at float32."""
    rng = np.random.default_rng(4)
    A, B, _, _ = _setup(4)
    A, B = (0.5 * A).astype(np.float32), B.astype(np.float32)
    us = rng.normal(size=(9, 2)).astype(np.float32)
    ws = 0.1 * rng.normal(size=(9, 3)).astype(np.float32)
    x0 = rng.normal(size=3).astype(np.float32)
    sys_j = mpc.LinearSystem(A=jnp.asarray(A), B=jnp.asarray(B))
    sys_t = LinearSystem(A=_t(A, torch.float32), B=_t(B, torch.float32))
    ref = mpc.rollout(jnp.asarray(x0), sys_j, jnp.asarray(us))
    got = S.rollout(torch.as_tensor(x0), sys_t, torch.as_tensor(us))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL32)
    ref = mpc.simulate(jnp.asarray(x0), sys_j, 9, mpc.open_loop_policy(jnp.asarray(us)),
                       disturbances=jnp.asarray(ws))
    got = S.simulate(torch.as_tensor(x0), sys_t, 9, S.open_loop_policy(torch.as_tensor(us)),
                     disturbances=torch.as_tensor(ws))
    np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), rtol=0, atol=TOL32)
    K = rng.normal(size=(2, 3)).astype(np.float32) * 0.1
    ref = mpc.simulate(jnp.asarray(x0), sys_j, 9,
                       mpc.policy_from_law(lambda x, t: jnp.asarray(K) @ x))
    got = S.simulate(torch.as_tensor(x0), sys_t, 9,
                     S.policy_from_law(lambda x, t: torch.as_tensor(K) @ x))
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), rtol=0, atol=TOL32)
