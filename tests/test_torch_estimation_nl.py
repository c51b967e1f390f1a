"""The nonlinear MHE (``estimation_nl.py``) against the JAX package's, in
float64 on the same seeded numpy inputs, at the JAX tests' bars
(``tests/test_estimation_nl.py``):

- the linear limit: one Gauss-Newton step on linear closures is the port's
  linear MHE (1e-10), and with inactive bounds the bounded step lands there
  too (1e-8); the JAX estimator on the same window within 1e-10;
- the filtering arrival cost: the receding-horizon estimator on linear
  closures is the time-varying Kalman filter (1e-9), as JAX's trajectory;
  the frozen arrival is visibly not (> 1e-3);
- bounded bicycle windows (v ≥ 0): the receding-horizon trajectory within
  1e-8 of JAX's, the bound respected (> −1e-6);
- ``solve_batch`` on ADMM and on PDIP: each within 1e-8 of JAX's, ADMM
  within 1e-5 of PDIP, a window of the batch equal to ``solve`` (1e-9);
- ``mhe_output_feedback_policy``: three steps of the MHE-in-the-loop
  linear MPC (interior point), inputs and estimates within 1e-8 of JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
import model_predictive_control_tpu.estimation as JE
from model_predictive_control_tpu.estimation_nl import (
    NonlinearMHE as JaxMHE,
    initial_mhe_feedback_carry as jax_carry,
    mhe_output_feedback_policy as jax_feedback,
)
from model_predictive_control_tpu.models.bicycle import kinematic_bicycle_ode as jax_bicycle
from model_predictive_control_tpu.ops.integrators import rk4 as jax_rk4

import model_predictive_control_tpu_torch.estimation as PE
from model_predictive_control_tpu_torch.estimation_nl import (
    NonlinearMHE,
    initial_mhe_feedback_carry,
    mhe_output_feedback_policy,
)
from model_predictive_control_tpu_torch.models.bicycle import kinematic_bicycle_ode
from model_predictive_control_tpu_torch.models.linear import LinearSystem
from model_predictive_control_tpu_torch.models.parameters import VehicleParameters
from model_predictive_control_tpu_torch.ops.integrators import rk4

A = np.array([[1.0, 0.3], [0.0, 1.0]])
B = np.array([[0.0], [0.3]])
C = np.array([[1.0, 0.0]])
QW, RV = np.array([[1e-4, 0.0], [0.0, 4e-3]]), np.array([[0.04]])
P0 = np.array([[0.5, 0.1], [0.1, 0.3]])
X_MIN, X_MAX = [-3.0, -2.0, -7.0, 0.0], [3.0, 2.0, 7.0, 1.0]
QW_BIKE = np.diag([1e-6, 1e-6, 1e-5, 1e-3])
RV_BIKE = 0.01 * np.eye(2)
P0_BIKE = np.diag([1e-4, 1e-4, 1e-3, 1e-2])
j, t = jnp.asarray, torch.as_tensor


def _linear(P0_=P0, **kw):
    """The same linear estimator in both packages."""
    Aj, Bj, Cj = j(A), j(B), j(C)
    At, Bt, Ct = t(A), t(B), t(C)
    jm = JaxMHE(lambda x, u: Aj @ x + Bj @ u, lambda x: Cj @ x, j(QW), j(RV), j(P0_), nx=2, **kw)
    tm = NonlinearMHE(lambda x, u: At @ x + Bt @ u, lambda x: Ct @ x, t(QW), t(RV), t(P0_), nx=2,
                      **kw)
    return jm, tm


def _linear_record(T, seed):
    rng = np.random.default_rng(seed)
    us = 0.2 * np.cos(0.3 * np.arange(T))[:, None]
    x, ys = np.array([1.0, -0.5]), [C @ np.array([1.0, -0.5]) + 0.2 * rng.normal(size=1)]
    for k in range(T):
        x = A @ x + B @ us[k] + rng.multivariate_normal(np.zeros(2), QW)
        ys.append(C @ x + 0.2 * rng.normal(size=1))
    return us, np.stack(ys)


def test_linear_limit_single_window_equals_linear_mhe():
    M = 8
    us, ys = _linear_record(M, 4)
    xbar = np.array([0.8, -0.3])
    lin = PE.make_mhe(LinearSystem(A=t(A), B=t(B), C=t(C)), t(QW), t(RV), t(P0), M)
    xM_lin, X_lin, _ = lin.solve_unconstrained(t(xbar), t(us), t(ys))
    jm, tm = _linear(M=M, gn_iters=1)
    xM, X, _ = tm.solve(t(xbar), t(us), t(ys))
    np.testing.assert_allclose(xM.numpy(), xM_lin.numpy(), atol=1e-10)
    np.testing.assert_allclose(X.numpy(), X_lin.numpy(), atol=1e-10)
    np.testing.assert_allclose(X.numpy(), np.asarray(jm.solve(j(xbar), j(us), j(ys))[1]),
                               atol=1e-10)
    # the bounded step with inactive bounds lands on the same optimum
    _, tb = _linear(M=M, gn_iters=2, x_min=[-10.0, -10.0], x_max=[10.0, 10.0])
    np.testing.assert_allclose(tb.solve(t(xbar), t(us), t(ys))[0].numpy(), xM_lin.numpy(),
                               atol=1e-8)


def test_propagated_arrival_is_the_kalman_filter():
    M, T = 6, 16
    us, ys = _linear_record(T, 7)
    xbar0 = np.array([1.2, -0.3])
    # the KF: ingest y0 first, then filter
    S0 = C @ P0 @ C.T + RV
    K0 = P0 @ C.T @ np.linalg.inv(S0)
    xhat0 = xbar0 + K0 @ (ys[0] - C @ xbar0)
    I = np.eye(2)
    P0p = (I - K0 @ C) @ P0 @ (I - K0 @ C).T + K0 @ RV @ K0.T
    xh_ref, _ = PE.kalman_filter_trajectory(LinearSystem(A=t(A), B=t(B), C=t(C)), t(QW), t(RV),
                                            t(xhat0), t(P0p), t(us), t(ys[1:]))
    jm, tm = _linear(M=M, gn_iters=1, propagate_arrival=True)
    ends = tm.trajectory(t(xbar0), t(us), t(ys))
    assert ends.shape == (T - M + 1, 2)
    np.testing.assert_allclose(ends.numpy(), xh_ref[M - 1:].numpy(), atol=1e-9)
    np.testing.assert_allclose(ends.numpy(), np.asarray(jm.trajectory(j(xbar0), j(us), j(ys))),
                               atol=1e-9)
    _, frozen = _linear(M=M, gn_iters=1)
    assert (frozen.trajectory(t(xbar0), t(us), t(ys)) - xh_ref[M - 1:]).abs().max() > 1e-3


def _bicycle(M, **kw):
    pj = mpc.VehicleParameters()
    jstep = jax_rk4(lambda x, u: jax_bicycle(pj, x, u), 0.05)
    p = VehicleParameters()
    tstep = rk4(lambda x, u: kinematic_bicycle_ode(p, x, u), 0.05)
    jm = JaxMHE(jstep, lambda x: x[:2], j(QW_BIKE), j(RV_BIKE), j(P0_BIKE), M, nx=4,
                x_min=X_MIN, x_max=X_MAX, **kw)
    tm = NonlinearMHE(tstep, lambda x: x[:2], t(QW_BIKE), t(RV_BIKE), t(P0_BIKE), M, nx=4,
                      x_min=X_MIN, x_max=X_MAX, **kw)
    return jm, tm, tstep


def test_bicycle_bounded_windows_match_jax():
    """A car coasting to rest, position-only measurements: the bounded
    receding-horizon estimates equal JAX's and never reverse."""
    M, T = 6, 14
    jm, tm, step = _bicycle(M, gn_iters=3, propagate_arrival=True)
    rng = np.random.default_rng(1)
    us = np.concatenate([np.tile([[0.2, 0.05]], (4, 1)), np.zeros((T - 4, 2))])
    x = torch.zeros(4, dtype=torch.float64)
    ys = [x[:2].numpy()]
    for k in range(T):
        x = step(x, t(us[k])) + t(rng.multivariate_normal(np.zeros(4), QW_BIKE))
        x[3] = torch.clamp(x[3], min=0.0)
        ys.append(x[:2].numpy() + 0.1 * rng.normal(size=2))
    ys = np.stack(ys)
    ends = tm.trajectory(torch.zeros(4, dtype=torch.float64), t(us), t(ys))
    ref = np.asarray(jm.trajectory(jnp.zeros(4), j(us), j(ys)))
    np.testing.assert_allclose(ends.numpy(), ref, atol=1e-8)
    assert float(ends[:, 3].min()) > -1e-6


@pytest.mark.parametrize("qp_solver, qp_iters", [("admm", 80), ("pdip", 25)])
def test_solve_batch_matches_jax(qp_solver, qp_iters):
    M = 8
    jm, tm, step = _bicycle(M, gn_iters=3, qp_solver=qp_solver, qp_iters=qp_iters)
    rng = np.random.default_rng(2)
    x0 = np.array([0.1, -0.2, 0.3, 0.05])
    us = np.tile([[0.2, 0.05]], (M, 1))
    xs = [t(x0)]
    for k in range(M):
        xs.append(step(xs[-1], t(us[k])))
    ys = torch.stack(xs)[:, :2].numpy() + 0.1 * rng.normal(size=(M + 1, 2))
    xb, ub, yb = np.stack([x0, x0 + 0.01]), np.stack([us, us]), np.stack([ys, ys + 0.01])
    got = tm.solve_batch(t(xb), t(ub), t(yb))
    ref = jm.solve_batch(j(xb), j(ub), j(yb))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-8)
    assert float(got[1][..., 3].min()) > -1e-8
    np.testing.assert_allclose(tm.solve(t(x0), t(us), t(ys))[1].numpy(), got[1][0].numpy(),
                               atol=1e-9)
    if qp_solver == "admm":
        _, pdip, _ = _bicycle(M, gn_iters=3, qp_iters=25)
        np.testing.assert_allclose(got[1].numpy(), pdip.solve_batch(t(xb), t(ub), t(yb))[1].numpy(),
                                   atol=1e-5)


def test_mhe_output_feedback_policy_matches_jax():
    """Three steps of the session-2 MPC (interior point) on the MHE's
    estimates from noisy position measurements."""
    from model_predictive_control_tpu_torch.control.simulate import simulate

    from model_predictive_control_tpu_torch.solvers.linear_mpc import BoxProblem, make_box_mpc

    problem = mpc.session2_problem(N=8)
    box = dict(A=A, B=B, Q=np.diag([10.0, 1.0]), R=np.diag([0.01]),
               x_min=[problem.p_min, problem.v_min], x_max=[problem.p_max, problem.v_max],
               u_min=[problem.u_min], u_max=[problem.u_max], N=8)
    cj = mpc.make_box_mpc(mpc.BoxProblem(**box), solver="pdip", iters=40, dtype=jnp.float64)
    ct = make_box_mpc(BoxProblem(**box), solver="pdip", iters=40, dtype=torch.float64,
                      device="cpu")
    jm, tm = _linear(P0_=0.1 * np.eye(2), M=4, gn_iters=1, propagate_arrival=True)
    v = 0.2 * np.random.default_rng(3).normal(size=(3, 1))
    x0 = np.array([-30.0, 4.0])
    pj, pt = jax_feedback(cj, jm), mhe_output_feedback_policy(ct, tm)
    ref = mpc.simulate(j(x0), lambda x, u: j(A) @ x + j(B) @ u, 3,
                       lambda x, k, c: pj(j(C) @ x + j(v)[k], k, c),
                       jax_carry(cj, jm, j(x0), nu=1, dtype=jnp.float64))
    got = simulate(t(x0), lambda x, u: t(A) @ x + t(B) @ u, 3,
                   lambda x, k, c: pt(t(C) @ x + t(v)[k], k, c),
                   initial_mhe_feedback_carry(ct, tm, x0, nu=1, dtype=torch.float64, device="cpu"))
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=1e-8)
    np.testing.assert_allclose(got.logs["state_estimate"].numpy(),
                               np.asarray(ref.logs["state_estimate"]), atol=1e-8)


def test_nonlinear_mhe_from_jax_copies_the_estimator():
    """``convert.nonlinear_mhe_from_jax``: covariances, bounds, window and
    iteration settings copied; with the port's step, the same window solve."""
    from model_predictive_control_tpu_torch.convert import nonlinear_mhe_from_jax

    jm, tm, step = _bicycle(6, gn_iters=2, qp_solver="admm", qp_iters=30, propagate_arrival=True)
    got = nonlinear_mhe_from_jax(jm, step, lambda x: x[:2], device="cpu", dtype=torch.float64)
    for name in ("Qw", "Rv", "P0", "x_min", "x_max"):
        assert torch.equal(getattr(got, name), getattr(tm, name)), name
    for name in ("M", "nx", "gn_iters", "qp_iters", "qp_solver", "propagate_arrival", "reg"):
        assert getattr(got, name) == getattr(tm, name), name
