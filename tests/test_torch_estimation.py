"""The port's estimation layer against the JAX package on the same
numpy-made records.

Gates (float64 on both sides unless stated):
- the steady-state Kalman gain and covariance (DARE by duality), the
  time-varying Kalman filter, the unconstrained MHE window and the receding
  MHE over a record, the EKF (Jacobians by ``torch.func.jacfwd`` against
  ``jax.jacfwd``) and the unrolled SPD solve: within 1e-9 (the same float64
  program in both packages);
- the bounded MHE's ``solve`` (per-scenario ADMM, float64) within 1e-9, and
  ``solve_batch`` on the twin of the fused kernel (float32) against the JAX
  Pallas kernel in interpret mode within 5e-4 (the gate of
  tests/test_estimation.py::test_batched_mhe_rides_the_pallas_kernel);
- output-feedback MPC in closed loop: inputs within 1e-4 (interior point);
- a small ``mhe_loop_sweep`` on the twin: the JAX summary's keys and
  tests/test_mhe_loop_sweep.py's bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu import estimation as JE
from model_predictive_control_tpu.ops.pallas.admm_kernel import admm_solve_pallas
from model_predictive_control_tpu.utils.smallsolve import solve_spd as jax_solve_spd
from model_predictive_control_tpu_torch import estimation as PE
from model_predictive_control_tpu_torch.control.simulate import simulate
from model_predictive_control_tpu_torch.models.linear import LinearSystem
from model_predictive_control_tpu_torch.parallel.batch import mhe_loop_sweep
from model_predictive_control_tpu_torch.utils.smallsolve import solve_spd

TOL = 1e-9
A = np.array([[1.0, 0.3], [0.0, 1.0]])
B = np.array([[0.045], [0.3]])
C = np.array([[1.0, 0.0]])
QW = np.array([[2e-3, 0.0], [0.0, 5e-3]])
RV = np.array([[4e-2]])


def _systems(dtype_j=jnp.float64, dtype_t=torch.float64):
    sj = mpc.LinearSystem(A=jnp.asarray(A, dtype_j), B=jnp.asarray(B, dtype_j),
                          C=jnp.asarray(C, dtype_j))
    t = lambda a: torch.as_tensor(a, dtype=dtype_t)
    return sj, LinearSystem(A=t(A), B=t(B), C=t(C))


def _record(T, seed=0):
    """Inputs and noisy measurements of a simulated record: ``us (T, 1)``,
    ``ys (T + 1, 1)`` (y₀..y_T), the states ``(T + 1, 2)``."""
    rng = np.random.default_rng(seed)
    us = 0.3 * rng.normal(size=(T, 1))
    x = np.array([1.0, -0.5])
    xs, ys = [x], [C @ x + 0.2 * rng.normal(size=1)]
    for u in us:
        x = A @ x + B @ u + rng.normal(size=2) * np.sqrt(np.diag(QW))
        xs.append(x)
        ys.append(C @ x + 0.2 * rng.normal(size=1))
    return us, np.array(ys), np.array(xs)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def test_kalman_gain_and_filter_trajectory():
    sj, st = _systems()
    kj = JE.kalman_gain(sj, jnp.asarray(QW), jnp.asarray(RV))
    kt = PE.kalman_gain(st, torch.as_tensor(QW), torch.as_tensor(RV))
    _close(kt.L, kj.L)
    _close(kt.P, kj.P)
    us, ys, _ = _record(30)
    xj, Pj = JE.kalman_filter_trajectory(sj, jnp.asarray(QW), jnp.asarray(RV), jnp.zeros(2),
                                         jnp.eye(2), jnp.asarray(us), jnp.asarray(ys[1:]))
    xt, Pt = PE.kalman_filter_trajectory(st, torch.as_tensor(QW), torch.as_tensor(RV),
                                         torch.zeros(2, dtype=torch.float64),
                                         torch.eye(2, dtype=torch.float64),
                                         torch.as_tensor(us), torch.as_tensor(ys[1:]))
    _close(xt, xj)
    _close(Pt, Pj)
    x = torch.tensor([0.3, -0.1], dtype=torch.float64)
    _close(kt.step(x, torch.as_tensor(us[0]), torch.as_tensor(ys[1])),
           kj.step(jnp.asarray(x.numpy()), jnp.asarray(us[0]), jnp.asarray(ys[1])))


def _mhes(M=6, bounded=True, iters=300, dtype_j=jnp.float64, dtype_t=torch.float64):
    sj, st = _systems(dtype_j, dtype_t)
    box = dict(x_min=[-5.0, -5.0], x_max=[5.0, 5.0]) if bounded else {}
    mj = JE.make_mhe(sj, jnp.asarray(QW, dtype_j), jnp.asarray(RV, dtype_j),
                     0.25 * jnp.eye(2, dtype=dtype_j), M, iters=iters,
                     **{k: jnp.asarray(v, dtype_j) for k, v in box.items()})
    mt = PE.make_mhe(st, torch.as_tensor(QW, dtype=dtype_t), torch.as_tensor(RV, dtype=dtype_t),
                     0.25 * torch.eye(2, dtype=dtype_t), M, iters=iters, **box)
    return mj, mt


def test_mhe_builds_the_same_qp_and_unconstrained_windows():
    mj, mt = _mhes(bounded=False)
    assert mt.op is None
    for name in ("H", "Phi", "Gamma_u", "Gamma_w", "Cbar", "obs_shift"):
        _close(getattr(mt, name), getattr(mj, name))
    us, ys, _ = _record(20, seed=1)
    xbar = np.array([0.9, -0.4])
    got = mt.solve_unconstrained(torch.as_tensor(xbar), torch.as_tensor(us[:6]),
                                 torch.as_tensor(ys[:7]))
    want = mj.solve_unconstrained(jnp.asarray(xbar), jnp.asarray(us[:6]), jnp.asarray(ys[:7]))
    for g, w in zip(got, want):
        _close(g, w)
    _close(PE.mhe_trajectory(mt, torch.as_tensor(xbar), torch.as_tensor(us), torch.as_tensor(ys),
                             unconstrained=True),
           JE.mhe_trajectory(mj, jnp.asarray(xbar), jnp.asarray(us), jnp.asarray(ys),
                             unconstrained=True))
    with pytest.raises(ValueError, match="without state bounds"):
        mt.solve(torch.as_tensor(xbar), torch.as_tensor(us[:6]), torch.as_tensor(ys[:7]))


def test_bounded_mhe_solve_matches_jax():
    """The bounded window through the per-scenario ADMM, float64, and the
    receding MHE over a record on it."""
    mj, mt = _mhes()
    for name in ("D", "E", "Minv_stack"):
        _close(getattr(mt.op, name), getattr(mj.op, name))
    us, ys, _ = _record(12, seed=2)
    xbar = np.array([0.9, -0.4])
    got = mt.solve(torch.as_tensor(xbar), torch.as_tensor(us[:6]), torch.as_tensor(ys[:7]))
    want = mj.solve(jnp.asarray(xbar), jnp.asarray(us[:6]), jnp.asarray(ys[:7]))
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    assert bool(got[3].converged) == bool(want[3].converged)
    _close(PE.mhe_trajectory(mt, torch.as_tensor(xbar), torch.as_tensor(us), torch.as_tensor(ys)),
           JE.mhe_trajectory(mj, jnp.asarray(xbar), jnp.asarray(us), jnp.asarray(ys)))


def test_solve_batch_twin_matches_pallas_interpret():
    """Five windows through the port's ``solve_batch`` (the fused kernel's
    twin on CPU tensors, tile 4) against the JAX kernel in interpret mode on
    the same windows: x within 5e-4, every window converged."""
    mj, mt = _mhes(dtype_j=jnp.float32, dtype_t=torch.float32)
    recs = [_record(6, seed=10 + i) for i in range(5)]
    us = np.stack([r[0] for r in recs]).astype(np.float32)
    ys = np.stack([r[1] for r in recs]).astype(np.float32)
    xb = np.stack([r[2][0] + 0.1 for r in recs]).astype(np.float32)
    qs = jax.vmap(mj._linear_term)(jnp.asarray(xb), jnp.asarray(us), jnp.asarray(ys))
    shifts = jax.vmap(lambda u: mj.Gamma_u @ u.reshape(-1))(jnp.asarray(us))
    ls = jnp.concatenate([jnp.tile(mj.x_lb[:2], (5, 1)), mj.x_lb[None] - shifts], axis=1)
    ub = jnp.concatenate([jnp.tile(mj.x_ub[:2], (5, 1)), mj.x_ub[None] - shifts], axis=1)
    ref = admm_solve_pallas(mj.op, qs, ls, ub, iters=300, tile=4)
    x_M, X, w, sol = mt.solve_batch(torch.as_tensor(xb), torch.as_tensor(us),
                                    torch.as_tensor(ys), tile=4)
    assert X.shape == (5, 7, 2) and w.shape == (5, 6, 2)
    assert bool(sol.converged.all()) and bool(jnp.all(ref.converged))
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x), atol=5e-4)
    torch.testing.assert_close(x_M, X[:, -1])


def test_output_feedback_policy_matches_jax():
    """Kalman correction → MPC (interior point) → prediction, 25 steps from
    noisy position measurements: inputs within 1e-4."""
    sj, st = _systems()
    kj = JE.kalman_gain(sj, jnp.asarray(QW), jnp.asarray(RV))
    kt = PE.kalman_gain(st, torch.as_tensor(QW), torch.as_tensor(RV))
    problem = mpc.session2_problem(N=8)
    box = mpc.BoxProblem(A=A, B=B, Q=np.diag([10.0, 1.0]), R=np.diag([0.01]),
                         x_min=[problem.p_min, problem.v_min], x_max=[problem.p_max, problem.v_max],
                         u_min=[problem.u_min], u_max=[problem.u_max], N=8)
    from model_predictive_control_tpu_torch.solvers.linear_mpc import BoxProblem, make_box_mpc

    cj = mpc.make_box_mpc(box, solver="pdip", iters=40, dtype=jnp.float64)
    ct = make_box_mpc(BoxProblem(**{k: getattr(box, k) for k in
                                    ("A", "B", "Q", "R", "x_min", "x_max", "u_min", "u_max", "N")}),
                      solver="pdip", iters=40, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    v = 0.2 * rng.normal(size=(25, 1))
    x0 = np.array([-20.0, 3.0])
    ref = mpc.simulate(
        jnp.asarray(x0), lambda x, u: sj.A @ x + sj.B @ u, 25,
        lambda x, t, c: JE.output_feedback_policy(cj, kj)(sj.C @ x + jnp.asarray(v)[t], t, c),
        JE.initial_output_feedback_carry(cj, jnp.asarray(x0 + 0.5), jnp.float64),
    )
    got = simulate(
        torch.as_tensor(x0), lambda x, u: st.A @ x + st.B @ u, 25,
        lambda x, t, c: PE.output_feedback_policy(ct, kt)(st.C @ x + torch.as_tensor(v)[t], t, c),
        PE.initial_output_feedback_carry(ct, x0 + 0.5, torch.float64),
    )
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=1e-4)
    _close(got.logs["state_estimate"], ref.logs["state_estimate"], 1e-5)


def test_ekf_matches_jax_on_a_pendulum():
    """A damped pendulum with a sine measurement: the EKF's Jacobians by
    ``torch.func.jacfwd`` and its Joseph update, step by step and over a
    record, and the EKF output-feedback policy's correction."""
    dt = 0.05

    def f_j(x, u):
        return jnp.stack([x[0] + dt * x[1], x[1] + dt * (-9.81 * jnp.sin(x[0]) - 0.2 * x[1] + u[0])])

    def f_t(x, u):
        return torch.stack([x[0] + dt * x[1],
                            x[1] + dt * (-9.81 * torch.sin(x[0]) - 0.2 * x[1] + u[0])])

    h_j = lambda x: jnp.stack([jnp.sin(x[0]), x[1]])
    h_t = lambda x: torch.stack([torch.sin(x[0]), x[1]])
    Qw, Rv = 1e-3 * np.eye(2), np.diag([1e-2, 5e-2])
    ej = JE.ExtendedKalmanFilter(f_j, h_j, jnp.asarray(Qw), jnp.asarray(Rv))
    et = PE.ExtendedKalmanFilter(f_t, h_t, torch.as_tensor(Qw), torch.as_tensor(Rv))
    rng = np.random.default_rng(6)
    us = 0.5 * rng.normal(size=(30, 1))
    ys = rng.normal(size=(30, 2)) * 0.1 + np.array([0.3, 0.0])
    xj, Pj = JE.ekf_trajectory(ej, jnp.asarray([0.4, 0.0]), jnp.eye(2), jnp.asarray(us),
                               jnp.asarray(ys))
    xt, Pt = PE.ekf_trajectory(et, torch.tensor([0.4, 0.0], dtype=torch.float64),
                               torch.eye(2, dtype=torch.float64), torch.as_tensor(us),
                               torch.as_tensor(ys))
    _close(xt, xj)
    _close(Pt, Pj)


def test_ekf_on_a_linear_system_is_the_kalman_filter():
    sj, st = _systems()
    et = PE.ExtendedKalmanFilter(lambda x, u: st.A @ x + st.B @ u, lambda x: st.C @ x,
                                 torch.as_tensor(QW), torch.as_tensor(RV))
    us, ys, _ = _record(20, seed=8)
    x0, P0 = torch.zeros(2, dtype=torch.float64), torch.eye(2, dtype=torch.float64)
    xe, Pe = PE.ekf_trajectory(et, x0, P0, torch.as_tensor(us), torch.as_tensor(ys[1:]))
    xk, Pk = PE.kalman_filter_trajectory(st, torch.as_tensor(QW), torch.as_tensor(RV), x0, P0,
                                         torch.as_tensor(us), torch.as_tensor(ys[1:]))
    _close(xe, xk)
    _close(Pe, Pk)


@pytest.mark.parametrize("n", [1, 2, 3, 6, 13])
def test_solve_spd_matches_jax(n):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(n, n))
    S = M @ M.T + n * np.eye(n)
    for rhs in (rng.normal(size=n), rng.normal(size=(n, 3))):
        _close(solve_spd(torch.as_tensor(S), torch.as_tensor(rhs)),
               jax_solve_spd(jnp.asarray(S), jnp.asarray(rhs)))
    # a leading batch axis
    Sb = np.stack([S, S + np.eye(n)])
    rb = rng.normal(size=(2, n))
    got = solve_spd(torch.as_tensor(Sb), torch.as_tensor(rb))
    for i in range(2):
        _close(got[i], jax_solve_spd(jnp.asarray(Sb[i]), jnp.asarray(rb[i])))


def test_mhe_loop_sweep_regulates_and_estimates():
    """tests/test_mhe_loop_sweep.py's bars on a small sweep through the twin
    (both halves: the MHE windows, n + m = 44, and the soft MPC at N=20,
    n + m = 200)."""
    res, s = mhe_loop_sweep(8, 30, tile=8, device="cpu")
    assert set(s) == {"batch", "steps", "M", "success_rate", "mhe_converged_rate",
                      "est_rmse_pos", "est_rmse_vel", "median_final_pos"}
    assert s["est_rmse_pos"] < 0.15 and s["est_rmse_vel"] < 0.15, s
    assert s["mhe_converged_rate"] > 0.99, s
    assert s["median_final_pos"] < 0.5, s
    assert s["success_rate"] > 0.85, s
    tail = (res.logs["state_estimate"] - res.states[:-1])[s["M"] + 2:].abs()
    assert float(tail[..., 0].max()) < 1.0


def test_mhe_loop_builds_each_kernel_operator_once(monkeypatch):
    """The MHE loop alternates two operators every step (the MHE windows'
    and the soft MPC's): each one's fused kernel operator is built at its
    first solve and kept, so a 4-step loop builds exactly two."""
    from model_predictive_control_tpu_torch.ops.cuda import admm_kernel as K

    builds = []
    build = K._fused_operator
    monkeypatch.setattr(K, "_fused_operator", lambda op: builds.append(op) or build(op))
    mhe_loop_sweep(4, 4, tile=4, device="cpu")
    assert len(builds) == 2 and builds[0] is not builds[1]


def test_ekf_output_feedback_over_ilqr_mpc_matches_jax():
    """The EKF output feedback over the parking AL-iLQR MPC (JAX
    ``tests/test_ekf.py:105``'s composition: y = the position and heading
    plus noise, EKF correct → ``ILQRMPC`` solve → EKF predict), two steps
    from the session-4 start in float64, the same noise on both sides: the
    planned inputs (u₀ is on the input box in both steps) and the state
    estimates within 1e-8."""
    from model_predictive_control_tpu_torch.models.bicycle import kinematic_bicycle_ode
    from model_predictive_control_tpu_torch.models.parameters import VehicleParameters
    from model_predictive_control_tpu_torch.ops.integrators import euler
    from model_predictive_control_tpu_torch.solvers.parking import ILQRMPC, make_parking_ilqr
    from model_predictive_control_tpu.solvers.parking import ILQRMPC as JILQRMPC

    N, ts, sigma, steps = 12, 0.08, 0.01, 2
    x0 = np.array([0.6, -0.25, 0.0, 0.0])
    P0 = np.diag([1e-4] * 3 + [1e-2])
    vs = sigma * np.random.default_rng(0).normal(size=(steps, 3))

    def run(lib, ctrl, ekf, carry, step):
        policy = ekf_policy[lib](ctrl, ekf)
        x, out = x0 if lib == "jax" else torch.as_tensor(x0), []
        for t in range(steps):
            y = x[:3] + (jnp.asarray(vs[t]) if lib == "jax" else torch.as_tensor(vs[t]))
            u, carry, aux = policy(y, t, carry)
            out.append((np.asarray(aux["input_prediction"]), np.asarray(aux["state_estimate"])))
            x = step(x, u)
        return out

    ekf_policy = {"jax": JE.ekf_output_feedback_policy, "torch": PE.ekf_output_feedback_policy}
    pj = mpc.VehicleParameters()
    prob, cons, nc = mpc.make_parking_ilqr(pj, N, ts, dtype=jnp.float64)
    cj = JILQRMPC(prob, cons, nc, outer_iters=6, inner_iters=15)
    step_j = mpc.euler(lambda x, u: mpc.kinematic_bicycle_ode(pj, x, u), ts)
    ej = JE.ExtendedKalmanFilter(step_fn=step_j, obs_fn=lambda x: x[:3],
                                 Qw=1e-6 * jnp.eye(4, dtype=jnp.float64),
                                 Rv=sigma**2 * jnp.eye(3, dtype=jnp.float64))
    want = run("jax", cj, ej, JE.initial_ekf_carry(cj, x0, P0, dtype=jnp.float64), step_j)

    pt = VehicleParameters()
    prob, cons, nc = make_parking_ilqr(pt, N, ts, dtype=torch.float64, device="cpu")
    ct = ILQRMPC(prob, cons, nc, outer_iters=6, inner_iters=15)
    step_t = euler(lambda x, u: kinematic_bicycle_ode(pt, x, u), ts)
    et = PE.ExtendedKalmanFilter(step_fn=step_t, obs_fn=lambda x: x[:3],
                                 Qw=1e-6 * torch.eye(4, dtype=torch.float64),
                                 Rv=sigma**2 * torch.eye(3, dtype=torch.float64))
    got = run("torch", ct, et, PE.initial_ekf_carry(ct, x0, P0, dtype=torch.float64,
                                                    device="cpu"), step_t)
    for t, ((u_t, xh_t), (u_j, xh_j)) in enumerate(zip(got, want)):
        print(f"step {t}: max|du| {np.abs(u_t - u_j).max():.2e}, "
              f"max|dxhat| {np.abs(xh_t - xh_j).max():.2e}")
        np.testing.assert_allclose(u_t, u_j, rtol=0, atol=1e-8)
        np.testing.assert_allclose(xh_t, xh_j, rtol=0, atol=1e-8)
