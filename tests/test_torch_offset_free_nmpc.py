"""The offset-free NMPC (``solvers/offset_free_nmpc.py``) against the JAX
package's, in float64.

- The target solve: a fixed point of the corrected model with the tracked
  outputs on the reference, residual below 1e-10, equal to JAX's within
  1e-10 (``tests/test_offset_free_nmpc.py:68-75``).
- The augmented EKF's correction and prediction within 1e-12 of JAX's.
- The slope-parking case (friction × 0.8 and a 0.35 slope, 320 steps) and
  the crosswind case (120 steps) at that file's bars, on the JAX policy's
  own closed loop (jitted: 320 steps of the port's eager solver take minutes
  here): the JAX loop parks within 0.04 m with d̂ on the speed row within
  2e-4 of the slope's, and tracks within 0.01 m with d̂ on the p_y row
  within 5e-4 of the wind; and at steps along that loop the port's policy,
  given JAX's measurement and carry, returns JAX's input and next carry
  within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.experiments.racing import (
    Q_KINEMATIC,
    QN_SCALE,
    R_KINEMATIC,
    ellipse_reference as jax_ellipse,
)
from model_predictive_control_tpu.models.bicycle import kinematic_bicycle_ode as jode
from model_predictive_control_tpu.ops.integrators import euler as jeuler, rk4 as jrk4, rk4_fine as jrk4_fine
from model_predictive_control_tpu.solvers.offset_free_nmpc import (
    DisturbanceCompensatedTracking as JDCT,
    OffsetFreeNMPC as JOF,
)
from model_predictive_control_tpu.solvers.parking import Q_SOL, QN_SCALE_SOL

from model_predictive_control_tpu_torch.convert import (
    disturbance_compensated_tracking_from_jax,
    offset_free_nmpc_from_jax,
)
from model_predictive_control_tpu_torch.models.bicycle import kinematic_bicycle_ode
from model_predictive_control_tpu_torch.models.parameters import VehicleParameters
from model_predictive_control_tpu_torch.ops.integrators import euler
from model_predictive_control_tpu_torch.solvers.offset_free_nmpc import OffsetFreeNMPC

N, TS, SLOPE = 12, 0.05, 0.35
X0 = np.array([0.6, -0.25, 0.0, 0.0])


def _jax_ctrl(**kw):
    p = mpc.VehicleParameters()
    Q = jnp.asarray(Q_SOL, jnp.float64)
    kw.setdefault("r", [0.0, 0.0])
    return JOF(jeuler(lambda x, u: jode(p, x, u), TS), nx=4, nu=2, N=N, Q=Q,
               R=jnp.asarray([1.0, 0.01], jnp.float64), QN=QN_SCALE_SOL * Q,
               u_lb=[p.min_drive, -p.max_steer], u_ub=[p.max_drive, p.max_steer],
               dtype=jnp.float64, **kw)


def _port_ctrl(jctrl):
    p = VehicleParameters()
    return offset_free_nmpc_from_jax(jctrl, euler(lambda x, u: kinematic_bicycle_ode(p, x, u), TS),
                                     device="cpu", dtype=torch.float64)


def _t(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def test_target_solve_matches_jax():
    jctrl = _jax_ctrl()
    ctrl = _port_ctrl(jctrl)
    d_hat = torch.tensor([0.0, 0.0, 0.0, -SLOPE * TS], dtype=torch.float64)
    x_s, u_s, res = ctrl.solve_target(d_hat)
    assert res.item() < 1e-10
    step = euler(lambda x, u: kinematic_bicycle_ode(VehicleParameters(), x, u), TS)
    torch.testing.assert_close(step(x_s, u_s) + ctrl.Bd @ d_hat, x_s, rtol=0, atol=1e-10)
    torch.testing.assert_close(x_s[:2], torch.zeros(2, dtype=torch.float64), rtol=0, atol=1e-10)
    assert u_s[0].item() > 0.05  # holding against the slope takes drive at rest
    jx, ju, _ = jctrl.solve_target(jnp.asarray(d_hat.numpy()))
    np.testing.assert_allclose(x_s.numpy(), np.asarray(jx), atol=1e-10)
    np.testing.assert_allclose(u_s.numpy(), np.asarray(ju), atol=1e-10)


def test_square_target_system_required():
    p = VehicleParameters()
    with pytest.raises(ValueError, match="square"):
        OffsetFreeNMPC(euler(lambda x, u: kinematic_bicycle_ode(p, x, u), TS), nx=4, nu=2, N=N,
                       Q=Q_SOL, R=(1.0, 0.01), QN=Q_SOL, u_lb=(-1.0, -0.3), u_ub=(1.0, 0.3),
                       H=torch.eye(4)[:3], r=[0.0, 0.0, 0.0], device="cpu")


def test_augmented_ekf_matches_jax():
    jctrl = _jax_ctrl()
    ctrl = _port_ctrl(jctrl)
    rng = np.random.default_rng(3)
    z = rng.normal(0, 0.1, 8)
    A = rng.normal(0, 0.05, (8, 8))
    P = A @ A.T + 1e-3 * np.eye(8)
    y, u = rng.normal(0, 0.1, 4), rng.normal(0, 0.2, 2)
    zc, Pc = ctrl._ekf_correct(*(torch.tensor(a) for a in (z, P, y)))
    jzc, jPc = jctrl._ekf_correct(*(jnp.asarray(a) for a in (z, P, y)))
    np.testing.assert_allclose(zc.numpy(), np.asarray(jzc), atol=1e-12)
    np.testing.assert_allclose(Pc.numpy(), np.asarray(jPc), atol=1e-12)
    zn, Pn = ctrl._ekf_predict(zc, Pc, torch.tensor(u))
    jzn, jPn = jctrl._ekf_predict(jzc, jPc, jnp.asarray(u))
    np.testing.assert_allclose(zn.numpy(), np.asarray(jzn), atol=1e-12)
    np.testing.assert_allclose(Pn.numpy(), np.asarray(jPn), atol=1e-12)
    for got, want in zip(ctrl.initial_carry(X0), jctrl.initial_carry(jnp.asarray(X0))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0)


def _jax_loop(jctrl, plant, x0, steps, keep):
    """JAX's jitted policy in a closed loop; the measurement, carry and
    output at the steps in ``keep``, and the last logs."""
    pol = jax.jit(jctrl.policy())
    x, carry, kept = jnp.asarray(x0), jctrl.initial_carry(jnp.asarray(x0)), {}
    for t in range(steps):
        u, carry_n, aux = pol(x, t, carry)
        if t in keep:
            kept[t] = (x, carry, u, carry_n)
        x, carry = plant(x, u), carry_n
    return x, aux, kept


def _policy_matches(policy, kept):
    for t, (x, carry, u, carry_n) in kept.items():
        got_u, got_carry, _ = policy(_t(x), t, _t(carry))
        np.testing.assert_allclose(got_u.numpy(), np.asarray(u), atol=1e-6, err_msg=f"step {t}")
        for a, b in zip(got_carry, carry_n):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, err_msg=f"step {t}")


def test_slope_parking_offset_removed():
    jctrl = _jax_ctrl()
    p = mpc.VehicleParameters()
    p_true = dataclasses.replace(p, friction=p.friction * 0.8)
    drift = jnp.asarray([0.0, 0.0, 0.0, -SLOPE])
    plant = jax.jit(jrk4_fine(lambda x, u: jode(p_true, x, u) + drift, TS, substeps=16))
    x, aux, kept = _jax_loop(jctrl, plant, X0, 320, keep=(0, 100, 319))
    assert float(jnp.linalg.norm(x[:2])) < 0.04
    np.testing.assert_allclose(float(aux["disturbance_estimate"][3]), -SLOPE * TS, atol=2e-4)
    _policy_matches(_port_ctrl(jctrl).policy(), kept)


def test_crosswind_offset_removed():
    steps, wind = 120, 0.004
    p = mpc.VehicleParameters()
    ref = jax_ellipse(steps + 15 + 1, speed=0.35, ts=TS, dynamic=False, dtype=jnp.float64)
    Q = jnp.asarray(Q_KINEMATIC, jnp.float64)
    jctrl = JDCT(jeuler(lambda x, u: jode(p, x, u), TS), nx=4, nu=2, N=15, Q=Q,
                 R=jnp.asarray(R_KINEMATIC, jnp.float64), QN=QN_SCALE * Q,
                 u_lb=jnp.asarray([p.min_drive, -p.max_steer]),
                 u_ub=jnp.asarray([p.max_drive, p.max_steer]), ref_traj=ref, ts=TS,
                 dtype=jnp.float64)
    w = jnp.asarray([0.0, -wind, 0.0, 0.0])
    base = jrk4(lambda x, u: jode(p, x, u), TS)
    errs = []
    pol = jax.jit(jctrl.policy())
    x, carry, kept = ref[0], jctrl.initial_carry(ref[0]), {}
    for t in range(steps):
        u, carry_n, aux = pol(x, t, carry)
        errs.append(float(aux["tracking_error"]))
        if t in (0, 60, 119):
            kept[t] = (x, carry, u, carry_n)
        x, carry = base(x, u) + w, carry_n
    assert np.mean(errs[-40:]) < 0.01
    np.testing.assert_allclose(float(aux["disturbance_estimate"][1]), -wind, atol=5e-4)
    ctrl = disturbance_compensated_tracking_from_jax(
        jctrl, euler(lambda x, u: kinematic_bicycle_ode(VehicleParameters(), x, u), TS),
        device="cpu", dtype=torch.float64)
    _policy_matches(ctrl.policy(), kept)
