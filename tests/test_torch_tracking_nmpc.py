"""The tracking NMPC (``solvers/nmpc_tracking.py``), ``make_racing_mpc``,
``make_tracking_ilqr_window`` and the racing sweep on the parking kernel's
tracking mode, against the JAX package.

Tolerances: float64 solves and closed loops of the per-scenario route within
1e-6 (the same algorithm; it agrees to ~1e-12); the float32 closed loop of
``racing_sweep(backend="pallas-hand")`` (the kernel's twin on the CPU) on
the JAX sweep's own draws within 5e-3 of JAX's ``pallas-hand`` route (the
Pallas kernel in interpret mode) and of its ``xla`` route, the JAX
package's gate between its racing backends (``tests/test_racing_sweep.py:
111-116``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.experiments.racing import make_racing_mpc as jax_make_racing_mpc
from model_predictive_control_tpu.parallel.batch import (
    DEFAULT_PERTURB_FIELDS,
    make_tracking_ilqr_window as jax_window,
    perturb_parameters as jax_perturb,
    racing_sweep as jax_racing_sweep,
)

import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.convert import tracking_nmpc_from_jax, vehicle_parameters_from_jax
from model_predictive_control_tpu_torch.experiments.racing import ellipse_reference
from model_predictive_control_tpu_torch.models.bicycle import kinematic_bicycle_ode
from model_predictive_control_tpu_torch.models.parameters import VehicleParameters
from model_predictive_control_tpu_torch.ops.integrators import euler, rk4
from model_predictive_control_tpu_torch.parallel import batch as PB

N, TS = 10, 0.05


@pytest.mark.parametrize("dynamic", [False, True])
def test_make_racing_mpc_matches_jax(dynamic):
    """The controller's reference, weights and box are JAX's; one solve
    from a perturbed lap start matches (float64, kinematic with the tube)."""
    ctrl, ref = port.make_racing_mpc(N=N, steps=20, dynamic=dynamic, dtype=torch.float64,
                                     device="cpu")
    jctrl, jref = jax_make_racing_mpc(N=N, steps=20, dynamic=dynamic, dtype=jnp.float64)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=1e-12)
    for name in ("Q", "R", "QN", "u_lb", "u_ub"):
        np.testing.assert_allclose(getattr(ctrl, name).numpy(), np.asarray(getattr(jctrl, name)),
                                   atol=1e-12)
    assert ctrl.n_constraints == jctrl.n_constraints and ctrl.tube_radius == jctrl.tube_radius
    if dynamic:
        return
    x0 = ref[0] + torch.tensor([0.03, -0.02, 0.05, 0.0], dtype=torch.float64)
    sol = ctrl.solve(x0, 2)
    jsol = jctrl.solve(jnp.asarray(x0.numpy()), 2)
    np.testing.assert_allclose(sol.us.numpy(), np.asarray(jsol.us), atol=1e-6)
    assert abs(sol.viol.item() - float(jsol.viol)) < 1e-9


def test_tracking_nmpc_closed_loop_matches_jax():
    """The kinematic lap, 3 steps of the receding-horizon loop (Euler
    prediction, RK4 plant), the controller built from the JAX one."""
    jctrl, jref = jax_make_racing_mpc(N=N, steps=10, dynamic=False, dtype=jnp.float64)
    params = VehicleParameters()
    step = euler(lambda x, u: kinematic_bicycle_ode(params, x, u), TS)
    ctrl = tracking_nmpc_from_jax(jctrl, step, device="cpu", dtype=torch.float64)
    plant = rk4(lambda x, u: kinematic_bicycle_ode(params, x, u), TS)
    x0 = ctrl.ref_traj[0]
    got = port.simulate(x0, plant, 3, ctrl.policy(), ctrl.initial_carry(torch.float64))
    jplant = mpc.ops.integrators.rk4(
        lambda x, u: mpc.models.bicycle.kinematic_bicycle_ode(mpc.VehicleParameters(), x, u), TS)
    want = mpc.simulate(jref[0], jplant, steps=3, policy=jctrl.policy(),
                        policy_carry=jctrl.initial_carry(jnp.float64))
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(want.inputs), atol=1e-6)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(want.states), atol=1e-6)
    np.testing.assert_allclose(got.logs["tracking_error"].numpy(),
                               np.asarray(want.logs["tracking_error"]), atol=1e-6)


def test_make_tracking_ilqr_window_matches_jax():
    """The window problem with the kernel's rows (state and input boxes),
    solved by the AL-iLQR in float64 for two windows at once."""
    ref = ellipse_reference(N + 3, speed=0.35, ts=TS, dynamic=False, dtype=torch.float64,
                            device="cpu")
    Q, R, qn = (40.0, 40.0, 4.0, 1.0), (0.5, 0.5), 5.0
    xl, xu = (-3.0, -2.0, -100.0, -0.5), (3.0, 2.0, 100.0, 0.5)
    windows = torch.stack([ref[0:N + 1], ref[2:N + 3]])
    x0 = windows[:, 0] + torch.tensor([0.02, -0.03, 0.05, 0.01], dtype=torch.float64)
    prob, cons, nc = port.make_tracking_ilqr_window(VehicleParameters(), windows, Q, R, qn, xl,
                                                    xu, TS, dtype=torch.float64)
    sol = port.al_ilqr_solve(prob, cons, nc, x0, outer_iters=4, inner_iters=10, viol_tol=1e-4)
    for i in range(2):
        jp, jc, jnc = jax_window(mpc.VehicleParameters(), jnp.asarray(windows[i].numpy()), Q, R,
                                 qn, xl, xu, TS, dtype=jnp.float64)
        assert nc == jnc
        want = mpc.al_ilqr_solve(jp, jc, jnc, jnp.asarray(x0[i].numpy()), outer_iters=4,
                                 inner_iters=10, viol_tol=1e-4)
        np.testing.assert_allclose(sol.us[i].numpy(), np.asarray(want.us), atol=1e-6)
        assert abs(sol.cost[i].item() - float(want.cost)) < 1e-8


@pytest.mark.parametrize("jax_backend", ["pallas-hand", "xla"])
def test_racing_sweep_on_the_tracking_mode_matches_jax(jax_backend):
    """``racing_sweep(backend="pallas-hand")``'s policy (K2's tracking mode,
    its twin here) on the JAX sweep's starts and plants, 3 steps, against
    the JAX sweep's ``pallas-hand`` (interpret mode) and ``xla`` routes."""
    B, STEPS, NR, TILE = 4, 3, 15, 8
    key = jax.random.PRNGKey(5)
    want, _ = jax_racing_sweep(batch=B, steps=STEPS, key=key, tile=TILE, backend=jax_backend)
    k_par, _ = jax.random.split(key)
    plant = vehicle_parameters_from_jax(
        jax_perturb(k_par, mpc.VehicleParameters(), B, rel_scale=0.1,
                    fields=DEFAULT_PERTURB_FIELDS, dtype=jnp.float32), device="cpu")
    policy = PB.batched_racing_policy(
        ellipse_reference(STEPS + NR + 1, speed=0.35, dynamic=False, device="cpu"), N=NR,
        tile=TILE, backend="pallas-hand")
    got = port.simulate_batch(torch.as_tensor(np.array(want.states[0])),
                              PB.batched_plant(plant, 0.05, substeps=8), STEPS, policy,
                              policy.initial_carry(B, device="cpu"))
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(want.inputs), atol=5e-3)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(want.states), atol=5e-3)
    np.testing.assert_array_equal(got.logs["solver_success"].numpy(),
                                  np.asarray(want.logs["solver_success"]))
    assert "kernel_inner_iters" in got.logs


def test_racing_sweep_routes():
    """The entry point on the tracking mode and on the per-scenario route:
    the JAX summary keys (``mean_inner_iters`` on a kernel), and the two
    routes within 5e-3 of each other on the same draws."""
    kw = dict(N=6, outer_iters=3, inner_iters=6, plant_substeps=2, device="cpu")
    a, sa = port.racing_sweep(3, 2, backend="pallas-hand", **kw)
    b, sb = port.racing_sweep(3, 2, backend="torch", **kw)
    assert sa["backend"] == "pallas-hand" and "mean_inner_iters" in sa
    assert sb["backend"] == "torch" and "mean_inner_iters" not in sb
    np.testing.assert_allclose(a.states.numpy(), b.states.numpy(), atol=5e-3)
    res, s = port.racing_sweep_dynamic(2, 1, N=4, backend="torch", pred_substeps=1,
                                       outer_iters=1, inner_iters=2, plant_substeps=2,
                                       device="cpu")
    assert res.states.shape == (2, 2, 6) and s["backend"] == "torch"
