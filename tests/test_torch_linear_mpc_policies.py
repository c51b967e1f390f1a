"""The port's linear MPC policies against the JAX package: ``policy`` in
``simulate`` with the terminal set, the soft state boxes and the DARE
terminal cost, ``tracking_policy`` on a position ramp, and the soft layout of
``_shift_warm``.

Gates: u-trajectories within 1e-4 of the JAX float64 closed loops (ROADMAP's
bar for u-trajectories against the float64 oracles), the logs' keys and
success masks equal, predictions within 1e-3; the soft ``_shift_warm``
exactly. The controllers are built by
tests/test_torch_linear_mpc_options.py's ``_pair``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.control.simulate import simulate

from tests.test_torch_linear_mpc_options import N, TOL_U, _pair


@pytest.mark.parametrize("option, solver, x0, steps", [
    ("terminal_set", "pdip", (-15.0, 8.0), 25),
    ("soft", "admm", (-0.5, 20.0), 20),
    ("dare", "admm", (-60.0, 10.0), 15),
])
def test_policy_closed_loop_matches_jax(option, solver, x0, steps):
    """``policy`` in ``simulate``: inputs within 1e-4, the logs' keys and
    success; the terminal-set loop succeeds at every step, the soft loop
    recovers from an overshooting start."""
    pj, ref, got = _pair(option, solver=solver, iters=40 if solver == "pdip" else 400)
    res_r = mpc.simulate(jnp.asarray(x0, jnp.float64), pj.system(jnp.float64), steps=steps,
                         policy=ref.policy(), policy_carry=ref.initial_carry(jnp.float64))
    sys_t = port.session2_problem(N=N).system(torch.float64, "cpu")
    res_g = simulate(torch.tensor(x0, dtype=torch.float64), sys_t, steps, got.policy(),
                     got.initial_carry(torch.float64, "cpu"))
    assert set(res_g.logs) == set(res_r.logs)
    np.testing.assert_allclose(res_g.inputs.numpy(), np.asarray(res_r.inputs), atol=TOL_U)
    np.testing.assert_array_equal(res_g.logs["solver_success"].numpy(),
                                  np.asarray(res_r.logs["solver_success"]))
    np.testing.assert_allclose(res_g.logs["state_prediction"].numpy(),
                               np.asarray(res_r.logs["state_prediction"]), atol=1e-3)


def test_tracking_policy_matches_jax():
    """Preview tracking of a position ramp (tests/test_tracking.py's), pdip:
    inputs within 1e-4; a constant window equals the baked reference."""
    Nt, steps = 12, 40
    pj = mpc.session3_problem(N=Nt)
    from model_predictive_control_tpu_torch.solvers.linear_mpc import session3_problem

    t = np.arange(steps + Nt + 1) * pj.Ts
    p = np.minimum(-90.0 + 2.0 * t, -30.0)
    ref_traj = np.stack([p, np.where(p < -30.0, 2.0, 0.0)], axis=1)[1:]
    ref = mpc.make_linear_mpc(pj, solver="pdip", iters=40, dtype=jnp.float64)
    got = port.make_linear_mpc(session3_problem(N=Nt), solver="pdip", iters=40,
                               dtype=torch.float64, device="cpu")
    x0 = np.array([-90.0, 2.0])
    res_r = mpc.simulate(jnp.asarray(x0), pj.system(jnp.float64), steps=steps,
                         policy=ref.tracking_policy(jnp.asarray(ref_traj)),
                         policy_carry=ref.initial_carry(jnp.float64))
    res_g = simulate(torch.as_tensor(x0), session3_problem(N=Nt).system(torch.float64, "cpu"),
                     steps, got.tracking_policy(torch.as_tensor(ref_traj)),
                     got.initial_carry(torch.float64, "cpu"))
    np.testing.assert_allclose(res_g.inputs.numpy(), np.asarray(res_r.inputs), atol=TOL_U)
    np.testing.assert_allclose(res_g.logs["ref"].numpy(), np.asarray(res_r.logs["ref"]))
    window = torch.tensor([[-30.0, 0.0]] * Nt, dtype=torch.float64)
    baked = port.make_linear_mpc(session3_problem(N=Nt), solver="pdip", dtype=torch.float64,
                                 device="cpu", x_ref=(-30.0, 0.0))
    np.testing.assert_allclose(got.qp.ref_linear_term(window).numpy(), baked.qp.q_const.numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("axis", [0, 1])
def test_soft_shift_warm_is_exact(axis):
    """The soft layout ``[ū, s | (in, up, lo, sl)]`` shifts block by block,
    bit for bit the JAX package's."""
    _, ref, got = _pair("soft")
    rng = np.random.default_rng(axis)
    shape = lambda k: (k,) if axis == 0 else (3, k)
    x = rng.normal(size=shape(got.qp.n))
    y = rng.normal(size=shape(got.qp.m))
    xr, yr = ref._shift_warm(jnp.asarray(x), jnp.asarray(y), axis=axis)
    xg, yg = got._shift_warm(torch.as_tensor(x), torch.as_tensor(y), axis=axis)
    np.testing.assert_array_equal(xg.numpy(), np.asarray(xr))
    np.testing.assert_array_equal(yg.numpy(), np.asarray(yr))
