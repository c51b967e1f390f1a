"""The stagewise (long-horizon) controller's terminal options in the port
against the JAX package: ``make_stagewise_mpc(terminal="dare")`` and
``terminal_set=True`` (the last stage's box tightened to the certified inner
box of the invariant DARE ellipsoid). Gates: the data within 1e-9 of the
∞-norm (float64 on both sides), a 40-step closed loop through
``backend="torch"`` within 1e-4 of the JAX controller's u-trajectory
(ROADMAP's bar for u-trajectories against the float64 oracles), succeeding at
every step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.control.simulate import simulate
from model_predictive_control_tpu_torch.solvers.riccati_ip import make_stagewise_mpc

TOL_U = 1e-4


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want[np.isfinite(want)]).max()))


@pytest.mark.parametrize("terminal, terminal_set", [("dare", False), ("Q", True)])
def test_stagewise_terminal_options_match_jax(terminal, terminal_set):
    """``make_stagewise_mpc`` with the DARE terminal weight and the terminal
    set (per-stage bounds, the last stage tightened): data within 1e-9, a
    40-step closed loop through ``backend="torch"`` within 1e-4 of the JAX
    controller's, succeeding at every step."""
    pj = mpc.session2_problem(N=20)
    ref = mpc.make_stagewise_mpc(pj, iters=25, dtype=jnp.float64, terminal=terminal,
                                 terminal_set=terminal_set)
    got = make_stagewise_mpc(port.session2_problem(N=20), iters=25, dtype=torch.float64,
                             terminal=terminal, terminal_set=terminal_set, device="cpu")
    for name in ("Pf", "x_lb", "x_ub", "u_lb", "u_ub"):
        _close(getattr(got, name), getattr(ref, name), 1e-9)
    if terminal_set:
        assert got.x_ub.shape == (20, 2) and float(got.x_ub[-1, 1]) < float(got.x_ub[0, 1])
    x0 = (-15.0, 8.0)
    res_r = mpc.simulate(jnp.asarray(x0, jnp.float64), pj.system(jnp.float64), steps=40,
                         policy=ref.policy(), policy_carry=ref.initial_carry(jnp.float64))
    res_g = simulate(torch.tensor(x0, dtype=torch.float64),
                     port.session2_problem(N=20).system(torch.float64, "cpu"), 40, got.policy(),
                     got.initial_carry(torch.float64, "cpu"))
    np.testing.assert_allclose(res_g.inputs.numpy(), np.asarray(res_r.inputs), atol=TOL_U)
    assert bool(res_g.logs["solver_success"].all())
