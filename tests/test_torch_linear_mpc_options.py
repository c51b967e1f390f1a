"""Every option of the port's ``make_box_mpc`` against the JAX package on the
same inputs: the DARE terminal cost, the terminal set, the soft state boxes,
a baked reference, preview tracking, and the interior-point solver.

Gates:
- each option's QP data and operator, float64 builds on both sides, as
  tests/test_torch_closed_loop.py::test_port_builds_the_same_controller holds
  them (1e-10 on the QP data, 1e-9 of the ∞-norm on the operator);
- ``LinearMPC.solve`` and ``policy`` u-trajectories within 1e-4 of the JAX
  float64 solves (ROADMAP's bar for u-trajectories against the float64
  oracles);
- the soft ``_shift_warm`` exactly;
The policies in closed loop, preview tracking and the soft warm shift are
held in tests/test_torch_linear_mpc_policies.py, the stagewise controller's
terminal options in tests/test_torch_stagewise_terminal.py, the soft
batched closed loop on the twin in tests/test_torch_soft_closed_loop.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
import model_predictive_control_tpu_torch as port

N = 10
TOL_U = 1e-4

OPTIONS = {
    "plain": {},
    "dare": {"terminal": "dare"},
    "terminal_set": {"terminal_set": True},
    "soft": {"soft_state": True, "slack_weight": 100.0, "slack_linear": 50.0},
    "x_ref": {"x_ref": (-30.0, 0.0)},
    "x_ref_window": {"x_ref": np.stack([np.linspace(-40.0, -30.0, N), np.zeros(N)], 1)},
}


def _pair(option, problem="session2", solver="pdip", iters=40, N=N):
    kw = OPTIONS[option]
    pj = getattr(mpc, f"{problem}_problem")(N=N)
    pt = {"session2": port.session2_problem, "session3": port.session3_problem}[problem](N=N)
    jkw = {k: (jnp.asarray(v, jnp.float64) if k == "x_ref" else v) for k, v in kw.items()}
    ref = mpc.make_linear_mpc(pj, solver=solver, iters=iters, dtype=jnp.float64, **jkw)
    got = port.make_linear_mpc(pt, solver=solver, iters=iters, dtype=torch.float64,
                               device="cpu", **kw)
    return pj, ref, got


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want[np.isfinite(want)]).max()))


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_builds_the_same_controller(option):
    _, ref, got = _pair(option)
    assert got.soft == ref.soft
    hard_r = ref.qp.base if ref.soft else ref.qp
    hard_g = got.qp.base if got.soft else got.qp
    for name in ("P", "A_c"):
        np.testing.assert_allclose(getattr(got.qp, name).numpy(), np.asarray(getattr(ref.qp, name)),
                                   atol=1e-10)
    for name in ("q_x0", "q_const", "QG", "u_lb", "u_ub", "x_lb", "x_ub"):
        np.testing.assert_allclose(getattr(hard_g, name).numpy(),
                                   np.asarray(getattr(hard_r, name)), atol=1e-10)
    if ref.terminal_P is None:
        assert got.terminal_P is None
    else:
        _close(got.terminal_P, ref.terminal_P, 1e-10)
    for name in ("D", "E", "Minv_stack", "S"):
        _close(getattr(got.op, name), getattr(ref.op, name), 1e-9)
    x0 = np.array([[-60.0, 8.0], [-5.0, 20.0]])
    for a, b in zip(got.qp.qp_vectors(torch.as_tensor(x0)),
                    (np.stack(v) for v in zip(*(ref.qp.qp_vectors(jnp.asarray(x)) for x in x0)))):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-9)


@pytest.mark.parametrize("option", ["plain", "dare", "terminal_set", "soft", "x_ref"])
@pytest.mark.parametrize("solver, iters", [("pdip", 40), ("admm", 400)])
def test_solve_matches_jax(option, solver, iters):
    """u-trajectories of single solves at three states (one beyond the
    braking wall, where only the soft QP is feasible), wherever the JAX solve
    converged; the converged flags agree (an infeasible solve's iterate is
    not a solution, and the two packages leave it in different places)."""
    _, ref, got = _pair(option, solver=solver, iters=iters)
    states = [(-60.0, 8.0), (-15.0, 8.0)] + ([(0.5, 24.0)] if option == "soft" else [])
    for x in states:
        u_r, sol_r = ref.solve(jnp.asarray(x, jnp.float64))
        u_g, sol_g = got.solve(torch.tensor(x, dtype=torch.float64))
        assert u_g.shape == (N, 1)
        assert bool(sol_g.converged) == bool(sol_r.converged)
        if bool(sol_r.converged):
            np.testing.assert_allclose(u_g.numpy(), np.asarray(u_r), atol=TOL_U)


def test_terminal_set_rejects_x_ref():
    with pytest.raises(ValueError, match="terminal_set"):
        port.make_linear_mpc(port.session2_problem(N=N), terminal_set=True, x_ref=(0.5, 0.0),
                             device="cpu")
