"""The port's batched iLQR and AL-iLQR (``solvers/ilqr.py``) against the JAX
package's, on the same problems.

Tolerances, float64, the bars of ``tests/test_ilqr.py``: the LQ problem's
controls within 1e-7 of the Riccati solution (and of the JAX solve); the
parking solves' cost within 1e-8 and controls within 1e-4 of the JAX
solve (they agree to ~1e-14: the same algorithm, derivatives by
``torch.func`` where JAX uses ``jax.jacfwd`` / ``jax.hessian``). A batch
whose scenarios stop at different iterations equals its scenarios solved
one by one within 1e-12. Float32, the parking sweep's budget and 1e-4 gate
on the plain parking OCP: the JAX float32 solve's converged flag, controls
within 5e-3 (two float32 implementations round apart; they agree to
~1e-4). With the obstacle the float32 AL iteration is chaotic at 6 × 15
(the port and JAX part by up to 0.08 in u at N=8 while both agree to 1e-14
in float64), the float32 chaos of ROADMAP queue 3: not gated here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.solvers.parking import (
    Q_SOL as JQ_SOL,
    QN_SCALE_SOL as JQN_SOL,
    make_parking_ilqr as jax_make_parking_ilqr,
)

from model_predictive_control_tpu_torch.models.parameters import VehicleParameters
from model_predictive_control_tpu_torch.ops.riccati import riccati_recursion
from model_predictive_control_tpu_torch.solvers import ilqr as IL
from model_predictive_control_tpu_torch.solvers.parking import Q_SOL, QN_SCALE_SOL, make_parking_ilqr

X0 = np.array([0.3, -0.1, 0.0, 0.0])
X_OBS = (0.25, 0.0, 0.0, 0.0)


def _lq(N, dtype=torch.float64):
    A = torch.tensor([[1.0, 0.5], [0.0, 1.0]], dtype=dtype)
    B = torch.tensor([[0.0], [0.5]], dtype=dtype)
    Q = torch.diag(torch.tensor([10.0, 1.0], dtype=dtype))
    R = torch.tensor([[0.01]], dtype=dtype)
    prob = IL.ILQRProblem(
        dynamics=lambda x, u, p: A @ x + B @ u,
        stage_cost=lambda x, u, p, s: x @ (Q @ x) + u @ (R @ u),
        terminal_cost=lambda x, p: x @ (Q @ x),
        N=N, nx=2, nu=1,
    )
    return prob, A, B, Q, R


def test_ilqr_matches_lqr_and_jax():
    """On an LQ problem the backward pass is the Riccati recursion: the
    solve lands on the LQR controls (1e-7), and each start on the JAX
    solve's controls (1e-7) and cost (1e-8)."""
    N = 12
    prob, A, B, Q, R = _lq(N)
    x0 = torch.tensor([[-3.0, 2.0], [1.0, -1.0]], dtype=torch.float64)
    sol = IL.ilqr_solve(prob, x0, iters=10)
    assert sol.us.shape == (2, N, 1) and bool(sol.converged.all())
    _, K = riccati_recursion(A, B, Q, R, Q, N)
    x, us = x0, []
    for k in range(N):
        u = x @ K[k].T
        us.append(u)
        x = x @ A.T + u @ B.T
    # the JAX test's start (the other one stops at its gradient test a few
    # 1e-7 short of the Riccati controls, in both packages)
    torch.testing.assert_close(sol.us[0], torch.stack(us, dim=1)[0], rtol=0, atol=1e-7)

    Aj, Bj, Qj, Rj = (jnp.asarray(m.numpy()) for m in (A, B, Q, R))
    jprob = mpc.ILQRProblem(dynamics=lambda x, u, t: Aj @ x + Bj @ u,
                            stage_cost=lambda x, u, t: x @ (Qj @ x) + u @ (Rj @ u),
                            terminal_cost=lambda x: x @ (Qj @ x), N=N, nx=2, nu=1)
    for i in range(2):
        ref = mpc.ilqr_solve(jprob, jnp.asarray(x0[i].numpy()), iters=10)
        np.testing.assert_allclose(sol.us[i].numpy(), np.asarray(ref.us), atol=1e-7)
        assert abs(sol.cost[i].item() - float(ref.cost)) < 1e-8


@pytest.mark.parametrize("obstacle", [False, True])
def test_al_ilqr_parking_matches_jax(obstacle):
    """The parking OCP, the sol variant without obstacle (N=10) and the
    obstacle case (N=8): cost within 1e-8, controls within 1e-4, the
    violation and the multipliers as JAX's."""
    N, ts = (8, 0.08) if obstacle else (10, 0.05)
    kw = dict(x_obs=X_OBS if obstacle else None)
    if not obstacle:
        kw.update(Q=Q_SOL, qn_scale=QN_SCALE_SOL)
    prob, cons, nc = make_parking_ilqr(VehicleParameters(), N, ts, dtype=torch.float64,
                                       device="cpu", **kw)
    jkw = dict(x_obs=jnp.asarray(X_OBS) if obstacle else None)
    if not obstacle:
        jkw.update(Q=JQ_SOL, qn_scale=JQN_SOL)
    jprob, jcons, jnc = jax_make_parking_ilqr(mpc.VehicleParameters(), N, ts, dtype=jnp.float64,
                                              **jkw)
    assert nc == jnc
    sol = IL.al_ilqr_solve(prob, cons, nc, torch.tensor(X0)[None], outer_iters=10,
                           inner_iters=30)
    ref = mpc.al_ilqr_solve(jprob, jcons, jnc, jnp.asarray(X0), outer_iters=10, inner_iters=30)
    assert bool(sol.converged[0]) and bool(ref.converged)
    assert abs(sol.cost[0].item() - float(ref.cost)) < 1e-8
    assert np.abs(sol.us[0].numpy() - np.asarray(ref.us)).max() < 1e-4
    np.testing.assert_allclose(sol.viol[0].item(), float(ref.viol), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(sol.lams[0].numpy(), np.asarray(ref.lams), atol=1e-6)


def test_batched_solve_equals_one_by_one():
    """Three parking starts whose AL loops stop at different outer rounds
    and inner iterations: the batched solve equals each scenario solved
    alone (the scenario frozen once its own exit fires)."""
    N = 6
    prob, cons, nc = make_parking_ilqr(VehicleParameters(), N, 0.08, x_obs=X_OBS,
                                       dtype=torch.float64, device="cpu")
    x0 = torch.tensor([[0.3, -0.1, 0.0, 0.0], [0.02, 0.01, 0.0, 0.0], [0.45, -0.05, 0.3, 0.0]],
                      dtype=torch.float64)
    u0 = torch.zeros(3, N, 2, dtype=torch.float64)
    u0[1] = 0.01  # the near-origin start, warm: it stops first
    kw = dict(outer_iters=5, inner_iters=8)
    both = IL.al_ilqr_solve(prob, cons, nc, x0, u_init=u0, **kw)
    alone = [IL.al_ilqr_solve(prob, cons, nc, x0[i:i + 1], u_init=u0[i:i + 1], **kw)
             for i in range(3)]
    for name in ("us", "xs", "cost", "viol", "lams"):
        torch.testing.assert_close(getattr(both, name),
                                   torch.cat([getattr(a, name) for a in alone]),
                                   rtol=0, atol=1e-12)
    # the inner solve too: a scenario that is not active keeps its controls
    inner = IL.ilqr_solve(prob, x0, u_init=u0, iters=5,
                          active=torch.tensor([True, False, True]))
    assert torch.equal(inner.us[1], u0[1])


def test_al_ilqr_float32_matches_jax():
    """Float32, the plain parking OCP at N=12 with the parking sweep's
    budget and gate (6 × 15, viol_tol 1e-4)."""
    N = 12
    prob, cons, nc = make_parking_ilqr(VehicleParameters(), N, 0.05, Q=Q_SOL,
                                       qn_scale=QN_SCALE_SOL, device="cpu")
    jprob, jcons, jnc = jax_make_parking_ilqr(mpc.VehicleParameters(), N, 0.05, Q=JQ_SOL,
                                              qn_scale=JQN_SOL)
    sol = IL.al_ilqr_solve(prob, cons, nc, torch.tensor(X0, dtype=torch.float32)[None],
                           outer_iters=6, inner_iters=15, viol_tol=1e-4)
    ref = mpc.al_ilqr_solve(jprob, jcons, jnc, jnp.asarray(X0, jnp.float32), outer_iters=6,
                            inner_iters=15, viol_tol=1e-4)
    assert sol.us.dtype == torch.float32
    assert bool(sol.converged[0]) == bool(ref.converged) and sol.viol[0].item() < 1e-4
    assert np.abs(sol.us[0].numpy() - np.asarray(ref.us)).max() < 5e-3
    assert abs(sol.cost[0].item() - float(ref.cost)) < 1e-5 * float(ref.cost)


def test_nan_factor_keeps_iterating():
    """A stage whose regularized Quu is not positive definite gives a NaN
    gradient, which keeps the scenario iterating (JAX's ``nan < x`` rule)
    and rejects the sweep: the controls stay finite."""
    prob, *_ = _lq(4)
    neg = prob._replace(stage_cost=lambda x, u, p, s: x @ x - 1e3 * (u @ u))
    sol = IL.ilqr_solve(neg, torch.tensor([[1.0, 0.0]], dtype=torch.float64), iters=3)
    assert torch.isnan(sol.grad_norm).all() and not bool(sol.converged.any())
    assert bool(torch.isfinite(sol.us).all())
