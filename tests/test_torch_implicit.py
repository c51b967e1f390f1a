"""The port's implicit differentiation against the JAX package's.

Float64 throughout, the same inputs (numpy, fixed seeds) on both sides. The
gradients are one KKT solve at each side's solution: where the forward solves
agree to rounding, the gradients agree to ~1e-12; the bars are 1e-10 for the
bare KKT solve, 1e-6 relative for the QP and AL-iLQR gradients (the
solutions themselves differ by the solvers' rounding) and 1e-8 for the
stagewise one. Central differences of the re-solved optimum hold the port
on its own, at the JAX package's bars (``tests/test_implicit.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.models.parameters import VehicleParameters as VehicleJ
from model_predictive_control_tpu.solvers import implicit as IJ
from model_predictive_control_tpu.solvers.parking import make_parking_ilqr as parking_j
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.models.parameters import VehicleParameters
from model_predictive_control_tpu_torch.solvers import implicit as IT
from model_predictive_control_tpu_torch.solvers.parking import make_parking_ilqr

REL = 1e-6


def _rel(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * (1.0 + np.abs(want).max()))


def _box_qp(seed, n=6, m=9):
    """``tests/test_implicit.py``'s random box-QP family from a numpy seed."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    width = 0.3 + rng.uniform(size=m)
    return dict(P=L @ L.T + 0.5 * np.eye(n), A=rng.normal(size=(m, n)), q=rng.normal(size=n),
                l=-width, u=0.7 * width)


def _fd(f, theta, eps=1e-6):
    g = np.zeros_like(theta)
    for i in range(theta.size):
        dp, dm = theta.copy(), theta.copy()
        dp[i] += eps
        dm[i] -= eps
        g[i] = (f(dp) - f(dm)) / (2 * eps)
    return g


def test_kkt_vjp_matches_jax():
    """One KKT solve on a (P, A, x, y, active set) with lower- and
    upper-active rows, batched and one scenario."""
    d = _box_qp(0)
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=6), rng.normal(size=9)
    lower, upper = y < -0.3, y > 0.3
    g = [rng.normal(size=k) for k in (6, 9, 9)]
    want = IJ.kkt_vjp(jnp.asarray(d["P"]), jnp.asarray(d["A"]), jnp.asarray(x), jnp.asarray(y),
                      jnp.asarray(lower), jnp.asarray(upper), *(jnp.asarray(a) for a in g))
    t = torch.as_tensor
    one = IT.kkt_vjp(t(d["P"]), t(d["A"]), t(x), t(y), t(lower), t(upper), *(t(a) for a in g))
    two = IT.kkt_vjp(t(d["P"]), t(d["A"]), *(t(np.stack([a, a])) for a in (x, y, lower, upper, *g)))
    assert lower.any() and upper.any()
    for a, b, w in zip(one, two, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=1e-10)
        assert torch.equal(b[0], b[1]) and torch.allclose(b[0], a, rtol=0, atol=1e-14)


@pytest.mark.parametrize("solver", ["admm", "pdip"])
def test_grad_wrt_qlu_matches_jax_and_fd(solver):
    d = _box_qp(0)
    c, w = np.linspace(1.0, 2.0, 6), np.linspace(-1.0, 1.0, 9)
    theta = np.array([0.3, 0.2, 0.15])
    sj = mpc.make_implicit_qp_solver(solver, iters=300)
    opj = mpc.qp_setup(jnp.asarray(d["P"]), jnp.asarray(d["A"]))

    def loss_j(th):
        q = jnp.asarray(d["q"]) + th[0] * jnp.asarray(c)
        l = jnp.asarray(d["l"]) - jnp.abs(th[1]) * jnp.abs(jnp.asarray(w))
        u = jnp.asarray(d["u"]) + jnp.abs(th[2]) * jnp.abs(jnp.asarray(w))
        sol = sj(opj, q, l, u)
        return jnp.sum(jnp.asarray(c) * sol.x) + 0.1 * jnp.sum(jnp.asarray(w) * sol.y)

    want = jax.jit(jax.grad(loss_j))(jnp.asarray(theta))
    st = port.make_implicit_qp_solver(solver, iters=300)
    op = port.qp_setup(torch.as_tensor(d["P"]), torch.as_tensor(d["A"]))
    ct, wt = torch.as_tensor(c), torch.as_tensor(w)

    def loss_t(th):
        q = torch.as_tensor(d["q"]) + th[0] * ct
        l = torch.as_tensor(d["l"]) - th[1].abs() * wt.abs()
        u = torch.as_tensor(d["u"]) + th[2].abs() * wt.abs()
        sol = st(op, q, l, u)
        assert bool(sol.converged)
        return (ct * sol.x).sum() + 0.1 * (wt * sol.y).sum()

    th = torch.tensor(theta, requires_grad=True)
    (got,) = torch.autograd.grad(loss_t(th), th)
    _rel(got, want)
    with torch.no_grad():
        # eps 1e-5: the interior point's re-solve noise over eps stays under atol
        fd = _fd(lambda a: float(loss_t(torch.as_tensor(a))), theta, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), fd, rtol=2e-5, atol=2e-7)


def test_grad_wrt_P_and_A_through_qp_setup_matches_jax_and_fd():
    """The weight-tuning path: ``theta`` scales the Hessian, or moves the
    constraint matrix; the gradient reaches ``op.P`` / ``op.A_c`` through
    ``qp_setup`` and nothing else of the operator."""
    d = _box_qp(1)
    V = np.random.default_rng(3).normal(size=d["A"].shape)
    c = np.linspace(-1.0, 1.0, 6)
    sj = mpc.make_implicit_qp_solver("admm", iters=300)
    st = port.make_implicit_qp_solver("admm", iters=300)
    q, l, u = (jnp.asarray(d[k]) for k in "qlu")
    qt, lt, ut = (torch.as_tensor(d[k]) for k in "qlu")
    eye = np.eye(6)

    def loss_j(th):
        op = mpc.qp_setup(jnp.asarray(d["P"]) + th[0] * eye, jnp.asarray(d["A"]) + th[1] * V)
        return jnp.sum(jnp.asarray(c) * sj(op, q, l, u).x)

    def loss_t(th):
        op = port.qp_setup(torch.as_tensor(d["P"]) + th[0] * torch.as_tensor(eye),
                           torch.as_tensor(d["A"]) + th[1] * torch.as_tensor(V))
        return (torch.as_tensor(c) * st(op, qt, lt, ut).x).sum()

    theta = np.array([0.4, 0.05])
    want = jax.jit(jax.grad(loss_j))(jnp.asarray(theta))
    th = torch.tensor(theta, requires_grad=True)
    (got,) = torch.autograd.grad(loss_t(th), th)
    _rel(got, want)
    with torch.no_grad():
        fd = _fd(lambda a: float(loss_t(torch.as_tensor(a))), theta)
    np.testing.assert_allclose(got.numpy(), fd, rtol=5e-5, atol=2e-8)


def test_batched_gradient_equals_scenario_gradients():
    """A batch of four q shifts through one batched implicit solve: each
    scenario's gradient is the one-scenario solve's, and JAX's ``vmap``."""
    d = _box_qp(4)
    shifts = 0.1 * np.random.default_rng(5).normal(size=(4, 6))
    sj = mpc.make_implicit_qp_solver("admm", iters=200)
    opj = mpc.qp_setup(jnp.asarray(d["P"]), jnp.asarray(d["A"]))
    loss_j = lambda s: jnp.sum(sj(opj, jnp.asarray(d["q"]) + s, jnp.asarray(d["l"]),
                                  jnp.asarray(d["u"])).x)
    want = jax.jit(jax.vmap(jax.grad(loss_j)))(jnp.asarray(shifts))
    st = port.make_implicit_qp_solver("admm", iters=200)
    op = port.qp_setup(torch.as_tensor(d["P"]), torch.as_tensor(d["A"]))
    s = torch.tensor(shifts, requires_grad=True)
    sol = st(op, torch.as_tensor(d["q"]) + s, torch.as_tensor(d["l"]).expand(4, 9),
             torch.as_tensor(d["u"]).expand(4, 9))
    (got,) = torch.autograd.grad(sol.x.sum(), s)
    _rel(got, want)
    one = torch.tensor(shifts[2], requires_grad=True)
    (g2,) = torch.autograd.grad(st(op, torch.as_tensor(d["q"]) + one, torch.as_tensor(d["l"]),
                                   torch.as_tensor(d["u"])).x.sum(), one)
    torch.testing.assert_close(got[2], g2, rtol=0, atol=1e-12)


STAGEWISE_N = 8


@pytest.fixture(scope="module")
def stagewise_case():
    """Session-2 data at N=8 from a start that rides the input and the
    velocity bound (``tests/test_implicit.py:187-226``), with per-stage
    linear terms; the JAX gradient of a loss on ``us``, ``xs``, ``lam_u``
    and ``lam_x`` w.r.t. all twelve canonical parameters."""
    Ts, N = 0.3, STAGEWISE_N
    rng = np.random.default_rng(8)
    params = [
        np.broadcast_to(np.array([[1.0, Ts], [0.0, 1.0]]), (N, 2, 2)).copy(),
        np.broadcast_to(np.array([[0.0], [Ts]]), (N, 2, 1)).copy(),
        np.broadcast_to(np.diag([10.0, 1.0]), (N, 2, 2)).copy(),
        np.broadcast_to(np.diag([0.01]), (N, 1, 1)).copy(),
        np.diag([10.0, 1.0]),
        np.tile([-150.0, -20.0], (N, 1)), np.tile([1.0, 25.0], (N, 1)),
        np.tile([-20.0], (N, 1)), np.tile([10.0], (N, 1)),
        np.array([-30.0, 23.0]),
        0.1 * rng.normal(size=(N + 1, 2)), 0.01 * rng.normal(size=(N, 1)),
    ]
    weights = [rng.normal(size=s) for s in ((N, 1), (N + 1, 2), (N, 1), (N, 2))]

    def loss_j(*p):
        res = IJ.make_implicit_stagewise_solver(N, iters=40)(*p)
        return sum(jnp.sum(jnp.asarray(w) * a) for w, a in
                   zip(weights, (res.us, res.xs, res.lam_u, 1e-3 * res.lam_x)))

    p_j = [jnp.asarray(a) for a in params]
    want = jax.grad(loss_j, argnums=tuple(range(12)))(*p_j)  # its backward splits eagerly
    res_j = mpc.stagewise_ip_solve_implicit(*p_j[:10], p_j[10], p_j[11], N=N, iters=40)
    return params, weights, want, res_j


def test_stagewise_implicit_gradient_matches_jax(stagewise_case):
    params, weights, want, res_j = stagewise_case
    p = [torch.tensor(a, requires_grad=True) for a in params]
    res = IT.make_implicit_stagewise_solver(STAGEWISE_N, iters=40)(*p)
    assert bool(res.success) and bool(res_j.success)
    assert float(res.lam_x.abs().max()) > 1.0  # the velocity bound is active
    np.testing.assert_allclose(res.us.detach().numpy(), np.asarray(res_j.us), atol=1e-10)
    loss = sum((torch.as_tensor(w) * a).sum() for w, a in
               zip(weights, (res.us, res.xs, res.lam_u, 1e-3 * res.lam_x)))
    got = torch.autograd.grad(loss, p)
    for name, g, w in zip(IT._STAGEWISE_PARAMS, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-8 * (1.0 + np.abs(np.asarray(w)).max()), err_msg=name)


def test_stagewise_implicit_broadcasting_and_fd():
    """The public signature (LTI data, shared bounds) reduces the gradients
    to the caller's shapes; x0, a dynamics entry, R and the input bound
    against central differences (``tests/test_implicit.py:184-226``)."""
    Ts, N = 0.3, STAGEWISE_N
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    A, B, Q, R = t([[1.0, Ts], [0.0, 1.0]]), t([[0.0], [Ts]]), t([[10.0, 0.0], [0.0, 1.0]]), t([[0.01]])
    x_lb, x_ub, u_lb, u_ub = t([-150.0, -20.0]), t([1.0, 25.0]), t([-20.0]), t([10.0])

    def loss(theta):
        x0 = t([-30.0, 23.0]) + theta[0]
        A_t = A + theta[1] * t([[0.0, 1.0], [0.0, 0.0]])
        res = port.stagewise_ip_solve_implicit(A_t, B, Q, R * (1.0 + theta[2]), Q, x_lb, x_ub,
                                               u_lb, u_ub + theta[3], x0, N=N, iters=40)
        return (res.us ** 2).sum() + (res.xs[-1] ** 2).sum()

    theta = torch.zeros(4, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(theta), theta)
    with torch.no_grad():
        fd = _fd(lambda a: float(loss(torch.as_tensor(a))), np.zeros(4), eps=1e-5)
    np.testing.assert_allclose(g.numpy(), fd, rtol=1e-4, atol=1e-6)
    Rg = torch.tensor([[0.01]], dtype=torch.float64, requires_grad=True)
    res = port.stagewise_ip_solve_implicit(A, B, Q, Rg, Q, x_lb, x_ub, u_lb, u_ub,
                                           t([-30.0, 23.0]), N=N, iters=40)
    (gR,) = torch.autograd.grad(res.us.sum(), Rg)
    assert gR.shape == (1, 1) and bool(torch.isfinite(gR).all())


PARK_N, PARK_TS = 5, 0.05
X0S = np.array([[0.6, -0.25, 0.0, 0.0], [0.4, 0.2, 0.3, 0.0], [0.55, -0.22, 0.0, 0.0]])
THETA = {"logQ": np.log([1.0, 3.0, 0.1, 0.01]), "logR": np.log([1.0, 0.01])}


def _objective(sol, xp):
    """A loss on every differentiable output: controls, terminal state,
    cost and multipliers."""
    return ((sol.us ** 2).sum() + (sol.xs[..., -1, :] ** 2).sum() + sol.cost.sum()
            + 0.1 * (sol.lams * xp.linspace(0.0, 1.0, sol.lams.shape[-1])).sum())


@pytest.fixture(scope="module")
def parking_grads():
    """JAX's θ and x0 gradients of :func:`_objective` through
    ``make_implicit_al_ilqr_param_solver`` (per-scenario forward, summed
    over the starts), and its x0 gradient through
    ``make_implicit_al_ilqr_solver``."""
    params = VehicleJ()

    def problem_fn(theta):
        prob, cons, _ = parking_j(params, N=PARK_N, ts=PARK_TS, x_obs=None,
                                  Q=jnp.exp(theta["logQ"]), R=jnp.exp(theta["logR"]),
                                  qn_scale=10.0, dtype=jnp.float64)
        return prob, cons

    nc = parking_j(params, N=PARK_N, ts=PARK_TS, x_obs=None, dtype=jnp.float64)[2]
    solve = IJ.make_implicit_al_ilqr_param_solver(problem_fn, nc, outer_iters=8, inner_iters=30)
    theta = {k: jnp.asarray(v) for k, v in THETA.items()}
    obj = lambda th, x0: _objective(solve(th, x0), jnp)
    g_theta, g_x0 = jax.jit(jax.vmap(jax.grad(obj, argnums=(0, 1)), in_axes=(None, 0)))(
        theta, jnp.asarray(X0S))
    prob, cons, _ = parking_j(params, N=PARK_N, ts=PARK_TS, x_obs=None, dtype=jnp.float64)
    solve_x = IJ.make_implicit_al_ilqr_solver(prob, cons, nc, outer_iters=8, inner_iters=30)
    g_x = jax.jit(jax.vmap(jax.grad(lambda x0: _objective(solve_x(x0), jnp))))(jnp.asarray(X0S))
    return ({k: np.asarray(v).sum(axis=0) for k, v in g_theta.items()}, np.asarray(g_x0),
            np.asarray(g_x))


def test_al_ilqr_theta_and_x0_gradients_match_jax(parking_grads):
    """The batched backward (one ``vmap`` over the starts) gives JAX's
    per-scenario gradients: θ summed over the batch, x0 per start."""
    want_theta, want_x0, _ = parking_grads
    params = VehicleParameters()

    def problem_fn(theta):
        prob, cons, _ = make_parking_ilqr(params, N=PARK_N, ts=PARK_TS, x_obs=None,
                                          Q=torch.exp(theta["logQ"]), R=torch.exp(theta["logR"]),
                                          qn_scale=10.0, dtype=torch.float64)
        return prob, cons

    nc = make_parking_ilqr(params, N=PARK_N, ts=PARK_TS, x_obs=None, dtype=torch.float64,
                           device="cpu")[2]
    solve = port.make_implicit_al_ilqr_param_solver(problem_fn, nc, outer_iters=8,
                                                    inner_iters=30)
    theta = {k: torch.tensor(v, requires_grad=True) for k, v in THETA.items()}
    x0 = torch.tensor(X0S, requires_grad=True)
    sol = solve(theta, x0)
    assert bool(sol.converged.all()) and float(sol.lams.max()) > 1e-3
    got = torch.autograd.grad(_objective(sol, torch), [theta["logQ"], theta["logR"], x0])
    _rel(got[0], want_theta["logQ"])
    _rel(got[1], want_theta["logR"])
    _rel(got[2], want_x0)
    # one scenario at a time: the same x0 gradient
    one = torch.tensor(X0S[1], requires_grad=True)
    (g1,) = torch.autograd.grad(_objective(solve(theta, one), torch), one)
    torch.testing.assert_close(g1, got[2][1], rtol=0, atol=1e-10)


def test_al_ilqr_x0_solver_matches_jax(parking_grads):
    *_, want = parking_grads
    prob, cons, nc = make_parking_ilqr(VehicleParameters(), N=PARK_N, ts=PARK_TS, x_obs=None,
                                       dtype=torch.float64, device="cpu")
    solve = port.make_implicit_al_ilqr_solver(prob, cons, nc, outer_iters=8, inner_iters=30)
    x0 = torch.tensor(X0S, requires_grad=True)
    (got,) = torch.autograd.grad(_objective(solve(x0), torch), x0)
    _rel(got, want)


def test_linear_mpc_implicit_solve_gradient_matches_jax():
    """``LinearMPC.solve(implicit=True)``: the solution equals the plain
    solve's, and the gradient of a trajectory loss w.r.t. the start is
    JAX's."""
    problem = mpc.session2_problem(N=6)
    ctrl_j = mpc.make_linear_mpc(problem, solver="admm", iters=400, dtype=jnp.float64)
    ctrl_t = port.make_linear_mpc(port.session2_problem(N=6), solver="admm", iters=400,
                                  dtype=torch.float64, device="cpu")
    x0 = np.array([-9.0, 4.0])
    w = np.linspace(1.0, 2.0, 6)

    def loss_j(x):
        u, sol = ctrl_j.solve(x, implicit=True)
        return jnp.sum(jnp.asarray(w) * u[:, 0]) + 1e-3 * jnp.sum(sol.y)

    want = jax.jit(jax.grad(loss_j))(jnp.asarray(x0))
    x = torch.tensor(x0, requires_grad=True)
    u, sol = ctrl_t.solve(x, implicit=True)
    u_plain, _ = ctrl_t.solve(x.detach())
    torch.testing.assert_close(u.detach(), u_plain, rtol=0, atol=0)
    (got,) = torch.autograd.grad((torch.as_tensor(w) * u[:, 0]).sum() + 1e-3 * sol.y.sum(), x)
    _rel(got, want)
