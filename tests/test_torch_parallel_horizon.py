"""The port's parallel-in-horizon primitives against the JAX package's.

The same float64 inputs (numpy, fixed seeds) go through
``ops/parallel_horizon.py`` of both packages, time-invariant (LTI) and
per-stage (LTV) data, at horizons that are and are not powers of two. Both
compute the same associative combines in the same odd/even order, so they
agree to rounding: 1e-9. The stagewise interior point with the parallel KKT
solver agrees with JAX's within 1e-8 after its 20 iterations and polish.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.ops import parallel_horizon as PJ
from model_predictive_control_tpu.solvers import riccati_ip as RJ
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.models.linear import LinearSystem
from model_predictive_control_tpu_torch.ops import parallel_horizon as PT
from model_predictive_control_tpu_torch.solvers import lqr as L
from model_predictive_control_tpu_torch.solvers import riccati_ip as RT

TOL = 1e-9
HORIZONS = (1, 7, 20, 33)


def _data(N, ltv, seed, nx=3, nu=2):
    """Stable-ish dynamics, SPD stage costs, linear terms and a start; the
    dynamics and input costs stacked per stage where ``ltv``."""
    rng = np.random.default_rng(seed)
    k = N if ltv else 1
    A = np.eye(nx) + 0.1 * rng.normal(size=(k, nx, nx))
    B = rng.normal(size=(k, nx, nu))
    Lq = rng.normal(size=(N + 1, nx, nx))
    Q = Lq @ Lq.transpose(0, 2, 1) + np.eye(nx)
    Lr = rng.normal(size=(N, nu, nu))
    R = Lr @ Lr.transpose(0, 2, 1) + 0.5 * np.eye(nu)
    d = dict(A=A if ltv else A[0], B=B if ltv else B[0], Q=Q, R=R,
             q=rng.normal(size=(N + 1, nx)), r=rng.normal(size=(N, nu)),
             x0=rng.normal(size=nx), u=rng.normal(size=(N, nu)))
    return d


def _both(d, *names):
    return ([jnp.asarray(d[n]) for n in names], [torch.as_tensor(d[n]) for n in names])


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("ltv", [False, True], ids=["lti", "ltv"])
@pytest.mark.parametrize("N", HORIZONS)
def test_primitives_match_jax(N, ltv):
    """``affine_rollout_parallel``, ``rollout_parallel``,
    ``riccati_recursion_parallel`` and ``lqt_solve_parallel`` against the
    JAX package's on the same data."""
    d = _data(N, ltv, seed=N + 100 * ltv)
    (A, B, x0, u), (At, Bt, x0t, ut) = _both(d, "A", "B", "x0", "u")
    # the JAX side jitted: eager JAX compiles every primitive of the scan
    want = jax.jit(PJ.affine_rollout_parallel)(A, B, x0, u)
    _close(PT.affine_rollout_parallel(At, Bt, x0t, ut), want)
    _close(PT.rollout_parallel(LinearSystem(A=At, B=Bt), x0t, ut),
           jax.jit(lambda *a: PJ.rollout_parallel(mpc.LinearSystem(A=a[0], B=a[1]), *a[2:]))(
               A, B, x0, u))
    (Q, R), (Qt, Rt) = _both(d, "Q", "R")
    riccati = jax.jit(PJ.riccati_recursion_parallel, static_argnums=5)
    for got, want in zip(PT.riccati_recursion_parallel(At, Bt, Qt[:-1], Rt, Qt[-1], N),
                         riccati(A, B, Q[:-1], R, Q[-1], N)):
        _close(got, want, TOL * (1.0 + float(np.abs(np.asarray(want)).max())))
    As = np.broadcast_to(d["A"], (N, 3, 3))
    Bs = np.broadcast_to(d["B"], (N, 3, 2))
    args = (As, Bs, d["Q"], d["R"], d["q"], d["r"], d["x0"])
    want = jax.jit(PJ.lqt_solve_parallel)(*(jnp.asarray(a) for a in args))
    got = PT.lqt_solve_parallel(*(torch.as_tensor(np.array(a)) for a in args))
    for g, w in zip(got, want):
        _close(g, w)


def test_lqt_batch_equals_sequential_riccati():
    """A batch of right-hand sides and starts through the parallel LQ solve
    equals the sequential factor / affine-solve pair of the interior point,
    lane by lane."""
    N = 20
    d = _data(N, True, seed=3)
    rng = np.random.default_rng(4)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    qb, xb = t(rng.normal(size=(5, N + 1, 3))), t(rng.normal(size=(5, 3)))
    As, Bs, Qt, Rt, rt = t(d["A"]), t(d["B"]), t(d["Q"]), t(d["R"]), t(d["r"])
    got = PT.lqt_solve_parallel(As, Bs, Qt, Rt, qb, rt, xb)
    want = RT.lq_affine_solve(RT.lq_factor(As, Bs, Qt, Rt), As, Bs, qb, rt, x_init=xb)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-9)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_scan_equals_sequential_fold(n):
    """The associative scan against a left fold, with a combine that is
    associative but not commutative (2 x 2 matrix products with a carried
    sum), so that an operand order mistake shows."""
    rng = np.random.default_rng(n)
    M = torch.as_tensor(rng.normal(size=(n, 2, 2)))
    v = torch.as_tensor(rng.normal(size=(n, 2)))
    combine = lambda a, b: (b[0] @ a[0], (b[0] @ a[1][..., None])[..., 0] + b[1])
    got = PT.associative_scan(combine, (M, v))
    acc = (M[0], v[0])
    want = [acc]
    for k in range(1, n):
        acc = combine(acc, (M[k], v[k]))
        want.append(acc)
    for i, part in enumerate(got):
        torch.testing.assert_close(part, torch.stack([w[i] for w in want]), rtol=1e-12,
                                   atol=1e-12)


def test_solve_finite_horizon_parallel_matches_jax():
    d = _data(12, False, seed=7)
    (A, B, Q, R), (At, Bt, Qt, Rt) = _both(d, "A", "B", "Q", "R")
    want = mpc.solve_finite_horizon(mpc.LinearSystem(A=A, B=B), Q[0], R[0], Q[1], 12,
                                    parallel=True)
    got = L.solve_finite_horizon(LinearSystem(A=At, B=Bt), Qt[0], Rt[0], Qt[1], 12,
                                 parallel=True)
    seq = L.solve_finite_horizon(LinearSystem(A=At, B=Bt), Qt[0], Rt[0], Qt[1], 12)
    scale = 1.0 + float(np.abs(np.asarray(want.P)).max())
    _close(got.P, want.P, TOL * scale)
    _close(got.K, want.K)
    torch.testing.assert_close(got.P, seq.P, rtol=0, atol=TOL * scale)


def _session2_data():
    p = mpc.session2_problem()
    Q = np.diag(p.Q)
    return (np.array([[1.0, p.Ts], [0.0, 1.0]]), np.array([[0.0], [p.Ts]]), Q, np.diag(p.R), Q,
            np.array([p.p_min, p.v_min]), np.array([p.p_max, p.v_max]), np.array([p.u_min]),
            np.array([p.u_max]))


def test_stagewise_ip_parallel_matches_jax():
    """``stagewise_ip_solve(parallel=True)`` at N=12 on session-2 starts
    that activate the input and state bounds: the JAX package's parallel
    solve within 1e-8, and the port's sequential solve."""
    N = 12
    data = _session2_data()
    rng = np.random.default_rng(11)
    x0 = np.stack([rng.uniform(-120.0, -20.0, 4), rng.uniform(-10.0, 24.0, 4)], axis=1)
    want = jax.jit(jax.vmap(lambda x: RJ.stagewise_ip_solve(
        *(jnp.asarray(a) for a in data), x, N=N, parallel=True)))(jnp.asarray(x0))
    got = RT.stagewise_ip_solve(*(torch.as_tensor(a) for a in data), torch.as_tensor(x0), N=N,
                                parallel=True)
    seq = RT.stagewise_ip_solve(*(torch.as_tensor(a) for a in data), torch.as_tensor(x0), N=N)
    assert bool(got.success.all()) and np.asarray(want.success).all()
    assert float(got.lam_u.abs().max()) > 1e-3  # bounds are active
    for name in ("us", "xs"):
        _close(getattr(got, name), getattr(want, name), 1e-8)
        torch.testing.assert_close(getattr(got, name), getattr(seq, name), rtol=0, atol=1e-8)


def test_stagewise_mpc_parallel_policy_runs_the_parallel_solver(monkeypatch):
    """``make_stagewise_mpc(parallel=True)`` routes the torch backend's
    solves through ``lqt_solve_parallel`` and gives the sequential policy's
    controls."""
    calls = []
    solve = PT.lqt_solve_parallel
    monkeypatch.setattr(PT, "lqt_solve_parallel", lambda *a: calls.append(1) or solve(*a))
    problem = port.session2_problem(N=10)
    par = port.make_stagewise_mpc(problem, parallel=True, dtype=torch.float64, device="cpu")
    seq = port.make_stagewise_mpc(problem, dtype=torch.float64, device="cpu")
    x = torch.tensor([[-60.0, 12.0], [-30.0, 20.0]], dtype=torch.float64)
    carry = par.initial_batch_carry(2, dtype=torch.float64, device="cpu")
    u_p, _, aux_p = par.batched_policy(backend="torch")(x, 0, carry)
    assert calls
    u_s, _, aux_s = seq.batched_policy(backend="torch")(x, 0, carry)
    assert bool(aux_p["solver_success"].all())
    torch.testing.assert_close(u_p, u_s, rtol=0, atol=1e-8)
