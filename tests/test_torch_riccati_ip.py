"""The port's stagewise Riccati interior-point solver against the JAX one.

The same inputs (numpy, fixed seeds) go through ``jax.vmap`` of the JAX
package's ``stagewise_ip_solve`` and the port's batched one, on the CPU
(``device="cpu"`` explicit: the port's default is the card).

Tolerances. In float32 both run the same algorithm with sums in another
order (XLA's matmuls against torch's), and the interior-point iterate
amplifies that to ~1e-4 on the session-2 family (controls span ±20, states
±150): 5e-4 on ``us``/``xs`` over the lanes the reference solved, with equal
success masks, is the JAX package's own bar between its two float32
implementations (``tests/test_pallas_riccati_ip.py:69-96``). In float64 the
two agree within 1e-6. The building blocks (``lq_factor``,
``lq_affine_solve``, the equilibration rules) are exact up to rounding:
1e-12 relative in float64.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.solvers import riccati_ip as J
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.convert import stagewise_mpc_from_jax
from model_predictive_control_tpu_torch.solvers import riccati_ip as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("A", "B", "Q", "R", "Pf", "x_lb", "x_ub", "u_lb", "u_ub")


def session2(N=8):
    p = mpc.session2_problem(N=N)
    Q = np.diag(p.Q)
    return dict(
        A=np.array([[1.0, p.Ts], [0.0, 1.0]]), B=np.array([[0.0], [p.Ts]]), Q=Q,
        R=np.diag(p.R), Pf=Q, x_lb=np.array([p.p_min, p.v_min]),
        x_ub=np.array([p.p_max, p.v_max]), u_lb=np.array([p.u_min]), u_ub=np.array([p.u_max]),
    )


def synthetic():
    """nx=3 / nu=2 with a dense R and infinite bounds
    (``tests/test_pallas_riccati_ip.py:144-158``)."""
    Q = np.diag([5.0, 1.0, 0.5])
    return dict(
        A=np.array([[1.0, 0.1, 0.0], [0.0, 1.0, 0.1], [0.0, 0.0, 0.95]]),
        B=np.array([[0.0, 0.005], [0.1, 0.0], [0.0, 0.1]]), Q=Q,
        R=np.array([[0.1, 0.01], [0.01, 0.2]]), Pf=Q,
        x_lb=np.array([-4.0, -2.0, -np.inf]), x_ub=np.array([4.0, 2.0, 1.5]),
        u_lb=np.array([-1.0, -0.8]), u_ub=np.array([1.0, 0.8]),
    )


def states(batch, seed=0, infeasible=False):
    rng = np.random.default_rng(seed)
    x0 = np.stack([rng.uniform(-140, -20, batch), rng.uniform(-15, 24, batch)], axis=1)
    if infeasible:
        x0[-1] = [50.0, 30.0]
    return x0


def both(data, x0, dtype="float32", u_init=None, q_lin=None, r_lin=None, **kw):
    """(JAX result, port result) on the same numpy inputs."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    args_j = [jnp.asarray(data[k], jd) for k in NAMES]
    extra = [None if v is None else jnp.asarray(v, jd) for v in (q_lin, r_lin)]

    def one(x, u):
        return J.stagewise_ip_solve(*args_j, x, u, *extra, **kw)

    xj = jnp.asarray(x0, jd)
    if u_init is None:
        ref = jax.vmap(lambda x: one(x, None))(xj)
    else:
        ref = jax.vmap(one)(xj, jnp.asarray(u_init, jd))
    t = lambda v: None if v is None else torch.as_tensor(np.asarray(v), dtype=td, device="cpu")
    got = T.stagewise_ip_solve(
        *(data[k] for k in NAMES), t(x0), t(u_init), t(q_lin), t(r_lin), **kw
    )
    return ref, got


def check(ref, got, atol, fields=("us", "xs"), rtol=0):
    ok = np.asarray(ref.success)
    np.testing.assert_array_equal(got.success.numpy(), ok)
    for name in fields:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert g.shape == r.shape
        np.testing.assert_allclose(g[ok], r[ok], rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("N, iters, infeasible", [(8, 15, False), (40, 20, True)])
def test_solve_matches_jax_session2(N, iters, infeasible):
    ref, got = both(session2(), states(6, infeasible=infeasible), N=N, iters=iters)
    check(ref, got, 5e-4)
    assert bool(got.success[:-1].all()) and bool(got.success[-1]) != infeasible
    ok = np.asarray(ref.success)
    np.testing.assert_allclose(got.mu.numpy()[ok], np.asarray(ref.mu)[ok], atol=1e-6)
    np.testing.assert_allclose(got.prim_res.numpy()[ok], np.asarray(ref.prim_res)[ok], atol=1e-5)
    # multipliers reach 1e4 here: relative to their size
    lam = np.asarray(ref.lam_x)[ok]
    np.testing.assert_allclose(got.lam_x.numpy()[ok], lam, atol=1e-3 * (1 + np.abs(lam).max()))


def test_solve_matches_jax_float64():
    ref, got = both(session2(), states(5), dtype="float64", N=12, iters=25)
    assert bool(got.success.all())
    check(ref, got, 1e-6)
    # the polish's multiplier estimates carry its penalty (1e8 in float64)
    # times the rounding of the polished trajectory: relative to their size
    check(ref, got, 1e-6, fields=("lam_x", "lam_u"), rtol=1e-5)


def test_warm_start_matches_jax():
    data, x0 = session2(), states(4)
    cold, _ = both(data, x0, N=10, iters=18)
    warm = np.asarray(cold.us) * 0.9 + 0.05
    ref, got = both(data, x0, u_init=warm, N=10, iters=18)
    check(ref, got, 5e-4)


def test_nu2_dense_cost_and_inf_bounds():
    x0 = np.array([[3.0, -1.5, 1.0], [-3.5, 1.9, -2.0], [0.2, 0.1, 0.0]])
    ref, got = both(synthetic(), x0, N=12, iters=18)
    assert bool(got.success.all())
    check(ref, got, 2e-4)  # tests/test_pallas_riccati_ip.py:168


def test_stacked_ltv_and_stage_bounds():
    """Per-stage ``A``/``B``/``Q``/``R`` sized by the stack, and ``(N, n)``
    bounds with a tighter last stage."""
    rng = np.random.default_rng(3)
    N, data = 9, session2()
    scale = 1.0 + 0.05 * rng.uniform(-1, 1, N)
    data["A"] = data["A"][None] * np.ones((N, 1, 1))
    data["A"][:, 0, 1] *= scale
    data["B"] = data["B"][None] * scale[:, None, None]
    data["Q"] = data["Q"][None] * (1.0 + 0.1 * rng.uniform(0, 1, N))[:, None, None]
    data["R"] = data["R"][None] * np.ones((N, 1, 1))
    data["x_ub"] = np.tile(data["x_ub"], (N, 1))
    data["x_ub"][-1] = [0.5, 20.0]
    data["x_lb"] = np.tile(data["x_lb"], (N, 1))
    ref, got = both(data, states(4, seed=1), iters=18)  # N from the stack
    assert got.us.shape == (4, N, 1)
    check(ref, got, 5e-4)


def test_linear_cost_terms():
    rng = np.random.default_rng(4)
    N = 10
    q_lin = rng.normal(size=(N + 1, 2)) * np.array([2.0, 0.5])
    r_lin = rng.normal(size=(N, 1)) * 0.05
    ref, got = both(session2(), states(4, seed=2), q_lin=q_lin, r_lin=r_lin, N=N, iters=18)
    check(ref, got, 5e-4)
    # a batched linear term, one row per lane, gives the same answer
    t = lambda v: torch.as_tensor(v, dtype=torch.float32)
    data = session2()
    again = T.stagewise_ip_solve(
        *(data[k] for k in NAMES), t(states(4, seed=2)), None,
        t(np.broadcast_to(q_lin, (4, N + 1, 2)).copy()), t(r_lin), N=N, iters=18,
    )
    assert torch.equal(again.us, got.us)


def test_single_state_has_no_batch_dimension():
    data, x0 = session2(), states(3)
    t = lambda v: torch.as_tensor(v, dtype=torch.float32)
    batch = T.stagewise_ip_solve(*(data[k] for k in NAMES), t(x0), N=8, iters=12)
    one = T.stagewise_ip_solve(*(data[k] for k in NAMES), t(x0[1]), N=8, iters=12)
    assert one.us.shape == (8, 1) and one.xs.shape == (9, 2) and one.success.shape == ()
    torch.testing.assert_close(one.us, batch.us[1], rtol=0, atol=1e-5)


def _lq_data(seed=0, N=4, nx=3, nu=2, batch=()):
    rng = np.random.default_rng(seed)
    As = rng.normal(size=(N, nx, nx)) * 0.4 + np.eye(nx)
    Bs = rng.normal(size=(N, nx, nu))
    spd = lambda n, k: np.stack(
        [(lambda L: L @ L.T + 0.5 * np.eye(n))(rng.normal(size=(n, n))) for _ in range(k)]
    )
    Qts, Rts = spd(nx, N + 1), spd(nu, N)
    qts = rng.normal(size=(*batch, N + 1, nx))
    rts = rng.normal(size=(*batch, N, nu))
    return As, Bs, Qts, Rts, qts, rts


def test_lq_factor_and_affine_solve_match_jax():
    As, Bs, Qts, Rts, qts, rts = _lq_data(batch=(3,))
    f_j = J.lq_factor(*(jnp.asarray(v) for v in (As, Bs, Qts, Rts)))
    t = lambda v: torch.as_tensor(v, dtype=torch.float64)
    f_t = T.lq_factor(t(As), t(Bs), t(Qts), t(Rts))
    for name in ("K", "Quu_inv", "Qux"):
        np.testing.assert_allclose(
            getattr(f_t, name).numpy(), np.asarray(getattr(f_j, name)), rtol=1e-12, atol=1e-12
        )
    x_init = np.random.default_rng(1).normal(size=(3, 3))
    for xi in (None, x_init):
        solve = lambda q, r, x: J.lq_affine_solve(f_j, jnp.asarray(As), jnp.asarray(Bs), q, r, x)
        if xi is None:
            dx_j, du_j = jax.vmap(lambda q, r: solve(q, r, None))(jnp.asarray(qts), jnp.asarray(rts))
        else:
            dx_j, du_j = jax.vmap(solve)(jnp.asarray(qts), jnp.asarray(rts), jnp.asarray(xi))
        dx_t, du_t = T.lq_affine_solve(
            f_t, t(As), t(Bs), t(qts), t(rts), x_init=None if xi is None else t(xi)
        )
        np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(du_t.numpy(), np.asarray(du_j), rtol=1e-11, atol=1e-11)


def test_lq_factor_takes_batched_costs():
    """A leading batch dimension on the costs gives each lane its own
    factorization (the interior-point loop's use)."""
    As, Bs, Qts, Rts, _, _ = _lq_data()
    t = lambda v: torch.as_tensor(v, dtype=torch.float64)
    Qb = torch.stack([t(Qts), 2.0 * t(Qts)])
    Rb = torch.stack([t(Rts), 3.0 * t(Rts)])
    f = T.lq_factor(t(As), t(Bs), Qb, Rb)
    f1 = T.lq_factor(t(As), t(Bs), 2.0 * t(Qts), 3.0 * t(Rts))
    torch.testing.assert_close(f.K[1], f1.K, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("xp_name", ["torch", "numpy"])
def test_bound_scale_and_cost_normalizer(xp_name):
    lb = np.array([-4.0, -np.inf, -np.inf, 0.0, -3.0, 1e-12])
    ub = np.array([2.0, 5.0, np.inf, 0.0, np.inf, 2e-12])
    want = np.asarray(J.bound_scale(jnp.asarray(lb), jnp.asarray(ub)))
    np.testing.assert_array_equal(want, [3.0, 5.0, 1.0, 1e-8, 3.0, 1e-8])
    rng = np.random.default_rng(5)
    Qs, Rs, Pf = rng.normal(size=(4, 3, 3)), rng.normal(size=(4, 2, 2)), 7.0 * np.eye(3)
    c_want = float(J.cost_normalizer(jnp.asarray(Qs), jnp.asarray(Rs), jnp.asarray(Pf)))
    if xp_name == "torch":
        t = lambda v: torch.as_tensor(v, dtype=torch.float64)
        got = T.bound_scale(t(lb), t(ub)).numpy()
        c_got = T.cost_normalizer(t(Qs), t(Rs), t(Pf))
    else:
        got = T.bound_scale(lb, ub, xp=np)
        c_got = T.cost_normalizer(Qs, Rs, Pf, xp=np)
    np.testing.assert_array_equal(got, want)
    assert c_got == pytest.approx(c_want, rel=1e-15)
    assert T.cost_normalizer(0 * Qs, 0 * Rs, 0 * Pf, xp=np) == 1e8  # the 1e-8 floor


def test_make_stagewise_mpc_builds_the_same_controller():
    problem = mpc.session2_problem(N=5)
    ref = J.make_stagewise_mpc(problem, iters=17, dtype=jnp.float32, N=30)
    got = port.make_stagewise_mpc(port.session2_problem(N=5), iters=17, N=30, device="cpu")
    conv = stagewise_mpc_from_jax(ref, device="cpu")
    for c in (got, conv):
        assert (c.N, c.iters, c.parallel) == (30, 17, False)
        for name in NAMES:
            np.testing.assert_array_equal(getattr(c, name).numpy(), np.asarray(getattr(ref, name)))
    assert port.make_stagewise_mpc(port.session2_problem(N=5), device="cpu").N == 5
    assert got.initial_carry(device="cpu").shape == (30, 1)
    assert got.initial_batch_carry(7, device="cpu").shape == (7, 30, 1)


def test_scalar_policy_matches_jax():
    ref = J.make_stagewise_mpc(mpc.session2_problem(N=8), iters=15, dtype=jnp.float32)
    got = stagewise_mpc_from_jax(ref, device="cpu")
    x = states(1, seed=6)[0].astype(np.float32)
    u_j, warm_j, aux_j = ref.policy()(jnp.asarray(x), 0, ref.initial_carry())
    u_t, warm_t, aux_t = got.policy()(torch.as_tensor(x), 0, got.initial_carry(device="cpu"))
    assert set(aux_t) == set(aux_j)
    assert bool(aux_t["solver_success"]) and bool(aux_j["solver_success"])
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=5e-4)
    np.testing.assert_allclose(warm_t.numpy(), np.asarray(warm_j), atol=5e-4)
    np.testing.assert_allclose(
        aux_t["state_prediction"].numpy(), np.asarray(aux_j["state_prediction"]), atol=5e-4
    )


def test_unported_options_raise():
    """``parallel=True`` (S6), which raised here, now solves as JAX's does:
    the batched solver and the controller built with it, float64."""
    data, x0 = session2(), torch.zeros(2, 2)
    starts = np.array([[-60.0, 12.0], [-30.0, 20.0]])
    got = T.stagewise_ip_solve(*(torch.as_tensor(data[k]) for k in NAMES), torch.as_tensor(starts),
                               N=4, parallel=True)
    want = jax.vmap(lambda x: J.stagewise_ip_solve(*(jnp.asarray(data[k]) for k in NAMES), x,
                                                   N=4, parallel=True))(jnp.asarray(starts))
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us), rtol=0, atol=1e-8)
    problem = port.session2_problem(N=4)
    ctrl = port.make_stagewise_mpc(problem, device="cpu", parallel=True, dtype=torch.float64)
    assert ctrl.parallel
    u, _, _ = ctrl.policy()(torch.as_tensor(starts[0]), 0, None)
    np.testing.assert_allclose(u.numpy(), np.asarray(want.us[0, 0]), rtol=0, atol=1e-8)
    # the terminal options of S2.1 build (tests/test_torch_stagewise_terminal.py)
    for kw in ({"terminal": "dare"}, {"terminal_set": True}):
        port.make_stagewise_mpc(problem, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown terminal"):
        port.make_stagewise_mpc(problem, terminal="P", device="cpu")
    ctrl = port.make_stagewise_mpc(problem, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        ctrl.batched_policy(backend="pallas")
    with pytest.raises(ValueError, match="size the horizon"):
        T.stagewise_ip_solve(*(data[k] for k in NAMES), x0)


ENTRY_POINTS = {
    "make_stagewise_mpc": lambda: port.make_stagewise_mpc(port.session2_problem()),
    "make_linear_mpc": lambda: port.make_linear_mpc(port.session2_problem()),
    "Problem.system": lambda: port.session2_problem().system(),
    "parking_sweep": lambda: port.parking_sweep(2, 1, N=4),
    "racing_sweep": lambda: port.racing_sweep(2, 1, N=4),
    "racing_sweep_dynamic": lambda: port.racing_sweep_dynamic(2, 1, N=4),
    "initial_batch_carry": lambda: port.make_stagewise_mpc(
        port.session2_problem(), device="cpu"
    ).initial_batch_carry(3),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_the_card_by_default(name, monkeypatch):
    """Called without ``device``, an entry point runs on the card and raises
    where there is none; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_port_sources_import_no_jax():
    """No module of the port, and not ``chip_smoke.py``, imports jax or the
    JAX package."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|model_predictive_control_tpu)(\.|\s|$)", re.MULTILINE
    )
    files = [*sorted((ROOT / "model_predictive_control_tpu_torch").rglob("*.py")),
             ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert not bad, bad
