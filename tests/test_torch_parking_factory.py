"""The obstacle-parking OCP through the fused tracker kernel: the port's
``al_ilqr_parking_solve_factory`` (the kernel's twin, on the CPU) against the
JAX package's in interpret mode, at the same tile, on the same seeded numpy
inputs.

Gates: converged masks and executed inner iterations equal; ``us``, ``xs``
(and ``lam``) within 1e-5 after one inner iteration, ``us`` and ``xs`` within
5e-3 at a small budget (4 × 2): float32 AL-iLQR with the obstacle is
chaotic (ROADMAP queue 3). On these inputs a budget of 3 or more inner
iterations a round meets a line-search tie on lane 1 at the third
iteration: α = 0.5 and 0.25 cost 11.6544666 and 11.6544657 in the twin, one
float32 ulp apart, and the two implementations step differently (0.068 in u
after the fourth); at 4 × 2 every lane agrees within 1.5e-6. The clearance rows are held to JAX's at
float64 within 1e-12; per-lane weights equal to the constants give the
constant-weight solve bit for bit; the sweep's ``backend="factory"`` closed
loop on JAX's draws gives JAX's success masks exactly, states within 5e-2
(``tests/test_pallas_ilqr.py:117``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.control.batch_loop import simulate_batch as jax_simulate
from model_predictive_control_tpu.ops.pallas.ilqr_kernel import parking_geometry as jax_geometry
from model_predictive_control_tpu.ops.pallas.parking_factory import (
    al_ilqr_parking_solve_factory as jax_solve,
    make_clearance_rows as jax_clearance_rows,
)
from model_predictive_control_tpu.parallel.batch import (
    batched_parking_policy as jax_policy,
    batched_plant as jax_plant,
)

import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.convert import vehicle_parameters_from_jax
from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as F
from model_predictive_control_tpu_torch.ops.cuda.ilqr_kernel import parking_geometry
from model_predictive_control_tpu_torch.ops.cuda.parking_factory import (
    al_ilqr_parking_solve_factory,
    make_clearance_rows,
    make_parking_ode_rows,
)

B, N, TS, TILE = 4, 8, 0.08, 4
X_OBS = (0.25, 0.0, 0.0, 0.0)
WEIGHTS = ((1.0, 6.0, 0.2, 0.05), (1.0, 0.01), 100.0)
NC = 4 + 8 + 9
CASES = {
    # name: (extra_order, outer, inner, lam_init, weights_rt, tol)
    "order2_one_iteration": (2, 1, 1, False, False, 1e-5),
    "order1_lam_init_weights_rt_one_iteration": (1, 1, 1, True, True, 1e-5),
    "order2_budget": (2, 4, 2, False, False, 5e-3),
    "order1_lam_init_budget": (1, 4, 2, True, False, 5e-3),
}


def _inputs(seed=0):
    """Starts around the reference's, kept out of the obstacle; per-lane
    (acc, fric); a warm start of the multipliers; per-lane weights."""
    rng = np.random.default_rng(seed)
    x0 = np.array([0.3, -0.1, 0.0, 0.0]) + rng.uniform(-1, 1, (B, 4)) * np.array(
        [0.2, 0.15, 0.3, 0.05])
    d = x0[:, :2] - np.array(X_OBS[:2])
    r = np.linalg.norm(d, axis=1, keepdims=True)
    x0[:, :2] = np.where(r < 0.22, np.array(X_OBS[:2]) + d / r * 0.22, x0[:, :2])
    acc = 2.0 * (1.0 + 0.1 * rng.uniform(-1, 1, B))
    fric = 1.0 + 0.1 * rng.uniform(-1, 1, B)
    lam = rng.uniform(0.0, 2.0, (B, N, NC)) * (rng.uniform(size=(B, N, NC)) < 0.3)
    w = np.array([*WEIGHTS[0], *WEIGHTS[1], WEIGHTS[2]])
    wrt = w * (1.0 + 0.2 * rng.uniform(-1, 1, (B, 7)))
    return {k: np.asarray(v, np.float32) for k, v in
            dict(x0=x0, acc=acc, fric=fric, lam=lam, wrt=wrt).items()}


def _kwargs(case, a, to):
    order, outer, inner, lam, wrt, _ = CASES[case]
    kw = dict(N=N, ts=TS, outer_iters=outer, inner_iters=inner, extra_order=order, tile=TILE)
    if lam:
        kw["lam_init"] = to(a["lam"])
    if wrt:
        kw["weights_rt"] = to(a["wrt"])
    else:
        kw["weights"] = WEIGHTS
    return kw


@pytest.fixture(scope="module")
def jax_solutions():
    """Every case through the JAX kernel in interpret mode, once."""
    a = _inputs()
    geom, limits = jax_geometry(mpc.VehicleParameters(), X_OBS, n_circles=3)
    out = {}
    for case in CASES:
        sol = jax_solve(jnp.asarray(a["x0"]), jnp.zeros((B, N, 2), jnp.float32),
                        jnp.asarray(a["acc"]), jnp.asarray(a["fric"]), geom=geom, limits=limits,
                        **_kwargs(case, a, jnp.asarray))
        out[case] = {f: np.asarray(getattr(sol, f)) for f in
                     ("us", "xs", "lam", "converged", "inner_iters_executed")}
    return out


def _port_solve(case, a=None, **over):
    a = _inputs() if a is None else a
    geom, limits = parking_geometry(port.VehicleParameters(), X_OBS, n_circles=3)
    t = torch.as_tensor
    return al_ilqr_parking_solve_factory(
        t(a["x0"]), torch.zeros(B, N, 2), t(a["acc"]), t(a["fric"]), geom=geom, limits=limits,
        **{**_kwargs(case, a, t), **over})


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_pallas_factory(jax_solutions, case):
    ref = jax_solutions[case]
    got = _port_solve(case)
    tol = CASES[case][-1]
    assert got.us.shape == (B, N, 2) and got.lam.shape == (B, N, NC)
    np.testing.assert_array_equal(got.converged.numpy(), ref["converged"])
    np.testing.assert_array_equal(got.inner_iters_executed.numpy(), ref["inner_iters_executed"])
    du = np.abs(got.us.numpy() - ref["us"]).max()
    dx = np.abs(got.xs.numpy() - ref["xs"]).max()
    dl = np.abs(got.lam.numpy() - ref["lam"]).max()
    print(f"{case}: max|us - us_jax| {du:.3e}, max|xs - xs_jax| {dx:.3e}, max|lam - lam_jax| "
          f"{dl:.3e} (tol {tol})")
    assert du <= tol and dx <= tol
    if tol == 1e-5:
        assert dl <= tol


def test_clearance_rows_match_jax_float64():
    """The nine rows in float64 on random states, (i, j) order, as JAX's."""
    geom, _ = parking_geometry(port.VehicleParameters(), X_OBS, n_circles=3)
    _, _, ox, r2, obs = geom
    rows = make_clearance_rows(tuple(ox), float(r2), tuple(obs))
    assert rows.n_extra == 9 and rows.deps == (0, 1, 2) and rows.kernel == "clearance"
    assert rows.consts == (*ox, r2, *(v for q in obs for v in q))
    x = np.random.default_rng(3).uniform(-1, 1, (4, 16))
    ref = jax_clearance_rows(tuple(ox), float(r2), tuple(obs))(tuple(jnp.asarray(x)), (), ())
    got = rows(tuple(torch.as_tensor(x)), (), ())
    np.testing.assert_allclose(np.stack([g.numpy() for g in got]), np.stack(ref), rtol=0,
                               atol=1e-12)
    # other circle counts run on the twin: no instantiation
    assert make_clearance_rows((0.1, 0.2), 0.04, ((0.0, 0.0), (0.1, 0.0))).kernel is None


def test_weights_rt_equal_to_the_constants_is_bit_for_bit():
    """Per-lane weight rows equal to the constant weights give the constant
    solve's every output bit for bit (the products 2 Qd, 2 Rd, (2 qn) Qd
    are formed in float32 either way)."""
    a = _inputs(seed=1)
    static = _port_solve("order2_budget", a)
    rows = np.tile(np.array([*WEIGHTS[0], *WEIGHTS[1], WEIGHTS[2]], np.float32), (B, 1))
    per_lane = _port_solve("order2_budget", a, weights=None, weights_rt=torch.as_tensor(rows))
    for f in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
        assert torch.equal(getattr(static, f), getattr(per_lane, f)), f


def test_parking_sweep_factory_closed_loop_matches_jax():
    """``backend="factory"`` closed loop, 4 scenarios × 2 steps on JAX's
    draws, the multipliers carried as JAX carries them: equal success masks,
    states within 5e-2, the carry of the same shape."""
    a = _inputs(seed=2)
    steps, outer, inner = 2, 3, 4
    plant_j = dataclasses.replace(mpc.VehicleParameters(), acceleration=jnp.asarray(a["acc"]),
                                  friction=jnp.asarray(a["fric"]))
    pol_j = jax_policy(mpc.VehicleParameters(), N, TS, x_obs=X_OBS, backend="factory", tile=TILE,
                       outer_iters=outer, inner_iters=inner)
    ref = jax_simulate(jnp.asarray(a["x0"]), jax_plant(plant_j, TS, substeps=4), steps, pol_j,
                       pol_j.initial_carry(B), batched_dynamics=True)
    plant_t = vehicle_parameters_from_jax(plant_j, device="cpu")
    pol_t = port.batched_parking_policy(port.VehicleParameters(), N, TS, x_obs=X_OBS,
                                        backend="factory", tile=TILE, outer_iters=outer,
                                        inner_iters=inner)
    got = port.simulate_batch(torch.as_tensor(a["x0"]), port.batched_plant(plant_t, TS, substeps=4),
                              steps, pol_t, pol_t.initial_carry(B, device="cpu"),
                              batched_dynamics=True)
    np.testing.assert_array_equal(got.logs["solver_success"].numpy(),
                                  np.asarray(ref.logs["solver_success"]))
    np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), atol=5e-2)
    (u_j, lam_j), (u_t, lam_t) = ref.final_carry, got.final_carry
    assert tuple(u_t.shape) == u_j.shape and tuple(lam_t.shape) == lam_j.shape == (B, N, NC)


def test_parking_sweep_factory_entry_point():
    """``parking_sweep(backend="factory")`` on the twin: the summary keys of
    the kernel route, one solve a step."""
    res, summary = port.parking_sweep(4, 2, N=6, outer_iters=2, inner_iters=3, plant_substeps=4,
                                      backend="factory", tile=TILE, device="cpu")
    assert res.states.shape == (3, 4, 4) and bool(torch.isfinite(res.states).all())
    assert "mean_inner_iters" in summary and 0.0 <= summary["success_rate"] <= 1.0


def test_factory_solve_refuses_on_the_card_what_no_library_holds(monkeypatch):
    """On CUDA tensors a solve no hand-written instantiation holds (here:
    two circles, and the nine under RK4) goes to an instantiation generated
    from its rows, with the solve's properties, before any hand library is
    built; the build is stopped here, so neither counts a launch."""

    class Reached(Exception):
        pass

    seen = []

    def generated(inst, group):
        seen.append(inst)
        raise Reached

    monkeypatch.setattr(F, "_build_library", lambda *a, **k: pytest.fail("built a library"))
    monkeypatch.setattr(F, "_generated_library", generated)
    geom, limits = parking_geometry(port.VehicleParameters(), X_OBS, n_circles=3)
    kb, lr, ox, r2, obs = geom
    x0, u0, _, par = F.prepare_tiles(torch.zeros(4, 4), torch.zeros(4, N, 2), None,
                                     torch.ones(4, 2), tile=TILE)
    kw = dict(ode_rows=make_parking_ode_rows(kb, lr), nx=4, nu=2,
              N=N, tile=TILE, ts=TS, substeps=1, integrator="euler", limits=limits[2:],
              state_limits=limits[:2], weights=WEIGHTS, outer_iters=1, inner_iters=1,
              mu_init=10.0, mu_scale=10.0, mu_max=1e8, viol_tol=1e-4, tol=1e-6,
              extra_constraints=make_clearance_rows(tuple(ox[:2]), r2, tuple(obs[:2])),
              n_extra=4, extra_deps=(0, 1, 2))
    before = F.LAUNCHES
    with pytest.raises(Reached):
        F._launch(x0, u0, None, par, **kw)
    with pytest.raises(Reached):
        F._launch(x0, u0, None, par, **{**kw, "extra_constraints": make_clearance_rows(
            tuple(ox), r2, tuple(obs)), "n_extra": 9, "integrator": "rk4"})
    assert F.LAUNCHES == before
    two, rk4 = seen
    assert "NEXTRA = 4, NE = 3" in two.rows and "NEXTRA = 9, NE = 3" in rk4.rows
    assert "k == 0 ? 0 : k == 1 ? 1 : k == 2 ? 2 : -1" in two.rows
    assert not two.rk4 and rk4.rk4 and two.order == rk4.order == 2 and two.ubox
