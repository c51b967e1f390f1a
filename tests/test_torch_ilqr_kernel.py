"""The fused AL-iLQR kernel's plain twin (the port, on the CPU) against the
JAX package's Pallas kernel in interpret mode, at the same tile.

Inputs are made with numpy from a fixed seed and given to both. Gates, as
in tests/test_pallas_ilqr.py: converged masks and executed inner iterations
equal; controls within 5e-3 on converged lanes (two float32
implementations of this OCP, whose sin, cos, tan and sqrt round
differently); the stored states equal the Euler rollout of the stored
controls within 1e-5; two identical calls agree bitwise.

The contract-horizon case (N=30) runs the contract's 6 outer rounds with 3
inner iterations each, not 15. With 15, the float32 iteration is chaotic at
N=30: moving x0 by one ulp moves the twin's own controls on converged lanes
by up to 0.12, as much as the twin differs from the JAX kernel there. With
3 the two agree within 3e-5 on every lane, as far as one-ulp noise carries.

The tracking (``refs``), additive-offset (``dist``) and input-reference
(``urefs``) modes are held the same way on windows like the wind and
offset-free sweeps' (N=15 and N=12, no obstacle): one outer round of one
inner iteration within 1e-5 (the two implementations' rounding only), and
the sweeps' budgets (3 × 8, 5 × 10) within the 5e-3 bar above, with equal
converged masks, on every lane. Two things part the sides on the offset-free
windows at 5 × 10, and the test handles each:

- A tile may reach the tile-wide exit (``viol < 1e-4`` and ``lam_step <
  1e-3``) one outer round apart on the two sides. Such a tile is held after
  the same rounds: the side that ran more is rerun with its outer budget cut
  until it executes exactly the other side's inner iterations. A tile for
  which no cut reproduces them fails.
- From the second outer round on, the float32 iteration is chaotic on some
  lanes: moving x0 by one ulp moves the twin's own controls on one lane by
  1.4e-2 and the Pallas kernel's on another by 2.9e-3, with the same
  iterations executed. A lane that misses the 5e-3 bar passes only if it is
  such a lane: one side's own one-ulp spread (x0 against its next float32
  up, at the same budget) is above the bar, and the twin-to-Pallas gap is
  within the larger of the two sides' spreads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.ops.pallas.ilqr_kernel import (
    al_ilqr_solve_pallas,
    parking_geometry as jax_parking_geometry,
)
from model_predictive_control_tpu_torch.models.bicycle import kinematic_bicycle_ode
from model_predictive_control_tpu_torch.models.parameters import VehicleParameters
from model_predictive_control_tpu_torch.ops.cuda import ilqr_kernel as K
from model_predictive_control_tpu_torch.ops.integrators import euler
from model_predictive_control_tpu_torch.solvers.parking import (
    Q_MAIN,
    QN_SCALE_MAIN,
    R_MAIN,
)

X_OBS = (0.25, 0.0, 0.0, 0.0)
WEIGHTS = (tuple(Q_MAIN), tuple(R_MAIN), float(QN_SCALE_MAIN))
TOL_U = 5e-3  # tests/test_pallas_ilqr.py:86
TOL_ROLLOUT = 1e-5  # tests/test_pallas_ilqr.py:88-100

CASES = {
    # name: (B, N, ts, obstacle, outer, inner, tile, warm, seed)
    "no_obstacle_N6": (2, 6, 0.1, False, 5, 12, 8, False, 0),
    "obstacle_N8": (4, 8, 0.08, True, 6, 15, 8, False, 3),
    "ragged_B5_tile4": (5, 6, 0.08, True, 4, 8, 4, False, 0),
    "warm_lam_init": (4, 8, 0.08, True, 6, 15, 4, True, 0),
    "contract_N30": (8, 30, 0.08, True, 6, 3, 8, False, 3),
}


def _inputs(B, N, obstacle, warm, seed):
    rng = np.random.default_rng(seed)
    x0 = np.array([0.3, -0.1, 0.0, 0.0]) + rng.uniform(-1, 1, (B, 4)) * np.array(
        [0.2, 0.15, 0.3, 0.05]
    )
    if obstacle:  # keep the starts outside the clearance circle
        d = x0[:, :2] - np.array(X_OBS[:2])
        r = np.linalg.norm(d, axis=1, keepdims=True)
        x0[:, :2] = np.where(r < 0.22, np.array(X_OBS[:2]) + d / r * 0.22, x0[:, :2])
    nc = K.n_constraints(3 if obstacle else 0)
    if warm:
        u = rng.uniform(-0.3, 0.3, (B, N, 2))
        lam = np.maximum(rng.normal(0.0, 0.05, (B, N, nc)), 0.0)
    else:
        u = np.zeros((B, N, 2))
        lam = None
    acc = 2.0 * (1.0 + 0.1 * rng.uniform(-1, 1, B))
    fric = 1.0 + 0.1 * rng.uniform(-1, 1, B)
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)
    return f32(x0), f32(u), f32(acc), f32(fric), f32(lam)


def _solve_jax(args, *, N, ts, obstacle, outer, inner, tile):
    x0, u, acc, fric, lam = args
    geom, limits = jax_parking_geometry(
        mpc.VehicleParameters(), X_OBS if obstacle else None, n_circles=3
    )
    j = lambda a: None if a is None else jnp.asarray(a, jnp.float32)
    return al_ilqr_solve_pallas(
        j(x0), j(u), j(acc), j(fric), lam_init=j(lam), N=N, ts=ts, geom=geom,
        limits=limits, weights=WEIGHTS, n_circles=3 if obstacle else 0,
        outer_iters=outer, inner_iters=inner, viol_tol=1e-4, tile=tile,
    )


def _solve_port(args, *, N, ts, obstacle, outer, inner, tile):
    x0, u, acc, fric, lam = args
    geom, limits = K.parking_geometry(
        VehicleParameters(), X_OBS if obstacle else None, n_circles=3
    )
    t = lambda a: None if a is None else torch.as_tensor(a)
    return K.al_ilqr_solve_cuda(
        t(x0), t(u), t(acc), t(fric), lam_init=t(lam), N=N, ts=ts, geom=geom,
        limits=limits, weights=WEIGHTS, n_circles=3 if obstacle else 0,
        outer_iters=outer, inner_iters=inner, viol_tol=1e-4, tile=tile,
    )


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_pallas_kernel(case):
    B, N, ts, obstacle, outer, inner, tile, warm, seed = CASES[case]
    args = _inputs(B, N, obstacle, warm, seed)
    kw = dict(N=N, ts=ts, obstacle=obstacle, outer=outer, inner=inner, tile=tile)
    ref = _solve_jax(args, **kw)
    got = _solve_port(args, **kw)

    nc = K.n_constraints(3 if obstacle else 0)
    assert got.us.shape == (B, N, 2) and got.xs.shape == (B, N + 1, 4)
    assert got.lam.shape == (B, N, nc) and got.viol.shape == (B,)
    assert got.converged.dtype == torch.bool
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(
        got.inner_iters_executed.numpy(), np.asarray(ref.inner_iters_executed)
    )
    conv = np.asarray(ref.converged)
    assert conv.any()
    du = np.abs(got.us.numpy() - np.asarray(ref.us)).max(axis=(1, 2))
    print(f"{case}: max|us - us_jax| on converged lanes "
          f"{du[conv].max() if conv.any() else float('nan'):.3e} (tol {TOL_U})")
    assert np.all(du[conv] <= TOL_U), du

    # rollout consistency: the stored states are the Euler rollout of the
    # stored controls under each lane's own parameters
    params = VehicleParameters(
        acceleration=torch.as_tensor(args[2]), friction=torch.as_tensor(args[3])
    )
    step = euler(lambda x, u: kinematic_bicycle_ode(params, x, u), ts)
    x = torch.as_tensor(args[0])
    for t in range(N):
        x = step(x, got.us[:, t])
        torch.testing.assert_close(x, got.xs[:, t + 1], rtol=0, atol=TOL_ROLLOUT)

    again = _solve_port(args, **kw)
    for name in ("us", "xs", "viol", "lam", "inner_iters_executed"):
        assert torch.equal(getattr(again, name), getattr(got, name)), name


def test_unported_operands_raise():
    """``refs``, ``dist`` and ``urefs`` are taken (they were refused before
    the modes were ported); what still raises is an operand of the wrong
    shape."""
    args = [torch.as_tensor(a) for a in _inputs(2, 4, True, False, 0)[:4]]
    geom, limits = K.parking_geometry(VehicleParameters(), X_OBS)
    kw = dict(N=4, ts=0.08, geom=geom, limits=limits, weights=WEIGHTS, n_circles=3,
              outer_iters=1, inner_iters=1)
    for extra in ({"refs": torch.zeros(2, 5, 4)}, {"dist": torch.zeros(2, 4)},
                  {"urefs": torch.zeros(2, 4, 2)}):
        assert K.al_ilqr_solve_cuda(*args, **extra, **kw).us.shape == (2, 4, 2)
    for extra in ({"refs": torch.zeros(2, 4, 4)}, {"dist": torch.zeros(2, 2)},
                  {"urefs": torch.zeros(1, 4, 2)}):
        with pytest.raises(ValueError, match="must be"):
            K.al_ilqr_solve_cuda(*args, **extra, **kw)


MODE_CASES = {
    # name: (refs, dist, urefs, sweep, B, N, outer, inner, tile, tol)
    "refs_one_iteration": (True, False, False, "wind", 5, 15, 1, 1, 4, 1e-5),
    "dist_urefs_one_iteration": (False, True, True, "offset_free", 5, 12, 1, 1, 4, 1e-5),
    "all_one_iteration": (True, True, True, "wind", 5, 15, 1, 1, 8, 1e-5),
    "refs_budget": (True, False, False, "wind", 6, 15, 3, 8, 4, TOL_U),
    "dist_urefs_budget": (False, True, True, "offset_free", 6, 12, 5, 10, 4, TOL_U),
    "all_budget_wind": (True, True, True, "wind", 6, 15, 3, 8, 8, TOL_U),
    "all_budget_offset_free": (True, True, True, "offset_free", 6, 12, 5, 10, 4, TOL_U),
}
# the sweeps' weights (Q, R, qn): the kinematic racing tier's, the sol variant's
SWEEP_WEIGHTS = {
    "wind": ((40.0, 40.0, 4.0, 1.0), (0.5, 0.5), 5.0),
    "offset_free": ((1.0, 3.0, 0.1, 0.01), (1.0, 0.01), 10.0),
}


def _mode_inputs(sweep, B, N, seed=11):
    """Operands like the sweep's (numpy, ``seed``). Wind: starts around the
    ellipse lap's start, a reference window along it, wind-sized offsets on
    the position rows and small input references. Offset-free: starts
    around the parking start, the target state near the origin on every
    stage, a slope's offset on the speed row, the holding input."""
    rng = np.random.default_rng(seed)
    if sweep == "wind":
        ref0 = np.array([1.5, 0.0, np.pi / 2, 0.35])
        window = ref0 + np.arange(N + 1)[:, None] * np.array([-0.0002, 0.0175, 0.012, 0.0])
        x0 = ref0 + rng.uniform(-1, 1, (B, 4)) * np.array([0.05, 0.05, 0.1, 0.03])
        refs = window[None] + rng.normal(0, 0.003, (B, N + 1, 4))
        dist = np.concatenate([rng.uniform(-4e-3, 4e-3, (B, 2)), np.zeros((B, 2))], axis=1)
        urefs = rng.uniform(-0.2, 0.2, (B, N, 2))
    else:
        x0 = np.array([0.6, -0.25, 0.0, 0.0]) + rng.uniform(-1, 1, (B, 4)) * np.array(
            [0.1, 0.1, 0.2, 0.03])
        x_s = rng.normal(0, 1e-3, (B, 4))
        refs = np.repeat(x_s[:, None], N + 1, axis=1)
        slope = rng.uniform(0.15, 0.45, B)
        dist = np.zeros((B, 4))
        dist[:, 3] = -slope * 0.05
        urefs = np.repeat(np.stack([slope / 2.0, np.zeros(B)], axis=1)[:, None], N, axis=1)
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(x0), f32(np.zeros((B, N, 2))), f32(np.full(B, 2.0)), f32(np.ones(B)), \
        f32(refs), f32(dist), f32(urefs)


@pytest.mark.parametrize("case", list(MODE_CASES))
def test_twin_modes_match_pallas_kernel(case):
    has_ref, has_dist, has_uref, sweep, B, N, outer, inner, tile, tol = MODE_CASES[case]
    x0, u, acc, fric, refs, dist, urefs = _mode_inputs(sweep, B, N)
    pick = lambda a, on: a if on else None
    extra = dict(refs=pick(refs, has_ref), dist=pick(dist, has_dist), urefs=pick(urefs, has_uref))
    # the wind and offset-free sweeps' boxes: wide state rows, the input box
    limits = ((-100.0,) * 4, (100.0,) * 4, (-1.0, -0.384), (1.0, 0.384))
    kw = dict(N=N, ts=0.05, limits=limits, weights=SWEEP_WEIGHTS[sweep], n_circles=0,
              outer_iters=outer, inner_iters=inner, viol_tol=1e-4, tile=tile)
    jgeom, _ = jax_parking_geometry(mpc.VehicleParameters(), None, n_circles=3)
    geom, _ = K.parking_geometry(VehicleParameters(), None)
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.as_tensor(a)

    def pallas(rounds, x0=x0):
        sol = al_ilqr_solve_pallas(j(x0), j(u), j(acc), j(fric),
                                   **{k: j(v) for k, v in extra.items()}, geom=jgeom,
                                   **{**kw, "outer_iters": rounds})
        return tuple(np.asarray(a) for a in (sol.us, sol.xs, sol.inner_iters_executed))

    def twin(rounds, x0=x0):
        sol = K.al_ilqr_solve_cuda(t(x0), t(u), t(acc), t(fric),
                                   **{k: t(v) for k, v in extra.items()}, geom=geom,
                                   **{**kw, "outer_iters": rounds})
        return tuple(a.numpy() for a in (sol.us, sol.xs, sol.inner_iters_executed)), sol

    (us_t, xs_t, ni_t), got = twin(outer)
    ref = al_ilqr_solve_pallas(j(x0), j(u), j(acc), j(fric), **{k: j(v) for k, v in extra.items()},
                               geom=jgeom, **kw)
    us_p, xs_p, ni_p = (np.asarray(a) for a in (ref.us, ref.xs, ref.inner_iters_executed))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    # a tile whose sides ran different iterations: cut the longer side's
    # outer budget until it runs exactly the shorter side's iterations
    held = ni_t == ni_p
    us_t, xs_t, us_p, xs_p = (a.copy() for a in (us_t, xs_t, us_p, xs_p))
    for rounds in range(1, outer):
        if held.all():
            break
        if (~held & (ni_t > ni_p)).any():
            (cu, cx, cn), _ = twin(rounds)
            cut = ~held & (ni_t > ni_p) & (cn == ni_p)
            us_t[cut], xs_t[cut] = cu[cut], cx[cut]
            held |= cut
        if (~held & (ni_p > ni_t)).any():
            cu, cx, cn = pallas(rounds)
            cut = ~held & (ni_p > ni_t) & (cn == ni_t)
            us_p[cut], xs_p[cut] = cu[cut], cx[cut]
            held |= cut
    assert held.all(), (ni_t, ni_p)
    assert (ni_t == ni_p).all() if outer == 1 or sweep == "wind" else True
    lane_max = lambda a: np.abs(a).max(axis=(1, 2))
    du, dx = lane_max(us_t - us_p), lane_max(xs_t - xs_p)
    ok = (du <= tol) & (dx <= tol)
    if not ok.all():
        # the lanes' float32 noise: each side's own spread under one ulp of x0
        x1 = np.nextafter(x0, np.float32(np.inf)).astype(np.float32)
        (nu_t, nx_t, _), _ = twin(outer, x1)
        nu_p, nx_p, _ = pallas(outer, x1)
        spread_u = np.maximum(lane_max(nu_t - got.us.numpy()), lane_max(nu_p - np.asarray(ref.us)))
        spread_x = np.maximum(lane_max(nx_t - got.xs.numpy()), lane_max(nx_p - np.asarray(ref.xs)))
        chaotic = (spread_u > tol) & (du <= spread_u) & (dx <= np.maximum(spread_x, tol))
        print(f"{case}: lanes over the bar {np.flatnonzero(~ok)}, their one-ulp spreads "
              f"{spread_u[~ok]} (controls)")
        ok |= chaotic
    print(f"{case}: max|us - us_jax| {du.max():.3e}, max|xs - xs_jax| {dx.max():.3e} "
          f"(tol {tol}); {int((ni_t != ni_p).sum())} of {B} lanes held after the same "
          f"rounds by a cut budget, {int((du > tol).sum())} chaotic")
    assert ok.all(), (du, dx)
    if outer > 1:
        assert bool(np.asarray(ref.converged).any())
