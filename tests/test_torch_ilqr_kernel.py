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
    args = [torch.as_tensor(a) for a in _inputs(2, 4, True, False, 0)[:4]]
    geom, limits = K.parking_geometry(VehicleParameters(), X_OBS)
    kw = dict(N=4, ts=0.08, geom=geom, limits=limits, weights=WEIGHTS, n_circles=3)
    for extra in ({"refs": torch.zeros(2, 5, 4)}, {"dist": torch.zeros(2, 4)},
                  {"urefs": torch.zeros(2, 4, 2)}):
        with pytest.raises(NotImplementedError, match="ROADMAP S4"):
            K.al_ilqr_solve_cuda(*args, **extra, **kw)
