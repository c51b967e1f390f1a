"""User constraint rows and terminal rows in the fused tracker: the port's
twin against the JAX package's ``fused_tracker_solve`` in interpret mode, on
the planar quadrotor of ``tests/test_ilqr_factory_constrained.py`` (a
keep-out disc on its path, state-only rows), predicted with one Euler step
an interval (the rows are what is held here; the integrators are held in
``test_torch_benchmark_models.py``).

The disc row is a bare Python callable: on the card it runs on an
instantiation generated from it (``ops/cuda/tracker_codegen.py``); here the
twin is held. The thrust cluster (nu = 4) with the spherical keep-out of
``tests/test_ilqr_factory_constrained.py`` is one more case. Gates:
converged masks and executed inner iterations equal; us and xs within 1e-5
after one inner iteration (lam within 1e-5 of its largest entry), within
5e-3 at a 3 × 5 budget (the JAX package's gate between two float32
implementations of a K3 OCP).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_predictive_control_tpu.models.benchmarks import (
    make_planar_quadrotor_ode_rows as jax_quadrotor_rows,
)
from model_predictive_control_tpu.models.benchmarks import (
    make_thruster_ode_rows as jax_thruster_rows,
)
from model_predictive_control_tpu.ops.pallas.ilqr_factory import fused_tracker_solve

from model_predictive_control_tpu_torch.models.benchmarks import (
    QUADROTOR_PARAMS,
    THRUSTER_PARAMS,
    make_planar_quadrotor_ode_rows,
    make_thruster_ode_rows,
)
from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as F

N, TS, SUB, TILE = 6, 0.1, 1, 4
OBS_X, OBS_Z, OBS_R = 0.55, -0.05, 0.3
M_, _, _, G_ = QUADROTOR_PARAMS
QUAD_LIMITS = ((0.0, 0.0), (1.5 * M_ * G_, 1.5 * M_ * G_))
QUAD_WEIGHTS = ((5.0, 5.0, 1.0, 0.5, 0.5, 0.1), (0.02, 0.02), 10.0)
STATE_LIMITS = ((-2.0, -2.0, -0.5, -3.0, -3.0, -3.0), (2.0, 2.0, 0.5, 3.0, 3.0, 3.0))
TERMINAL_LIMITS = ((-0.3, -0.3, -0.2, -0.5, -0.5, -0.5), (0.3, 0.3, 0.2, 0.5, 0.5, 0.5))
X0S = np.asarray([
    [1.1, -0.1, 0.0, -0.3, 0.0, 0.0],  # the straight line clips the disc
    [1.3, 0.2, 0.1, 0.0, 0.0, 0.0],
    [0.95, -0.35, 0.0, 0.0, 0.2, 0.0],
    [1.2, 0.0, -0.1, -0.2, 0.1, 0.0],
], np.float32)


def quad_clearance_rows(xr, ur):
    """One circle-clearance row (c = r² − ‖p − p_obs‖² ≤ 0), state-only:
    plain arithmetic, the same function for both packages."""
    wx = xr[0] - OBS_X
    wz = xr[1] - OBS_Z
    return (OBS_R * OBS_R - (wx * wx + wz * wz),)


def quad_coupled_rows(xr, ur):
    """The disc row and a row coupling position and thrust, c = 0.3 − u₀·x ≤ 0
    (active at the zero warm start): with ``extra_deps="xu"`` its Hessian has
    state-input entries."""
    return quad_clearance_rows(xr, ur) + (0.3 - ur[0] * xr[0],)


KEEPOUT = (0.45, 0.0, 0.1, 0.25)


def keepout_rows(xr, ur):
    """The thrust cluster's spherical keep-out (``c = r² − ‖p − o‖² ≤ 0``,
    on (px, py, pz)), the same function for both packages."""
    ox, oy, oz, orad = KEEPOUT
    wx, wy, wz = xr[0] - ox, xr[1] - oy, xr[2] - oz
    return (orad * orad - (wx * wx + wy * wy + wz * wz),)


THRUSTER = dict(nx=6, nu=4, limits=((0.0,) * 4, (6.0,) * 4),
                weights=((5.0, 5.0, 5.0, 0.5, 0.5, 0.5), (0.02,) * 4, 10.0))
THRUSTER_X0S = np.asarray([
    [0.95, 0.05, 0.15, -0.3, 0.0, 0.0],  # the straight line clips the sphere
    [0.8, -0.1, 0.2, 0.0, 0.0, -0.1],
    [1.0, 0.1, 0.05, 0.0, 0.1, 0.0],
    [0.9, -0.05, 0.1, -0.1, 0.0, 0.1],
], np.float32)

CASES = {
    # name: (keywords, outer, inner, tol)
    "coupled_rows_xu_one_iteration": (dict(extra_constraints=quad_coupled_rows, n_extra=2,
                                           extra_deps="xu", extra_order=2), 1, 1, 1e-5),
    "disc_order2_budget": (dict(extra_constraints=quad_clearance_rows, n_extra=1,
                                extra_deps="x", extra_order=2), 3, 5, 5e-3),
    "disc_order1_one_iteration": (dict(extra_constraints=quad_clearance_rows, n_extra=1,
                                       extra_deps="x", extra_order=1), 1, 1, 1e-5),
    "terminal_state_limits_one_iteration": (dict(state_limits=STATE_LIMITS,
                                                 terminal_state_limits=TERMINAL_LIMITS), 1, 1,
                                            1e-5),
    "thruster_keepout_one_iteration": (dict(extra_constraints=keepout_rows, n_extra=1,
                                            extra_deps=(0, 1, 2), extra_order=2), 1, 1, 1e-5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_pallas_tracker(case):
    extra, outer, inner, tol = CASES[case]
    thruster = case.startswith("thruster")
    kw = dict(nx=6, nu=2, N=N, ts=TS, substeps=SUB, integrator="euler", limits=QUAD_LIMITS,
              weights=QUAD_WEIGHTS, outer_iters=outer, inner_iters=inner, viol_tol=1e-4, tile=TILE, **extra)
    x0s = X0S
    jax_rows, rows = jax_quadrotor_rows(QUADROTOR_PARAMS), make_planar_quadrotor_ode_rows(
        QUADROTOR_PARAMS)
    if thruster:
        kw.update(THRUSTER)
        x0s = THRUSTER_X0S
        jax_rows, rows = jax_thruster_rows(THRUSTER_PARAMS), make_thruster_ode_rows(THRUSTER_PARAMS)
    B = x0s.shape[0]
    u0 = np.zeros((B, N, kw["nu"]), np.float32)
    ref = fused_tracker_solve(jnp.asarray(x0s), jnp.asarray(u0), None, ode_rows=jax_rows, **kw)
    got = F.fused_tracker_solve_cuda(torch.as_tensor(x0s), torch.as_tensor(u0), None,
                                     ode_rows=rows, **kw)
    n_lam = N + 1 if "terminal_state_limits" in extra else N
    assert got.lam.shape == np.asarray(ref.lam).shape and got.lam.shape[1] == n_lam
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(got.inner_iters_executed.numpy(),
                                  np.asarray(ref.inner_iters_executed))
    for name in ("us", "xs") + (("lam",) if tol == 1e-5 else ()):
        want = np.asarray(getattr(ref, name))
        d = np.abs(getattr(got, name).numpy() - want).max()
        # multipliers grow with mu: held relative to their largest
        bar = tol * max(1.0, np.abs(want).max()) if name == "lam" else tol
        print(f"{case}: max|{name} - {name}_jax| {d:.3e} (tol {bar:.3e})")
        assert d <= bar, name
    if "terminal_state_limits" in extra:
        # the terminal row N past its 2 nx rows stays zero
        assert bool((got.lam[:, N, 2 * 6:] == 0).all())


def test_bare_rows_reach_the_generated_instantiation_on_the_card(monkeypatch):
    """On CUDA tensors a bare constraint row function goes to an
    instantiation generated from it: with the build and the launch stood in
    for, the solve reaches the generated library once (at the default
    group 8), with the rows' functor (one row on the six x columns), the
    model's, order 2 and the solve's Euler and input box, and counts one
    launch under the instantiation's name."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(F, "_build_library", lambda *a, **k: pytest.fail("built a hand library"))
    seen = []

    class Lib:
        @staticmethod
        def tracker_generated_launch(*args):
            seen.append(args)
            return 0

    reached = []
    monkeypatch.setattr(F, "_generated_library",
                        lambda inst, group: reached.append((inst, group)) or Lib)
    before = F.LAUNCHES
    F.fused_tracker_solve_cuda(
        torch.as_tensor(X0S), torch.zeros(4, N, 2), None,
        ode_rows=make_planar_quadrotor_ode_rows(QUADROTOR_PARAMS), nx=6, nu=2, N=N, ts=TS,
        substeps=SUB, limits=QUAD_LIMITS, weights=QUAD_WEIGHTS, integrator="euler",
        extra_constraints=quad_clearance_rows, n_extra=1, extra_deps="x")
    ((inst, group),) = reached
    assert group == F.GENERATED_GROUP == 8 and len(seen) == 1
    assert "NEXTRA = 1, NE = 6" in inst.rows and "NX = 6, NU = 2, NP = 0" in inst.model
    assert inst.order == 2 and not inst.rk4 and inst.ubox and not (inst.tbox or inst.rw)
    assert F.LAUNCHES == before + 1 and F.LAUNCHES_BY_KERNEL[inst.key] >= 1
