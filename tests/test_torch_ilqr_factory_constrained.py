"""User constraint rows and terminal rows in the fused tracker: the port's
twin against the JAX package's ``fused_tracker_solve`` in interpret mode, on
the planar quadrotor of ``tests/test_ilqr_factory_constrained.py`` (a
keep-out disc on its path, state-only rows), predicted with one Euler step
an interval (the rows are what is held here; the integrators are held in
``test_torch_benchmark_models.py``).

The disc row is a bare Python callable: it has no C++ instantiation, so it
runs on the twin only (on the card it raises, naming ROADMAP S4.6). Gates:
converged masks and executed inner iterations equal; us and xs within 1e-5
after one inner iteration (lam within 1e-5 of its largest entry), within
5e-3 at a 3 × 5 budget (the JAX package's gate between two float32
implementations of a K3 OCP).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_predictive_control_tpu.models.benchmarks import (
    make_planar_quadrotor_ode_rows as jax_quadrotor_rows,
)
from model_predictive_control_tpu.ops.pallas.ilqr_factory import fused_tracker_solve

from model_predictive_control_tpu_torch.models.benchmarks import (
    QUADROTOR_PARAMS,
    make_planar_quadrotor_ode_rows,
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
}


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_pallas_tracker(case):
    extra, outer, inner, tol = CASES[case]
    kw = dict(nx=6, nu=2, N=N, ts=TS, substeps=SUB, integrator="euler", limits=QUAD_LIMITS,
              weights=QUAD_WEIGHTS, outer_iters=outer, inner_iters=inner, viol_tol=1e-4, tile=TILE, **extra)
    B = X0S.shape[0]
    u0 = np.zeros((B, N, 2), np.float32)
    ref = fused_tracker_solve(jnp.asarray(X0S), jnp.asarray(u0), None,
                              ode_rows=jax_quadrotor_rows(QUADROTOR_PARAMS), **kw)
    got = F.fused_tracker_solve_cuda(torch.as_tensor(X0S), torch.as_tensor(u0), None,
                                     ode_rows=make_planar_quadrotor_ode_rows(QUADROTOR_PARAMS),
                                     **kw)
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


def test_bare_rows_raise_on_the_card(monkeypatch):
    """A bare constraint row function has no C++ counterpart: on CUDA tensors
    the wrapper raises before anything is prepared, naming S4.6."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(NotImplementedError, match="ROADMAP S4.6"):
        F.fused_tracker_solve_cuda(
            torch.as_tensor(X0S), torch.zeros(4, N, 2), None,
            ode_rows=make_planar_quadrotor_ode_rows(QUADROTOR_PARAMS), nx=6, nu=2, N=N, ts=TS,
            substeps=SUB, limits=QUAD_LIMITS, weights=QUAD_WEIGHTS,
            extra_constraints=quad_clearance_rows, n_extra=1, extra_deps="x")
