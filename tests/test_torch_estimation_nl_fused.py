"""Bounded nonlinear MHE windows on the fused tracker kernel's additive mode
(``NonlinearMHE.solve_batch_fused``, on the kernel's twin here): against
the JAX package's in interpret mode, and against the port's own
Gauss-Newton + ADMM windows (``solve_batch``), which minimize the same NLP.

Gates: after one inner iteration every output within 1e-5 of JAX's (the
windows in float32, inputs made in float64 with numpy); at 6 × 12 every
window converged, v ≥ 0 at every knot (−1e-5), the window ends within 2e-2
and the windows within 3e-2 of the Gauss-Newton windows, the median position
error below 0.06 m and within 0.02 of the Gauss-Newton one (the JAX test's
bars, ``tests/test_estimation_nl_fused.py``); on a braking record the bound
is respected and binds (v.min < 5e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.estimation_nl import NonlinearMHE as JaxMHE
from model_predictive_control_tpu.models.bicycle import (
    kinematic_bicycle_ode as jax_bicycle,
    make_kinematic_ode_rows as jax_kinematic_rows,
)
from model_predictive_control_tpu.ops.integrators import rk4 as jax_rk4

from model_predictive_control_tpu_torch.estimation_nl import NonlinearMHE, _gated_ode_rows
from model_predictive_control_tpu_torch.models.bicycle import (
    kinematic_bicycle_ode,
    make_kinematic_ode_rows,
)
from model_predictive_control_tpu_torch.models.parameters import VehicleParameters
from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as F
from model_predictive_control_tpu_torch.ops.integrators import rk4

TS, M, B = 0.05, 6, 4
X_MIN, X_MAX = [-3.0, -2.0, -7.0, 0.0], [3.0, 2.0, 7.0, 1.0]
QW = np.diag([1e-6, 1e-6, 1e-5, 1e-3])
RV = 0.01 * np.eye(2)
P0 = np.diag([1e-4, 1e-4, 1e-3, 1e-2])
KW = dict(x_min=X_MIN, x_max=X_MAX, gn_iters=3, qp_iters=60, qp_solver="admm")
t = torch.as_tensor


def _port():
    p = VehicleParameters()
    step = rk4(lambda x, u: kinematic_bicycle_ode(p, x, u), TS)
    mhe = NonlinearMHE(step, lambda x: x[:2], t(QW), t(RV), t(P0), M, nx=4, **KW)
    kb = float(p.axis_rear) / float(p.axis_front + p.axis_rear)
    rows = make_kinematic_ode_rows(kb, float(p.axis_rear), float(p.acceleration),
                                   float(p.friction))
    return mhe, step, rows


def _data(step, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.5, 0.5, (B, 4))
    x0[:, 3] = 0.3
    us = np.tile([[0.2, 0.05]], (B, M, 1))
    xs = [t(x0)]
    for k in range(M):
        xs.append(torch.stack([step(x, t(us[b, k])) for b, x in enumerate(xs[-1])]))
    Xs = torch.stack(xs, dim=1).numpy()
    ys = Xs[..., :2] + 0.1 * rng.normal(size=(B, M + 1, 2))
    return x0, us, ys, Xs


def test_kinematic_rows_match_jax_float64():
    """``make_kinematic_ode_rows`` against JAX's at float64 (the division by
    l_r is a multiplication by its float32 reciprocal: relative 3e-8), and
    its gated form: γ = 0 gives zero rows, γ = 1 the rows; cached."""
    p = VehicleParameters()
    kb = float(p.axis_rear) / float(p.axis_front + p.axis_rear)
    args = (kb, float(p.axis_rear), float(p.acceleration), float(p.friction))
    rows = make_kinematic_ode_rows(*args)
    assert rows is make_kinematic_ode_rows(*args) and rows.kernel == "kinematic_const"
    rng = np.random.default_rng(1)
    x, u = rng.uniform(-1, 1, (4, 8)), rng.uniform(-0.4, 0.4, (2, 8))
    ref = np.stack(jax_kinematic_rows(*args)(tuple(jnp.asarray(x)), tuple(jnp.asarray(u))))
    got = np.stack([r.numpy() for r in rows(tuple(t(x)), tuple(t(u)))])
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-12)
    gated = _gated_ode_rows(rows, 2)
    assert gated is _gated_ode_rows(rows, 2)
    assert (gated.kernel, gated.nx, gated.nu) == ("gated_kinematic", 4, 4)
    for gam in (0.0, 1.0):
        e = (t(np.full(8, gam)),) + tuple(t(u))
        g = np.stack([r.numpy() for r in gated(tuple(t(x)), e)])
        np.testing.assert_array_equal(g, gam * got)


@pytest.fixture(scope="module")
def jax_one_iteration():
    """JAX's fused windows after one inner iteration, in interpret mode."""
    pj = mpc.VehicleParameters()
    jstep = jax_rk4(lambda x, u: jax_bicycle(pj, x, u), TS)
    mhe = JaxMHE(jstep, lambda x: x[:2], jnp.asarray(QW), jnp.asarray(RV), jnp.asarray(P0), M,
                 nx=4, **KW)
    kb = float(pj.axis_rear) / float(pj.axis_front + pj.axis_rear)
    rows = jax_kinematic_rows(kb, float(pj.axis_rear), float(pj.acceleration),
                              float(pj.friction))
    x0, us, ys, _ = _data(_port()[1])
    out = mhe.solve_batch_fused(jnp.asarray(x0), jnp.asarray(us), jnp.asarray(ys), ode_rows=rows,
                                ts=TS, obs_indices=(0, 1), outer_iters=1, inner_iters=1, tile=4)
    return [np.asarray(a) for a in out]


def test_fused_windows_match_pallas_after_one_iteration(jax_one_iteration):
    mhe, step, rows = _port()
    x0, us, ys, _ = _data(step)
    got = mhe.solve_batch_fused(t(x0), t(us), t(ys), ode_rows=rows, ts=TS, obs_indices=(0, 1),
                                outer_iters=1, inner_iters=1, tile=4)
    assert got[1].shape == (B, M + 1, 4) and got[2].shape == (B, M, 4)
    for name, g, r in zip(("x_M", "X", "w", "converged"), got, jax_one_iteration):
        d = np.abs(g.numpy().astype(np.float64) - r.astype(np.float64)).max()
        print(f"{name}: max|port - jax| {d:.3e} (tol 1e-5)")
        assert d <= 1e-5, name


def test_fused_windows_match_gauss_newton_windows():
    mhe, step, rows = _port()
    x0, us, ys, Xs = _data(step)
    xM_g, X_g, _ = mhe.solve_batch(t(x0), t(us), t(ys))
    xM_f, X_f, w_f, conv = mhe.solve_batch_fused(t(x0), t(us), t(ys), ode_rows=rows, ts=TS,
                                                 obs_indices=(0, 1), outer_iters=6,
                                                 inner_iters=12, tile=4)
    assert bool(conv.all())
    assert float(X_f[..., 3].min()) >= -1e-5
    np.testing.assert_allclose(xM_f.double().numpy(), xM_g.numpy(), atol=2e-2)
    np.testing.assert_allclose(X_f.double().numpy(), X_g.numpy(), atol=3e-2)
    err_f = np.linalg.norm(xM_f[:, :2].double().numpy() - Xs[:, -1, :2], axis=-1)
    err_g = np.linalg.norm(xM_g[:, :2].numpy() - Xs[:, -1, :2], axis=-1)
    assert np.median(err_f) < 0.06 and np.median(err_f) < np.median(err_g) + 0.02


def test_fused_windows_v_bound_binds():
    """A braking record from near standstill: v ≥ 0 holds and binds."""
    mhe, step, rows = _port()
    x0 = np.tile([[0.0, 0.0, 0.1, 0.05]], (B, 1))
    us = np.tile([[-1.0, 0.0]], (B, M, 1))
    xs = [t(x0)]
    for k in range(M):
        xn = torch.stack([step(x, t(us[b, k])) for b, x in enumerate(xs[-1])])
        xn[:, 3] = torch.clamp(xn[:, 3], min=0.0)
        xs.append(xn)
    ys = torch.stack(xs, dim=1)[..., :2].numpy()
    ys = ys + 0.05 * np.random.default_rng(3).normal(size=ys.shape)
    _, X, _, _ = mhe.solve_batch_fused(t(x0), t(us), t(ys), ode_rows=rows, ts=TS,
                                       obs_indices=(0, 1), outer_iters=6, inner_iters=12, tile=4)
    v = X[..., 3].numpy()
    assert v.min() >= -1e-5 and v.min() < 5e-3


def test_fused_windows_refuse_what_the_kernel_does_not_take(monkeypatch):
    """No state bounds or a full covariance raise ``ValueError`` (as JAX);
    on CUDA tensors a bare row function, gated, reaches an instantiation
    generated from it in the additive mode with terminal rows and Rd per
    stage (the build is stopped here)."""
    mhe, step, rows = _port()
    x0, us, ys, _ = _data(step)
    free = NonlinearMHE(step, lambda x: x[:2], t(QW), t(RV), t(P0), M, nx=4)
    with pytest.raises(ValueError, match="requires state bounds"):
        free.solve_batch_fused(t(x0), t(us), t(ys), ode_rows=rows, ts=TS, obs_indices=(0, 1))
    full = NonlinearMHE(step, lambda x: x[:2], t(QW + 1e-7), t(RV), t(P0), M, nx=4, **KW)
    with pytest.raises(ValueError, match="diagonal Qw"):
        full.solve_batch_fused(t(x0), t(us), t(ys), ode_rows=rows, ts=TS, obs_indices=(0, 1))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))

    class Reached(Exception):
        pass

    seen = []

    def generated(inst, group):
        seen.append(inst)
        raise Reached

    monkeypatch.setattr(F, "_generated_library", generated)
    with pytest.raises(Reached):
        mhe.solve_batch_fused(t(x0), t(us), t(ys), ode_rows=rows.rows, ts=TS, obs_indices=(0, 1))
    (inst,) = seen
    assert "ADD = true" in inst.model and "NEXO = 3" in inst.model
    assert inst.tbox and inst.rw and inst.rk4 and not inst.ubox and not inst.rows
    assert F.instantiation(_gated_ode_rows(rows, 2)) == "gated_kinematic"
