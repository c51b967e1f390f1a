"""The racing slice's models against the JAX package: the kinematic row ODE
with per-scenario parameters, the dynamic (Pacejka) bicycle and its row
form, the ellipse references, the twin's exact step Jacobians and the
dual-number rules at kinks, and the Pacejka parameter tuple.

Tolerances: ``dynamic_bicycle_ode`` in float64 at 1e-10 (the same
operations); the row functions in float64 within 1e-6 of each row's scale
(the port multiplies by float32 reciprocals of ``l_r``, ``m``, ``I_z`` and
0.01, as XLA compiles the reference, and uses ``atan`` where the JAX kernel
carries its polynomial ``matan``, |err| ≤ 1.3e-7); the ellipse references
exactly (the same float64 numpy code, cast to float32); the step Jacobians
within 1e-5 of the largest entry against ``jax.jacfwd`` of the JAX step in
float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.experiments import racing as jax_racing
from model_predictive_control_tpu.models.bicycle import dynamic_bicycle_ode as jax_dyn_ode
from model_predictive_control_tpu.ops.integrators import euler as jax_euler
from model_predictive_control_tpu.ops.integrators import rk4_fine as jax_rk4_fine
from model_predictive_control_tpu.ops.pallas.ilqr_dyn_kernel import (
    make_pacejka_ode_rows as jax_pacejka_rows,
    model_tuple as jax_model_tuple,
)
from model_predictive_control_tpu.ops.pallas.parking_factory import (
    make_parking_ode_rows as jax_kinematic_rows,
)

from model_predictive_control_tpu_torch.convert import vehicle_parameters_from_jax
from model_predictive_control_tpu_torch.experiments import racing
from model_predictive_control_tpu_torch.models.bicycle import dynamic_bicycle_ode
from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as F
from model_predictive_control_tpu_torch.ops.cuda.ilqr_dyn_kernel import (
    make_pacejka_ode_rows,
    model_tuple,
)
from model_predictive_control_tpu_torch.ops.cuda.parking_factory import make_parking_ode_rows

B = 16
KB, LR = 0.05 / (0.047 + 0.05), 0.05
TS = 0.05
TOL_ROWS = 1e-6  # relative to each row's largest magnitude (module docstring)
TOL_JAC = 1e-5  # relative to the largest Jacobian entry


def _kinematic_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, 4)) * np.array([1.5, 1.0, 6.0, 0.5])
    u = rng.uniform(-1, 1, (B, 2)) * np.array([1.0, 0.384])
    p = np.stack([2.0 + 0.2 * rng.uniform(-1, 1, B), 1.0 + 0.1 * rng.uniform(-1, 1, B)], axis=1)
    return x, u, p


def _dynamic_inputs(seed=1, kinks=True):
    """Around the racing operating point (v_x = 1.2 ± 0.5), with ``kinks``
    some lanes' v_x at the clamp: exactly ±0.01 and 0, inside it, reverse."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, 6)) * np.array([1.5, 1.0, 6.0, 0.5, 0.1, 2.0])
    x[:, 3] += 1.2
    if kinks:
        x[:5, 3] = [0.01, -0.01, 0.0, 0.005, -0.4]
    u = rng.uniform(-1, 1, (B, 2)) * np.array([1.0, 0.384])
    return x, u


def _rows_t(rows, *args):
    return torch.stack(rows(*(tuple(torch.as_tensor(a[:, i]) for i in range(a.shape[1])) for a in args)), 1)


def _rows_j(rows, *args):
    return np.stack(rows(*(tuple(jnp.asarray(a[:, i]) for i in range(a.shape[1])) for a in args)), 1)


def _close_per_row(got, ref, tol):
    scale = np.maximum(np.abs(ref).max(axis=0), 1.0)
    err = np.abs(got - ref).max(axis=0) / scale
    assert np.all(err <= tol), err


def test_kinematic_rows_match_jax():
    x, u, p = _kinematic_inputs()
    got = _rows_t(make_parking_ode_rows(KB, LR), x, u, p).numpy()
    ref = _rows_j(jax_kinematic_rows(KB, LR), x, u, p)
    _close_per_row(got, ref, TOL_ROWS)


def test_pacejka_rows_match_jax():
    x, u = _dynamic_inputs()
    mt = jax_model_tuple(mpc.VehicleParameters())
    got = _rows_t(make_pacejka_ode_rows(mt), x, u).numpy()
    ref = _rows_j(jax_pacejka_rows(mt), x, u)
    _close_per_row(got, ref, TOL_ROWS)


@pytest.mark.parametrize("batched", [False, True])
def test_dynamic_bicycle_ode_matches_jax(batched):
    x, u = _dynamic_inputs(2)
    pj = mpc.VehicleParameters()
    if batched:  # per-scenario tire peaks and friction, as the dynamic sweep draws them
        rng = np.random.default_rng(3)
        pj = dataclasses.replace(
            pj, df=jnp.asarray(0.4399 * (1 + 0.05 * rng.uniform(-1, 1, B))),
            dr=jnp.asarray(0.6236 * (1 + 0.05 * rng.uniform(-1, 1, B))),
            friction=jnp.asarray(1.0 + 0.05 * rng.uniform(-1, 1, B)),
        )
    axes = jax.tree.map(lambda l: 0 if jnp.ndim(l) > 0 else None, pj)
    ref = jax.vmap(jax_dyn_ode, in_axes=(axes, 0, 0))(pj, jnp.asarray(x), jnp.asarray(u))
    pt = vehicle_parameters_from_jax(pj, dtype=torch.float64, device="cpu")
    got = dynamic_bicycle_ode(pt, torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-10)


@pytest.mark.parametrize("dynamic, speed", [(False, 0.35), (True, 1.2)])
def test_ellipse_reference_matches_jax(dynamic, speed):
    n = 200
    ref = jax_racing.ellipse_reference(n, speed=speed, ts=0.05, dynamic=dynamic, dtype=jnp.float32)
    got = racing.ellipse_reference(n, speed=speed, ts=0.05, dynamic=dynamic, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _jax_step_jacobian(ode, x, u, p, substeps, integrator):
    """``jax.jacfwd`` of one interval (Euler or RK4 with substeps) per lane."""

    def step(xx, uu, pp):
        f = lambda a, b: ode(a, b, pp)
        s = jax_euler(f, TS) if integrator == "euler" else jax_rk4_fine(f, TS, substeps=substeps)
        return s(xx, uu)

    A, Bm = jax.vmap(jax.jacfwd(step, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(u), jnp.asarray(p))
    return np.asarray(A), np.asarray(Bm)


@pytest.mark.parametrize("tier", ["kinematic_euler", "pacejka_rk4x4", "pacejka_euler_at_the_clamp"])
def test_step_jacobians_match_jacfwd(tier):
    """The twin's dual-number Jacobians (what the kernel computes) against
    ``jax.jacfwd`` of the JAX step, in float64: the kinematic Euler step, the
    Pacejka RK4×4 step at the racing operating point, and a Pacejka Euler
    step with v_x at and inside the ±0.01 clamp (where RK4×4 is unstable:
    at v_x = 0.01 the lateral modes reach λ·h ≈ 20, and the Jacobian
    amplifies float64 rounding by orders of magnitude)."""
    if tier == "kinematic_euler":
        x, u, p = _kinematic_inputs(4)
        rows_j = jax_kinematic_rows(KB, LR)
        ode = lambda xx, uu, pp: jnp.stack(rows_j(tuple(xx), tuple(uu), tuple(pp)))
        model, substeps, integrator = make_parking_ode_rows(KB, LR), 1, "euler"
        pr = tuple(torch.as_tensor(p[:, i]) for i in range(2))
    else:
        at_clamp = tier == "pacejka_euler_at_the_clamp"
        x, u = _dynamic_inputs(5, kinks=at_clamp)
        p = np.zeros((B, 1))
        mt = jax_model_tuple(mpc.VehicleParameters())
        rows_j = jax_pacejka_rows(mt)
        ode = lambda xx, uu, pp: jnp.stack(rows_j(tuple(xx), tuple(uu)))
        substeps, integrator = (1, "euler") if at_clamp else (4, "rk4")
        model, pr = make_pacejka_ode_rows(mt), None
    A_ref, B_ref = _jax_step_jacobian(ode, x, u, p, substeps, integrator)
    xr = tuple(torch.as_tensor(x[:, i]) for i in range(x.shape[1]))
    ur = tuple(torch.as_tensor(u[:, j]) for j in range(2))
    A, Bm = F.step_jacobian(model, xr, ur, pr, ts=TS, substeps=substeps, integrator=integrator)
    A, Bm = A.permute(2, 0, 1).numpy(), Bm.permute(2, 0, 1).numpy()
    for got, ref in ((A, A_ref), (Bm, B_ref)):
        err = np.abs(got - ref).max() / np.abs(ref).max()
        print(f"{tier}: max|J - jacfwd| / max|J| = {err:.2e} (tol {TOL_JAC})")
        assert err <= TOL_JAC


def test_dual_rules_at_kinks_follow_jax():
    """abs at 0 takes +d; the v_x clamp (JAX maximum/minimum against ±0.01)
    takes half the tangent at a tie and none below; where takes the branch."""
    v = np.array([0.01, -0.01, 0.0, 0.3, -0.3, 0.005], np.float64)
    d = np.ones_like(v)

    def jax_clamp(x):
        return jnp.where(x >= 0.0, jnp.maximum(x, 1e-2), jnp.minimum(x, -1e-2))

    def port_clamp(x):
        return torch.where(x >= 0.0, torch.clamp(x, min=1e-2), torch.clamp(x, max=-1e-2))

    for jf, tf in ((jax_clamp, port_clamp), (jnp.abs, torch.abs), (jnp.tanh, torch.tanh),
                   (jnp.arctan, torch.atan)):
        val_j, tan_j = jax.jvp(jf, (jnp.asarray(v),), (jnp.asarray(d),))
        out = tf(F.Dual(torch.as_tensor(v), torch.as_tensor(d)[None]))
        np.testing.assert_allclose(out.v.numpy(), np.asarray(val_j), rtol=1e-15, atol=0)
        np.testing.assert_allclose(out.d[0].numpy(), np.asarray(tan_j), rtol=1e-14, atol=1e-300)


def test_model_tuple_matches_jax():
    pj = mpc.VehicleParameters()
    assert model_tuple(vehicle_parameters_from_jax(pj, device="cpu")) == jax_model_tuple(pj)


def test_rowform_to_vector():
    x, u = _dynamic_inputs(6)
    rows = make_pacejka_ode_rows(model_tuple(vehicle_parameters_from_jax(mpc.VehicleParameters(), device="cpu")))
    ode = F.rowform_to_vector(rows, 6, 2)
    got = ode(torch.as_tensor(x), torch.as_tensor(u))
    assert got.shape == (B, 6)
    torch.testing.assert_close(got, _rows_t(rows, x, u), rtol=0, atol=0)
