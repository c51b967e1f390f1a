"""The parking slice's models against the JAX package, in float64: the
kinematic bicycle, the covering-circle geometry, the integrators and the
batched fine-RK4 plant with per-scenario acceleration and friction (atol
1e-10); the kernel's geometry tuples; the parameter crossing and the
scenario draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.models.bicycle import (
    kinematic_bicycle_ode as jax_ode,
)
from model_predictive_control_tpu.ops import integrators as jax_int
from model_predictive_control_tpu.ops.pallas.ilqr_kernel import (
    parking_geometry as jax_parking_geometry,
)
from model_predictive_control_tpu.parallel.batch import (
    batched_plant as jax_batched_plant,
    perturb_parameters as jax_perturb,
)
from model_predictive_control_tpu.utils import geometry as jax_geo

import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.convert import vehicle_parameters_from_jax
from model_predictive_control_tpu_torch.models.bicycle import kinematic_bicycle_ode
from model_predictive_control_tpu_torch.ops import integrators
from model_predictive_control_tpu_torch.ops.cuda.ilqr_kernel import parking_geometry
from model_predictive_control_tpu_torch.parallel import batch as PB
from model_predictive_control_tpu_torch.utils import geometry

ATOL = 1e-10
B = 16


def _xu(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, 4)) * np.array([0.5, 0.5, 3.0, 0.5])
    u = rng.uniform(-1, 1, (B, 2)) * np.array([1.0, 0.384])
    return x, u


def _params(seed=1):
    """JAX parameters with per-scenario acceleration and friction (float64)
    and the port's crossing of them."""
    rng = np.random.default_rng(seed)
    pj = dataclasses.replace(
        mpc.VehicleParameters(),
        acceleration=jnp.asarray(2.0 + 0.2 * rng.uniform(-1, 1, B)),
        friction=jnp.asarray(1.0 + 0.1 * rng.uniform(-1, 1, B)),
    )
    return pj, vehicle_parameters_from_jax(pj, dtype=torch.float64, device="cpu")


def _jax_batched(f, pj):
    axes = jax.tree.map(lambda l: 0 if jnp.ndim(l) > 0 else None, pj)
    return jax.vmap(f, in_axes=(axes, 0, 0))


@pytest.mark.parametrize("batched", [False, True])
def test_bicycle_ode_matches_jax(batched):
    x, u = _xu()
    pj, pt = _params() if batched else (mpc.VehicleParameters(), port.VehicleParameters())
    ref = _jax_batched(jax_ode, pj)(pj, jnp.asarray(x), jnp.asarray(u))
    got = kinematic_bicycle_ode(pt, torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["euler", "rk4", "rk4_fine"])
def test_integrators_match_jax(name):
    x, u = _xu(2)
    pj, pt = mpc.VehicleParameters(), port.VehicleParameters()
    ts = 0.08
    step_j = getattr(jax_int, name)(lambda a, b: jax_ode(pj, a, b), ts)
    step_t = getattr(integrators, name)(lambda a, b: kinematic_bicycle_ode(pt, a, b), ts)
    ref = jax.vmap(step_j)(jnp.asarray(x), jnp.asarray(u))
    got = step_t(torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("substeps", [4, 16])
def test_batched_plant_matches_jax(substeps):
    x, u = _xu(3)
    pj, pt = _params(4)
    ref = jax_batched_plant(pj, 0.08, substeps=substeps)(jnp.asarray(x), jnp.asarray(u))
    got = port.batched_plant(pt, 0.08, substeps=substeps)(torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_geometry_matches_jax():
    p = mpc.VehicleParameters()
    for n in (1, 3):
        cj, rj = jax_geo.cover_circle_offsets(p.length, p.width, n)
        ct, rt = geometry.cover_circle_offsets(p.length, p.width, n, device="cpu")
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert rt == rj
    x, _ = _xu(5)
    offs = np.asarray(jax_geo.cover_circle_offsets(p.length, p.width, 3)[0], np.float64)
    got = geometry.transform_circles(torch.as_tensor(x), torch.as_tensor(offs))
    ref = np.stack([np.asarray(jax_geo.transform_circles(jnp.asarray(xi), jnp.asarray(offs)))
                    for xi in x])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    # row-major pair order: p = i·m + j
    got_d = geometry.pairwise_sq_distances(got, got.flip(0))
    ref_d = np.stack([np.asarray(jax_geo.pairwise_sq_distances(jnp.asarray(a), jnp.asarray(b)))
                      for a, b in zip(ref, ref[::-1])])
    np.testing.assert_allclose(got_d.numpy(), ref_d, rtol=0, atol=ATOL)


@pytest.mark.parametrize("x_obs", [(0.25, 0.0, 0.0, 0.0), (0.1, -0.2, 0.4, 0.0), None])
def test_parking_geometry_matches_jax(x_obs):
    assert parking_geometry(port.VehicleParameters(), x_obs) == jax_parking_geometry(
        mpc.VehicleParameters(), x_obs
    )


def test_vehicle_parameters_cross_over():
    pj = jax_perturb(jax.random.PRNGKey(0), mpc.VehicleParameters(), 5)
    pt = vehicle_parameters_from_jax(pj, device="cpu")
    assert pt.batched_fields() == {"acceleration", "friction"}
    assert isinstance(pt.length, float) and pt.length == float(pj.length)
    np.testing.assert_array_equal(pt.friction.numpy(), np.asarray(pj.friction, np.float32))
    assert dataclasses.asdict(port.VehicleParameters()) == {
        f.name: float(getattr(mpc.VehicleParameters(), f.name))
        for f in dataclasses.fields(mpc.VehicleParameters)
    }


def test_scenario_draws():
    """Perturbed fields lie in base ± 10%, drawn in field order from the
    generator; initial states lie in the box around the start and outside
    the clearance circle; a seed gives the same draws twice."""
    base = port.VehicleParameters()
    draw = lambda: (
        PB.perturb_parameters(torch.Generator().manual_seed(7), base, 4096, device="cpu"),
        PB.random_initial_states(torch.Generator().manual_seed(7), 4096, x_obs=(0.25, 0.0, 0.0, 0.0), device="cpu"),
    )
    (p, x0), (p2, x02) = draw(), draw()
    assert torch.equal(p.friction, p2.friction) and torch.equal(x0, x02)
    for name, v in (("friction", 1.0), ("acceleration", 2.0)):
        f = getattr(p, name)
        assert f.dtype == torch.float32 and f.shape == (4096,)
        assert (f >= 0.9 * v - 1e-6).all() and (f <= 1.1 * v + 1e-6).all()
    assert not torch.equal(p.friction, p.acceleration / 2.0)
    r = torch.linalg.vector_norm(x0[:, :2] - torch.tensor([0.25, 0.0]), dim=1)
    assert (r >= 0.22 - 1e-6).all()
    lo = torch.tensor([0.1, -0.25, -0.3, -0.05]) - 1e-6
    hi = torch.tensor([0.5, 0.05, 0.3, 0.05]) + 1e-6
    inside = (r > 0.22 + 1e-6)
    assert ((x0[inside] >= lo) & (x0[inside] <= hi)).all()


def test_project_clear_matches_numpy():
    """The radial projection (the JAX package's random_initial_states
    :93-104) against a numpy transcription, coincident sample included."""
    rng = np.random.default_rng(6)
    x0 = rng.uniform(-0.3, 0.6, (64, 4))
    x0[0, :2] = (0.25, 0.0)
    p_obs = np.array([0.25, 0.0])
    d = x0[:, :2] - p_obs
    r = np.linalg.norm(d, axis=1, keepdims=True)
    dir_ = np.where(r > 1e-6, d / np.maximum(r, 1e-6), np.array([1.0, 0.0]))
    ref = x0.copy()
    ref[:, :2] = np.where(r < 0.22, p_obs + dir_ * 0.22, x0[:, :2])
    got = PB.project_clear(torch.as_tensor(x0), (0.25, 0.0, 0.0, 0.0), 0.22)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[0, :2].numpy(), [0.47, 0.0], atol=ATOL)
