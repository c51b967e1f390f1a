"""The parking slice as a whole: the port's closed loop (kernel policy with
its shift and multiplier carry-over, fine-RK4 plant, batched loop) against
the JAX closed loop (Pallas kernel in interpret mode), same initial states
and perturbed plant parameters, same tile.

Gates: states within 5e-2 (tests/test_pallas_ilqr.py:117), success masks
agreeing on at least 90% of the (step, scenario) entries, the carried
multipliers of the same shape. Then the sweep's entry point and its
unsupported options.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.control.batch_loop import simulate_batch as jax_simulate
from model_predictive_control_tpu.parallel.batch import (
    batched_parking_policy as jax_policy,
    batched_plant as jax_plant,
)
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.convert import vehicle_parameters_from_jax

B, N, STEPS, TILE, TS, SUBSTEPS = 8, 8, 3, 4, 0.08, 4
X_OBS = (0.25, 0.0, 0.0, 0.0)
# the JAX package's parking_sweep summary on the kernel route (:582-596)
SUMMARY_KEYS = {
    "batch", "steps", "success_rate", "median_final_dist", "parked_frac_5cm",
    "controller_knows", "rel_scale", "mean_inner_iters",
}


def _scenarios(seed=0):
    rng = np.random.default_rng(seed)
    x0 = np.array([0.3, -0.1, 0.0, 0.0]) + rng.uniform(-1, 1, (B, 4)) * np.array(
        [0.2, 0.15, 0.3, 0.05]
    )
    d = x0[:, :2] - np.array(X_OBS[:2])
    r = np.linalg.norm(d, axis=1, keepdims=True)
    x0[:, :2] = np.where(r < 0.22, np.array(X_OBS[:2]) + d / r * 0.22, x0[:, :2])
    acc = 2.0 * (1.0 + 0.1 * rng.uniform(-1, 1, B))
    fric = 1.0 + 0.1 * rng.uniform(-1, 1, B)
    return (np.asarray(a, np.float32) for a in (x0, acc, fric))


def test_closed_loop_matches_jax():
    x0, acc, fric = _scenarios()
    plant_j = dataclasses.replace(
        mpc.VehicleParameters(), acceleration=jnp.asarray(acc), friction=jnp.asarray(fric)
    )
    pol_j = jax_policy(mpc.VehicleParameters(), N, TS, x_obs=X_OBS, backend="pallas", tile=TILE)
    ref = jax_simulate(
        jnp.asarray(x0), jax_plant(plant_j, TS, substeps=SUBSTEPS), STEPS, pol_j,
        pol_j.initial_carry(B), batched_dynamics=True,
    )

    plant_t = vehicle_parameters_from_jax(plant_j, device="cpu")
    pol_t = port.batched_parking_policy(port.VehicleParameters(), N, TS, x_obs=X_OBS, tile=TILE)
    got = port.simulate_batch(
        torch.as_tensor(x0), port.batched_plant(plant_t, TS, substeps=SUBSTEPS), STEPS,
        pol_t, pol_t.initial_carry(B, device="cpu"), batched_dynamics=True,
    )

    assert got.states.shape == (STEPS + 1, B, 4) and got.inputs.shape == (STEPS, B, 2)
    assert bool(torch.isfinite(got.states).all())
    np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), atol=5e-2)
    s_ref = np.asarray(ref.logs["solver_success"])
    s_got = got.logs["solver_success"].numpy()
    assert s_got.shape == s_ref.shape
    assert (s_ref == s_got).mean() >= 0.9
    assert set(got.logs) == set(ref.logs)
    (u_j, lam_j), (u_t, lam_t) = ref.final_carry, got.final_carry
    assert tuple(u_t.shape) == u_j.shape and tuple(lam_t.shape) == lam_j.shape


@pytest.mark.parametrize("controller_knows", [False, True])
def test_sweep_entry_point(controller_knows):
    res, summary = port.parking_sweep(
        4, 2, N=6, outer_iters=3, inner_iters=5, plant_substeps=4,
        controller_knows=controller_knows, device="cpu",
    )
    assert set(summary) == SUMMARY_KEYS
    assert res.states.shape == (3, 4, 4) and bool(torch.isfinite(res.states).all())
    assert summary["controller_knows"] is controller_knows
    assert 0.0 <= summary["success_rate"] <= 1.0
    # a generator seeded 0 is the default
    _, again = port.parking_sweep(
        4, 2, generator=torch.Generator().manual_seed(0), N=6, outer_iters=3,
        inner_iters=5, plant_substeps=4, controller_knows=controller_knows, device="cpu",
    )
    assert again == summary


def test_median_averages_the_middle_pair():
    """median_final_dist is jnp.median's: the mean of the two middle values
    of an even batch (torch.median would return the lower one)."""
    res, summary = port.parking_sweep(
        4, 1, N=4, outer_iters=1, inner_iters=1, plant_substeps=2, device="cpu"
    )
    d = np.linalg.norm(res.states[-1][:, :2].numpy(), axis=-1)
    assert summary["median_final_dist"] == pytest.approx(float(np.median(d)), rel=1e-6)


@pytest.mark.parametrize(
    "kw, item",
    [
        ({"solver": "sqp"}, "S3.2"),
        ({"backend": "xla"}, "S3.2"),
        ({"backend": "factory"}, "S4.3"),
        ({"perturb_fields": ("friction", "axis_rear"), "controller_knows": True,
          "backend": "torch"}, "S3.2"),
        ({"dtype": torch.float64, "backend": "torch"}, "S3.2"),
        ({"mesh": "one-rank"}, "S7.1"),
        ({"checkpoint_every": 1}, "S7.2"),
        ({"u_seed": np.zeros((2, 4, 2))}, "S3.4"),
    ],
)
def test_unported_options_raise(kw, item):
    """The options of S3.2, S3.4, S4.3, S7.1 and S7.2 (the per-scenario
    route, ``u_seed``, the factory kernel's route, here on its twin, a device
    mesh, the checkpointed segments) are ported and run; on a one-rank mesh
    the sweep equals the unsharded one bit for bit.
    ``backend="xla"`` is the JAX name of ``"torch"``. The kernel refuses what
    only the per-scenario route takes."""
    if kw.get("backend") == "torch":
        with pytest.raises(ValueError, match="backend='torch'"):
            port.parking_sweep(2, 1, N=4, device="cpu", **{**kw, "backend": "cuda"})
    if item in ("S3.2", "S3.4", "S4.3", "S7.2"):
        if kw.get("backend") == "xla":
            with pytest.raises(ValueError, match="backend='torch'"):
                port.parking_sweep(2, 1, N=4, device="cpu", **kw)
            return
        res, summary = port.parking_sweep(2, 1, N=4, device="cpu", sqp_iters=2, qp_iters=8,
                                          outer_iters=1, inner_iters=2, plant_substeps=2, **kw)
        assert bool(torch.isfinite(res.states).all()) and 0.0 <= summary["success_rate"] <= 1.0
        return
    import torch.distributed as dist

    from model_predictive_control_tpu_torch.parallel import make_mesh

    small = dict(N=4, device="cpu", outer_iters=1, inner_iters=2, plant_substeps=2)
    try:
        res, summary = port.parking_sweep(2, 1, mesh=make_mesh(1, device="cpu"), **small)
    finally:
        dist.destroy_process_group()
    plain, plain_summary = port.parking_sweep(2, 1, **small)
    assert torch.equal(res.states, plain.states) and summary == plain_summary
