"""The loiter sweeps as a whole (planar quadrotor, thrust cluster): the
port's closed loop (tracker policy with its shifted warm start, fine-RK4
plant, batched loop) against the JAX package's ``quadrotor_sweep`` and
``thruster_sweep`` on the fused tracker kernel in interpret mode, at the
same tile, on the JAX sweeps' own draws: the start states are the JAX run's
``states[0]`` and the plant parameters come from the JAX draws on the same
key. 4 scenarios × 4 steps at the JAX tests' small configuration (N = 4,
Euler-free RK4 prediction with one substep, 3 × 6 iterations, 4 plant
substeps, ``tests/test_ilqr_factory.py:220``): states within 5e-3 (the JAX
package's gate between two float32 implementations of a tracking loop) and
equal success masks. Then the entry points: the summary keys, the default
generator, the twin backend, and the refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_predictive_control_tpu.models.benchmarks import QUADROTOR_PARAMS, THRUSTER_PARAMS
from model_predictive_control_tpu.parallel import batch as JPB

import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.parallel import batch as PB

B, STEPS, N, TILE = 4, 4, 4, 8
SMALL = dict(N=N, pred_substeps=1, plant_substeps=4, outer_iters=3, inner_iters=6)
SWEEPS = {
    # name: (JAX sweep, port policy, port plant, nominal plant parameters)
    "quadrotor": (JPB.quadrotor_sweep, PB.batched_quadrotor_policy, PB.batched_quadrotor_plant,
                  QUADROTOR_PARAMS[:3]),
    "thruster": (JPB.thruster_sweep, PB.batched_thruster_policy, PB.batched_thruster_plant,
                 (THRUSTER_PARAMS[0], THRUSTER_PARAMS[2], THRUSTER_PARAMS[3])),
}
KEYS = {"batch", "steps", "model", "success_rate", "mean_tracking_error", "p95_tracking_error",
        "rel_scale", "mean_inner_iters"}


def _jax_plant_params(key, nominal, rel_scale=0.1):
    """The JAX sweeps' per-scenario plant parameters on ``key``."""
    k_par, _ = jax.random.split(key)
    f = 1.0 + rel_scale * jax.random.uniform(k_par, (B, 3), minval=-1.0, maxval=1.0,
                                             dtype=jnp.float32)
    return tuple(torch.as_tensor(np.array(v * f[:, i])) for i, v in enumerate(nominal))


def test_loiter_reference_matches_jax():
    n, ts, om = 60, 0.1, 2.0 * jnp.pi / 12.0
    t = jnp.arange(n, dtype=jnp.float32) * ts
    zero = jnp.zeros_like(t)
    want = jnp.stack([jnp.sin(om * t), 1.0 - jnp.cos(om * t), zero, om * jnp.cos(om * t),
                      om * jnp.sin(om * t), zero], axis=-1)
    got = PB.loiter_reference(n, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(SWEEPS))
def test_closed_loop_matches_jax(name):
    jax_sweep, make_policy, make_plant, nominal = SWEEPS[name]
    key = jax.random.PRNGKey(0)
    ref, summary = jax_sweep(B, STEPS, key=key, tile=TILE, **SMALL)
    policy = make_policy(PB.loiter_reference(STEPS + N + 1, device="cpu"), N=N, pred_substeps=1,
                         outer_iters=3, inner_iters=6, tile=TILE)
    got = port.simulate_batch(
        torch.as_tensor(np.array(ref.states[0])),
        make_plant(_jax_plant_params(key, nominal), 0.1, substeps=4), STEPS, policy,
        policy.initial_carry(B, device="cpu"), batched_dynamics=True,
    )
    nu = 2 if name == "quadrotor" else 4
    assert got.states.shape == (STEPS + 1, B, 6) and got.inputs.shape == (STEPS, B, nu)
    d = np.abs(got.states.numpy() - np.asarray(ref.states)).max()
    print(f"{name}: max|x - x_jax| over {STEPS} steps {d:.3e} (tol 5e-3)")
    assert d <= 5e-3
    np.testing.assert_array_equal(got.logs["solver_success"].numpy(),
                                  np.asarray(ref.logs["solver_success"]))
    np.testing.assert_allclose(got.logs["tracking_error"].numpy(),
                               np.asarray(ref.logs["tracking_error"]), atol=5e-3)


@pytest.mark.parametrize("entry, model", [("quadrotor_sweep", "planar-quadrotor"),
                                          ("thruster_sweep", "thrust-cluster-nu4")])
def test_sweep_entry_points(entry, model):
    sweep = getattr(port, entry)
    res, s = sweep(3, 2, device="cpu", **SMALL)
    assert set(s) == KEYS and s["model"] == model and s["batch"] == 3
    assert res.states.shape == (3, 3, 6) and bool(torch.isfinite(res.states).all())
    assert 0.0 <= s["success_rate"] <= 1.0 and s["mean_inner_iters"] > 0
    _, again = sweep(3, 2, generator=torch.Generator().manual_seed(0), device="cpu", **SMALL)
    assert again == s  # a generator seeded 0 is the default
    twin, _ = sweep(3, 2, backend="twin", device="cpu", **SMALL)
    assert torch.equal(twin.states, res.states)  # on CPU tensors "cuda" runs the twin
    with pytest.raises(ValueError, match="xla"):
        sweep(3, 2, backend="xla", device="cpu")
    with pytest.raises(ValueError, match="float32"):
        sweep(3, 2, dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP S7.1"):
        sweep(3, 2, mesh=object(), device="cpu")
