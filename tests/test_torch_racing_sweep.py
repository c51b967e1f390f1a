"""The racing slice as a whole: the port's lap-tracking closed loops (tracker
policy with its shifted warm start, fine-RK4 plant, batched loop) against
the JAX package's, on the JAX sweeps' own draws: the start states are the
JAX run's ``states[0]`` and the plant parameters come from the JAX
``perturb_parameters`` on the same key.

- Kinematic tier against JAX ``racing_sweep`` on the factory kernel in
  interpret mode, same tile: states and inputs within 5e-3, the JAX
  package's own gate between its two backends (``tests/test_racing_sweep.py:
  111-116``).
- Pacejka tier against JAX ``racing_sweep_dynamic(backend="xla")``, the
  per-scenario AL-iLQR in float64: inputs within 2e-2, states within 2e-2
  on (p_x, p_y, ψ, v_x) and 1e-1 on (v_y, ω), the JAX package's bars
  between its kernel and that path (``tests/test_pallas_ilqr_dyn.py:
  200-217``).

Then the entry points with their summary keys, and the backends and
options not ported yet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.parallel.batch import (
    DEFAULT_PERTURB_FIELDS,
    perturb_parameters as jax_perturb,
    racing_sweep as jax_racing_sweep,
    racing_sweep_dynamic as jax_racing_sweep_dynamic,
)

import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.convert import vehicle_parameters_from_jax
from model_predictive_control_tpu_torch.experiments.racing import ellipse_reference
from model_predictive_control_tpu_torch.parallel import batch as PB

KINEMATIC_KEYS = {
    "batch", "steps", "speed", "success_rate", "mean_tracking_error",
    "p95_tracking_error", "max_tracking_error", "rel_scale", "backend",
    "mean_inner_iters",
}
DYNAMIC_KEYS = KINEMATIC_KEYS - {"max_tracking_error"} | {"model"}


def _jax_plant(key, batch, rel_scale, fields):
    k_par, _ = jax.random.split(key)
    plant = jax_perturb(k_par, mpc.VehicleParameters(), batch, rel_scale=rel_scale,
                        fields=fields, dtype=jnp.float32)
    return vehicle_parameters_from_jax(plant, device="cpu")


def test_kinematic_closed_loop_matches_jax():
    B, STEPS, N, TILE = 8, 4, 15, 8
    key = jax.random.PRNGKey(3)
    ref, _ = jax_racing_sweep(batch=B, steps=STEPS, tile=TILE, key=key)
    plant = _jax_plant(key, B, 0.1, DEFAULT_PERTURB_FIELDS)
    policy = PB.batched_racing_policy(
        ellipse_reference(STEPS + N + 1, speed=0.35, dynamic=False, device="cpu"), N=N, tile=TILE
    )
    got = port.simulate_batch(
        torch.as_tensor(np.array(ref.states[0])), PB.batched_plant(plant, 0.05, substeps=8),
        STEPS, policy, policy.initial_carry(B, device="cpu"), batched_dynamics=True,
    )
    assert got.states.shape == (STEPS + 1, B, 4) and got.inputs.shape == (STEPS, B, 2)
    assert bool(torch.isfinite(got.states).all())
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=5e-3)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), atol=5e-3)
    np.testing.assert_array_equal(
        got.logs["solver_success"].numpy(), np.asarray(ref.logs["solver_success"])
    )
    np.testing.assert_allclose(
        got.logs["tracking_error"].numpy(), np.asarray(ref.logs["tracking_error"]), atol=5e-3
    )


def test_dynamic_closed_loop_matches_jax():
    B, STEPS, N, SUB = 2, 3, 6, 1
    key = jax.random.PRNGKey(7)
    ref, _ = jax_racing_sweep_dynamic(
        batch=B, steps=STEPS, key=key, N=N, pred_substeps=SUB, backend="xla"
    )
    plant = _jax_plant(key, B, 0.05, ("df", "dr", "friction"))
    policy = PB.batched_racing_dynamic_policy(
        ellipse_reference(STEPS + N + 1, speed=1.2, dynamic=True, device="cpu"), N=N, pred_substeps=SUB, tile=8
    )
    got = port.simulate_batch(
        torch.as_tensor(np.array(ref.states[0]), dtype=torch.float32),
        PB.batched_dynamic_plant(plant, 0.05, substeps=16), STEPS, policy, policy.initial_carry(B, device="cpu"),
        batched_dynamics=True,
    )
    assert got.states.shape == (STEPS + 1, B, 6)
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=2e-2)
    tol = np.array([2e-2, 2e-2, 2e-2, 2e-2, 1e-1, 1e-1])
    d = np.abs(got.states.numpy() - np.asarray(ref.states))
    assert (d <= tol).all(), (d.max(axis=(0, 1)), tol)
    assert got.logs["solver_success"].all()


def test_sweep_entry_points():
    kw = dict(N=6, outer_iters=2, inner_iters=3, plant_substeps=2, device="cpu")
    res, s = port.racing_sweep(4, 2, **kw)
    assert set(s) == KINEMATIC_KEYS and s["backend"] == "cuda"
    assert res.states.shape == (3, 4, 4) and bool(torch.isfinite(res.states).all())
    assert 0.0 <= s["success_rate"] <= 1.0 and s["mean_inner_iters"] > 0
    _, again = port.racing_sweep(4, 2, generator=torch.Generator().manual_seed(0), **kw)
    assert again == s  # a generator seeded 0 is the default
    res, s = port.racing_sweep_dynamic(4, 2, pred_substeps=1, **kw)
    assert set(s) == DYNAMIC_KEYS and s["model"] == "dynamic-pacejka"
    assert res.states.shape == (3, 4, 6) and bool(torch.isfinite(res.states).all())


def test_twin_backend_is_the_cpu_route():
    """On CPU tensors the kernel route runs the twin: both backends agree."""
    kw = dict(N=5, outer_iters=2, inner_iters=3, plant_substeps=2, device="cpu")
    a, _ = port.racing_sweep(3, 2, **kw)
    b, _ = port.racing_sweep(3, 2, backend="twin", **kw)
    assert torch.equal(a.states, b.states)


@pytest.mark.parametrize(
    "sweep, kw, item",
    [
        ("racing_sweep", {"backend": "pallas-hand"}, "S4.2"),
        ("racing_sweep", {"backend": "xla"}, "S3.2"),
        ("racing_sweep", {"mesh": object()}, "S7.1"),
        ("racing_sweep", {"dtype": torch.float64, "backend": "torch"}, "S3.2"),
        ("racing_sweep_dynamic", {"backend": "xla"}, "S3.2"),
        ("racing_sweep_dynamic", {"mesh": object()}, "S7.1"),
    ],
)
def test_unported_options_raise(sweep, kw, item):
    """Meshes (ROADMAP S7.1) still raise; the options of S3.2 and S4.2 (the
    per-scenario route, the parking kernel's tracking mode) are ported and
    run; ``backend="xla"`` is the JAX name of ``"torch"``; the kernel
    refuses float64, naming the per-scenario route."""
    if kw.get("backend") == "torch":
        with pytest.raises(ValueError, match="float32 only.*backend='torch'"):
            getattr(port, sweep)(2, 1, N=4, device="cpu", **{**kw, "backend": "cuda"})
    if item == "S7.1":
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            getattr(port, sweep)(2, 1, N=4, device="cpu", **kw)
    elif kw.get("backend") == "xla":
        with pytest.raises(ValueError, match="backend='torch'"):
            getattr(port, sweep)(2, 1, N=4, device="cpu", **kw)
    else:
        res, _ = getattr(port, sweep)(2, 1, N=4, device="cpu", outer_iters=1, inner_iters=2,
                                      plant_substeps=2, **kw)
        assert bool(torch.isfinite(res.states).all())


def test_per_scenario_controller_model_raises():
    """A per-scenario controller model the kernel has no operand for raises
    on the kernel backends, naming the per-scenario route, which takes it;
    a backend the Pacejka tier does not know still raises."""
    ref = ellipse_reference(10, speed=0.35, dynamic=False, device="cpu")
    per_lane = port.VehicleParameters(axis_rear=torch.full((2,), 0.05))
    for backend in ("cuda", "twin", "pallas-hand"):
        with pytest.raises(ValueError, match="axis_rear.*backend='torch'"):
            PB.batched_racing_policy(ref, per_lane, N=4, backend=backend)
    with pytest.raises(ValueError, match="axis_rear.*backend='torch'"):
        PB.batched_racing_dynamic_policy(ref, per_lane, N=4)
    pol = PB.batched_racing_policy(ref, per_lane, N=4, outer_iters=1, inner_iters=2,
                                   backend="torch")
    u, _, aux = pol(ref[:1].expand(2, 4).clone(), 0, pol.initial_carry(2, device="cpu"))
    assert u.shape == (2, 2) and "kernel_inner_iters" not in aux
    with pytest.raises(ValueError, match="unknown backend"):
        port.racing_sweep_dynamic(2, 1, N=4, backend="pallas-hand", device="cpu")


@pytest.mark.parametrize(
    "sweep, solver",
    [("racing_sweep", "fused_tracker_solve_cuda"), ("racing_sweep_dynamic", "al_ilqr_dyn_solve_cuda")],
)
def test_group_reaches_the_solver(monkeypatch, sweep, solver):
    """``group`` (the kernel's threads per lane) travels from the sweep
    through the policy to every solve; ``None`` (the instantiation's
    default) when it is not given; an unknown one raises."""
    seen = []
    solve = getattr(PB, solver)

    def spy(*args, **kw):
        seen.append(kw["group"])
        return solve(*args, **kw)

    monkeypatch.setattr(PB, solver, spy)
    kw = dict(N=4, outer_iters=1, inner_iters=2, plant_substeps=2, device="cpu")
    if sweep == "racing_sweep_dynamic":
        kw["pred_substeps"] = 1
    a, _ = getattr(port, sweep)(3, 2, group=16, **kw)
    b, _ = getattr(port, sweep)(3, 2, **kw)
    assert seen == [16, 16, None, None]
    assert torch.equal(a.states, b.states)  # the twin has no threads to group
    with pytest.raises(ValueError, match="group must be one of"):
        getattr(port, sweep)(3, 1, group=3, **kw)
