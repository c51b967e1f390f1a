"""The port's scale-out layer in one process (the single-process half of
``tests/test_distributed.py``): ``make_mesh``'s shapes and refusals, the
DTensor placements, ``initialize`` without a launcher, the batch slice and
the scaling efficiency, one-rank meshes through the sweeps and the kernel
policy (equal to the unsharded runs bit for bit), the weak-scaling ladder
through ``cli.main`` on the CPU, and every mesh refusal of the earlier port
gone. A one-rank mesh starts a world-1 gloo group, which each test ends."""

import inspect
import json
import pathlib

import pytest
import torch
import torch.distributed as dist

import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch import cli
from model_predictive_control_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_constraint_sharding,
    batch_sharding,
    global_mesh,
    initialize,
    make_mesh,
    process_batch_slice,
    replicated,
    scaling_efficiency,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def one_rank():
    """A one-rank CPU mesh, its world-1 group ended after the test."""
    mesh = make_mesh(1, device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_make_mesh_shapes_and_refusals(one_rank):
    from torch.distributed.tensor import Replicate, Shard

    assert one_rank.shape == (1, 1) and one_rank.mesh_dim_names == (DATA_AXIS, MODEL_AXIS)
    assert tuple(one_rank.get_coordinate()) == (0, 0)
    assert global_mesh(device="cpu").shape == (1, 1)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="divisible by model_parallel"):
        make_mesh(1, model_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        global_mesh(model_parallel=2, device="cpu")
    assert batch_sharding(one_rank) == [Shard(0), Replicate()]
    assert batch_constraint_sharding(one_rank) == [Shard(0), Shard(1)]
    assert replicated(one_rank) == [Replicate(), Replicate()]


def test_make_mesh_refuses_more_ranks_without_a_group():
    with pytest.raises(ValueError, match="requested 4 devices"):
        make_mesh(4, device="cpu")
    assert not dist.is_initialized()


def test_initialize_is_a_noop_without_a_launcher(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize(device="cpu") is False
    assert initialize(coordinator_address="localhost:1", num_processes=1, device="cpu") is False
    assert not dist.is_initialized()


def test_process_batch_slice_and_scaling_efficiency():
    assert process_batch_slice(64) == (0, 64)
    assert scaling_efficiency(800.0, 8, 100.0) == pytest.approx(1.0)
    assert scaling_efficiency(400.0, 8, 100.0) == pytest.approx(0.5)


def test_one_rank_parking_sweep_equals_unsharded(one_rank):
    kw = dict(N=5, outer_iters=2, inner_iters=3, plant_substeps=2, device="cpu")
    res, summary = port.parking_sweep(4, 2, mesh=one_rank, **kw)
    plain, plain_summary = port.parking_sweep(4, 2, **kw)
    assert torch.equal(res.states, plain.states) and summary == plain_summary


@pytest.mark.parametrize("sweep", ["tube_sweep", "wind_sweep"])
def test_one_rank_sweeps_equal_unsharded(one_rank, sweep):
    kw = ({"N": 4, "iters": 20} if sweep == "tube_sweep"
          else {"N": 4, "outer_iters": 1, "inner_iters": 2})
    res, summary = getattr(port, sweep)(4, 1, mesh=one_rank, device="cpu", **kw)
    plain, plain_summary = getattr(port, sweep)(4, 1, device="cpu", **kw)
    assert torch.equal(res.states, plain.states) and summary == plain_summary


def test_one_rank_batched_policy_equals_unsharded(one_rank):
    ctrl = port.make_linear_mpc(port.session2_problem(N=6), iters=100, device="cpu")
    g = torch.Generator().manual_seed(0)
    x0 = torch.stack([-100.0 + 80.0 * torch.rand(8, generator=g),
                      -10.0 + 30.0 * torch.rand(8, generator=g)], dim=1)
    carry = ctrl.initial_batch_carry(8, device="cpu")
    u_a, carry_a, aux_a = ctrl.batched_policy(tile=2)(x0, 0, carry)
    u_b, carry_b, aux_b = ctrl.batched_policy(tile=2, mesh=one_rank)(x0, 0, carry)
    assert torch.equal(u_a, u_b) and all(torch.equal(a, b) for a, b in zip(carry_a, carry_b))
    assert aux_a.keys() == aux_b.keys()
    assert all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)


def test_podscale_scaling_through_the_cli(capsys):
    assert cli.main(["podscale", "--scaling", "--batch", "16", "--steps", "2", "--horizon", "6",
                     "--iters", "20", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the JAX report's keys, and where the ranks ran
    jax_keys = {"metric", "batch_per_device", "steps", "horizon", "platform", "non_performance",
                "predicted_real_efficiency", "prediction_basis", "points"}
    assert jax_keys <= report.keys() and report["platform"] == "cpu"
    assert report["non_performance"] is True and report["ranks"] == 1
    (point,) = report["points"]
    assert point.keys() == {"devices", "batch", "solves_per_s", "per_chip_solves_per_s",
                            "efficiency_vs_1", "success_rate", "wall_s"}
    assert point["devices"] == 1 and point["batch"] == 16 and point["efficiency_vs_1"] == 1.0
    assert point["solves_per_s"] > 0 and 0.0 <= point["success_rate"] <= 1.0
    assert not dist.is_initialized()  # the world-1 group it started is ended


def test_mesh_refusals_are_gone():
    """Every entry point the JAX package gives ``mesh`` takes it, and no
    module of the port refuses a mesh any more."""
    from model_predictive_control_tpu_torch.parallel import batch

    ctrl = port.make_linear_mpc(port.session2_problem(N=4), iters=10, device="cpu")
    for fn in (ctrl.batched_policy, batch.batched_parking_policy, batch.parking_sweep,
               batch.batched_racing_policy, batch.racing_sweep,
               batch.batched_racing_dynamic_policy, batch.racing_sweep_dynamic, batch.tube_sweep,
               batch.quadrotor_sweep, batch.thruster_sweep, batch.wind_sweep):
        assert "mesh" in inspect.signature(fn).parameters, fn.__name__
    for path in (ROOT / "model_predictive_control_tpu_torch").rglob("*.py"):
        assert "S7.1" not in path.read_text(), path
