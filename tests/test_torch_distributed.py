"""The port's scale-out layer on four gloo ranks (2 × 2: data × model), held
against the JAX package's mesh paths on the conftest's virtual CPU devices
(the counterparts of ``tests/test_distributed.py`` and
``tests/test_tensor_parallel.py``).

One spawn of four ranks runs every case
(:func:`model_predictive_control_tpu_torch.parallel.dryrun.record_checks`,
whose ranks import ``torch`` and the port only) and writes each rank's
results to ``tmp_path``; the JAX side runs once, in this process:

- the global mesh's axes and refusals, each process's batch slice, a global
  DTensor batch gathered back;
- ``admm_solve_tp`` against JAX's ``admm_solve_tp`` on a 2 × 2 JAX mesh in
  float64 within 5e-8 (``tests/test_tensor_parallel.py``'s bar), against the
  port's ``admm_solve`` at a fixed ρ, and exactly one model-axis
  ``all_reduce`` an iteration (the counterpart of the JAX test's HLO check);
- the kernel policy's mesh path (its twin on the CPU) bit for bit against
  the unsharded policy, and against JAX's mesh path on the same starts at
  ``tests/test_distributed.py``'s bar (u within 2e-3 on lanes converged in
  both);
- a sharded parking sweep bit for bit against the unsharded one, its summary
  computed on the gathered batch;
- the command line inside the four-rank run: its sweep takes the mesh of all
  ranks, rank 0 alone prints, the summary the one-process command's;
- the dry run's ``dryrun_multichip OK`` line.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.parallel import admm_solve_tp as jax_admm_solve_tp
from model_predictive_control_tpu.parallel.mesh import make_mesh as jax_make_mesh

from model_predictive_control_tpu_torch import cli
from model_predictive_control_tpu_torch.parallel.dryrun import CLI_SWEEP, record_checks, run_ranks

RANKS = 4


def _starts(rng, B, p_lo):
    return np.stack([rng.uniform(p_lo, -20.0, B), rng.uniform(-10.0, 20.0, B)], axis=1)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    ctrl = mpc.make_linear_mpc(mpc.session2_problem(N=10), solver="admm", iters=200,
                               dtype=jnp.float64)
    q, l, u = jax.vmap(ctrl.qp.qp_vectors)(jnp.asarray(_starts(rng, 8, -120.0)))
    return {
        "tp_q": np.asarray(q), "tp_l": np.asarray(l), "tp_u": np.asarray(u),
        "pol_x0": _starts(rng, 16, -100.0).astype(np.float32),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}, out / "inputs.pt")
    run_ranks(record_checks, RANKS, args=(str(out), str(out / "inputs.pt"), "cpu"),
              device="cpu", timeout_s=300)
    return [torch.load(out / f"rank{r}.pt") for r in range(RANKS)]


def test_global_mesh_axes(ranks):
    assert [r["coordinate"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert r["mesh_shape"] == (2, 2) and r["mesh_dims"] == ("data", "model")
        assert r["refuse_model3"]  # 4 ranks do not split by a model axis of 3


def test_process_batch_slice_halves(ranks):
    # by data coordinate on the mesh: ranks that differ only on the model axis share a half
    assert [r["slice_mesh"] for r in ranks] == [(0, 32), (0, 32), (32, 64), (32, 64)]
    assert [r["slice_world"] for r in ranks] == [(0, 16), (16, 32), (32, 48), (48, 64)]
    assert all(r["refuse_uneven"] for r in ranks)


def test_make_global_batch_gathers_the_input(ranks):
    for r in ranks:
        assert torch.equal(r["global_batch"], torch.arange(32, dtype=torch.float32).reshape(16, 2))


@pytest.fixture(scope="module")
def jax_tp(inputs):
    ctrl = mpc.make_linear_mpc(mpc.session2_problem(N=10), solver="admm", iters=200,
                               dtype=jnp.float64)
    sol = jax_admm_solve_tp(ctrl.op, *(jnp.asarray(inputs[k]) for k in ("tp_q", "tp_l", "tp_u")),
                            mesh=jax_make_mesh(4, model_parallel=2), iters=400)
    return np.asarray(sol.x), np.asarray(sol.converged)


def test_tp_matches_jax_admm_solve_tp(ranks, jax_tp):
    x_jax, conv_jax = jax_tp
    assert conv_jax.sum() >= 6  # most starts are feasible
    for r in ranks:
        np.testing.assert_allclose(r["tp_x"].numpy(), x_jax, atol=5e-8)
        np.testing.assert_array_equal(r["tp_converged"].numpy(), conv_jax)


def test_tp_matches_admm_solve_at_fixed_rho(ranks):
    for r in ranks:
        np.testing.assert_allclose(r["tp_x"].numpy(), r["admm_x"].numpy(), atol=5e-8)


def test_tp_one_model_all_reduce_per_iteration(ranks):
    assert [r["tp_all_reduces_10"] for r in ranks] == [10] * RANKS


def test_sharded_batched_policy_matches_unsharded_and_jax(ranks, inputs):
    for r in ranks:
        assert torch.equal(r["pol_mesh_u"], r["pol_u"])
        assert torch.equal(r["pol_mesh_ok"], r["pol_ok"])
        assert torch.equal(r["pol_mesh_iters"], r["pol_iters"])  # gathered like the logs
    # JAX's mesh path (the Pallas kernel in interpret mode shard-mapped over
    # two data devices) on the same starts at the same tile (a data slice is
    # one tile), at its own test's bar
    ctrl = mpc.make_linear_mpc(mpc.session2_problem(N=6), solver="admm", iters=400,
                               dtype=jnp.float32)
    x0 = jnp.asarray(inputs["pol_x0"])
    u_j, _, aux_j = jax.jit(ctrl.batched_policy(backend="pallas", tile=8,
                                                mesh=jax_make_mesh(2)))(
        x0, 0, ctrl.initial_batch_carry(x0.shape[0]))
    both = np.asarray(aux_j["solver_success"]) & ranks[0]["pol_mesh_ok"].numpy()
    assert both.sum() >= 8
    np.testing.assert_allclose(ranks[0]["pol_mesh_u"].numpy()[both], np.asarray(u_j)[both],
                               atol=2e-3)


def test_sharded_parking_sweep_matches_unsharded(ranks):
    for r in ranks:
        assert torch.equal(r["park_mesh_states"], r["park_states"])
        assert torch.equal(r["park_mesh_ok"], r["park_ok"])
        # the summary of the gathered batch is the unsharded run's, key for key
        assert r["park_mesh_summary"] == r["park_summary"]
        assert r["park_mesh_summary"]["batch"] == 8


def test_cli_sweep_takes_the_mesh_of_all_ranks(ranks, capsys):
    assert [r["cli_printed"] == "" for r in ranks] == [False, True, True, True]
    meshed = json.loads(ranks[0]["cli_printed"].strip().splitlines()[-1])
    assert cli.main(CLI_SWEEP + ["--device", "cpu"]) == 0
    plain = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    timing = {"wall_s", "solves_per_s", "wall_steady_s"}
    assert meshed.keys() == plain.keys()
    assert {k: v for k, v in meshed.items() if k not in timing} == {
        k: v for k, v in plain.items() if k not in timing}


def test_dryrun_multichip_prints_ok(ranks):
    for r in ranks:
        assert r["dryrun"].startswith(
            "dryrun_multichip OK: 4 devices, mesh {'data': 2, 'model': 2}, batch 8")
        assert "tp_collective=verified" in r["dryrun"]
