"""The fused ADMM kernel's plain twin against the JAX Pallas kernel (run in
interpret mode on the CPU, as tests/test_pallas_admm.py runs it), same tile,
float32. The CUDA kernel itself is held against the twin on the card by
tests/test_torch_cuda.py.

Gates: x and z within 5e-4 absolute (the gate of
test_pallas_matches_xla_path); y within 5e-4 of its own ∞-norm scale. The
JAX kernel's iteration product is a bf16×3 split with about 1e-5 relative
error against the port's full FP32, which biases its fixed point by about
that much relative to the duals' size. The same bias can keep a JAX tile
from passing an exit test that the port passes: in the warm case the port
exits at the 8-iteration probe where the reference runs 29 to 50, and the
reference with ``_dot3`` replaced by an exact FP32 product exits at 8 too.
Executed iterations are equal in every other case (ROADMAP queue 3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_predictive_control_tpu.ops.pallas.admm_kernel import admm_solve_pallas
from model_predictive_control_tpu.solvers.qp import qp_setup as jax_qp_setup
from model_predictive_control_tpu_torch.convert import from_jax_arrays
from model_predictive_control_tpu_torch.ops.cuda import admm_kernel as K
from model_predictive_control_tpu_torch.solvers.qp import QPOperator

from tests.test_qp import random_qp


def _problem(seed=0, B=16, n=10, m=16):
    rng = np.random.default_rng(seed)
    P, A, _, l, u = random_qp(rng, n=n, m=m, one_sided=False)
    op_j = jax_qp_setup(jnp.asarray(P, jnp.float32), jnp.asarray(A, jnp.float32))
    qs = rng.normal(size=(B, n)).astype(np.float32)
    ls = np.tile(l, (B, 1)).astype(np.float32)
    us = np.tile(u, (B, 1)).astype(np.float32)
    return op_j, from_jax_arrays(op_j, QPOperator, device="cpu"), qs, ls, us


def _both(op_j, op_t, q, l, u, warm=(None, None), **kw):
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.as_tensor(np.array(a))
    ref, ni_ref = admm_solve_pallas(
        op_j, j(q), j(l), j(u), *map(j, warm), return_iters=True, **kw
    )
    got, ni = K.admm_solve_cuda(
        op_t, t(q), t(l), t(u), *map(t, warm), return_iters=True, **kw
    )
    return ref, np.asarray(ni_ref), got, ni.numpy()


def _assert_close(ref, got):
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=5e-4)
    np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z), atol=5e-4)
    y_ref = np.asarray(ref.y)
    np.testing.assert_allclose(
        got.y.numpy(), y_ref, atol=5e-4 * max(1.0, np.abs(y_ref).max())
    )
    # the port converges wherever the reference does
    assert np.all(got.converged.numpy()[np.asarray(ref.converged)])


def test_cold_with_polish():
    op_j, op_t, q, l, u = _problem(seed=0)
    ref, ni_ref, got, ni = _both(op_j, op_t, q, l, u, iters=300, tile=8)
    _assert_close(ref, got)
    np.testing.assert_array_equal(ni, ni_ref)


def test_warm_polish_off_fixed_rho():
    op_j, op_t, q, l, u = _problem(seed=7)
    cold = admm_solve_pallas(op_j, *map(jnp.asarray, (q, l, u)), iters=400, tile=8)
    ref, ni_ref, got, ni = _both(
        op_j, op_t, q, l, u, warm=(cold.x, cold.y), iters=50, tile=8,
        polish=False, max_rho_moves=0, probe_iters=8,
    )
    _assert_close(ref, got)
    assert np.all(ni <= ni_ref)
    assert got.converged.all()


def test_ragged_batch():
    """B not a tile multiple: padded zero rows join the last tile's exit."""
    op_j, op_t, q, l, u = _problem(seed=2, B=13)
    ref, ni_ref, got, ni = _both(op_j, op_t, q, l, u, iters=300, tile=4)
    assert got.x.shape == (13, 10)
    _assert_close(ref, got)
    np.testing.assert_array_equal(ni, ni_ref)


def test_probe_covers_whole_budget():
    """iters <= probe_iters: the probe is the whole budget, bit for bit the
    single-chunk schedule of the same depth."""
    op_j, op_t, q, l, u = _problem(seed=7)
    ref, ni_ref, got, ni = _both(
        op_j, op_t, q, l, u, iters=8, chunks=4, probe_iters=32, tile=4
    )
    _assert_close(ref, got)
    np.testing.assert_array_equal(ni, ni_ref)
    assert np.all(ni == 8)
    t = lambda a: torch.as_tensor(a)
    one = K.admm_solve_cuda(op_t, t(q), t(l), t(u), iters=8, chunks=1, probe_iters=0, tile=4)
    torch.testing.assert_close(got.x, one.x, rtol=0, atol=0)
    torch.testing.assert_close(got.y, one.y, rtol=0, atol=0)


def test_geometric_schedule():
    op_j, op_t, q, l, u = _problem(seed=5)
    ref, ni_ref, got, ni = _both(
        op_j, op_t, q, l, u, iters=200, schedule="geometric", probe_iters=8,
        tile=8,
    )
    _assert_close(ref, got)
    np.testing.assert_array_equal(ni, ni_ref)
    # every executed count is a prefix sum of the schedule
    prefix = np.cumsum(K.chunk_lengths(200, 2, 8, "geometric"))
    assert set(ni.tolist()) <= set(prefix.tolist())


@pytest.mark.parametrize(
    "args, lens",
    [
        ((80, 2, 8, "uniform"), [8, 36, 36]),
        ((160, 4, 0, "uniform"), [40, 40, 40, 40]),
        ((8, 4, 32, "uniform"), [8]),
        ((3, 4, 0, "uniform"), [1, 1, 1, 1]),
        ((200, 2, 8, "geometric"), [8, 8, 12, 20, 32, 52, 68]),
    ],
)
def test_chunk_schedule(args, lens):
    assert K.chunk_lengths(*args) == lens


def test_cpu_tensors_take_the_twin():
    op_j, op_t, q, l, u = _problem(seed=1, B=4)
    before = K.LAUNCHES
    t = lambda a: torch.as_tensor(a)
    sol = K.admm_solve_cuda(op_t, t(q), t(l), t(u), iters=50, tile=4)
    twin = K.admm_solve_twin(op_t, t(q), t(l), t(u), iters=50, tile=4)
    assert K.LAUNCHES == before
    torch.testing.assert_close(sol.x, twin.x, rtol=0, atol=0)


def test_operator_built_once_per_operator(monkeypatch):
    """The fused W and Wq, 1/E and 1/(c·D) are built at the first solve with
    an operator and kept on it: a second solve builds nothing, and both give
    what a solve on operands built anew gives, bit for bit."""
    _, op_t, q, l, u = _problem(seed=4, B=8)
    t = lambda a: torch.as_tensor(a)
    kw = dict(iters=60, chunks=2, probe_iters=8, max_rho_moves=None, schedule="uniform",
              tile=4, cg_iters=40, alpha=1.6, eps_abs=None, polish=True)
    args, launch_kw = K.prepare_tiles(op_t, t(q), t(l), t(u), None, None, **kw)
    W, Wq = K._fused_operator(op_t)
    fresh = [W, Wq, op_t.A_s, op_t.P_s, op_t.Pinv_s, op_t.S, op_t.rho_levels, 1.0 / op_t.E,
             1.0 / (op_t.c * op_t.D), *args[9:]]
    want = K.admm_solve_tiles_reference(*[a.float().contiguous() for a in fresh], **launch_kw)

    op2 = dataclasses.replace(op_t)  # an operator the kernel has not seen
    builds = []
    build = K._fused_operator
    monkeypatch.setattr(K, "_fused_operator", lambda op: builds.append(op) or build(op))
    for _ in range(2):
        sol = K.admm_solve_cuda(op2, t(q), t(l), t(u), **kw)
        got = K.admm_solve_tiles_reference(*K.prepare_tiles(op2, t(q), t(l), t(u), None, None,
                                                            **kw)[0], **launch_kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert builds == [op2]
    assert sol.x.shape == (8, 10)
