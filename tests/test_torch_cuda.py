"""The hand-written CUDA kernel against its plain twin on the card.

These tests need a CUDA device and skip without one. They import neither JAX
nor the JAX package, so they also run where only torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.ops.cuda import admm_kernel as K

pytestmark = pytest.mark.cuda

N, B, TILE = 8, 64, 8


@pytest.fixture
def ctrl():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    problem = port.session2_problem(N=N)
    return problem, port.make_linear_mpc(
        problem, iters=150, dtype=torch.float32, device="cuda"
    )


def _states(seed=0, batch=B):
    g = torch.Generator().manual_seed(seed)
    p = torch.empty(batch).uniform_(-140.0, -20.0, generator=g)
    v = torch.empty(batch).uniform_(-15.0, 24.0, generator=g)
    return torch.stack([p, v], dim=1).cuda()


@pytest.mark.parametrize("polish", [True, False])
def test_kernel_matches_twin(ctrl, polish):
    """Same inputs on the card: executed iterations agree on at least 90% of
    the scenarios, and x agrees within 2e-2 where they do (x in [-20, 10];
    FP32 sums in another order, amplified by the polish's CG)."""
    _, c = ctrl
    q, l, u = c.qp.qp_vectors(_states())
    kw = dict(iters=300, chunks=4, probe_iters=8, tile=TILE, polish=polish,
              return_iters=True)
    before = K.LAUNCHES
    got, ni = K.admm_solve_cuda(c.op, q, l, u, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    ref, ni_ref = K.admm_solve_twin(c.op, q, l, u, **kw)
    same = ni == ni_ref
    assert same.float().mean() >= 0.9
    torch.testing.assert_close(got.x[same], ref.x[same], rtol=0, atol=2e-2)
    assert (got.converged == ref.converged).float().mean() >= 0.95


def test_oversize_tile_raises(ctrl):
    _, c = ctrl
    q, l, u = c.qp.qp_vectors(_states(batch=4))
    with pytest.raises(ValueError, match="shared memory"):
        K.admm_solve_cuda(c.op, q, l, u, tile=4096)


def test_closed_loop_kernel_matches_twin(ctrl):
    problem, c = ctrl
    x0 = _states(seed=1)
    x0 = x0[torch.argsort(port.boundary_compaction_key(problem.p_max, x0), stable=True)]
    system = problem.system(torch.float32, "cuda")
    out = {}
    for backend in ("cuda", "twin"):
        carry = c.presolve_batch_carry(x0, iters_mult=3, backend=backend, tile=TILE)
        pol = c.batched_policy(backend=backend, tile=TILE, max_rho_moves=0,
                               polish=False, probe_iters=8)
        out[backend] = port.simulate_batch(x0, system, 12, pol, carry)
    torch.testing.assert_close(
        out["cuda"].states, out["twin"].states, rtol=0, atol=5e-2
    )
