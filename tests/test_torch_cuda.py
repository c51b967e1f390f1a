"""The hand-written CUDA kernels against their plain twins on the card.

These tests need a CUDA device and skip without one. They import neither JAX
nor the JAX package, so they also run where only torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.ops.cuda import admm_kernel as K
from model_predictive_control_tpu_torch.parallel.batch import random_initial_states

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


@pytest.fixture
def parking():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from model_predictive_control_tpu_torch.ops.cuda import ilqr_kernel as KI
    from model_predictive_control_tpu_torch.solvers.parking import Q_MAIN, QN_SCALE_MAIN, R_MAIN

    geom, limits = KI.parking_geometry(port.VehicleParameters(), (0.25, 0.0, 0.0, 0.0))
    kw = dict(N=8, ts=0.08, geom=geom, limits=limits, n_circles=3,
              weights=(tuple(Q_MAIN), tuple(R_MAIN), float(QN_SCALE_MAIN)))
    return KI, kw


@pytest.mark.parametrize("tile", [4, 32])
def test_alilqr_kernel_matches_twin(parking, tile):
    """Same inputs on the card: the kernel does the twin's operations in the
    twin's order without FMA contraction, so the two agree bit for bit."""
    KI, kw = parking
    g = torch.Generator().manual_seed(2)
    x0 = random_initial_states(
        g, 37, x_obs=(0.25, 0.0, 0.0, 0.0), device="cuda"
    )
    u = 0.1 * torch.randn(37, 8, 2, generator=g).cuda()
    acc, fric = torch.full((37,), 2.0).cuda(), torch.full((37,), 1.0).cuda()
    before = KI.LAUNCHES
    got = KI.al_ilqr_solve_cuda(x0, u, acc, fric, tile=tile, **kw)
    torch.cuda.synchronize()
    assert KI.LAUNCHES == before + 1
    ref = KI.al_ilqr_solve_twin(x0, u, acc, fric, tile=tile, **kw)
    for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_parking_sweep_launches_the_kernel(parking):
    KI, _ = parking
    before = KI.LAUNCHES
    res, summary = port.parking_sweep(64, 3, N=8, device="cuda")
    assert KI.LAUNCHES == before + 3
    assert res.states.is_cuda and bool(torch.isfinite(res.states).all())
    assert 0.0 <= summary["success_rate"] <= 1.0
