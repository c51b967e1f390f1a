"""The fused ADMM kernel past 256 columns (its panel mode on the card): the
port's plain twin against the JAX Pallas kernel in interpret mode on the
CPU, as tests/test_torch_admm_kernel.py runs it, on the operators the panel
mode serves: the condensed hard box at N = 100 (n = 100, m = 300) and the
slack-softened MPC at N = 30 (n = 90, m = 210). The CUDA kernel itself is held
against the twin by tests/test_torch_admm_kernel_host.py (its source built for
the host) and, on the card, by tests/test_torch_cuda.py and chip_smoke.py.

Gates. tests/test_torch_admm_kernel.py holds x and z within 5e-4 absolute on
a 10 × 16 random QP. At these operators z reaches ~150 and one iteration
sums 300-400 terms that cancel, so float32 programs that sum in other orders
part by more than 5e-4 in z after a single iteration, and the ADMM iterates
of these ill-conditioned QPs move such differences further each iteration
(:func:`test_one_iteration_matches_jax` prints each side's distance to the
twin's algorithm run in float64). So:

- one iteration (no polish: its acceptance test decides per row at the
  tolerance edge): x, z and y within 5e-4 of each output's ∞-norm (the y
  gate of tests/test_torch_admm_kernel.py, applied to all three);
- the presolve's budget: executed iterations equal, tile by tile (the exits
  and ρ moves decide alike), converged masks equal on 15 of the 16
  scenarios (a scenario is judged on its polished iterate, at the tolerance
  edge: one soft scenario differs);
- the warm policy's budget: the port exits no later and converges wherever
  JAX does (tests/test_torch_admm_kernel.py's warm case: the bf16×3 bias can
  keep a JAX tile from passing an exit test the port passes, here 48
  against 28 iterations on the soft operator);
- the slice's closed loop (N = 100, defaults, 8 scenarios × 3 steps):
  tests/test_torch_soft_closed_loop.py's bars (states within 5e-2, inputs
  within 3e-2) and equal success masks, against the JAX kernel with its
  bf16×3 product (``_dot3``: about 1e-5 relative, ROADMAP queue 3) replaced by
  the exact FP32 product the port computes (with the bf16×3 product the
  inputs' bar fails on one scenario of this draw).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.control.batch_loop import simulate_batch as jax_simulate
import model_predictive_control_tpu.ops.pallas.admm_kernel as JK
from model_predictive_control_tpu.ops.pallas.admm_kernel import admm_solve_pallas
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.convert import from_jax_arrays
from model_predictive_control_tpu_torch.ops.condensed import CondensedQP, SoftCondensedQP
from model_predictive_control_tpu_torch.ops.cuda import admm_kernel as K
from model_predictive_control_tpu_torch.solvers.linear_mpc import LinearMPC
from model_predictive_control_tpu_torch.solvers.qp import QPOperator

TILE = 8
# (horizon, soft): the hard box's defaults; the MHE loop's soft MPC settings
CASES = {"hard_N100": (100, False), "soft_N30": (30, True)}


def _controllers(N, soft):
    """The JAX controller (float32) and the port's on the same QP data and
    operator (copied across)."""
    problem = mpc.session2_problem(N=N)
    if soft:
        ctrl_j = mpc.make_linear_mpc(problem, iters=200, dtype=jnp.float32, soft_state=True,
                                     slack_weight=1e4, rho=0.02)
        base = from_jax_arrays(ctrl_j.qp.base, CondensedQP, device="cpu")
        qp = SoftCondensedQP(P=torch.as_tensor(np.array(ctrl_j.qp.P)),
                             A_c=torch.as_tensor(np.array(ctrl_j.qp.A_c)), base=base,
                             slack_linear=float(ctrl_j.qp.slack_linear))
    else:
        ctrl_j = mpc.make_linear_mpc(problem, solver="admm", dtype=jnp.float32)
        qp = from_jax_arrays(ctrl_j.qp, CondensedQP, device="cpu")
    ctrl_t = LinearMPC(qp=qp, op=from_jax_arrays(ctrl_j.op, QPOperator, device="cpu"),
                       iters=ctrl_j.iters, soft=soft)
    return problem, ctrl_j, ctrl_t


def _starts(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-140.0, -20.0, B), rng.uniform(-15.0, 24.0, B)],
                    axis=1).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    N, soft = CASES[request.param]
    problem, ctrl_j, ctrl_t = _controllers(N, soft)
    assert K.launch_plan(ctrl_t.qp.n, ctrl_t.qp.m, TILE, True).panel
    q, l, u = (a.numpy() for a in ctrl_t.qp.qp_vectors(torch.as_tensor(_starts(16, N))))
    return ctrl_j, ctrl_t, q, l, u


@pytest.fixture(scope="module")
def warm_start(case):
    """The JAX cold solution of the case (160 iterations in interpret mode),
    the warm start of the warm cases: one reference run shared by them."""
    ctrl_j, _, q, l, u = case
    return _warm(ctrl_j, q, l, u)


def _both(ctrl_j, ctrl_t, q, l, u, warm=(None, None), **kw):
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.as_tensor(np.array(a))
    ref, ni_ref = admm_solve_pallas(ctrl_j.op, j(q), j(l), j(u), *map(j, warm),
                                    return_iters=True, tile=TILE, **kw)
    got, ni = K.admm_solve_cuda(ctrl_t.op, t(q), t(l), t(u), *map(t, warm), return_iters=True,
                                tile=TILE, **kw)
    return ref, np.asarray(ni_ref), got, ni.numpy()


def _warm(ctrl_j, q, l, u):
    """The JAX cold solution, the warm start of the warm cases."""
    sol = admm_solve_pallas(ctrl_j.op, *map(jnp.asarray, (q, l, u)), iters=160, chunks=4,
                            probe_iters=0, tile=TILE)
    return sol.x, sol.y


@pytest.mark.parametrize("warm", [False, True])
def test_one_iteration_matches_jax(case, warm_start, warm):
    """One iteration, cold or warm from the JAX cold solution, no polish:
    x, z and y within 5e-4 of each output's ∞-norm. Prints each side's
    largest distance to the twin's algorithm run in float64 on the same
    operands."""
    ctrl_j, ctrl_t, q, l, u = case
    start = warm_start if warm else (None, None)
    kw = dict(iters=1, chunks=1, probe_iters=0, polish=False)
    ref, ni_ref, got, ni = _both(ctrl_j, ctrl_t, q, l, u, warm=start, **kw)
    t = lambda a: None if a is None else torch.as_tensor(np.array(a))
    plain = K.admm_solve_tiles_reference
    K.admm_solve_tiles_reference = lambda *a, **k: tuple(
        o.float() for o in plain(*(x.double() for x in a), **k))
    try:
        wit = K.admm_solve_cuda(ctrl_t.op, t(q), t(l), t(u), *map(t, start), tile=TILE, **kw)
    finally:
        K.admm_solve_tiles_reference = plain
    for name in ("x", "z"):
        w = getattr(wit, name).numpy()
        print(f"{name}: twin {np.abs(getattr(got, name).numpy() - w).max():.2e}, JAX "
              f"{np.abs(np.asarray(getattr(ref, name)) - w).max():.2e} from the float64 twin")
    for name in ("x", "z", "y"):
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), want,
                                   atol=5e-4 * max(1.0, np.abs(want).max()), err_msg=name)
    np.testing.assert_array_equal(ni, ni_ref)


def test_cold_with_polish_matches_jax(case):
    """The presolve's flags (ρ moves, polish) at a cut budget of 120
    iterations on 16 scenarios: executed iterations equal, converged masks
    equal on 15 of 16."""
    ctrl_j, ctrl_t, q, l, u = case
    ref, ni_ref, got, ni = _both(ctrl_j, ctrl_t, q, l, u, iters=120, chunks=4, probe_iters=0)
    np.testing.assert_array_equal(ni, ni_ref)
    assert (got.converged.numpy() == np.asarray(ref.converged)).sum() >= 15


def test_warm_fixed_rho_matches_jax(case, warm_start):
    """The warm policy's flags (fixed ρ, no polish, an 8-iteration probe)
    from the JAX cold solution: the port exits no later and converges
    wherever JAX does."""
    ctrl_j, ctrl_t, q, l, u = case
    ref, ni_ref, got, ni = _both(ctrl_j, ctrl_t, q, l, u, warm=warm_start, iters=48,
                                 polish=False, max_rho_moves=0, probe_iters=8)
    assert np.all(ni <= ni_ref)
    assert np.all(got.converged.numpy()[np.asarray(ref.converged)])


def test_long_horizon_closed_loop_matches_jax(monkeypatch):
    """The slice's path: the condensed hard box at N = 100 through the
    batched ADMM policy at its defaults (4× presolve, then 3 steps) on 8
    scenarios, the port's twin against the JAX Pallas kernel in interpret
    mode with its product in exact FP32 (see the module's note). States
    within 5e-2, inputs within 3e-2, success masks equal."""
    monkeypatch.setattr(JK, "_split_bf16", lambda a: (a, jnp.zeros_like(a)))
    monkeypatch.setattr(JK, "_dot3", lambda a, b: jnp.dot(a, b[0], **JK._DOT))
    jax.clear_caches()  # no trace of the bf16×3 product is reused
    problem, ctrl_j, ctrl_t = _controllers(100, False)
    x0 = _starts(8, 5)
    xj = jnp.asarray(x0)
    try:
        ref = jax_simulate(xj, problem.system(jnp.float32), 3,
                           ctrl_j.batched_policy(backend="pallas", tile=TILE),
                           ctrl_j.presolve_batch_carry(xj, tile=TILE))
    finally:
        monkeypatch.undo()
        jax.clear_caches()  # nor a trace of the exact one afterwards
    xt = torch.as_tensor(x0)
    got = port.simulate_batch(xt, port.session2_problem(N=100).system(device="cpu"), 3,
                              ctrl_t.batched_policy(tile=TILE),
                              ctrl_t.presolve_batch_carry(xt, tile=TILE), batched_dynamics=True)
    assert got.states.shape == (4, 8, 2) and got.inputs.shape == (3, 8, 1)
    np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), atol=5e-2)
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=3e-2)
    np.testing.assert_array_equal(got.logs["solver_success"].numpy(),
                                  np.asarray(ref.logs["solver_success"]))


@pytest.mark.parametrize("n, m", [(100, 300), (90, 210), (300, 700)])
@pytest.mark.parametrize("polish", [False, True])
def test_launch_plan_past_256_columns(n, m, polish):
    """``launch_plan`` returns a panel-mode plan at tile 8 for the hard box
    at N = 100 and the soft MPC at N = 30 and 100, within the shared memory
    a CTA may ask for."""
    plan = K.launch_plan(n, m, TILE, polish)
    assert plan.panel and plan.tiles_per_cta == 1 and plan.panel_rows >= 1
    assert plan.warps_per_quad == -(-(n + m) // 256)
    assert plan.smem_bytes <= K.SMEM_LIMIT and plan.threads <= K.MAX_THREADS


def test_launch_plan_raises_past_shared_memory():
    """Past the shared memory of one tile (one-row panels and the row
    buffers of tile 1), ``launch_plan`` raises and names the bytes."""
    with pytest.raises(ValueError, match=r"n \+ m = 5000 at tile 1 needs \d+ bytes of shared"):
        K.launch_plan(1000, 4000, 1, True)


def test_mhe_loop_budget_runs_match_jax():
    """The MHE loop's soft MPC (n + m = 200, the panel mode on the card) runs
    most tiles to its 200-iteration budget from step ~17 on. The loop's own
    solves at steps 18-24 (16 scenarios, tile 8, captured from the port's
    loop), re-solved on JAX's operator by the twin and by the JAX Pallas
    kernel in interpret mode with the policy's flags: executed iterations
    equal tile by tile, so the budget runs are the algorithm's in both
    packages, not a divergence of the port (ROADMAP queue 3)."""
    from model_predictive_control_tpu_torch.parallel.batch import mhe_loop_sweep
    from model_predictive_control_tpu_torch.solvers import linear_mpc as LM

    seen = []
    real = LM._TILED["cuda"]

    def spy(op, q, l, u, wx, wy, **kw):
        if q.shape[1] == 60:  # the soft MPC's solves, not the MHE windows'
            seen.append((q, l, u, wx, wy, kw))
        return real(op, q, l, u, wx, wy, **kw)

    LM._TILED["cuda"] = spy
    try:
        mhe_loop_sweep(16, 25, tile=TILE, device="cpu")
    finally:
        LM._TILED["cuda"] = real
    ctrl_j = mpc.make_linear_mpc(mpc.session2_problem(N=20), iters=200, dtype=jnp.float32,
                                 soft_state=True, slack_weight=1e4, rho=0.02)
    op_t = from_jax_arrays(ctrl_j.op, QPOperator, device="cpu")
    at_budget = []
    for q, l, u, wx, wy, kw in seen[19:26]:  # seen[0] is the presolve: steps 18-24
        _, ni = K.admm_solve_cuda(op_t, q, l, u, wx, wy, return_iters=True, **kw)
        _, ni_j = admm_solve_pallas(ctrl_j.op, *(jnp.asarray(a.numpy()) for a in (q, l, u, wx, wy)),
                                    return_iters=True, **kw)
        np.testing.assert_array_equal(ni.numpy(), np.asarray(ni_j))
        at_budget.append(ni[::TILE].eq(200).tolist())
    print(f"tiles at the 200-iteration budget, steps 18-24: {at_budget}")
    assert sum(map(sum, at_budget)) > len(at_budget)  # most tile-solves run the budget
