"""The port's tube and stochastic controllers and their sweeps against the
JAX package on the same numpy-made inputs.

Gates:
- the float64 set-up (the DARE gain, the mRPI supports, the Gaussian stage
  margins, the tightened QP bounds) within 1e-12 (the same numpy program;
  β by the standard library's normal quantile against scipy's erfinv);
- the single-scenario tube policy, float64 interior point on both sides:
  u-trajectories within 1e-4;
- the batched closed loops under the same starts and disturbances through
  ``simulate_batch(disturbances=...)`` on tests/test_torch_closed_loop.py's
  bars (states 5e-2, inputs 3e-2, success masks equal on 95% of the
  entries), the tube certificate equal: the tube's on the port's twin of
  the fused kernel against the JAX Pallas kernel in interpret mode, both
  tiers' per-scenario paths in float64;
- small sweeps on the twin: the JAX summaries' keys and the quality gates
  of BENCH_CONTRACT.json (tube: tube_ok_rate ≥ 0.999, success ≥ 0.97,
  original-box violations ≤ 0.01; stochastic: success ≥ 0.97, near-limit
  violations ≤ 0.13).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.control.batch_loop import simulate_batch as jax_simulate
from model_predictive_control_tpu.solvers import stochastic as JS
from model_predictive_control_tpu.solvers import tube as JT
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.control.simulate import simulate
from model_predictive_control_tpu_torch.parallel import batch as PB
from model_predictive_control_tpu_torch.solvers import stochastic as PS
from model_predictive_control_tpu_torch.solvers import tube as PT

W_HALF = np.array([0.0, 0.45])
SIGMA_W = np.diag([0.0, 0.12**2])


def _gains(problem):
    Ts = problem.Ts
    A = np.array([[1.0, Ts], [0.0, 1.0]])
    B = np.array([[0.0], [Ts]])
    Q = np.diag(np.asarray(problem.Q, float))
    R = np.diag(np.asarray(problem.R, float))
    return A, B, Q, R


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_mrpi_and_gaussian_margins_match(scale):
    A, B, Q, R = _gains(mpc.session2_problem(N=20))
    np.testing.assert_allclose(PT._np_dare(A, B, Q, R), JT._np_dare(A, B, Q, R), rtol=0,
                               atol=1e-12)
    K = PT.lqr_gain_np(A, B, Q, R)
    got = PT.mrpi_box_margins(A + B @ K, scale * W_HALF, K)
    want = JT.mrpi_box_margins(A + B @ K, scale * W_HALF, K)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    for eps in (0.1, 0.05):
        got = PS.gaussian_stage_margins(A, B, K, scale * SIGMA_W, 20, eps)
        want = JS.gaussian_stage_margins(A, B, K, scale * SIGMA_W, 20, eps)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="eps"):
        PS.gaussian_stage_margins(A, B, K, SIGMA_W, 20, 0.7)


def test_controllers_build_the_same_tightened_qp():
    pj = mpc.session2_problem(N=20)
    pt = port.session2_problem(N=20)
    tj = JT.make_tube_mpc(pj, W_HALF, iters=100, dtype=jnp.float64)
    tt = PT.make_tube_mpc(pt, W_HALF, iters=100, dtype=torch.float64, device="cpu")
    sj = JS.make_stochastic_mpc(pj, SIGMA_W, eps=0.1, iters=200, dtype=jnp.float64, rho=0.01)
    st = PS.make_stochastic_mpc(pt, SIGMA_W, eps=0.1, iters=200, dtype=torch.float64, rho=0.01,
                                device="cpu")
    assert (tt.s, tt.alpha) == (tj.s, pytest.approx(tj.alpha, abs=1e-12))
    for name in ("K", "z_margin", "u_margin"):
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(tj, name)),
                                   rtol=0, atol=1e-12)
    for name in ("state_margin", "input_margin", "K"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                   rtol=0, atol=1e-12)
    assert st.beta == pytest.approx(sj.beta, abs=1e-12)
    for got, ref in ((tt.inner, tj.inner), (st.inner, sj.inner)):
        for name in ("u_lb", "u_ub", "x_lb", "x_ub"):
            np.testing.assert_allclose(getattr(got.qp, name).numpy(),
                                       np.asarray(getattr(ref.qp, name)), rtol=0, atol=1e-10)
        np.testing.assert_allclose(got.qp.P.numpy(), np.asarray(ref.qp.P), atol=1e-10)
    with pytest.raises(ValueError, match="tube does not fit"):
        PT.make_tube_mpc(pt, np.array([0.0, 9.0]), device="cpu")


def test_tube_policy_matches_jax():
    """The single-scenario tube policy under corner disturbances, float64
    interior point: u within 1e-4, the certificate held at every step."""
    N, steps = 10, 25
    pj = mpc.session2_problem(N=N)
    tj = JT.make_tube_mpc(pj, W_HALF, solver="pdip", iters=40, dtype=jnp.float64)
    tt = PT.make_tube_mpc(port.session2_problem(N=N), W_HALF, solver="pdip", iters=40,
                          dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(1)
    w = rng.choice([-1.0, 1.0], size=(steps, 2)) * W_HALF
    x0 = np.array([-40.0, 8.0])
    ref = mpc.simulate(jnp.asarray(x0), pj.system(jnp.float64), steps, tj.policy(),
                       tj.initial_carry(jnp.asarray(x0)), disturbances=jnp.asarray(w))
    got = simulate(torch.as_tensor(x0), port.session2_problem(N=N).system(torch.float64, "cpu"),
                   steps, tt.policy(), tt.initial_carry(torch.as_tensor(x0)),
                   disturbances=torch.as_tensor(w))
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=1e-4)
    assert bool(got.logs["tube_ok"].all()) and bool(got.logs["solver_success"].all())


def _starts(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-120.0, -40.0, B), rng.uniform(0.0, 14.0, B)],
                    axis=1).astype(np.float32)


def _batched_pair(tier, backend, dtype_j, dtype_t, B=16, steps=10, N=10, tile=8):
    """The JAX and the port's batched closed loops of one tier on the same
    numpy-made starts and disturbances, after a 4× presolve."""
    rng = np.random.default_rng(7)
    x0 = _starts(B, 2).astype(np.dtype(dtype_j))
    pj, pt = mpc.session2_problem(N=N), port.session2_problem(N=N)
    if tier == "tube":
        cj = JT.make_tube_mpc(pj, W_HALF, iters=100, dtype=dtype_j)
        ct = PT.make_tube_mpc(pt, W_HALF, iters=100, dtype=dtype_t, device="cpu")
        w = rng.choice([-1.0, 1.0], size=(steps, B, 2)) * W_HALF
    else:
        cj = JS.make_stochastic_mpc(pj, SIGMA_W, eps=0.1, iters=200, dtype=dtype_j, rho=0.01)
        ct = PS.make_stochastic_mpc(pt, SIGMA_W, eps=0.1, iters=200, dtype=dtype_t, rho=0.01,
                                    device="cpu")
        w = np.zeros((steps, B, 2))
        w[:, :, 1] = 0.12 * rng.normal(size=(steps, B))
    w = w.astype(x0.dtype)
    xj, xt = jnp.asarray(x0), torch.as_tensor(x0)
    kw_j = {"tile": tile} if backend == "pallas" else {"backend": "xla"}
    kw_t = {"tile": tile} if backend == "pallas" else {"backend": "xla"}
    carry_j = cj.inner.presolve_batch_carry(xj, **kw_j)
    carry_t = ct.inner.presolve_batch_carry(xt, **kw_t)
    if tier == "tube":
        carry_j, carry_t = (xj, carry_j), (xt, carry_t)
    ref = jax_simulate(xj, pj.system(dtype_j), steps,
                       cj.batched_policy(backend=backend, **({"tile": tile} if backend == "pallas"
                                                             else {})),
                       carry_j, disturbances=jnp.asarray(w))
    got = port.simulate_batch(xt, pt.system(dtype_t, device="cpu"), steps,
                              ct.batched_policy(backend="cuda" if backend == "pallas" else "xla",
                                                tile=tile),
                              carry_t, disturbances=torch.as_tensor(w))
    return ref, got


def _gate(ref, got, tier):
    np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), atol=5e-2)
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), atol=3e-2)
    s_ref = np.asarray(ref.logs["solver_success"])
    assert (got.logs["solver_success"].numpy() == s_ref).mean() >= 0.95
    if tier == "tube":
        np.testing.assert_array_equal(got.logs["tube_ok"].numpy(), np.asarray(ref.logs["tube_ok"]))


def test_tube_batched_loop_twin_matches_pallas_interpret():
    """The tube's batched loop on the port's twin against the JAX Pallas
    kernel in interpret mode (float32, 16 scenarios × 10 steps, N=10, tile
    8, the polish on as in the JAX closed-loop test's policy). With the
    sweeps' steady flags (ρ fixed, no polish) the two kernels stop at
    iterates that differ within the success tolerance
    ``1e-4·(1 + ‖q‖∞)``, ‖q‖∞ in the thousands at p ≈ −100, and two of 16
    solved scenarios move by 0.1-0.2 (the JAX kernel's bf16×3 product biases
    its fixed point, ROADMAP queue 3); the sweeps' flags are held to the
    quality gates below."""
    _gate(*_batched_pair("tube", "pallas", jnp.float32, torch.float32), "tube")


@pytest.mark.parametrize("tier", ["tube", "stochastic"])
def test_batched_loop_xla_backend_matches_jax_float64(tier):
    """Both tiers' batched loops on the per-scenario path, float64 on both
    sides. (The stochastic loop at ρ = 0.01 is not held to the JAX Pallas
    kernel in float32: there the JAX kernel fails two of 16 scenarios at
    some step, which the twin solves, and the states part by up to 0.09.)"""
    _gate(*_batched_pair(tier, "xla", jnp.float64, torch.float64), tier)


def test_tube_sweep_summary_and_gates():
    res, s = PB.tube_sweep(256, 20, device="cpu")
    assert set(s) == {"batch", "steps", "success_rate", "tube_ok_rate",
                      "original_box_violation_frac", "backend"}
    assert res.states.shape == (21, 256, 2) and res.logs["tube_ok"].shape == (20, 256)
    assert s["tube_ok_rate"] >= 0.999
    assert s["success_rate"] >= 0.97
    assert s["original_box_violation_frac"] <= 0.01


def test_stochastic_sweep_summary_and_gates():
    res, s = PB.stochastic_sweep(256, 20, device="cpu")
    assert set(s) == {"batch", "steps", "eps", "success_rate", "near_limit_violation_rate",
                      "backend"}
    assert s["success_rate"] >= 0.97
    assert s["near_limit_violation_rate"] <= 0.13


def test_sweeps_take_given_scenarios_and_sort_them():
    """``scenarios=`` bypasses the draw; the lanes are sorted by the
    compaction key with the disturbances following them, so a permuted copy
    of the same scenarios gives the same states."""
    g = torch.Generator().manual_seed(5)
    problem = port.session2_problem(N=20)
    tube = PT.make_tube_mpc(problem, W_HALF, iters=100, device="cpu")
    x0, w = PB.tube_scenarios(g, 24, 6, problem, tube, W_HALF)
    perm = torch.randperm(24, generator=g)
    a, _ = PB.tube_sweep(24, 6, device="cpu", scenarios=(x0, w))
    b, _ = PB.tube_sweep(24, 6, device="cpu", scenarios=(x0[perm], w[:, perm]))
    torch.testing.assert_close(a.states, b.states, rtol=0, atol=0)
