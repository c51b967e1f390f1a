"""The port's float64 oracle tier against the JAX package's, on the same
numpy-made inputs.

Gates: the numpy/scipy oracles (LQR, condensed MPC, the certified box-QP)
and the native C++ oracles (ADMM + polish box-QP, its KKT residual, the
parking SQP and its closed loop) bit for bit: the same algorithms, and for
the native ones the same sources built with the same g++ flags (the port's
copies of ``native/*.cpp`` are held equal to them byte for byte). The
parking NLP's SLSQP within 1e-8 in u at N=10: its gradient comes from
``torch.autograd`` in place of ``jax.grad`` and ``jax.jacfwd``, whose
rounding may move SLSQP's path. Then the port's oracle certifies the port's float64 twin ADMM on the
session-2 family (the bars of ``tests/test_native_qp.py``), tensors are
taken as numpy arrays are, and workers that build a library at once load a
whole one. The JAX package's libraries are built from copies of its
sources in a directory of this module's own (its build is not atomic).
"""

import pathlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.oracle import (
    lqr_oracle as J_lqr,
    mpc_oracle as J_mpc,
    native_nlp as J_nlp,
    native_qp as J_nqp,
    qp_oracle as J_qp,
)
from model_predictive_control_tpu.oracle.parking_oracle import (
    solve_parking_nlp as jax_parking_nlp,
)
from model_predictive_control_tpu.solvers.parking import make_parking_ocp as jax_parking_ocp
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch import oracle as O
from model_predictive_control_tpu_torch.oracle import _native_build as NB
from model_predictive_control_tpu_torch.oracle import native_nlp as T_nlp
from model_predictive_control_tpu_torch.solvers.parking import Q_SOL, QN_SCALE_SOL, make_parking_ocp

ROOT = pathlib.Path(__file__).resolve().parents[1]
X0_PARK = np.array([0.3, -0.1, 0.0, 0.0])
X_OBS = np.array([0.25, 0.0, 0.0, 0.0])


@pytest.fixture(scope="module", autouse=True)
def jax_native_build(tmp_path_factory):
    """The JAX package's native libraries built from copies of its sources
    in a directory of this module's own: its build writes the ``.so`` in
    place, so two test workers building ``native/build/`` at once could
    load a partial file."""
    from model_predictive_control_tpu.oracle import _native_build as JB

    src = tmp_path_factory.mktemp("native")
    for name in ("qp_oracle.cpp", "nlp_oracle.cpp"):
        (src / name).write_bytes((ROOT / "native" / name).read_bytes())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "NATIVE_DIR", str(src))
        yield


def _same(got, want):
    """Bit for bit, leaf by leaf (arrays, tuples, dicts, scalars)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)) and not isinstance(want, np.ndarray):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _system(seed, nx=3, nu=2):
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.3 * rng.normal(size=(nx, nx))
    B = rng.normal(size=(nx, nu))
    Mq = rng.normal(size=(nx, nx))
    Q = Mq @ Mq.T + 0.5 * np.eye(nx)
    R = np.diag(rng.uniform(0.1, 1.0, nu))
    return A, B, Q, R


def _random_box_qp(rng, n=10, m=16):
    """``tests/test_native_qp.py``'s family: SPD P, boxes, one-sided rows."""
    G = rng.standard_normal((n, n))
    P = G @ G.T + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    center = rng.standard_normal(m)
    width = np.abs(rng.standard_normal(m)) + 0.3
    l, u = center - width, center + width
    l[: m // 4] = -np.inf
    u[-m // 4:] = np.inf
    return P, q, A, l, u


def test_all_is_the_jax_oracles():
    from model_predictive_control_tpu import oracle as JO

    assert O.__all__ == JO.__all__
    assert all(callable(getattr(O, n)) for n in O.__all__)


@pytest.mark.parametrize("seed", [0, 1])
def test_lqr_oracle_bit_for_bit(seed):
    A, B, Q, R = _system(seed)
    _same(O.riccati_recursion_np(A, B, Q, R, Q, 12), J_lqr.riccati_recursion_np(A, B, Q, R, Q, 12))
    P = O.dare_np(A, B, Q, R)
    _same(P, J_lqr.dare_np(A, B, Q, R))
    _same(O.lqr_gain_np(A, B, R, P), J_lqr.lqr_gain_np(A, B, R, P))
    K = O.lqr_gain_np(A, B, R, P)
    f = lambda x, u: A @ x + B @ u
    policy = lambda x, t: K @ x
    x0 = np.random.default_rng(seed).normal(size=3)
    _same(O.simulate_np(x0, f, policy, 20), J_lqr.simulate_np(x0, f, policy, 20))


@pytest.mark.parametrize("seed", [0, 1])
def test_mpc_oracle_bit_for_bit(seed):
    A, B, Q, R = _system(seed, nx=2, nu=1)
    A = 0.9 * A / max(1.0, np.abs(np.linalg.eigvals(A)).max())
    N = 6
    _same(O.prediction_matrices_np(A, B, N), J_mpc.prediction_matrices_np(A, B, N))
    x_ref = np.random.default_rng(seed).normal(size=2)
    _same(O.condensed_qp_np(A, B, Q, R, 2 * Q, N, x_ref=x_ref),
          J_mpc.condensed_qp_np(A, B, Q, R, 2 * Q, N, x_ref=x_ref))
    problem = dict(A=A, B=B, Q=Q, R=R, QN=2 * Q, N=N, u_min=np.array([-0.5]),
                   u_max=np.array([0.5]), x_min=np.array([-5.0, -5.0]),
                   x_max=np.array([5.0, 5.0]))
    x0 = np.array([2.0, -1.0])
    _same(O.closed_loop_mpc_np(problem, x0, 4), J_mpc.closed_loop_mpc_np(problem, x0, 4))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qp_oracle_bit_for_bit(seed):
    P, q, A, l, u = _random_box_qp(np.random.default_rng(seed))
    _same(O.solve_qp_np(P, q, A, l, u), J_qp.solve_qp_np(P, q, A, l, u))


def test_native_sources_are_the_jax_packages():
    for name in ("qp_oracle.cpp", "nlp_oracle.cpp"):
        assert (NB.NATIVE_DIR / name).read_bytes() == (ROOT / "native" / name).read_bytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_native_qp_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    P, _, A, _, _ = _random_box_qp(rng)
    Qb = rng.standard_normal((6, 10))
    center = rng.standard_normal((6, 10)) @ A.T
    Lb, Ub = center - 1.0, center + 1.0
    Lb[:, :3] = -np.inf
    fam = O.solve_qp_family_native(P, A, Qb, Lb, Ub, iters=3000)
    _same(fam, J_nqp.solve_qp_family_native(P, A, Qb, Lb, Ub, iters=3000))
    assert fam[2].all()
    one = O.solve_qp_native(P, Qb[1], A, Lb[1], Ub[1], polish=False)
    _same(one, J_nqp.solve_qp_native(P, Qb[1], A, Lb[1], Ub[1], polish=False))
    X, Y, _ = fam
    for b in range(2):
        got = O.kkt_residual_native(P, Qb[b], A, Lb[b], Ub[b], X[b], Y[b])
        assert isinstance(got, float)
        assert got == J_nqp.kkt_residual_native(P, Qb[b], A, Lb[b], Ub[b], X[b], Y[b])
        assert got < 1e-9


def test_native_nlp_bit_for_bit():
    """The no-obstacle variant solved to its tolerance, eight SQP iterations
    of the obstacle variant (the clearance rows), and a closed loop."""
    pj, pt = mpc.VehicleParameters(), port.VehicleParameters()
    _same(T_nlp.pack_params(pt), J_nlp.pack_params(pj))
    sol = dict(Q=Q_SOL, qn_scale=QN_SCALE_SOL, tol=1e-7)
    got = T_nlp.solve_parking_native(pt, 10, 0.05, X0_PARK, **sol)
    _same(got, J_nlp.solve_parking_native(pj, 10, 0.05, X0_PARK, **sol))
    assert got[1]["converged"] and got[1]["kkt_res"] < 1e-7
    obs = dict(x_obs=X_OBS, max_iters=8, tol=1e-6)
    _same(T_nlp.solve_parking_native(pt, 12, 0.08, X0_PARK, **obs),
          J_nlp.solve_parking_native(pj, 12, 0.08, X0_PARK, **obs))
    loop = dict(Q=Q_SOL, qn_scale=QN_SCALE_SOL, plant_substeps=4)
    got = T_nlp.closed_loop_parking_native(pt, 10, 0.05, X0_PARK, 3, **loop)
    _same(got, J_nlp.closed_loop_parking_native(pj, 10, 0.05, X0_PARK, 3, **loop))
    assert got[2].all()


def test_parking_nlp_within_1e8():
    """The no-obstacle variant at N=10 (``tests/test_native_nlp.py``'s):
    SLSQP from the same start on the same float64 functions."""
    N, ts = 10, 0.05
    ocp_j = jax_parking_ocp(mpc.VehicleParameters(), N, ts, x_obs=None, Q=Q_SOL,
                            qn_scale=QN_SCALE_SOL, dtype=jnp.float64)
    ocp_t = make_parking_ocp(port.VehicleParameters(), N, ts, x_obs=None, Q=Q_SOL,
                             qn_scale=QN_SCALE_SOL, dtype=torch.float64, device="cpu")
    u_j, info_j = jax_parking_nlp(ocp_j, X0_PARK)
    u_t, info_t = O.solve_parking_nlp(ocp_t, torch.as_tensor(X0_PARK))
    assert isinstance(u_t, np.ndarray) and u_t.dtype == np.float64
    assert np.abs(u_t - u_j).max() < 1e-8
    assert abs(info_t["cost"] - info_j["cost"]) < 1e-10
    assert info_t["viol"] < 1e-7


def test_oracle_certifies_port_admm_on_session2_family():
    """``tests/test_native_qp.py``'s check of the JAX ADMM, held on the
    port's float64 twin: x within 2e-5 of the native solution, KKT residual
    below 1e-3."""
    problem = port.session2_problem(N=10)
    ctrl = port.make_linear_mpc(problem, solver="admm", iters=2000, dtype=torch.float64,
                                device="cpu")
    qp = ctrl.qp
    for x0 in ([-100.0, 20.0], [-60.0, 5.0], [-10.0, -3.0]):
        x0 = torch.tensor(x0, dtype=torch.float64)
        q, l, u = (v[0] for v in qp.qp_vectors(x0[None]))
        _, sol = ctrl.solve(x0)
        x_native, _, conv = O.solve_qp_native(qp.P, q, qp.A_c, l, u)
        assert conv
        np.testing.assert_allclose(sol.x.numpy(), x_native, atol=2e-5)
        assert O.kkt_residual_native(qp.P, q, qp.A_c, l, u, sol.x, sol.y) < 1e-3


def test_tensor_inputs_are_numpy_inputs():
    """Tensors (float32 or float64) are taken in float64 on the CPU: the
    same results as the numpy arrays they hold."""
    rng = np.random.default_rng(4)
    P, q, A, l, u = _random_box_qp(rng)
    t64 = lambda a: torch.as_tensor(a)
    _same(O.solve_qp_native(*map(t64, (P, q, A, l, u))), O.solve_qp_native(P, q, A, l, u))
    _same(O.solve_qp_np(*map(t64, (P, q, A, l, u))), O.solve_qp_np(P, q, A, l, u))
    Af, Bf, Qf, Rf = (a.astype(np.float32) for a in _system(0))
    _same(O.dare_np(*map(torch.as_tensor, (Af, Bf, Qf, Rf))), O.dare_np(Af, Bf, Qf, Rf))
    _same(O.prediction_matrices_np(torch.as_tensor(Af), torch.as_tensor(Bf), 5),
          O.prediction_matrices_np(Af, Bf, 5))


def test_concurrent_builds_load_one_whole_library(tmp_path, monkeypatch):
    """Two builds racing on one library (as test workers may) each write a
    file of their own and rename it into place: both return the same path,
    and it loads."""
    monkeypatch.setattr(NB, "NATIVE_BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(NB.build_native_lib("libqp_oracle.so", ("qp_oracle.cpp",)))
        except Exception as exc:  # reported by the assertion below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1 and pathlib.Path(paths[0]).parent == tmp_path
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]
    lib = NB.load_native_lib("libqp_oracle.so", ("qp_oracle.cpp",))
    assert lib.qp_kkt_residual is not None
