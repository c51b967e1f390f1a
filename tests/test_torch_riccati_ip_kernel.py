"""The stagewise-IP kernel's plain twin, through the real wrapper, against the
JAX package's Pallas kernel in interpret mode (as
``tests/test_pallas_riccati_ip.py`` runs it on the CPU), and the long-horizon
closed loop as a whole.

On CPU tensors ``stagewise_ip_solve_cuda`` runs the twin: the same tile
algorithm as the CUDA kernel, which is held to it bit for bit on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``) and here through a host
build of its source (``tests/test_torch_riccati_ip_host.py``). Both sides use
tile 128, so that the tile-wide exit couples the same lanes.

Tolerances. After one iteration the two differ by float32 rounding only
(the JAX kernel skips zero matrix entries at trace time and blends Q and Pf
by a traced weight, the port multiplies through and branches on the stage):
1e-5 on the controls (span ±20) and 2e-5 on the states (one float32 ulp at
|x| ≤ 256 is 1.5e-5). At the path's budgets the interior-point iterate
amplifies that to ~1e-4: 5e-4 on ``us``/``xs`` over the lanes the reference
solved, with equal success masks, is the JAX package's own bar between its
kernel and its XLA path (``tests/test_pallas_riccati_ip.py:69-96``), and 2e-3
on closed-loop states (``:171-194``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.control.batch_loop import simulate_batch as jax_simulate
from model_predictive_control_tpu.experimental.riccati_ip_kernel import (
    stagewise_ip_solve_pallas,
)
from model_predictive_control_tpu.solvers.riccati_ip import make_stagewise_mpc as jax_make
import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.convert import stagewise_mpc_from_jax
from model_predictive_control_tpu_torch.ops.cuda import riccati_ip_kernel as K
from model_predictive_control_tpu_torch.solvers.riccati_ip import stagewise_ip_solve

from test_torch_riccati_ip import NAMES, session2, states, synthetic

TILE = 128


def both(data, x0, u_init=None, **kw):
    x0 = np.asarray(x0, np.float32)
    ref = stagewise_ip_solve_pallas(
        *(jnp.asarray(data[k], jnp.float32) for k in NAMES), jnp.asarray(x0),
        None if u_init is None else jnp.asarray(u_init, jnp.float32), tile=TILE, **kw,
    )
    before = K.LAUNCHES
    got = K.stagewise_ip_solve_cuda(
        *(data[k] for k in NAMES), torch.as_tensor(x0),
        None if u_init is None else torch.as_tensor(np.asarray(u_init, np.float32)),
        tile=TILE, **kw,
    )
    assert K.LAUNCHES == before  # CPU tensors take the twin: no launch
    return ref, got


def check(ref, got, atol_u, atol_x=None, good=None):
    ok = np.asarray(ref.success)
    np.testing.assert_array_equal(got.success.numpy(), ok)
    good = ok if good is None else good
    for name, atol in (("us", atol_u), ("xs", atol_x or atol_u)):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert g.shape == r.shape
        np.testing.assert_allclose(g[good], r[good], rtol=0, atol=atol, err_msg=name)
    np.testing.assert_allclose(got.mu.numpy()[good], np.asarray(ref.mu)[good], atol=1e-6)


def test_one_iteration_matches_pallas():
    ref, got = both(session2(), states(6), N=8, iters=1)
    check(ref, got, 1e-5, 2e-5, good=slice(None))
    assert (got.iters_executed == 1).all()


@pytest.mark.parametrize("N, iters, infeasible", [(8, 15, False), (40, 20, True)])
def test_twin_matches_pallas_session2(N, iters, infeasible):
    ref, got = both(session2(), states(6, infeasible=infeasible), N=N, iters=iters)
    check(ref, got, 5e-4)
    assert bool(got.success[:-1].all()) and bool(got.success[-1]) != infeasible
    good = got.success.numpy()
    assert np.isfinite(got.us.numpy()[good]).all()
    # the tile exits early: every lane done before the budget is spent
    assert 1 < got.iters_executed[0] < iters and (got.iters_executed == got.iters_executed[0]).all()


def test_warm_start_matches_pallas():
    data, x0 = session2(), states(4)
    cold, _ = both(data, x0, N=10, iters=18)
    warm = np.asarray(cold.us) * 0.9 + 0.05
    ref, got = both(data, x0, u_init=warm, N=10, iters=18)
    check(ref, got, 5e-4)


def test_terminal_weight_differs_from_stage_weight():
    """Pf ≠ Q: the JAX kernel blends the two by a traced 0/1 weight
    (``cq + (cp − cq)·tb``), the port branches on the stage."""
    data = session2()
    data["Pf"] = np.array([[35.0, 4.0], [4.0, 6.0]])
    ref, got = both(data, states(5, seed=2), N=8, iters=15)
    assert bool(got.success.all())
    check(ref, got, 5e-4)


def test_nu2_dense_cost_and_inf_bounds():
    x0 = np.array([[3.0, -1.5, 1.0], [-3.5, 1.9, -2.0], [0.2, 0.1, 0.0]])
    ref, got = both(synthetic(), x0, N=12, iters=18)
    assert bool(got.success.all())
    check(ref, got, 2e-4)  # tests/test_pallas_riccati_ip.py:168


def test_padding_and_two_tile_sizes_agree():
    """A batch that is no tile multiple (padded lanes) at two tile sizes:
    the solutions agree; only the executed iterations depend on the tile."""
    data = session2()
    x0 = torch.as_tensor(states(5).astype(np.float32))
    a = K.stagewise_ip_solve_cuda(*(data[k] for k in NAMES), x0, N=8, iters=12, tile=32)
    b = K.stagewise_ip_solve_cuda(*(data[k] for k in NAMES), x0, N=8, iters=12, tile=3)
    assert a.us.shape == (5, 8, 1) and a.xs.shape == (5, 9, 2)
    assert torch.equal(a.success, b.success)
    torch.testing.assert_close(a.us, b.us, rtol=0, atol=1e-5)
    twin = K.stagewise_ip_solve_twin(*(data[k] for k in NAMES), x0, N=8, iters=12, tile=32)
    assert torch.equal(twin.us, a.us) and torch.equal(twin.iters_executed, a.iters_executed)


def test_twin_matches_the_torch_backend_at_the_long_horizon():
    """N=100, the horizon the path runs, against the port's own batched
    solver (no kernel semantics: per-lane freeze, fixed count)."""
    data = session2()
    x0 = torch.as_tensor(states(8, seed=5).astype(np.float32))
    got = K.stagewise_ip_solve_cuda(*(data[k] for k in NAMES), x0, N=100, iters=20, tile=32)
    ref = stagewise_ip_solve(*(data[k] for k in NAMES), x0, N=100, iters=20)
    assert bool(ref.success.all()) and torch.equal(got.success, ref.success)
    torch.testing.assert_close(got.us, ref.us, rtol=0, atol=5e-4)
    torch.testing.assert_close(got.xs, ref.xs, rtol=0, atol=5e-4)


def test_closed_loop_matches_pallas_policy():
    """simulate_batch over 6 steps, ``backend="twin"`` against the JAX
    ``backend="pallas"`` policy on the same starts; the controller crosses
    over through ``convert.stagewise_mpc_from_jax``."""
    problem = mpc.session2_problem(N=8)
    ctrl_j = jax_make(problem, iters=12, dtype=jnp.float32)
    ctrl_t = stagewise_mpc_from_jax(ctrl_j, device="cpu")
    x0 = states(4).astype(np.float32)
    ref = jax_simulate(
        jnp.asarray(x0), problem.system(jnp.float32), 6,
        ctrl_j.batched_policy(backend="pallas", tile=TILE), ctrl_j.initial_batch_carry(4),
    )
    system = port.session2_problem(N=8).system(device="cpu")
    carry = ctrl_t.initial_batch_carry(4, device="cpu")
    runs = {
        b: port.simulate_batch(
            torch.as_tensor(x0), system, 6, ctrl_t.batched_policy(backend=b, tile=TILE), carry,
            batched_dynamics=True
        )
        for b in ("twin", "cuda", "torch")
    }
    got = runs["twin"]
    assert set(got.logs) == set(ref.logs)
    assert bool(got.logs["solver_success"].all()) and bool(np.asarray(ref.logs["solver_success"]).all())
    np.testing.assert_allclose(got.states.numpy(), np.asarray(ref.states), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), rtol=0, atol=2e-3)
    assert got.final_carry.shape == (4, 8, 1)
    # on CPU tensors the kernel backend is the twin; the batched torch solver agrees
    assert torch.equal(runs["cuda"].states, got.states)
    torch.testing.assert_close(runs["torch"].states, got.states, rtol=0, atol=2e-3)


def test_what_the_kernel_does_not_take_raises():
    data = session2()
    x0 = torch.zeros(2, 2)
    staged = dict(data, x_ub=np.tile(data["x_ub"], (4, 1)))
    with pytest.raises(NotImplementedError, match="time-invariant bounds"):
        K.stagewise_ip_solve_cuda(*(staged[k] for k in NAMES), x0, N=4)
    wide = dict(data, B=np.ones((2, 3)), R=np.eye(3), u_lb=-np.ones(3), u_ub=np.ones(3))
    with pytest.raises(NotImplementedError, match="nu <= 2"):
        K.stagewise_ip_solve_cuda(*(wide[k] for k in NAMES), x0, N=4)
    with pytest.raises(ValueError, match="tile must be positive"):
        K.stagewise_ip_solve_cuda(*(data[k] for k in NAMES), x0, N=4, tile=0)
    ctrl = port.make_stagewise_mpc(port.session2_problem(N=4), device="cpu")
    staged_ctrl = dataclasses.replace(ctrl, x_ub=ctrl.x_ub.expand(4, 2))
    for backend in ("cuda", "twin"):
        with pytest.raises(NotImplementedError, match="backend='torch'"):
            staged_ctrl.batched_policy(backend=backend)
    staged_ctrl.batched_policy(backend="torch")  # the batched solver takes them


def test_constants_match_the_kernel_source():
    """The wrapper's constant block is the struct of the CUDA source, field
    for field, and its working-set reckoning the kernel's."""
    data = session2()
    kp = K.prepare_problem(*(data[k] for k in NAMES), device="cpu")
    x0, u0 = K.prepare_tiles(kp, torch.zeros(5, 2), None, N=6, tile=4)
    assert x0.shape == (2, 8) and u0.shape == (6, 1, 8) and x0.is_contiguous()
    np.testing.assert_allclose(kp.w_x.numpy(), [75.5, 22.5])
    floats, flags = K._consts(kp.problem, 6, 0.995)
    nx, nu = 2, 1
    assert len(floats) == 3 * nx * nx + nx * nu + nu * nu + 2 * (nx + nu) + 4
    assert flags == [1] * (2 * (nx + nu))
    assert floats[-4] == 1.0 / (6 * 6) and floats[-3:] == [0.995, K.EPS50, 1e4]
    src = K._SOURCES[0].read_text()
    for field in ("float A[NX][NX], B[NX][NU], Q[NX][NX], R[NU][NU], Pf[NX][NX];",
                  "float xlb[NX], xub[NX], ulb[NU], uub[NU];",
                  "float inv_count, tau, eps50, rho;", "int xl[NX], xu[NX], ul[NU], uu[NU];",
                  "enum { R_RED, R_GAIN, R_SCR, R_DIR, R_ZX, R_ZU, R_SD, N_REGIONS };"):
        assert field in src
    # 33 floats per stage (the gains, the scratch store, the two directions,
    # the state, the slacks and duals) and one per member of a lane's group
    assert sum(n for _, n, _ in K.regions(100, 2, 1, 8)) == 33 * 100 + 8
