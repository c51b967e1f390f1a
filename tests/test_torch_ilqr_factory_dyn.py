"""The fused tracker kernel's plain twin (the port, on the CPU) against the
JAX package's Pacejka instantiation (``al_ilqr_dyn_solve_pallas``, the
factory kernel in interpret mode), at the same tile: the dynamic racing
tier's OCP (6-state Pacejka single-track, RK4 prediction, input box,
tracking). One configuration only, N=6 with one substep at the sweep's 3 × 8
budget: its interpret-mode compile alone takes ~35 s on the CPU.

Inputs are made with numpy from a fixed seed (one lane with a 0.6 m/s
speed deficit, so that the drive bound binds). Gates: converged masks and
executed inner iterations equal; controls within 5e-3, the JAX package's
own gate between two float32 implementations of a tracking OCP
(``tests/test_racing_sweep.py:81``); states within 5e-3 on (p_x, p_y, ψ,
v_x) and 5e-2 on the fast states (v_y, ω), which the stiff lateral
dynamics move by about ten times the steering difference (the JAX package
gives them 1e-1, ``tests/test_pallas_ilqr_dyn.py:207-215``). The float32
solve is chaotic at the 1e-4 level: moving x0 by one ulp moves the twin's
own controls by up to 8.7e-4 (8 lanes), as much as the twin differs from
the JAX kernel (7.8e-4), which also runs ``matan`` where the port runs
``atan`` (≤ 1.3e-7 apart).
"""

import jax.numpy as jnp
import numpy as np
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.experiments.racing import (
    Q_DYNAMIC,
    QN_SCALE,
    R_DYNAMIC,
    ellipse_reference as jax_ellipse,
)
from model_predictive_control_tpu.ops.pallas.ilqr_dyn_kernel import (
    al_ilqr_dyn_solve_pallas,
    model_tuple as jax_model_tuple,
)

from model_predictive_control_tpu_torch.convert import vehicle_parameters_from_jax
from model_predictive_control_tpu_torch.ops.cuda import ilqr_dyn_kernel as D

B, N, TS, SUB, OUTER, INNER, TILE = 8, 6, 0.05, 1, 3, 8, 8
TOL_U = 5e-3
TOL_X = np.array([5e-3, 5e-3, 5e-3, 5e-3, 5e-2, 5e-2])


def test_twin_matches_pallas_pacejka_tracker():
    rng = np.random.default_rng(1)
    ref = np.asarray(jax_ellipse(N + 30, speed=1.2, ts=TS, dynamic=True, dtype=jnp.float32))
    refs = np.stack([ref[o : o + N + 1] for o in rng.integers(0, 25, B)]).astype(np.float32)
    x0 = refs[:, 0] + rng.uniform(-1, 1, (B, 6)) * np.array([0.05, 0.05, 0.1, 0.05, 0.01, 0.05])
    x0[0, 3] -= 0.6
    x0 = x0.astype(np.float32)
    u0 = np.zeros((B, N, 2), np.float32)
    params = mpc.VehicleParameters()
    kw = dict(
        N=N, ts=TS, substeps=SUB,
        limits=((-1.0, -0.384), (1.0, 0.384)),
        weights=(tuple(Q_DYNAMIC), tuple(R_DYNAMIC), float(QN_SCALE)),
        outer_iters=OUTER, inner_iters=INNER, viol_tol=1e-4, tile=TILE,
    )
    want = al_ilqr_dyn_solve_pallas(
        jnp.asarray(x0), jnp.asarray(u0), jnp.asarray(refs), model=jax_model_tuple(params), **kw
    )
    model = D.model_tuple(vehicle_parameters_from_jax(params, device="cpu"))
    assert model == jax_model_tuple(params)
    got = D.al_ilqr_dyn_solve_cuda(
        torch.as_tensor(x0), torch.as_tensor(u0), torch.as_tensor(refs), model=model, **kw
    )
    assert got.us.shape == (B, N, 2) and got.xs.shape == (B, N + 1, 6)
    assert got.lam.shape == (B, N, 4)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_array_equal(
        got.inner_iters_executed.numpy(), np.asarray(want.inner_iters_executed)
    )
    du = np.abs(got.us.numpy() - np.asarray(want.us)).max()
    dx = np.abs(got.xs.numpy() - np.asarray(want.xs)).max(axis=(0, 1))
    print(f"max|us - us_jax| {du:.3e} (tol {TOL_U}); max|xs - xs_jax| per state {dx} (tol {TOL_X})")
    assert du <= TOL_U
    assert np.all(dx <= TOL_X)
    # the speed-deficit lane saturates the drive within the AL tolerance
    assert got.us[0, :, 0].max().item() > 1.0 - 1e-2
    assert got.us[0, :, 0].max().item() <= 1.0 + 1e-3
