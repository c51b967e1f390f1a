"""``wind_sweep`` and ``offset_free_sweep`` (the AL-iLQR kernel's ``refs`` /
``dist`` / ``urefs`` modes) against the JAX package's scalar policy loops,
on the JAX sweeps' own draws (given through ``scenarios=``), 3 scenarios ×
4 steps.

Backends are paired by algorithm and precision: the per-scenario route
(``backend="torch"``) in float64 against JAX's scalar
``DisturbanceCompensatedTracking`` / ``OffsetFreeNMPC`` loops in float64,
inputs and states within 1e-6 (the same algorithm); the kernel route (its
twin on the CPU) in float32 against the scalar loops in float32 within
5e-3, the JAX package's own bar between its kernel sweep and the scalar loop
(``tests/test_wind_sweep.py:95-102``).

The ablation at the JAX test's 50 steps: the nominal tracker's steady error
over 2.5 times the compensated one's, the compensated EKF's wind estimate
within 5e-4 RMS and the ablation's beyond 1e-3 (``tests/test_wind_sweep.py:
110-120``). The offset-free ablation's 150-step gate
(``tests/test_offset_free_sweep.py:30-41``) is held by ``chip_smoke.py`` on
the card at the contract's size: 150 steps of the twin take minutes here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
from model_predictive_control_tpu.experiments.racing import (
    Q_KINEMATIC,
    QN_SCALE,
    R_KINEMATIC,
    ellipse_reference,
)
from model_predictive_control_tpu.models.bicycle import kinematic_bicycle_ode as jode
from model_predictive_control_tpu.ops.integrators import euler, rk4, rk4_fine
from model_predictive_control_tpu.solvers.offset_free_nmpc import (
    DisturbanceCompensatedTracking,
    OffsetFreeNMPC,
)
from model_predictive_control_tpu.solvers.parking import Q_SOL, QN_SCALE_SOL

import model_predictive_control_tpu_torch as port

B, STEPS = 3, 4
PAIRS = {"torch-float64": ("torch", jnp.float64, torch.float64, 1e-6),
         "kernel-float32": ("cuda", jnp.float32, torch.float32, 5e-3)}


def _wind_draws(key, batch, ref0, jdt, wind=0.004, spread=0.5):
    k_w, k_x0 = jax.random.split(key)
    ang = jax.random.uniform(k_w, (batch,), minval=0.0, maxval=2.0 * jnp.pi, dtype=jdt)
    mag = wind * jax.random.uniform(jax.random.fold_in(k_w, 1), (batch,), minval=1.0 - spread,
                                    maxval=1.0 + spread, dtype=jdt)
    w_full = jnp.zeros((batch, 4), jdt).at[:, :2].set(
        jnp.stack([mag * jnp.cos(ang), mag * jnp.sin(ang)], axis=1))
    noise = jax.random.uniform(k_x0, (batch, 4), minval=-1.0, maxval=1.0, dtype=jdt) * jnp.asarray(
        [0.05, 0.05, 0.1, 0.03], jdt)
    x0s = ref0 + noise
    return x0s.at[:, 3].set(jnp.clip(x0s[:, 3], 0.0, 0.5)), w_full


def _scalar_loops(ctrl, plant_of, x0s, *rows):
    """The JAX scalar loop of every scenario, ``STEPS`` steps, compiled once
    for all of them: scenario i's plant is ``plant_of(*(r[i] for r in
    rows))``. Returns ``[(inputs, states), ...]`` as numpy arrays."""

    def loop(x0, *row):
        res = mpc.simulate(x0, plant_of(*row), steps=STEPS, policy=ctrl.policy(),
                           policy_carry=ctrl.initial_carry(x0))
        return res.inputs, res.states

    run = jax.jit(loop)
    return [tuple(map(np.asarray, run(x0s[i], *(r[i] for r in rows)))) for i in range(B)]


@pytest.mark.parametrize("pair", list(PAIRS))
def test_wind_sweep_matches_scalar_policy(pair):
    backend, jdt, tdt, tol = PAIRS[pair]
    N, ts = 15, 0.05
    p = mpc.VehicleParameters()
    ref = ellipse_reference(STEPS + N + 1, speed=0.35, ts=ts, dynamic=False, dtype=jdt)
    x0s, w_full = _wind_draws(jax.random.PRNGKey(4), B, ref[0], jdt)
    res, s = port.wind_sweep(B, STEPS, backend=backend, dtype=tdt, tile=4, device="cpu",
                             scenarios=(torch.tensor(np.asarray(x0s)),
                                        torch.tensor(np.asarray(w_full))))
    assert s["success_rate"] == 1.0 and res.states.dtype == tdt
    step_fn = euler(lambda x, u: jode(p, x, u), ts)
    base = rk4(lambda x, u: jode(p, x, u), ts)
    Q = jnp.asarray(Q_KINEMATIC, jdt)
    ctrl = DisturbanceCompensatedTracking(
        step_fn, nx=4, nu=2, N=N, Q=Q, R=jnp.asarray(R_KINEMATIC, jdt), QN=QN_SCALE * Q,
        u_lb=jnp.asarray([p.min_drive, -p.max_steer], jdt),
        u_ub=jnp.asarray([p.max_drive, p.max_steer], jdt), ref_traj=ref, ts=ts, dtype=jdt,
        outer_iters=3, inner_iters=8)
    loops = _scalar_loops(ctrl, lambda w: lambda x, u: base(x, u) + w, x0s, w_full)
    for i, (u, x) in enumerate(loops):
        np.testing.assert_allclose(res.inputs[:, i].numpy(), u, atol=tol)
        np.testing.assert_allclose(res.states[:, i].numpy(), x, atol=tol)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_offset_free_sweep_matches_scalar_policy(pair):
    backend, jdt, tdt, tol = PAIRS[pair]
    N, ts = 12, 0.05
    p = mpc.VehicleParameters()
    k_s, k_f, k_x0 = jax.random.split(jax.random.PRNGKey(2), 3)
    slope = jax.random.uniform(k_s, (B,), minval=0.15, maxval=0.45, dtype=jdt)
    fscale = jax.random.uniform(k_f, (B,), minval=0.7, maxval=0.9, dtype=jdt)
    x0s = jnp.asarray([0.6, -0.25, 0.0, 0.0], jdt) + jax.random.uniform(
        k_x0, (B, 4), minval=-1.0, maxval=1.0, dtype=jdt) * jnp.asarray([0.1, 0.1, 0.2, 0.03], jdt)
    res, s = port.offset_free_sweep(
        B, STEPS, backend=backend, dtype=tdt, tile=4, device="cpu",
        scenarios=tuple(torch.tensor(np.asarray(a)) for a in (x0s, slope, fscale)))
    assert res.states.dtype == tdt and set(s) >= {"median_final_dist", "d_hat_rms_error"}
    Q = jnp.asarray(Q_SOL, jdt)
    ctrl = OffsetFreeNMPC(euler(lambda x, u: jode(p, x, u), ts), nx=4, nu=2, N=N, Q=Q,
                          R=jnp.asarray([1.0, 0.01], jdt), QN=QN_SCALE_SOL * Q,
                          u_lb=[p.min_drive, -p.max_steer], u_ub=[p.max_drive, p.max_steer],
                          r=[0.0, 0.0], dtype=jdt, outer_iters=5, inner_iters=10)
    def plant_of(fs, sl):
        pt = dataclasses.replace(p, friction=p.friction * fs)
        drift = jnp.zeros(4, jdt).at[3].set(-sl)
        return rk4_fine(lambda x, u: jode(pt, x, u) + drift, ts, substeps=16)

    for i, (u, x) in enumerate(_scalar_loops(ctrl, plant_of, x0s, fscale, slope)):
        np.testing.assert_allclose(res.inputs[:, i].numpy(), u, atol=tol)
        np.testing.assert_allclose(res.states[:, i].numpy(), x, atol=tol)


def test_wind_compensation_removes_offset():
    """The JAX test's ablation gates, 3 scenarios × 50 steps on the kernel
    route (its twin here), the port's own draws."""
    _, s_c = port.wind_sweep(3, 50, tile=4, device="cpu")
    _, s_n = port.wind_sweep(3, 50, tile=4, compensate=False, device="cpu")
    assert s_c["success_rate"] > 0.99
    assert s_n["steady_tracking_error"] > 2.5 * s_c["steady_tracking_error"], (s_n, s_c)
    assert s_c["wind_estimate_rms_error"] < 5e-4
    assert s_n["wind_estimate_rms_error"] > 1e-3


@pytest.mark.parametrize("sweep", ["wind_sweep", "offset_free_sweep"])
def test_sweeps_run_on_the_card_or_raise(monkeypatch, sweep):
    """The entry points default to the card: without one they raise. The
    kernel backends refuse float64, naming the per-scenario route."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(port, sweep)(2, 1)
    with pytest.raises(ValueError, match="backend='torch'"):
        getattr(port, sweep)(2, 1, backend="xla", device="cpu")
    for backend in ("cuda", "twin"):
        with pytest.raises(ValueError, match="float32 only.*backend='torch'"):
            getattr(port, sweep)(2, 1, backend=backend, dtype=torch.float64, device="cpu")
