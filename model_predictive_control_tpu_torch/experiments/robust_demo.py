"""Robustness demo: nominal against tube, stochastic and offset-free MPC
(port of ``experiments/robust_demo.py``).

The robustness layers side by side on the session-2 braking-wall scenario,
each against the disturbance class it is designed for:

1. bounded disturbances (uniform in a box): nominal MPC violates the wall,
   rigid-tube MPC does not;
2. Gaussian noise on the v_max-riding cruise: nominal violates about half of
   the near-limit steps, chance-constrained MPC caps the rate at ε;
3. a constant actuator bias: nominal MPC settles with an offset, offset-free
   MPC estimates the bias and tracks exactly;
4. nonlinear: parking on a slope with ``friction × 0.8``, nominal NMPC
   against the disturbance-augmented-EKF offset-free NMPC.

The realizations of sections 1 and 2 are a batch of scenarios: each
controller's batched per-scenario route (the JAX package's vmapped
single-scenario solve, ``batched_policy(backend="xla")``) under
:func:`..control.batch_loop.simulate_batch` with the drawn disturbances.
The draws are numpy's, from ``seed``, as the JAX package draws them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..control.batch_loop import simulate_batch
from ..control.simulate import simulate
from ..solvers.linear_mpc import make_linear_mpc, session2_problem
from ..solvers.offset_free import make_offset_free_mpc
from ..solvers.stochastic import make_stochastic_mpc
from ..solvers.tube import make_tube_mpc
from ..utils.device import resolve_device

W_HALF = np.array([0.0, 0.45])
SIGMA_V = 0.12
EPS = 0.1
BIAS = 1.5
R_POS = -5.0
SLOPE_ACCEL = 0.35  # m/s² downhill component on the v̇ row (section 4)


def _batch_runs(policy, carry, x0, sys, steps, ws):
    """``ws`` ``(batch, steps, nx)`` realizations from one start ``x0``:
    ``(states (batch, steps+1, nx), logs (batch, steps, ...))``."""
    B = ws.shape[0]
    res = simulate_batch(x0.expand(B, -1).contiguous(), sys, steps, policy, carry,
                         batched_dynamics=True, disturbances=ws.transpose(0, 1))
    return res.states.transpose(0, 1), {k: v.transpose(0, 1) for k, v in res.logs.items()}


def nonlinear_offset_free_demo(steps: int = 320, N: int = 12, ts: float = 0.05,
                               slope: float = SLOPE_ACCEL, friction_scale: float = 0.8,
                               dtype=torch.float32, device=None) -> dict:
    """Slope parking: the nominal :class:`..solvers.parking.ILQRMPC` against
    :class:`..solvers.offset_free_nmpc.OffsetFreeNMPC`, both predicting with
    the nominal Euler bicycle against an exact-integration plant with
    ``friction × friction_scale`` and a constant downhill acceleration."""
    from ..models.bicycle import kinematic_bicycle_ode
    from ..models.parameters import VehicleParameters
    from ..ops.integrators import euler, rk4_fine
    from ..solvers.offset_free_nmpc import OffsetFreeNMPC
    from ..solvers.parking import ILQRMPC, Q_SOL, QN_SCALE_SOL, make_parking_ilqr

    device = resolve_device(device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    params = VehicleParameters()
    p_true = dataclasses.replace(params, friction=params.friction * friction_scale)
    drift = t([0.0, 0.0, 0.0, -slope])
    plant = rk4_fine(lambda x, u: kinematic_bicycle_ode(p_true, x, u) + drift, ts, substeps=16)
    x0 = t([0.6, -0.25, 0.0, 0.0])  # session4_sol.py:350
    prob, cons, nc = make_parking_ilqr(params, N=N, ts=ts, x_obs=None, Q=Q_SOL,
                                       qn_scale=QN_SCALE_SOL, dtype=dtype, device=device)
    nominal = ILQRMPC(prob, cons, nc, outer_iters=6, inner_iters=15)
    res_nom = simulate(x0, plant, steps=steps, policy=nominal.policy(),
                       policy_carry=nominal.initial_carry(dtype, device))
    step_fn = euler(lambda x, u: kinematic_bicycle_ode(params, x, u), ts)
    Q = t(Q_SOL)
    of = OffsetFreeNMPC(step_fn, nx=4, nu=2, N=N, Q=Q, R=t([1.0, 0.01]), QN=QN_SCALE_SOL * Q,
                        u_lb=[params.min_drive, -params.max_steer],
                        u_ub=[params.max_drive, params.max_steer], r=[0.0, 0.0], dtype=dtype,
                        device=device)
    res_of = simulate(x0, plant, steps=steps, policy=of.policy(), policy_carry=of.initial_carry(x0))
    return {
        "slope": float(slope),
        "friction_scale": float(friction_scale),
        "nominal_final_dist": float(torch.linalg.vector_norm(res_nom.states[-1, :2])),
        "offset_free_final_dist": float(torch.linalg.vector_norm(res_of.states[-1, :2])),
        "offset_free_success": float(res_of.logs["solver_success"].float().mean()),
        "d_hat_v_row": float(res_of.logs["disturbance_estimate"][-1, 3]),
        "d_true_v_row": float(-slope * ts),
    }


def run(batch: int = 64, steps: int = 50, N: int = 8, iters: int = 300, seed: int = 0,
        dtype=torch.float32, outdir=None, nonlinear: bool = True, nonlinear_steps: int = 320,
        device=None):
    """Run every comparison on ``device`` (the card when ``None``); returns
    ``(results, summary)``."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    problem = session2_problem(N=N)
    sys = problem.system(dtype, device)
    rng = np.random.default_rng(seed)
    results = {}

    # -- 1. bounded disturbances: nominal vs tube -------------------------
    x0_b = t([-60.0, 18.0])
    # adversarially biased uniform noise (the worst direction: toward the wall)
    wb = t(rng.uniform(0.2, 1.0, size=(batch, steps, 2)) * W_HALF)
    nominal = make_linear_mpc(problem, iters=iters, dtype=dtype, device=device, terminal="dare")
    tube = make_tube_mpc(problem, W_HALF, iters=iters, dtype=dtype, device=device)
    nom_carry = lambda: nominal.initial_batch_carry(batch, dtype, device)
    s_nom, _ = _batch_runs(nominal.batched_policy(backend="xla"), nom_carry(), x0_b, sys,
                           steps, wb)
    s_tube, l_tube = _batch_runs(tube.batched_policy(backend="xla"),
                                 tube.initial_batch_carry(x0_b.expand(batch, -1), dtype),
                                 x0_b, sys, steps, wb)
    wall = problem.p_max
    host = lambda a: a.detach().cpu().numpy()
    results["bounded"] = {
        "nominal_violation_frac": float((host(s_nom[:, :, 0]) > wall).any(axis=1).mean()),
        "tube_violation_frac": float((host(s_tube[:, :, 0]) > wall).any(axis=1).mean()),
        "tube_ok_frac": float(host(l_tube["tube_ok"]).mean()),
    }

    # -- 2. Gaussian noise: nominal vs chance-constrained -----------------
    x0_g = t([-100.0, 20.0])
    wg = np.zeros((batch, steps, 2))
    wg[:, :, 1] = SIGMA_V * rng.standard_normal((batch, steps))
    wg = t(wg)
    stoch = make_stochastic_mpc(problem, np.diag([0.0, SIGMA_V**2]), eps=EPS, iters=iters,
                                dtype=dtype, device=device)
    s_ng, _ = _batch_runs(nominal.batched_policy(backend="xla"), nom_carry(), x0_g, sys, steps,
                          wg)
    s_st, _ = _batch_runs(stoch.batched_policy(backend="xla"),
                          stoch.inner.initial_batch_carry(batch, dtype, device), x0_g, sys,
                          steps, wg)

    def _vrate(states):
        v = host(states[:, 1:, 1])
        near = v > problem.v_max - 3.0 * SIGMA_V
        return float((v > problem.v_max).sum() / max(near.sum(), 1))

    results["gaussian"] = {
        "eps": EPS,
        "nominal_violation_rate": _vrate(s_ng),
        "stochastic_violation_rate": _vrate(s_st),
    }

    # -- 3. actuator bias: nominal (x_ref) vs offset-free ------------------
    x0_o = t([-20.0, 0.0])
    biased = lambda x, u: sys.A @ x + sys.B @ (u + BIAS)
    nominal_ref = make_linear_mpc(problem, iters=iters, dtype=dtype, device=device,
                                  terminal="dare", x_ref=t([R_POS, 0.0]))
    offset_free = make_offset_free_mpc(problem, r=R_POS, iters=iters, dtype=dtype, device=device)
    res_nr = simulate(x0_o, biased, steps=80, policy=nominal_ref.policy(),
                      policy_carry=nominal_ref.initial_carry(dtype, device))
    res_of = simulate(x0_o, biased, steps=80, policy=offset_free.policy(),
                      policy_carry=offset_free.initial_carry(x0_o, dtype, device))
    results["bias"] = {
        "bias": BIAS,
        "nominal_offset": float(abs(res_nr.states[-1, 0] - R_POS)),
        "offset_free_offset": float(abs(res_of.states[-1, 0] - R_POS)),
        "disturbance_estimate": float(res_of.logs["disturbance_estimate"][-1, 0]),
    }

    # -- 4. nonlinear: slope parking, nominal NMPC vs offset-free NMPC -----
    if nonlinear:
        results["nonlinear"] = nonlinear_offset_free_demo(steps=nonlinear_steps, dtype=dtype,
                                                          device=device)

    summary = {
        "batch": batch,
        "steps": steps,
        **{f"{k}.{kk}": vv for k, v in results.items() for kk, vv in v.items()},
    }
    if outdir is not None:
        _save_plots(host(s_nom), host(s_tube), host(res_nr.states), host(res_of.states), problem,
                    outdir)
    return results, summary


def _save_plots(s_nom, s_tube, s_nr, s_of, problem, outdir):
    import pathlib

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4), sharey=False)
    for ax, states, title in ((axes[0], s_nom, "nominal MPC"), (axes[1], s_tube, "rigid-tube MPC")):
        ax.plot(states[:, :, 0].T, lw=0.5, alpha=0.4, color="C0")
        ax.axhline(problem.p_max, color="r", ls="--", label="wall p = 1")
        ax.set_title(title)
        ax.set_xlabel("step")
    axes[0].set_ylabel("position [m]")
    axes[0].legend()
    fig.savefig(outdir / "robust_bounded.png", dpi=120)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(s_nr[:, 0], label="nominal (x_ref)")
    ax.plot(s_of[:, 0], label="offset-free")
    ax.axhline(R_POS, color="k", ls=":", label="reference")
    ax.set_xlabel("step")
    ax.set_ylabel("position [m]")
    ax.legend()
    fig.savefig(outdir / "robust_bias.png", dpi=120)
    plt.close(fig)
