"""Session-4 experiments: nonlinear parking MPC for the kinematic bicycle
(port of ``experiments/session4.py``).

The reference exercise drivers (``session4_sol.py:326-496``,
``session_4/main.py:241-297``) with their scenario constants:

- :func:`integrator_accuracy` ≙ exercise 1 / ``compare_open_loop``
  (``session4_sol.py:65-104``): Euler/RK4 rollouts under the test policy
  ``u = (1, 0.1·sin t)`` (``template.py:66-70``) vs a fine-substep RK4 ground
  truth standing in for ``scipy.odeint`` (``main.py:164-170``).
- :func:`open_loop_parking` ≙ exercise 3 (``session4_sol.py:340-386``): solve the
  OCP once (N=50, ts=0.05, no obstacle), replay the plan under an accurate plant.
- :func:`mismatch_open_loop` ≙ exercise 4 (``session4_sol.py:389-440``): replay
  the same plan on a plant with ``friction × 0.8`` (``session4_sol.py:410-411``).
- :func:`closed_loop_parking` ≙ exercise 5 and ``main()``: receding-horizon SQP
  re-solving each step — the "sol" variant (no obstacle, mismatched plant) and
  the "main" variant (obstacle at [0.25, 0, 0, 0], N=30, ts=0.08, 100 steps,
  exact plant integration; ``main.py:242-271``).

:func:`relative_error` fixes the reference's formula (``session4_sol.py:313-318``
*multiplies* by the norm sum instead of dividing — a bug faithfully copied into
``template.py:233-238``); we implement the intended relative error.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..control.simulate import open_loop_policy, policy_from_law, rollout, simulate
from ..models.bicycle import kinematic_bicycle_ode
from ..models.parameters import VehicleParameters
from ..ops.integrators import euler, heun, rk4, rk4_fine
from ..solvers.parking import (
    NonlinearMPC,
    Q_MAIN,
    Q_SOL,
    QN_SCALE_MAIN,
    QN_SCALE_SOL,
    R_MAIN,
    make_parking_ocp,
)
from ..utils.device import resolve_device

# main.py:242-248
MAIN_X0 = (0.3, -0.1, 0.0, 0.0)
MAIN_X_OBS = (0.25, 0.0, 0.0, 0.0)
MAIN_N = 30
MAIN_TS = 0.08
MAIN_STEPS = 100
# session4_sol.py:344,393,447: exercises 3/4/5 all start from [0.6, -0.25, 0, 0]
SOL_X0 = (0.6, -0.25, 0.0, 0.0)
# session4_sol.py:445-449
SOL_N = 50
SOL_TS = 0.05
SOL_STEPS = 100
MISMATCH_FRICTION = 0.8  # session4_sol.py:410-411

EXACT_SUBSTEPS = 64  # fine-RK4 "odeint" tier (SURVEY §2 native-equivalents table)


def test_policy(ts: float):
    """``u = (1, 0.1·sin t)`` with t the physical time (``template.py:66-70``),
    in the state's dtype and on its device."""
    return policy_from_law(
        lambda x, t: torch.stack([torch.ones((), dtype=x.dtype, device=x.device),
                                  0.1 * torch.sin(torch.tensor(t * ts, dtype=x.dtype,
                                                               device=x.device))])
    )


def relative_error(a, b) -> np.ndarray:
    """Per-step relative ∞-norm error ``‖a−b‖∞ / (‖a‖∞ + ‖b‖∞)``.

    The intended semantics of ``rel_error`` (``session4_sol.py:313-318``), with the
    division the reference accidentally wrote as a multiplication.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    num = np.max(np.abs(a - b), axis=-1)
    den = np.max(np.abs(a), axis=-1) + np.max(np.abs(b), axis=-1)
    return num / np.maximum(den, 1e-300)


def integrator_accuracy(
    ts_values=(0.05, 0.1, 0.5),
    steps: int = 100,
    params: VehicleParameters | None = None,
    x0=(0.0, 0.0, 0.0, 0.0),
    dtype=torch.float32,
    device=None,
):
    """Accuracy sweep: per-step ∞-norm error of each integrator vs the fine-RK4
    ground truth, per sampling time. Returns ``{ts: {method: (steps,) err}}``."""
    params = params or VehicleParameters()
    ode = lambda x, u: kinematic_bicycle_ode(params, x, u)
    x0 = torch.as_tensor(x0, dtype=dtype, device=resolve_device(device))

    out = {}
    for ts in ts_values:
        policy = test_policy(ts)
        run = lambda step_fn: simulate(x0, step_fn, steps=steps, policy=policy).states
        truth = run(rk4_fine(ode, ts, substeps=EXACT_SUBSTEPS)).cpu().numpy()
        errs = {}
        for name, make in (("euler", euler), ("heun", heun), ("rk4", rk4)):
            xs = run(make(ode, ts)).cpu().numpy()
            errs[name] = np.max(np.abs(xs - truth), axis=-1)[1:]
        out[float(ts)] = errs
    return out


def _plant(params: VehicleParameters, ts: float, kind: str):
    """Plant tiers: "euler" = the prediction model itself, "exact" = fine RK4
    (the ``odeint`` stand-in, ``main.py:164-170``)."""
    ode = lambda x, u: kinematic_bicycle_ode(params, x, u)
    if kind == "euler":
        return euler(ode, ts)
    if kind == "exact":
        return rk4_fine(ode, ts, substeps=EXACT_SUBSTEPS)
    raise ValueError(f"unknown plant kind {kind!r}")


def _controller(params, N, ts, x_obs, weights, sqp_iters, qp_iters, solver, dtype, device):
    """The parking controller of a scenario: the SQP (``"sqp"``) or the
    AL-iLQR (``"ilqr"``) on the nominal model."""
    Q, qn = (Q_MAIN, QN_SCALE_MAIN) if weights == "main" else (Q_SOL, QN_SCALE_SOL)
    obs = None if x_obs is None else torch.as_tensor(x_obs, dtype=dtype, device=device)
    if solver == "ilqr":
        from ..solvers.parking import ILQRMPC, make_parking_ilqr

        prob, cons, nc = make_parking_ilqr(params, N=N, ts=ts, x_obs=obs, Q=Q, R=R_MAIN,
                                           qn_scale=qn, dtype=dtype, device=device)
        return ILQRMPC(prob, cons, nc, outer_iters=8, inner_iters=25)
    if solver == "sqp":
        ocp = make_parking_ocp(params, N=N, ts=ts, x_obs=obs, Q=Q, R=R_MAIN, qn_scale=qn,
                               dtype=dtype, device=device)
        return NonlinearMPC(ocp, sqp_iters=sqp_iters, qp_iters=qp_iters)
    raise ValueError(f"unknown solver {solver!r}")


def _solve_plan(params, N, ts, x0, x_obs=None, weights="sol", sqp_iters=25, qp_iters=40,
                solver="sqp", dtype=torch.float32, device=None):
    device = resolve_device(device)
    mpc = _controller(params, N, ts, x_obs, weights, sqp_iters, qp_iters, solver, dtype, device)
    return mpc, mpc.solve(torch.as_tensor(x0, dtype=dtype, device=device))


def open_loop_parking(
    N: int = SOL_N,
    ts: float = SOL_TS,
    x0=SOL_X0,
    sqp_iters: int = 25,
    dtype=torch.float32,
    device=None,
):
    """Exercise 3: one OCP solve, plan replayed under prediction-model plant and
    the accurate plant. Returns ``(u_plan (N, 2), x_pred, x_exact, rel_err)``."""
    params = VehicleParameters()
    mpc, sol = _solve_plan(params, N, ts, x0, sqp_iters=sqp_iters, dtype=dtype, device=device)
    u_plan = sol.u.reshape(N, 2)
    x0 = torch.as_tensor(x0, dtype=dtype, device=u_plan.device)
    x_pred = rollout(x0, _plant(params, ts, "euler"), u_plan)
    x_exact = rollout(x0, _plant(params, ts, "exact"), u_plan)
    return u_plan, x_pred, x_exact, relative_error(x_exact.cpu(), x_pred.cpu())


def mismatch_open_loop(
    N: int = SOL_N,
    ts: float = SOL_TS,
    x0=SOL_X0,
    friction_scale: float = MISMATCH_FRICTION,
    sqp_iters: int = 25,
    dtype=torch.float32,
    device=None,
):
    """Exercise 4 (``session4_sol.py:389-440``): the nominal plan replayed under
    the *assumed* model (forward-Euler, nominal params, ``:406-408``) and under
    the true plant — exact integration with ``friction × 0.8`` (``:410-414``).
    Returns ``(u_plan, x_assumed, x_true, rel_err)``."""
    params = VehicleParameters()
    mpc, sol = _solve_plan(params, N, ts, x0, sqp_iters=sqp_iters, dtype=dtype, device=device)
    u_plan = sol.u.reshape(N, 2)
    x0 = torch.as_tensor(x0, dtype=dtype, device=u_plan.device)
    x_assumed = rollout(x0, _plant(params, ts, "euler"), u_plan)
    params_mm = dataclasses.replace(params, friction=params.friction * friction_scale)
    x_true = rollout(x0, _plant(params_mm, ts, "exact"), u_plan)
    return u_plan, x_assumed, x_true, relative_error(x_assumed.cpu(), x_true.cpu())


def closed_loop_parking(
    variant: str = "main",
    steps: int | None = None,
    mismatch: bool = False,
    sqp_iters: int = 15,
    qp_iters: int = 40,
    solver: str = "sqp",
    plant: str = "exact",
    x0=None,
    dtype=torch.float32,
    device=None,
):
    """Receding-horizon closed loop (exercise 5 / ``main()``) on ``device``
    (the card when ``None``).

    ``variant="main"``: obstacle scenario, N=30, ts=0.08, x0=[0.3,-0.1,0,0],
    exact plant (``main.py:241-271``). ``variant="sol"``: no obstacle, N=50,
    ts=0.05, x0=[0.6,-0.25,0,0] (``session4_sol.py:443-465``); ``mismatch=True``
    scales the plant friction by 0.8 while the controller keeps the nominal
    model. ``plant`` selects the plant integration tier: ``"exact"`` (fine RK4,
    the ``odeint`` stand-in) or ``"euler"`` (the prediction model itself).
    ``solver`` selects the per-step optimizer: ``"sqp"`` (condensed-QP SQP) or
    ``"ilqr"`` (AL-iLQR).

    Returns ``(SimResult, controller, params)``.
    """
    device = resolve_device(device)
    params = VehicleParameters()
    if variant == "main":
        N, ts, x_obs, weights = MAIN_N, MAIN_TS, MAIN_X_OBS, "main"
        steps = MAIN_STEPS if steps is None else steps
        x0 = MAIN_X0 if x0 is None else x0
    elif variant == "sol":
        N, ts, x_obs, weights = SOL_N, SOL_TS, None, "sol"
        steps = SOL_STEPS if steps is None else steps
        x0 = SOL_X0 if x0 is None else x0
    else:
        raise ValueError(f"unknown variant {variant!r}")
    mpc = _controller(params, N, ts, x_obs, weights, sqp_iters, qp_iters, solver, dtype, device)
    plant_params = (
        dataclasses.replace(params, friction=params.friction * MISMATCH_FRICTION)
        if mismatch
        else params
    )
    res = simulate(torch.as_tensor(x0, dtype=dtype, device=device),
                   _plant(plant_params, ts, plant), steps=steps, policy=mpc.policy(),
                   policy_carry=mpc.initial_carry(dtype, device))
    return res, mpc, params


def two_plant_closed_loop(
    steps: int = SOL_STEPS,
    sqp_iters: int = 15,
    solver: str = "sqp",
    dtype=torch.float32,
    device=None,
):
    """Exercise 5 faithful driver (``session4_sol.py:443-481``): the same MPC
    controller run closed-loop under TWO plants — (a) the assumed model
    (forward-Euler bicycle, nominal parameters, ``:452-458``) and (b) the true
    plant (exact integration with ``friction × 0.8``, ``:460-465``) — plus the
    per-step relative error between the two trajectories (``:477``).

    Returns ``(res_model, res_exact, rel_err, params)``.
    """
    res_model, _, params = closed_loop_parking(
        variant="sol", steps=steps, mismatch=False, plant="euler",
        sqp_iters=sqp_iters, solver=solver, dtype=dtype, device=device,
    )
    res_exact, _, _ = closed_loop_parking(
        variant="sol", steps=steps, mismatch=True, plant="exact",
        sqp_iters=sqp_iters, solver=solver, dtype=dtype, device=device,
    )
    rel = relative_error(res_exact.states.cpu(), res_model.states.cpu())
    return res_model, res_exact, rel, params


def run_open_loop(
    exercise: int = 3,
    N: int = SOL_N,
    ts: float = SOL_TS,
    outdir: str | None = None,
    sqp_iters: int = 25,
    device=None,
) -> dict:
    """Exercise-3/4 driver with the reference's plot artifacts
    (``session4_sol.py:340-440``): input sequence, predicted-vs-real trajectory
    overlay, and the per-step ``rel_error × 100`` curve — the reference's
    de-facto validation artifact (``:382, :428``)."""
    if exercise == 3:
        u_plan, x_a, x_b, rel = open_loop_parking(N=N, ts=ts, sqp_iters=sqp_iters,
                                                  device=device)
        kind = "integration error"
    elif exercise == 4:
        u_plan, x_a, x_b, rel = mismatch_open_loop(N=N, ts=ts, sqp_iters=sqp_iters,
                                                   device=device)
        kind = "parameter error"
    else:
        raise ValueError("exercise must be 3 or 4")
    params = VehicleParameters()
    summary = {
        "exercise": exercise,
        "N": N,
        "ts": ts,
        "x0": list(SOL_X0),
        "rel_err_max_pct": float(np.max(rel) * 100.0),
        "final_dist_predicted": float(np.linalg.norm(x_a.cpu().numpy()[-1, :2])),
        "final_dist_real": float(np.linalg.norm(x_b.cpu().numpy()[-1, :2])),
    }
    if outdir is not None:
        import os

        from ..viz import (
            plot_input_sequence,
            plot_relative_error,
            plot_state_trajectory,
        )

        os.makedirs(outdir, exist_ok=True)
        tag = f"session4_ex{exercise}"
        plot_input_sequence(
            u_plan.cpu().numpy(), params, ts=ts,
            save=os.path.join(outdir, f"{tag}_inputs.png"),
        )
        fig = plot_state_trajectory(x_a.cpu().numpy(), params, color="#0072B2",
                                    label="Predicted")
        plot_state_trajectory(
            x_b.cpu().numpy(), params, ax=fig.axes[0], color="#D55E00", label="Real",
            save=os.path.join(outdir, f"{tag}_traj.png"),
        )
        plot_relative_error(
            rel, title=f"Relative prediction error ({kind}) [%]",
            save=os.path.join(outdir, f"{tag}_rel_error.png"),
        )
    return summary


def run(
    variant: str = "main",
    steps: int | None = None,
    outdir: str | None = None,
    animate: bool = False,
    sqp_iters: int = 15,
    solver: str = "sqp",
    device=None,
) -> dict:
    """Driver: closed-loop parking + plots/animation.

    ``variant="main"`` reproduces ``main.py:241-297`` (obstacle scenario, exact
    plant). ``variant="sol"`` reproduces exercise 5 faithfully
    (``session4_sol.py:443-481``): the closed loop runs under BOTH the assumed
    Euler plant and the mismatched (friction × 0.8) exact plant, and the
    two-trajectory overlay + rel-error comparison are emitted as artifacts.
    """
    if variant == "sol":
        res_model, res, rel, params = two_plant_closed_loop(
            steps=SOL_STEPS if steps is None else steps,
            sqp_iters=sqp_iters, solver=solver, device=device,
        )
    else:
        res, mpc, params = closed_loop_parking(
            variant=variant, steps=steps, sqp_iters=sqp_iters, solver=solver, device=device
        )
        res_model, rel = None, None
    states = res.states.cpu().numpy()
    inputs = res.inputs.cpu().numpy()
    logs = {k: v.detach().cpu().numpy() for k, v in res.logs.items()}
    summary = {
        "variant": variant,
        "steps": int(inputs.shape[0]),
        "final_pose": [float(v) for v in states[-1]],
        "final_dist_to_spot": float(np.linalg.norm(states[-1, :2])),
        "success_rate": float(np.mean(logs["solver_success"].astype(np.float32))),
        "kkt_res_max": float(np.max(logs["kkt_res"])) if "kkt_res" in logs else None,
        "viol_max": float(np.max(logs["viol"])) if "viol" in logs else None,
    }
    if rel is not None:
        summary["rel_err_max_pct"] = float(np.max(rel) * 100.0)
        summary["final_dist_to_spot_model_plant"] = float(
            np.linalg.norm(res_model.states.cpu().numpy()[-1, :2])
        )

    if outdir is not None:
        import os

        from ..viz import (
            plot_input_sequence,
            plot_relative_error,
            plot_state_trajectory,
            plot_states_separately,
        )

        os.makedirs(outdir, exist_ok=True)
        ts = MAIN_TS if variant == "main" else SOL_TS
        tag = f"session4_{variant}"
        plot_input_sequence(
            inputs, params, ts=ts, save=os.path.join(outdir, f"{tag}_inputs.png")
        )
        plot_state_trajectory(
            states, params, save=os.path.join(outdir, f"{tag}_traj.png")
        )
        plot_states_separately(
            states, ts=ts, save=os.path.join(outdir, f"{tag}_states.png")
        )
        if res_model is not None:
            fig = plot_state_trajectory(
                res_model.states.cpu().numpy(), params,
                color="#0072B2", label="Predicted (model plant)",
            )
            plot_state_trajectory(
                states, params, ax=fig.axes[0], color="#D55E00",
                label="Real (mismatched plant)",
                save=os.path.join(outdir, f"{tag}_two_plant_traj.png"),
            )
            plot_relative_error(
                rel, title="Relative prediction error (parameter error) [%]",
                save=os.path.join(outdir, f"{tag}_rel_error.png"),
            )
        if animate:
            from ..viz import animate_parking

            animate_parking(
                states, params, os.path.join(outdir, f"{tag}.gif"), fps=12
            )
    return summary
