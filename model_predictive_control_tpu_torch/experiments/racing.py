"""Racing: lap tracking around an ellipse track (port of
``experiments/racing.py``).

The kinematic tier tracks at 0.35 m/s inside the kinematic model's velocity
box; the dynamic Pacejka tier at 1.2 m/s. :func:`make_racing_mpc` builds the
lap-tracking controller, :func:`run` drives one closed-loop lap with a
prediction/plant integration mismatch (dynamic: 4-substep RK4 prediction
against a 16-substep RK4 plant; kinematic: Euler against RK4), and
:func:`crosswind_comparison` holds the nominal tracker against the
disturbance-compensated one under a persistent crosswind.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.bicycle import NX, NX_DYNAMIC, dynamic_bicycle_ode, kinematic_bicycle_ode
from ..models.parameters import VehicleParameters
from ..control.simulate import simulate
from ..ops.integrators import euler, rk4, rk4_fine
from ..solvers.nmpc_tracking import TrackingNMPC
from ..utils.device import resolve_device

# track + scenario constants (miniature scale: the car is 0.17 m long and the
# state box is ±3 m × ±2 m; the ellipse fits inside it)
ELLIPSE_A = 1.5
ELLIPSE_B = 1.0
SPEED = 1.2  # m/s, the dynamic tier's lap speed
TS = 0.05
HORIZON = 15

Q_DYNAMIC = (40.0, 40.0, 4.0, 1.0, 0.2, 0.05)
R_DYNAMIC = (0.5, 0.5)
Q_KINEMATIC = (40.0, 40.0, 4.0, 1.0)
R_KINEMATIC = (0.5, 0.5)
QN_SCALE = 5.0


def ellipse_reference(
    n: int,
    a: float = ELLIPSE_A,
    b: float = ELLIPSE_B,
    speed: float = SPEED,
    ts: float = TS,
    dynamic: bool = True,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Constant-speed state reference along an ellipse, ``(n, nx)`` rows on
    ``device`` (the card when ``None``).

    Built on the host in float64 numpy, as in the JAX package: a dense
    arclength table, resampled at ``s = speed · t`` so that the reference
    moves at constant ground speed; the heading is the unwrapped path
    tangent; the dynamic tier adds the body velocities ``(v_x = speed,
    v_y = 0)`` and the yaw rate ``ω = ψ̇``.
    """
    device = resolve_device(device)
    theta_dense = np.linspace(0.0, 2.0 * np.pi, 20_000)
    dx = -a * np.sin(theta_dense)
    dy = b * np.cos(theta_dense)
    seg_speed = np.hypot(dx, dy)
    s_dense = np.concatenate(
        [[0.0], np.cumsum(0.5 * (seg_speed[1:] + seg_speed[:-1]) * np.diff(theta_dense))]
    )
    s_wanted = speed * ts * np.arange(n)
    theta = np.interp(np.mod(s_wanted, s_dense[-1]), s_dense, theta_dense)
    # unwrap the curve parameter across laps so psi can unwrap too
    theta = theta + 2.0 * np.pi * np.floor(s_wanted / s_dense[-1])

    px = a * np.cos(theta)
    py = b * np.sin(theta)
    psi = np.unwrap(np.arctan2(b * np.cos(theta), -a * np.sin(theta)))
    if dynamic:
        omega = np.gradient(psi, ts)
        ref = np.stack([px, py, psi, np.full(n, speed), np.zeros(n), omega], axis=1)
    else:
        ref = np.stack([px, py, psi, np.full(n, speed)], axis=1)
    return torch.as_tensor(ref, dtype=dtype, device=device)


def make_racing_mpc(
    params: VehicleParameters | None = None,
    N: int = HORIZON,
    ts: float = TS,
    steps: int = 200,
    dynamic: bool = True,
    tube_radius: float | None = 0.25,
    speed: float = SPEED,
    dtype=torch.float32,
    device=None,
) -> tuple[TrackingNMPC, torch.Tensor]:
    """The lap-tracking controller and its reference, on ``device`` (the
    card when ``None``). The dynamic tier predicts with RK4 over 4 substeps
    (forward Euler is unstable on the stiff Pacejka yaw mode at ``ts =
    0.05``, as the JAX package measured), the kinematic tier with Euler."""
    params = params or VehicleParameters()
    if dynamic:
        nx, Q, R = NX_DYNAMIC, Q_DYNAMIC, R_DYNAMIC
        pred_step = rk4_fine(lambda x, u: dynamic_bicycle_ode(params, x, u), ts, substeps=4)
    else:
        nx, Q, R = NX, Q_KINEMATIC, R_KINEMATIC
        pred_step = euler(lambda x, u: kinematic_bicycle_ode(params, x, u), ts)
    ref = ellipse_reference(steps + N + 1, speed=speed, ts=ts, dynamic=dynamic, dtype=dtype,
                            device=device)
    ctrl = TrackingNMPC(
        step_fn=pred_step, nx=nx, nu=2, N=N, Q=Q, R=R, QN=[QN_SCALE * q for q in Q],
        u_lb=[params.min_drive, -params.max_steer], u_ub=[params.max_drive, params.max_steer],
        ref_traj=ref, tube_radius=tube_radius,
    )
    return ctrl, ref


def run(steps: int = 200, N: int = HORIZON, ts: float = TS, dynamic: bool = True,
        speed: float = SPEED, tube_radius: float | None = 0.25, dtype=torch.float32,
        outdir=None, device=None):
    """One closed-loop lap on ``device`` (the card when ``None``) with a
    prediction/plant integration mismatch. Returns ``(SimResult,
    summary)``."""
    params = VehicleParameters()
    ctrl, ref = make_racing_mpc(params, N=N, ts=ts, steps=steps, dynamic=dynamic,
                                tube_radius=tube_radius, speed=speed, dtype=dtype, device=device)
    if dynamic:
        plant = rk4_fine(lambda x, u: dynamic_bicycle_ode(params, x, u), ts, substeps=16)
    else:
        plant = rk4(lambda x, u: kinematic_bicycle_ode(params, x, u), ts)
    res = simulate(ref[0], plant, steps=steps, policy=ctrl.policy(),
                   policy_carry=ctrl.initial_carry(dtype, ref.device))
    err = res.logs["tracking_error"].cpu().numpy()
    summary = {
        "model": "dynamic" if dynamic else "kinematic",
        "steps": steps,
        "speed": float(speed),
        "lap_time_s": float(steps * ts),
        "mean_tracking_error_m": float(err.mean()),
        "max_tracking_error_m": float(err.max()),
        "success_rate": float(res.logs["solver_success"].float().mean()),
        "unstable": bool(res.unstable),
    }
    if outdir is not None:
        _save_plots(res, ref, steps, summary, outdir)
    return res, summary


def _save_plots(res, ref, steps, summary, outdir):
    import pathlib

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    states = res.states.cpu().numpy()
    refn = ref.cpu().numpy()
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.plot(refn[:steps, 0], refn[:steps, 1], "k--", lw=1, label="reference")
    ax.plot(states[:, 0], states[:, 1], lw=1.5, label="car")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend()
    ax.set_title(f"{summary['model']} lap @ {summary['speed']} m/s — "
                 f"mean err {summary['mean_tracking_error_m'] * 100:.1f} cm")
    fig.savefig(outdir / "racing_track.png", dpi=120)
    plt.close(fig)
    fig, ax = plt.subplots(figsize=(7, 3))
    ax.plot(res.logs["tracking_error"].cpu().numpy() * 100.0)
    ax.set_xlabel("step")
    ax.set_ylabel("tracking error [cm]")
    fig.savefig(outdir / "racing_error.png", dpi=120)
    plt.close(fig)


def crosswind_comparison(steps: int = 120, N: int = HORIZON, ts: float = TS, speed: float = 0.35,
                         wind: float = 0.004, dtype=torch.float32, device=None) -> dict:
    """The nominal lap tracker against
    :class:`..solvers.offset_free_nmpc.DisturbanceCompensatedTracking` under a
    persistent lateral crosswind (the kinematic tier), on ``device`` (the
    card when ``None``). Returns both steady tracking errors and the EKF's
    wind estimate."""
    from ..solvers.offset_free_nmpc import DisturbanceCompensatedTracking

    params = VehicleParameters()
    ref = ellipse_reference(steps + N + 1, speed=speed, ts=ts, dynamic=False, dtype=dtype,
                            device=device)
    dev = ref.device
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    step_fn = euler(lambda x, u: kinematic_bicycle_ode(params, x, u), ts)
    plant_base = rk4(lambda x, u: kinematic_bicycle_ode(params, x, u), ts)
    w = t([0.0, -wind, 0.0, 0.0])
    plant = lambda x, u: plant_base(x, u) + w
    Q, R = t(Q_KINEMATIC), t(R_KINEMATIC)
    u_lb = t([params.min_drive, -params.max_steer])
    u_ub = t([params.max_drive, params.max_steer])
    nom = TrackingNMPC(step_fn, nx=NX, nu=2, N=N, Q=Q, R=R, QN=QN_SCALE * Q, u_lb=u_lb,
                       u_ub=u_ub, ref_traj=ref)
    res_n = simulate(ref[0], plant, steps=steps, policy=nom.policy(),
                     policy_carry=nom.initial_carry(dtype, dev))
    comp = DisturbanceCompensatedTracking(step_fn, nx=NX, nu=2, N=N, Q=Q, R=R, QN=QN_SCALE * Q,
                                          u_lb=u_lb, u_ub=u_ub, ref_traj=ref, ts=ts, dtype=dtype,
                                          device=dev)
    res_c = simulate(ref[0], plant, steps=steps, policy=comp.policy(),
                     policy_carry=comp.initial_carry(ref[0]))
    tail = slice(-max(10, steps // 3), None)
    err_n = res_n.logs["tracking_error"].cpu().numpy()
    err_c = res_c.logs["tracking_error"].cpu().numpy()
    return {
        "wind_per_step": float(wind),
        "nominal_steady_error_m": float(err_n[tail].mean()),
        "compensated_steady_error_m": float(err_c[tail].mean()),
        "compensated_success": float(res_c.logs["solver_success"].float().mean()),
        "wind_estimate": float(res_c.logs["disturbance_estimate"][-1, 1]),
    }
