"""Racing: lap tracking around an ellipse track (port of the constants and
the reference builder of ``experiments/racing.py``).

The kinematic tier tracks at 0.35 m/s inside the kinematic model's velocity
box; the dynamic Pacejka tier at 1.2 m/s. ``make_racing_mpc`` builds the
lap-tracking controller; ``run`` and the crosswind demo are not ported yet
(ROADMAP S7.3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.bicycle import NX, NX_DYNAMIC, dynamic_bicycle_ode, kinematic_bicycle_ode
from ..models.parameters import VehicleParameters
from ..ops.integrators import euler, rk4_fine
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


def run(*args, **kwargs):
    """The closed-loop lap demo of the JAX package: not ported yet."""
    raise NotImplementedError("experiments.racing.run is not ported yet: ROADMAP S7.3")


def crosswind_comparison(*args, **kwargs):
    """The crosswind demo of the JAX package: not ported yet."""
    raise NotImplementedError(
        "experiments.racing.crosswind_comparison is not ported yet: ROADMAP S7.3")
