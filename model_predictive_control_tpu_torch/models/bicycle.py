"""Kinematic bicycle for the parking problem (port of ``models/bicycle.py``;
the dynamic Pacejka tier comes with the factory family).

State ``x = (p_x, p_y, ψ, v)``, input ``u = (a, δ)``:

    β  = atan( l_r · tan δ / (l_f + l_r) )
    ṗx = v · cos(ψ + β)
    ṗy = v · sin(ψ + β)
    ψ̇  = v · sin β / l_r
    v̇  = acceleration · a − friction · v
"""

from __future__ import annotations

import torch

from .parameters import VehicleParameters

NX = 4  # (p_x, p_y, psi, v)
NU = 2  # (drive a, steer delta)


def kinematic_bicycle_ode(
    params: VehicleParameters, x: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """Continuous-time dynamics ``ẋ = f(x, u)`` on a batch: ``x`` is
    ``(B, 4)`` and ``u`` ``(B, 2)``. A parameter field that is a ``(B,)``
    tensor applies per scenario; a float applies to all."""
    psi = x[..., 2]
    v = x[..., 3]
    a = u[..., 0]
    delta = u[..., 1]

    lf = params.axis_front
    lr = params.axis_rear
    beta = torch.atan(lr * torch.tan(delta) / (lf + lr))

    px_dot = v * torch.cos(psi + beta)
    py_dot = v * torch.sin(psi + beta)
    psi_dot = v * torch.sin(beta) / lr
    v_dot = params.acceleration * a - params.friction * v
    return torch.stack([px_dot, py_dot, psi_dot, v_dot], dim=-1)
