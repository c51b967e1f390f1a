"""Bicycle models (port of ``models/bicycle.py``): the kinematic tier of the
parking problem and the dynamic Pacejka tier of the racing sweep.

Kinematic state ``x = (p_x, p_y, ψ, v)``, input ``u = (a, δ)``:

    β  = atan( l_r · tan δ / (l_f + l_r) )
    ṗx = v · cos(ψ + β)
    ṗy = v · sin(ψ + β)
    ψ̇  = v · sin β / l_r
    v̇  = acceleration · a − friction · v

Dynamic state ``(p_x, p_y, ψ, v_x, v_y, ω)``, same input: see
:func:`dynamic_bicycle_ode`.
"""

from __future__ import annotations

import functools

import torch

from ..ops.cuda.ilqr_factory import TrackerModel
from ..ops.cuda.ilqr_kernel import inv_f32
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


@functools.lru_cache(maxsize=16)
def make_kinematic_ode_rows(kb: float, lr: float, acc: float, fric: float) -> TrackerModel:
    """Row-form kinematic-bicycle ODE with CONSTANT acceleration and friction
    (``kb = l_r / (l_f + l_r)``; β through sin β = kb tan δ / √(1 + kb²
    tan² δ), no ``atan``), the JAX package's ``make_kinematic_ode_rows``:
    the same math as :func:`kinematic_bicycle_ode`, the JAX operation order,
    the division by ``lr`` a multiplication by its float32 reciprocal (as
    XLA compiles it, and as ``ops/cuda/parking_factory.py`` does). Cached on
    its arguments, so that a model keeps one identity. Its constants are
    ``(kb, kb², 1/lr, acc, fric)``; the kernel runs it gated, in the
    nonlinear MHE windows (``estimation_nl.py``: ``GatedKinematicRows``)."""
    kb2 = kb * kb
    inv_lr = inv_f32(lr)

    def ode_rows(xr, ur):
        _px, _py, psi, v = xr
        a, dl = ur
        t = torch.tan(dl)
        den = torch.sqrt(1.0 + kb2 * t * t)
        sinb = kb * t / den
        cosb = 1.0 / den
        sp, cp = torch.sin(psi), torch.cos(psi)
        return (
            v * (cp * cosb - sp * sinb),
            v * (sp * cosb + cp * sinb),
            v * sinb * inv_lr,
            acc * a - fric * v,
        )

    return TrackerModel(rows=ode_rows, kernel="kinematic_const",
                        consts=(kb, kb2, inv_lr, acc, fric), nx=NX, nu=NU)


NX_DYNAMIC = 6  # (p_x, p_y, psi, v_x, v_y, omega)


def dynamic_bicycle_ode(
    params: VehicleParameters, x: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """Dynamic single-track (Pacejka) bicycle ``ẋ = f(x, u)`` on a batch:
    ``x`` is ``(B, 6)``, ``u`` ``(B, 2)``; a parameter field may be a float
    or a ``(B,)`` tensor, as in :func:`kinematic_bicycle_ode`.

        α_f = δ − atan((ω l_f + v_y) / v_x),   α_r = atan((ω l_r − v_y) / v_x)
        F_f = d_f sin(c_f atan(b_f α_f)),      F_r = d_r sin(c_r atan(b_r α_r))
        F_x = (cm1 − cm2 v_x) a − cr2 v_x |v_x| − cr1 tanh(v_x / 0.01)

        ṗx = v_x cos ψ − v_y sin ψ,   ṗy = v_x sin ψ + v_y cos ψ,   ψ̇ = ω
        v̇x = (F_x − F_f sin δ) / m + v_y ω
        v̇y = (F_r + F_f cos δ) / m − v_x ω
        ω̇  = (F_f l_f cos δ − F_r l_r) / I_z

    ``v_x`` is clamped away from 0 (±0.01, forward at exactly 0) and the
    drag is ``v_x |v_x|``, as in the JAX package (its docstring says why the
    slip angles use ``atan`` of the ratio, not ``atan2``). ``friction`` is
    never read.
    """
    psi = x[..., 2]
    vx = x[..., 3]
    vy = x[..., 4]
    omega = x[..., 5]
    a = u[..., 0]
    delta = u[..., 1]

    lf = params.axis_front
    lr = params.axis_rear
    m = params.mass
    iz = params.inertia

    eps = 1e-2
    vx_safe = torch.where(vx >= 0, torch.clamp(vx, min=eps), torch.clamp(vx, max=-eps))
    alpha_f = delta - torch.atan((omega * lf + vy) / vx_safe)
    alpha_r = torch.atan((omega * lr - vy) / vx_safe)
    F_f = params.df * torch.sin(params.cf * torch.atan(params.bf * alpha_f))
    F_r = params.dr * torch.sin(params.cr * torch.atan(params.br * alpha_r))
    F_x = (
        (params.cm1 - params.cm2 * vx) * a
        - params.cr2 * vx * torch.abs(vx)
        - params.cr1 * torch.tanh(vx / 0.01)
    )

    px_dot = vx * torch.cos(psi) - vy * torch.sin(psi)
    py_dot = vx * torch.sin(psi) + vy * torch.cos(psi)
    vx_dot = (F_x - F_f * torch.sin(delta)) / m + vy * omega
    vy_dot = (F_r + F_f * torch.cos(delta)) / m - vx * omega
    omega_dot = (F_f * lf * torch.cos(delta) - F_r * lr) / iz
    return torch.stack([px_dot, py_dot, omega, vx_dot, vy_dot, omega_dot], dim=-1)
