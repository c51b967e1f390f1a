"""Benchmark model families for the model-parametric fused tracker (port of
``models/benchmarks.py``): cart-pole (nx 4, nu 1), planar quadrotor (nx 6,
nu 2), omnidirectional base (nx 6, nu 3; also with a per-scenario mass) and
thrust cluster (nx 6, nu 4), in the tracker's row form.

Each builder returns a :class:`..ops.cuda.ilqr_factory.TrackerModel`: the
torch rows (written with the operations :class:`..ops.cuda.ilqr_factory.Dual`
supports, in the reference's operation order), the name of the C++ functor
of ``csrc/ilqr_factory.cu`` that does the same operations, and the float
constants it reads. A division by a constant is a multiplication by its
float32 reciprocal, as XLA compiles the reference; a division by a
per-scenario parameter stays a division. Each builder is cached on its
parameter tuple, so that a model keeps one identity.
"""

from __future__ import annotations

import functools
import math

import torch

from ..ops.cuda.ilqr_factory import TrackerModel
from ..ops.cuda.ilqr_kernel import inv_f32

NX_CARTPOLE, NU_CARTPOLE = 4, 1
NX_QUADROTOR, NU_QUADROTOR = 6, 2
NX_OMNIBASE, NU_OMNIBASE = 6, 3
NX_THRUSTER, NU_THRUSTER = 6, 4

# (mass_cart, mass_pole, pole_length, gravity)
CARTPOLE_PARAMS = (1.0, 0.1, 0.5, 9.81)
# (mass, inertia, arm_length, gravity)
QUADROTOR_PARAMS = (0.5, 0.01, 0.17, 9.81)
# (mass, inertia, linear_drag, angular_drag)
OMNIBASE_PARAMS = (8.0, 0.4, 0.6, 0.15)
# (mass, gravity, linear_drag, quadratic_drag, cone_half_angle)
THRUSTER_PARAMS = (1.2, 9.81, 0.05, 0.08, 0.35)


@functools.lru_cache(maxsize=16)
def make_cartpole_ode_rows(params: tuple = CARTPOLE_PARAMS) -> TrackerModel:
    """Cart-pole, state ``(p, θ, ṗ, θ̇)`` with θ from the downward vertical,
    input ``(force,)``:

        (mc + mp sin²θ) p̈ = u + mp sinθ (l θ̇² + g cosθ)
        l (mc + mp sin²θ) θ̈ = −u cosθ − mp l θ̇² cosθ sinθ − (mc + mp) g sinθ

    C++ instantiation ``CartpoleRows``, constants ``(mc, mp, l, g, mp l,
    (mc + mp) g)``."""
    mc, mp, l, g = params
    mpl, mg = mp * l, (mc + mp) * g

    def ode_rows(xr, ur):
        _p, th, pd, thd = xr
        (u,) = ur
        s, c = torch.sin(th), torch.cos(th)
        den = mc + mp * s * s
        pdd = (u + mp * s * (l * thd * thd + g * c)) / den
        thdd = (-u * c - mpl * thd * thd * c * s - mg * s) / (l * den)
        return (pd, thd, pdd, thdd)

    return TrackerModel(rows=ode_rows, kernel="cartpole", consts=(mc, mp, l, g, mpl, mg),
                        nx=NX_CARTPOLE, nu=NU_CARTPOLE)


@functools.lru_cache(maxsize=16)
def make_planar_quadrotor_ode_rows(params: tuple = QUADROTOR_PARAMS) -> TrackerModel:
    """Planar quadrotor, state ``(p_x, p_z, θ, v_x, v_z, ω)``, inputs the two
    rotor thrusts ``(u₁, u₂)`` (hover at ``m g / 2`` each):

        v̇_x = −(u₁+u₂) sinθ / m,   v̇_z = (u₁+u₂) cosθ / m − g,
        ω̇ = (u₁−u₂) · arm / I.

    C++ instantiation ``QuadrotorRows``, constants ``(1/m, g, arm, 1/I)``."""
    m, inertia, arm, g = params
    inv_m, inv_i = inv_f32(m), inv_f32(inertia)

    def ode_rows(xr, ur):
        _px, _pz, th, vx, vz, om = xr
        u1, u2 = ur
        s, c = torch.sin(th), torch.cos(th)
        thrust = u1 + u2
        return (
            vx,
            vz,
            om,
            -thrust * s * inv_m,
            thrust * c * inv_m - g,
            (u1 - u2) * arm * inv_i,
        )

    return TrackerModel(rows=ode_rows, kernel="quadrotor", consts=(inv_m, g, arm, inv_i),
                        nx=NX_QUADROTOR, nu=NU_QUADROTOR)


@functools.lru_cache(maxsize=16)
def make_omnibase_ode_rows(params: tuple = OMNIBASE_PARAMS) -> TrackerModel:
    """Omnidirectional base, state ``(p_x, p_y, θ, v_x, v_y, ω)``, inputs
    body-frame forces and a yaw torque ``(f_fwd, f_lat, τ)``, linear drag:

        v̇_x = (f_fwd cosθ − f_lat sinθ)/m − c_v v_x
        v̇_y = (f_fwd sinθ + f_lat cosθ)/m − c_v v_y
        ω̇ = τ/I − c_ω ω

    C++ instantiation ``OmnibaseRows``, constants ``(1/m, 1/I, c_v, c_ω)``."""
    m, inertia, c_v, c_w = params
    inv_m, inv_i = inv_f32(m), inv_f32(inertia)

    def ode_rows(xr, ur):
        _px, _py, th, vx, vy, om = xr
        ff, fl, tq = ur
        s, c = torch.sin(th), torch.cos(th)
        return (
            vx,
            vy,
            om,
            (ff * c - fl * s) * inv_m - c_v * vx,
            (ff * s + fl * c) * inv_m - c_v * vy,
            tq * inv_i - c_w * om,
        )

    return TrackerModel(rows=ode_rows, kernel="omnibase", consts=(inv_m, inv_i, c_v, c_w),
                        nx=NX_OMNIBASE, nu=NU_OMNIBASE)


@functools.lru_cache(maxsize=16)
def make_omnibase_param_ode_rows(params: tuple = OMNIBASE_PARAMS) -> TrackerModel:
    """The omnidirectional base with the mass as a per-scenario parameter row
    ``pr = (m,)`` (``n_params = 1``); ``params``' mass is unused. C++
    instantiation ``OmnibaseParamRows``, constants ``(1/I, c_v, c_ω)``."""
    _, inertia, c_v, c_w = params
    inv_i = inv_f32(inertia)

    def ode_rows(xr, ur, pr):
        _px, _py, th, vx, vy, om = xr
        ff, fl, tq = ur
        (m,) = pr
        s, c = torch.sin(th), torch.cos(th)
        return (
            vx,
            vy,
            om,
            (ff * c - fl * s) / m - c_v * vx,
            (ff * s + fl * c) / m - c_v * vy,
            tq * inv_i - c_w * om,
        )

    return TrackerModel(rows=ode_rows, kernel="omnibase_param", consts=(inv_i, c_v, c_w),
                        nx=NX_OMNIBASE, nu=NU_OMNIBASE, n_params=1)


def thruster_directions(cone: float) -> tuple:
    """The four thrust directions, a pyramid around +z tilted by ``cone``
    toward +x, +y, −x, −y."""
    sa, ca = math.sin(cone), math.cos(cone)
    return ((sa, 0.0, ca), (0.0, sa, ca), (-sa, 0.0, ca), (0.0, -sa, ca))


@functools.lru_cache(maxsize=16)
def make_thruster_ode_rows(params: tuple = THRUSTER_PARAMS) -> TrackerModel:
    """Thrust cluster: a 3-D point mass, state ``(p_x, p_y, p_z, v_x, v_y,
    v_z)``, four fixed pyramid thrusters ``u_i ≥ 0`` (redundant: a rank-3
    input map), linear and quadratic drag:

        v̇ = Σᵢ uᵢ dᵢ / m − g e_z − c₁ v − c₂ ‖v‖ v,  ‖v‖ = √(v·v + 1e-9).

    The force sums are Python sums starting at 0, as the reference's. C++
    instantiation ``ThrusterRows``, constants ``(1/m, g, c₁, c₂, sin cone,
    cos cone)``."""
    m, g, c1, c2, cone = params
    inv_m = inv_f32(m)
    dirs = thruster_directions(cone)

    def ode_rows(xr, ur):
        _px, _py, _pz, vx, vy, vz = xr
        sp = torch.sqrt(vx * vx + vy * vy + vz * vz + 1e-9)
        fx = sum(ur[i] * dirs[i][0] for i in range(4)) * inv_m
        fy = sum(ur[i] * dirs[i][1] for i in range(4)) * inv_m
        fz = sum(ur[i] * dirs[i][2] for i in range(4)) * inv_m
        return (
            vx,
            vy,
            vz,
            fx - c1 * vx - c2 * sp * vx,
            fy - c1 * vy - c2 * sp * vy,
            fz - g - c1 * vz - c2 * sp * vz,
        )

    return TrackerModel(rows=ode_rows, kernel="thruster",
                        consts=(inv_m, g, c1, c2, math.sin(cone), math.cos(cone)),
                        nx=NX_THRUSTER, nu=NU_THRUSTER)
