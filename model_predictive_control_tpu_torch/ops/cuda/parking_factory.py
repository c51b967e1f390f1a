"""The kinematic bicycle as a tracker model for the fused tracker kernel
(port of ``make_parking_ode_rows`` in ``ops/pallas/parking_factory.py``).

One Euler substep of these rows is the parking kernel's discrete map; the
kinematic racing sweep predicts with it. The factory parking solve and its
clearance rows (``al_ilqr_parking_solve_factory``, ``make_clearance_rows``)
are not ported yet (ROADMAP S4.3).
"""

from __future__ import annotations

import functools

import torch

from .ilqr_factory import TrackerModel
from .ilqr_kernel import inv_f32

NX = 4
NU = 2


@functools.lru_cache(maxsize=16)
def make_parking_ode_rows(kb: float, lr: float) -> TrackerModel:
    """Row-form kinematic-bicycle ODE with per-scenario ``pr = (acc,
    fric)``; ``kb = l_r / (l_f + l_r)``, and β enters through sin β = kb tan δ
    / √(1 + kb² tan² δ), so no ``atan`` is needed. The division by ``lr`` is a
    multiplication by its float32 reciprocal, as XLA compiles the
    reference. C++ instantiation ``KinematicRows``, constants ``(kb, kb²,
    1/lr)``."""
    kb2 = kb * kb
    inv_lr = inv_f32(lr)

    def ode_rows(xr, ur, pr):
        _px, _py, psi, v = xr
        a, dl = ur
        acc, fric = pr
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

    return TrackerModel(
        rows=ode_rows, kernel="kinematic", consts=(kb, kb2, inv_lr), nx=NX, nu=NU, n_params=2
    )
