"""Vehicle parameters for the kinematic-bicycle parking problem (port of
``models/parameters.py``).

A frozen dataclass with the JAX package's fields and defaults. A field is
either a Python float (the nominal model) or a ``(B,)`` tensor (a field
perturbed per scenario, as :func:`..parallel.batch.perturb_parameters`
makes it); the model code broadcasts either against ``(B,)`` state rows.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_TWO_PI = 2.0 * math.pi


@dataclasses.dataclass(frozen=True)
class VehicleParameters:
    """Miniature race-car parameters (values from ``session_4/parameters.py``)."""

    # geometry (meters)
    length: float | torch.Tensor = 0.17
    axis_front: float | torch.Tensor = 0.047
    axis_rear: float | torch.Tensor = 0.05
    front: float | torch.Tensor = 0.08
    rear: float | torch.Tensor = 0.08
    width: float | torch.Tensor = 0.08
    height: float | torch.Tensor = 0.055
    mass: float | torch.Tensor = 0.1735
    inertia: float | torch.Tensor = 18.3e-5

    # input limits
    max_steer: float | torch.Tensor = 0.384
    max_drive: float | torch.Tensor = 1.0
    min_drive: float | torch.Tensor = -1.0

    # state limits
    min_pos_x: float | torch.Tensor = -3.0
    max_pos_x: float | torch.Tensor = 3.0
    min_pos_y: float | torch.Tensor = -2.0
    max_pos_y: float | torch.Tensor = 2.0
    min_vel: float | torch.Tensor = -0.5
    max_vel: float | torch.Tensor = 0.5
    max_heading: float | torch.Tensor = _TWO_PI
    min_heading: float | torch.Tensor = -_TWO_PI

    # Pacejka 'Magic Formula' tire parameters (front / rear)
    bf: float | torch.Tensor = 3.1355
    cf: float | torch.Tensor = 2.1767
    df: float | torch.Tensor = 0.4399
    br: float | torch.Tensor = 2.8919
    cr: float | torch.Tensor = 2.4431
    dr: float | torch.Tensor = 0.6236

    # kinematic approximation
    friction: float | torch.Tensor = 1.0
    acceleration: float | torch.Tensor = 2.0

    # motor parameters
    cm1: float | torch.Tensor = 0.3697
    cm2: float | torch.Tensor = 0.001295
    cr1: float | torch.Tensor = 0.1629
    cr2: float | torch.Tensor = 0.02133

    def batched_fields(self) -> set[str]:
        """Names of the fields that carry a scenario axis."""
        return {
            f.name
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
            and getattr(self, f.name).ndim > 0
        }
