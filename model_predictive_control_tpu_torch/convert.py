"""Build the port's dataclasses from the JAX package's objects.

Takes a numpy copy of each field by name, so this module needs no JAX import:
it reads attributes of whatever object it is given. The tests use it to feed
both packages the same operator and the same vehicle parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def from_jax_arrays(obj, cls, *, device="cpu", dtype=torch.float32):
    """A ``cls`` instance (e.g. :class:`~.ops.condensed.CondensedQP` or
    :class:`~.solvers.qp.QPOperator`) whose fields are copied from ``obj``'s
    attributes of the same names. Integer fields stay Python ints; array
    fields become tensors of ``dtype`` on ``device``."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        value = getattr(obj, f.name)
        if f.type == "int":
            kwargs[f.name] = int(np.asarray(value))
        else:
            kwargs[f.name] = torch.as_tensor(
                np.array(value, dtype=np.float64), dtype=dtype, device=device
            )
    return cls(**kwargs)


def vehicle_parameters_from_jax(params, *, device="cpu", dtype=torch.float32):
    """A port :class:`~.models.parameters.VehicleParameters` from the JAX
    package's: a 0-d field becomes a Python float, a ``(B,)`` field a
    tensor of ``dtype`` on ``device``."""
    from .models.parameters import VehicleParameters

    kwargs = {}
    for f in dataclasses.fields(VehicleParameters):
        value = np.asarray(getattr(params, f.name))
        kwargs[f.name] = (
            float(value)
            if value.ndim == 0
            else torch.as_tensor(value.astype(np.float64), dtype=dtype, device=device)
        )
    return VehicleParameters(**kwargs)
