"""Experiment drivers: the reference's ``main()`` / ``exerciseN()`` scripts
as importable functions returning structured results, with plots and
metrics as optional side effects (port of ``experiments/``). Entry point:
``python -m model_predictive_control_tpu_torch.cli``."""

from .session1 import cost_to_go_comparison, horizon_sweep
from .session23 import closed_loop_linear_mpc
from .session4 import (
    closed_loop_parking,
    integrator_accuracy,
    mismatch_open_loop,
    open_loop_parking,
    relative_error,
)

__all__ = [
    "horizon_sweep",
    "cost_to_go_comparison",
    "closed_loop_linear_mpc",
    "integrator_accuracy",
    "open_loop_parking",
    "mismatch_open_loop",
    "closed_loop_parking",
    "relative_error",
]
