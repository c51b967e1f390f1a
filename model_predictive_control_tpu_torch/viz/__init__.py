"""Visualization: the reference's plot set (``session_4/plotting.py``) and a
headless matplotlib substitute for its pyglet animation
(``session_4/animation.py``), the port's own copy of the JAX package's
``viz/`` on numpy. Importing it imports matplotlib (the card's machine has
none: a plot asked for there raises ``ImportError``). Off the perf path."""

from .plots import (
    plot_input_sequence,
    plot_state_trajectory,
    plot_states_separately,
    plot_phase_trajectory,
    plot_cost_to_go_comparison,
    plot_integration_error,
    plot_relative_error,
    plot_cover_circles,
)
from .animation import ParkingAnimator, animate_parking

__all__ = [
    "plot_input_sequence",
    "plot_state_trajectory",
    "plot_states_separately",
    "plot_phase_trajectory",
    "plot_cost_to_go_comparison",
    "plot_integration_error",
    "plot_relative_error",
    "plot_cover_circles",
    "ParkingAnimator",
    "animate_parking",
]
