"""Plotting layer: the reference's plot set, headless matplotlib (the port's
own copy of the JAX package's ``viz/plots.py``, on numpy; matplotlib is
imported when this module is, and nothing in the port imports it until a
plot is asked for).

Mirrors ``session_4/plotting.py:7-96`` (input-sequence panels with bound boxes,
state trajectory with car footprints and parking spot, per-state stacks) and the
session-1 inline plots (phase-plane closed loop with predicted-trajectory overlays,
``FHC.py:64-131``; cost-to-go convergence, ``FHC.py:117-131``).

All functions take numpy arrays or CPU tensors, draw on a fresh figure (or a provided Axes),
and return the Figure; pass ``save=path`` to write a PNG. No display backend is
required (compute hosts are headless) — callers never need ``plt.show``.
"""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg", force=False)
import matplotlib.pyplot as plt
from matplotlib import patches
from matplotlib import transforms as mtransforms

# Fixed categorical order (never cycled); colorblind-screened Okabe-Ito subset.
SERIES_COLORS = ("#0072B2", "#E69F00", "#009E73", "#CC79A7", "#56B4E9")
BOUND_COLOR = "#D55E00"  # reserved: limit/constraint lines only
TRACE_COLOR = SERIES_COLORS[0]
GRID_KW = dict(color="0.85", linewidth=0.6)  # recessive grid


def _finish(fig, save):
    if save is not None:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig


def plot_input_sequence(inputs, params, ts: float | None = None, save=None):
    """(a, δ) plane with the input-bound rectangle + per-component time series with
    limit lines (``plotting.py:7-44``). ``inputs``: (T, 2) = (drive, steer)."""
    inputs = np.asarray(inputs)
    t = np.arange(inputs.shape[0]) * (ts if ts is not None else 1.0)
    tlabel = "time [s]" if ts is not None else "step"

    fig, axes = plt.subplots(1, 3, figsize=(12, 3.4))
    ax = axes[0]
    ax.add_patch(
        patches.Rectangle(
            (params.min_drive, -params.max_steer),
            params.max_drive - params.min_drive,
            2 * params.max_steer,
            fill=False,
            edgecolor=BOUND_COLOR,
            linestyle="--",
            label="bounds",
        )
    )
    ax.plot(inputs[:, 0], inputs[:, 1], ".-", color=TRACE_COLOR, markersize=4)
    ax.set_xlabel("drive a")
    ax.set_ylabel("steer δ [rad]")
    ax.set_title("input plane")
    ax.grid(**GRID_KW)

    for ax, col, name, lo, hi in (
        (axes[1], 0, "drive a", params.min_drive, params.max_drive),
        (axes[2], 1, "steer δ [rad]", -params.max_steer, params.max_steer),
    ):
        ax.plot(t, inputs[:, col], color=TRACE_COLOR)
        ax.axhline(lo, color=BOUND_COLOR, linestyle="--", linewidth=1)
        ax.axhline(hi, color=BOUND_COLOR, linestyle="--", linewidth=1)
        ax.set_xlabel(tlabel)
        ax.set_ylabel(name)
        ax.grid(**GRID_KW)
    fig.tight_layout()
    return _finish(fig, save)


def _car_footprint(ax, pose, params, color, alpha):
    """Rotated car rectangle at ``pose = (px, py, ψ, ...)``."""
    px, py, psi = float(pose[0]), float(pose[1]), float(pose[2])
    rect = patches.Rectangle(
        (-params.length / 2.0, -params.width / 2.0),
        params.length,
        params.width,
        fill=False,
        edgecolor=color,
        alpha=alpha,
        linewidth=1.0,
    )
    tr = (
        mtransforms.Affine2D().rotate(psi).translate(px, py) + ax.transData
    )
    rect.set_transform(tr)
    ax.add_patch(rect)


def plot_state_trajectory(
    states,
    params,
    parking_spot=(0.0, 0.0),
    every: int = 2,
    save=None,
    ax=None,
    color=None,
    label: str = "position",
):
    """Position trace + car footprint rectangles with an alpha ramp + parking-spot
    rectangle (``plotting.py:46-77``: every 2nd step, alpha ``0.1 + i/len``).

    Pass an existing ``ax`` plus ``color``/``label`` to overlay a second
    trajectory, as the reference drivers do for predicted-vs-real comparisons
    (``session4_sol.py:372-378, 419-424, 469-474``); the parking-spot patch is
    drawn only on a fresh axis."""
    states = np.asarray(states)
    fresh_ax = ax is None
    if fresh_ax:
        fig, ax = plt.subplots(figsize=(6, 5))
    else:
        fig = ax.figure

    if fresh_ax:
        sx, sy = parking_spot
        ax.add_patch(
            patches.Rectangle(
                (sx - params.length * 0.75, sy - params.width * 0.75),
                params.length * 1.5,
                params.width * 1.5,
                fill=True,
                facecolor="0.92",
                edgecolor="0.55",
                label="parking spot",
            )
        )
    trace_color = TRACE_COLOR if color is None else color
    T = states.shape[0]
    for i in range(0, T, every):
        alpha = min(1.0, 0.1 + i / max(T, 1))
        _car_footprint(
            ax, states[i], params, SERIES_COLORS[2] if color is None else color, alpha
        )
    ax.plot(states[:, 0], states[:, 1], color=trace_color, label=label)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal")
    ax.grid(**GRID_KW)
    ax.legend(loc="best", frameon=False)
    return _finish(fig, save)


def plot_cover_circles(pose, params, n_circles: int = 3, save=None, ax=None):
    """Visual check of the covering-circle collision geometry — the reference's
    ``plot_cover_circle``/``test_circle`` (``session_4/main.py:203-238``): the car
    footprint at ``pose`` overlaid with its ``n_circles`` covering circles."""
    import torch

    from ..utils.geometry import cover_circle_offsets, transform_circles

    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 5))
    else:
        fig = ax.figure
    offsets, r = cover_circle_offsets(params.length, params.width, n_circles, device="cpu")
    pose = torch.as_tensor(np.asarray(pose), dtype=torch.float32)
    centers = transform_circles(pose, offsets).numpy()
    _car_footprint(ax, pose, params, SERIES_COLORS[0], alpha=1.0)
    for cx, cy in centers:
        ax.add_patch(
            patches.Circle(
                (float(cx), float(cy)), float(r),
                fill=False, edgecolor=SERIES_COLORS[1], linestyle="--",
            )
        )
    ax.set_aspect("equal")
    ax.relim()
    ax.autoscale_view()
    ax.grid(**GRID_KW)
    return _finish(fig, save)


STATE_LABELS_BICYCLE = ("x [m]", "y [m]", "heading ψ [rad]", "velocity v [m/s]")


def plot_states_separately(
    states, ts: float | None = None, labels=STATE_LABELS_BICYCLE, save=None
):
    """Stacked per-state time series (``plotting.py:80-96``)."""
    states = np.asarray(states)
    nx = states.shape[1]
    labels = list(labels)[:nx] + [f"x[{i}]" for i in range(len(labels), nx)]
    t = np.arange(states.shape[0]) * (ts if ts is not None else 1.0)
    fig, axes = plt.subplots(nx, 1, figsize=(7, 1.9 * nx), sharex=True)
    axes = np.atleast_1d(axes)
    for i, ax in enumerate(axes):
        ax.plot(t, states[:, i], color=TRACE_COLOR)
        ax.set_ylabel(labels[i])
        ax.grid(**GRID_KW)
    axes[-1].set_xlabel("time [s]" if ts is not None else "step")
    fig.tight_layout()
    return _finish(fig, save)


def plot_phase_trajectory(
    states, predictions=None, labels=("p", "v"), save=None, ax=None
):
    """Session-1 phase plane: closed-loop trace plus optional per-step predicted
    trajectories (``FHC.py:64-96``, ``LinearSystem.plot_traj``).

    ``predictions``: (T, N+1, 2) open-loop predictions made at each step.
    """
    states = np.asarray(states)
    if ax is None:
        fig, ax = plt.subplots(figsize=(5.5, 4.5))
    else:
        fig = ax.figure
    if predictions is not None:
        predictions = np.asarray(predictions)
        for i in range(predictions.shape[0]):
            ax.plot(
                predictions[i, :, 0],
                predictions[i, :, 1],
                color=SERIES_COLORS[1],
                alpha=0.35,
                linewidth=0.8,
                label="predicted" if i == 0 else None,
            )
    ax.plot(
        states[:, 0], states[:, 1], ".-", color=TRACE_COLOR, label="closed loop"
    )
    ax.plot(states[0, 0], states[0, 1], "o", color=TRACE_COLOR)
    ax.set_xlabel(labels[0])
    ax.set_ylabel(labels[1])
    ax.grid(**GRID_KW)
    ax.legend(loc="best", frameon=False)
    return _finish(fig, save)


def plot_cost_to_go_comparison(horizons, finite_costs, v_inf, save=None):
    """Finite-horizon cost-to-go ``x0ᵀ P_N x0`` vs the DARE value ``V∞`` over N
    (``FHC.py:117-131``)."""
    horizons = np.asarray(horizons)
    finite_costs = np.asarray(finite_costs)
    fig, ax = plt.subplots(figsize=(5.5, 4))
    ax.plot(
        horizons, finite_costs, "o-", color=TRACE_COLOR, label="finite horizon"
    )
    ax.axhline(
        float(v_inf), color=SERIES_COLORS[1], linestyle="--", label="infinite (DARE)"
    )
    ax.set_xlabel("horizon N")
    ax.set_ylabel("cost-to-go at x₀")
    ax.grid(**GRID_KW)
    ax.legend(loc="best", frameon=False)
    return _finish(fig, save)


def plot_integration_error(ts_values, errors_by_method, save=None):
    """Semilog integrator-accuracy sweep vs ground truth
    (``session4_sol.py:87-100``). ``errors_by_method``: {name: (T,) error}."""
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, (name, err) in enumerate(errors_by_method.items()):
        err = np.asarray(err)
        ax.semilogy(
            np.arange(err.shape[0]) * float(ts_values),
            np.maximum(err, 1e-17),
            color=SERIES_COLORS[i % len(SERIES_COLORS)],
            label=name,
        )
    ax.set_xlabel("time [s]")
    ax.set_ylabel("‖x − x_exact‖∞")
    ax.grid(**GRID_KW)
    ax.legend(loc="best", frameon=False)
    return _finish(fig, save)


def plot_relative_error(rel_err, title=None, save=None):
    """Per-step relative prediction error in percent — the reference's de-facto
    validation artifact, ``plt.plot(rel_error(...) * 100)`` with x-label "Time
    step" (``session4_sol.py:382-386, 428-432, 477-481``)."""
    rel_err = np.asarray(rel_err)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(rel_err * 100.0, color=SERIES_COLORS[0])
    ax.set_xlabel("Time step")
    ax.set_ylabel(r"$\|x - x_{pred}\| / (\|x\| + \|x_{pred}\|) \times 100$")
    if title:
        ax.set_title(title)
    ax.grid(**GRID_KW)
    return _finish(fig, save)
