"""Offline parking animation — matplotlib substitute for the reference's pyglet
window (``session_4/animation.py:10-84``), which cannot run on a headless host
and is explicitly off the perf path (BASELINE config: "no animation").

Capability parity with ``AnimateParking``:
- car sprite driven by the pose columns ``states[:, :3]`` (animation.py:48);
- ghost cars for comparison trajectories (``add_car_trajectory``);
- 2-D polyline traces (``trace``);
- predicted-trajectory *bundles*: a (T, N+1, nx) array of the open-loop plan made
  at each step, drawn as a fading fan per frame (``bundle``, animation.py:75-83);
- parking-spot rectangles (``ParkingSpot``).

Output is a GIF/MP4 file (Pillow/ffmpeg writers) instead of a live window.
"""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg", force=False)
import matplotlib.pyplot as plt
from matplotlib import animation as manimation
from matplotlib import patches
from matplotlib import transforms as mtransforms

from .plots import GRID_KW, SERIES_COLORS, TRACE_COLOR


class ParkingAnimator:
    """Compose trajectories/traces/bundles, then render to a file.

    Shape checks mirror the reference's (``animation.py:66-69, 76-79``): car
    trajectories need ≥3 state columns (pose), bundles need a 3-D array.
    """

    def __init__(self, params, parking_spot=(0.0, 0.0), n_spots: int = 5):
        self.params = params
        self.parking_spot = parking_spot
        self.n_spots = n_spots
        self._cars: list[tuple[np.ndarray, str]] = []
        self._traces: list[tuple[np.ndarray, str]] = []
        self._bundle: np.ndarray | None = None

    def add_car_trajectory(self, states, color: str | None = None):
        states = np.asarray(states)
        if states.ndim != 2 or states.shape[1] < 3:
            raise ValueError(
                f"car trajectory needs (T, ≥3) pose states, got {states.shape}"
            )
        color = color or SERIES_COLORS[len(self._cars) % len(SERIES_COLORS)]
        self._cars.append((states, color))

    def trace(self, xy, color: str = SERIES_COLORS[1]):
        xy = np.asarray(xy)
        if xy.ndim != 2 or xy.shape[1] < 2:
            raise ValueError(f"trace needs (T, ≥2), got {xy.shape}")
        self._traces.append((xy, color))

    def bundle(self, predictions):
        """(T, N+1, nx) predicted open-loop trajectories, one fan per frame."""
        predictions = np.asarray(predictions)
        if predictions.ndim != 3:
            raise ValueError(
                f"bundle needs (T, N+1, nx) predictions, got {predictions.shape}"
            )
        self._bundle = predictions

    # -- rendering ---------------------------------------------------------

    def _setup_axes(self, ax):
        p = self.params
        # parking spots in a row, camera on the scene (animation.py:23-57)
        for k in range(self.n_spots):
            cx = self.parking_spot[0] + (k - self.n_spots // 2) * p.length * 1.6
            ax.add_patch(
                patches.Rectangle(
                    (cx - p.length * 0.75, self.parking_spot[1] - p.width * 0.75),
                    p.length * 1.5,
                    p.width * 1.5,
                    facecolor="0.93",
                    edgecolor="0.6",
                )
            )
        all_xy = np.concatenate(
            [s[:, :2] for s, _ in self._cars]
            + [t[:, :2] for t, _ in self._traces]
        )
        lo = all_xy.min(axis=0) - 2.5 * p.length
        hi = all_xy.max(axis=0) + 2.5 * p.length
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_aspect("equal")
        ax.grid(**GRID_KW)

    def _car_patch(self, ax, color):
        p = self.params
        rect = patches.Rectangle(
            (-p.length / 2.0, -p.width / 2.0),
            p.length,
            p.width,
            facecolor=color,
            edgecolor="black",
            alpha=0.85,
        )
        ax.add_patch(rect)
        return rect

    def render(self, save: str, fps: int = 12, dpi: int = 80, stride: int = 1):
        """Write the animation to ``save`` (.gif via Pillow, .mp4 via ffmpeg)."""
        if not self._cars:
            raise ValueError("no car trajectories added")
        fig, ax = plt.subplots(figsize=(7, 5))
        self._setup_axes(ax)

        for xy, color in self._traces:
            ax.plot(xy[:, 0], xy[:, 1], color=color, linewidth=1.0, alpha=0.8)

        car_patches = [self._car_patch(ax, c) for _, c in self._cars]
        bundle_lines = []
        if self._bundle is not None:
            for _ in range(1):
                (ln,) = ax.plot([], [], color=SERIES_COLORS[3], alpha=0.5, lw=0.9)
                bundle_lines.append(ln)

        n_frames = max(s.shape[0] for s, _ in self._cars)
        frames = range(0, n_frames, stride)

        def draw(frame):
            artists = []
            for (states, _), rect in zip(self._cars, car_patches):
                i = min(frame, states.shape[0] - 1)
                px, py, psi = states[i, 0], states[i, 1], states[i, 2]
                rect.set_transform(
                    mtransforms.Affine2D().rotate(psi).translate(px, py)
                    + ax.transData
                )
                artists.append(rect)
            if self._bundle is not None:
                i = min(frame, self._bundle.shape[0] - 1)
                bundle_lines[0].set_data(
                    self._bundle[i, :, 0], self._bundle[i, :, 1]
                )
                artists.extend(bundle_lines)
            return artists

        anim = manimation.FuncAnimation(
            fig, draw, frames=frames, blit=True, interval=1000 // fps
        )
        if save.endswith(".gif"):
            anim.save(save, writer=manimation.PillowWriter(fps=fps), dpi=dpi)
        else:
            anim.save(save, fps=fps, dpi=dpi)
        plt.close(fig)
        return save


def animate_parking(
    states,
    params,
    save: str,
    predictions=None,
    comparison=None,
    parking_spot=(0.0, 0.0),
    fps: int = 12,
    stride: int = 1,
):
    """One-call animation of a closed-loop parking run (the ``exercise5`` pattern,
    ``session4_sol.py:484-488``): main car + optional ghost + prediction bundle."""
    anim = ParkingAnimator(params, parking_spot=parking_spot)
    anim.add_car_trajectory(np.asarray(states), color=TRACE_COLOR)
    anim.trace(np.asarray(states)[:, :2])
    if comparison is not None:
        anim.add_car_trajectory(np.asarray(comparison), color=SERIES_COLORS[2])
    if predictions is not None:
        anim.bundle(predictions)
    return anim.render(save, fps=fps, stride=stride)
