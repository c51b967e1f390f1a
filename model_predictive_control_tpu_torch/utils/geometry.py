"""Collision geometry: covering circles and pose transforms (port of
``utils/geometry.py``).

The car rectangle (length l, width w) is covered by ``n_c`` circles of radius
``r = √(d² + w²/4)`` with ``d = l/(2 n_c)``, centred at ``(2k+1)d − l/2``
along the body x-axis; two bodies are clear when ``‖c_v − c_o‖² ≥ (r_v + r_o)²``
for every circle pair.
"""

from __future__ import annotations

import torch

from .device import resolve_device


def cover_circle_offsets(
    length: float, width: float, n_circles: int = 3, device=None
) -> tuple[torch.Tensor, float]:
    """Body-frame circle centres ``(n_c, 2)`` and their common radius.

    The centres are float32, as in the JAX package, so that the kernel's
    geometry constants round the same way in both packages. They lie on
    ``device`` (the card when ``None``)."""
    device = resolve_device(device)
    d = length / (2 * n_circles)
    r = (d**2 + (width**2) / 4.0) ** 0.5
    k = torch.arange(n_circles, dtype=torch.float32, device=device)
    cx = (2.0 * k + 1.0) * d - length / 2.0
    return torch.stack([cx, torch.zeros_like(cx)], dim=1), r


def transform_circles(pose: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """World-frame circle centres for a body at ``pose = (px, py, ψ, ...)``.

    ``pose`` is ``(..., ≥3)`` and ``offsets`` ``(n_c, 2)``; returns
    ``(..., n_c, 2)`` (rotate, then translate)."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    ox, oy = offsets[:, 0], offsets[:, 1]
    x = ox * c - oy * s + pose[..., 0:1]
    y = ox * s + oy * c + pose[..., 1:2]
    return torch.stack([x, y], dim=-1)


def pairwise_sq_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(..., n, 2) × (..., m, 2) → (..., n·m)`` squared distances, row-major
    over ``(a_i, b_j)``: pair ``p = i·m + j``."""
    diff = a[..., :, None, :] - b[..., None, :, :]
    return (diff * diff).sum(dim=-1).flatten(-2)
