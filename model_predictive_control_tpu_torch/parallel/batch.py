"""Scenario-batch helpers (port of ``parallel/batch.py``; only the compaction
key so far)."""

from __future__ import annotations

import torch


def boundary_compaction_key(p_max: float, x0s: torch.Tensor) -> torch.Tensor:
    """Static scenario-compaction sort key for the session-2 family:
    ``(p_max − p) − 3·max(v, 0)``. Small for boundary-activating (long
    iterating) scenarios, so a stable ``torch.argsort`` of it packs them into
    few kernel tiles and lets the per-tile early exit fire for the rest."""
    return (float(p_max) - x0s[:, 0]) - 3.0 * torch.clamp(x0s[:, 1], min=0.0)
