"""Profiler hook (port of ``obs/profiling.py``): :func:`profile_trace`
wraps ``torch.profiler`` so a hot path can be captured for TensorBoard or
Perfetto; the CUDA activity is recorded where a card is."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """Capture a ``torch.profiler`` trace (host and, with a card, device
    activity) into ``logdir`` as a Chrome trace; a no-op for ``None``."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
