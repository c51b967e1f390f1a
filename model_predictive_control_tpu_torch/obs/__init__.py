"""Observability: metrics and JSONL logging, wall-clock timing fenced on the
device, ``torch.profiler`` traces, and checkpoint/resume of long batch
sweeps (port of the JAX package's ``obs/`` but ``roofline.py``)."""

from .checkpoint import load_sweep_state, save_sweep_state
from .metrics import MetricsLogger, Timer, summarize_run
from .profiling import profile_trace

__all__ = [
    "MetricsLogger",
    "Timer",
    "summarize_run",
    "save_sweep_state",
    "load_sweep_state",
    "profile_trace",
]
