"""Observability: metrics and JSONL logging, wall-clock timing fenced on the
device, the program's spans and ``torch.profiler`` traces, checkpoint/resume
of long batch sweeps, and the kernels' roofline at the H100's peaks (port of
the JAX package's ``obs/``)."""

from .checkpoint import load_sweep_state, save_sweep_state
from .metrics import MetricsLogger, Timer, summarize_run
from .profiling import profile_trace, recording, span, trace_events
from .roofline import (
    KernelRoofline,
    admm_kernel_roofline,
    al_ilqr_dyn_kernel_roofline,
    al_ilqr_kernel_roofline,
)

__all__ = [
    "MetricsLogger",
    "Timer",
    "summarize_run",
    "save_sweep_state",
    "load_sweep_state",
    "profile_trace",
    "span",
    "recording",
    "trace_events",
    "KernelRoofline",
    "admm_kernel_roofline",
    "al_ilqr_kernel_roofline",
    "al_ilqr_dyn_kernel_roofline",
]
