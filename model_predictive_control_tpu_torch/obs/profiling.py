"""The program's spans and its profiler hook (port of ``obs/profiling.py``).

:func:`span` marks a part of the closed loop (``loop.step``, ``policy.qp``,
``admm.launch``, ...). With recording off it is one check of a module flag
and returns a shared object that does nothing: it allocates nothing and
reads no clock. Inside :func:`recording` each span that closes appends
``(name, depth, t0_ns, t1_ns, tid)`` to the log, stamped with
:func:`time.time_ns`, which is the clock of ``torch.profiler``'s Chrome
trace: an event's ``ts`` (µs) is ``t_ns / 1e3 - baseTimeNanoseconds / 1e3``
(:func:`trace_events`). ``tid`` is the native id of the thread the span ran
on, and ``depth`` the number of spans open on that thread when it began, so
a span's parent is the nearest earlier one of its thread, of depth one less,
that holds it.

:func:`profile_trace` wraps ``torch.profiler`` so a hot path can be captured
for TensorBoard or Perfetto, the program's spans in the same trace; the CUDA
activity is recorded where a card is.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _Log(list):
    """The spans closed while recording, and for each thread how many are
    open (``open.n``) and its native id (``open.tid``: read once, as it is
    a system call)."""

    def __init__(self):
        super().__init__()
        self.open = threading.local()


class _Span:
    __slots__ = ("name", "log", "depth", "tid", "t0")

    def __init__(self, name: str, log: _Log):
        self.name, self.log = name, log

    def __enter__(self):
        open_ = self.log.open
        try:
            self.depth, self.tid = open_.n, open_.tid
        except AttributeError:  # the thread's first span
            self.depth, self.tid = 0, threading.get_native_id()
            open_.tid = self.tid
        open_.n = self.depth + 1
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.log.open.n = self.depth
        self.log.append((self.name, self.depth, self.t0, t1, self.tid))
        return False


_NOOP = _NoSpan()
_log: _Log | None = None  # the log while recording


def span(name: str):
    """A context manager that records the block as the span ``name`` while
    :func:`recording` is on; otherwise a shared no-op."""
    if _log is None:
        return _NOOP
    return _Span(name, _log)


@contextlib.contextmanager
def recording():
    """Record the spans that close inside the block; yields the log, a list
    of ``(name, depth, t0_ns, t1_ns, tid)`` in the order the spans closed,
    from every thread. The log is the process's: one recording at a time."""
    global _log
    if _log is not None:
        raise RuntimeError("spans are already being recorded")
    _log = _Log()
    try:
        yield _log
    finally:
        _log = None


def trace_events(log, base_ns: int) -> list:
    """The spans of ``log`` as Chrome-trace complete events (``ph`` ``X``,
    category ``user_annotation``) on the clock of a ``torch.profiler`` trace
    whose ``baseTimeNanoseconds`` is ``base_ns``, each on this process and
    the thread it ran on, as the profiler's host events of that thread are."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "user_annotation", "name": name, "pid": pid, "tid": tid,
             "ts": (t0 - base_ns) / 1e3, "dur": (t1 - t0) / 1e3, "args": {"depth": depth}}
            for name, depth, t0, t1, tid in log]


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """Capture a ``torch.profiler`` trace (host and, with a card, device
    activity) into ``logdir`` as a Chrome trace, ``trace.json``, with the
    program's spans recorded meanwhile among its host events (category
    ``user_annotation``); a no-op for ``None``."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=acts) as prof, recording() as log:
        yield
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"] += trace_events(log, int(trace["baseTimeNanoseconds"]))
    with open(path, "w") as f:
        json.dump(trace, f)
