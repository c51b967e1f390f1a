"""Structured metrics: a JSONL sink and device-fenced timing (port of
``obs/metrics.py``).

The per-step telemetry of a closed loop comes out of ``simulate`` /
``simulate_batch`` as stacked tensors (``SimResult.logs``); this module adds
the host-side layer: a run summarized into scalars, timed with the device's
queue drained, and JSONL records a dashboard or a bench driver can read.
"""

from __future__ import annotations

import json
import time
from typing import IO, Any

import numpy as np
import torch


def _tensors(obj) -> list:
    """The tensors in a nest of tuples, lists, dicts and dataclasses."""
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    elif hasattr(obj, "__dataclass_fields__"):
        obj = [getattr(obj, f) for f in obj.__dataclass_fields__]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


class Timer:
    """Wall-clock timer that waits for the device's queued work.

    ``with Timer() as t: out = f(x)``; register outputs with :meth:`fence`
    and the exit synchronizes every CUDA device they live on (tensors on the
    CPU need nothing). Read ``t.elapsed`` (seconds) after the block."""

    def __init__(self):
        self.elapsed: float | None = None
        self._targets: list[Any] = []

    def fence(self, *tensors) -> None:
        self._targets.extend(tensors)

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        for dev in {t.device for t in _tensors(self._targets) if t.is_cuda}:
            torch.cuda.synchronize(dev)
        self.elapsed = time.perf_counter() - self._t0


class MetricsLogger:
    """Append-only JSONL metrics sink.

    Each :meth:`write` emits one line ``{"ts": ..., **record}``; tensors and
    arrays become numbers or lists on the host, so a record never holds a
    device buffer."""

    def __init__(self, path_or_file: str | IO[str]):
        if isinstance(path_or_file, str):
            self._file = open(path_or_file, "a")
            self._owned = True
        else:
            self._file = path_or_file
            self._owned = False

    def write(self, record: dict) -> None:
        coerced = {k: _to_scalar(v) for k, v in record.items()}
        coerced.setdefault("ts", time.time())
        self._file.write(json.dumps(coerced) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._owned:
            self._file.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _to_scalar(v):
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    if isinstance(v, (np.ndarray, np.generic)):
        arr = np.asarray(v)
        return arr.item() if arr.ndim == 0 else arr.tolist()
    return v


def summarize_run(result, per_solve_iters: int | None = None) -> dict:
    """Scalar summary of a ``SimResult`` / ``BatchSimResult``: the solver's
    health (success rate, residual percentiles, the mean of the ADMM
    iterations the kernel executed where the logs hold them) and
    stability."""
    logs = result.logs if isinstance(result.logs, dict) else {}
    host = lambda a: torch.as_tensor(a).detach().cpu().numpy()
    out: dict[str, Any] = {"steps": int(result.inputs.shape[0])}
    if hasattr(result, "unstable"):
        out["unstable_frac"] = float(np.mean(host(result.unstable)))
    if "solver_success" in logs:
        succ = host(logs["solver_success"]).astype(np.float32)
        out["success_rate"] = float(succ.mean())
        out["success_rate_warm"] = float(succ[1:].mean()) if len(succ) > 1 else None
    for key in ("prim_res", "dual_res", "kkt_res", "viol"):
        if key in logs:
            v = host(logs[key]).astype(np.float64)
            out[f"{key}_p50"] = float(np.percentile(v, 50))
            out[f"{key}_p99"] = float(np.percentile(v, 99))
            out[f"{key}_max"] = float(v.max())
    if "admm_iters" in logs:
        out["admm_iters_mean"] = float(host(logs["admm_iters"]).astype(np.float64).mean())
    if per_solve_iters is not None:
        out["solver_iters"] = per_solve_iters
    return out
