"""Reduction of a ``torch.profiler`` trace (its Chrome-trace events) to what
the per-layer readers read.

Device operations are the events of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset``. Each is tied by its ``correlation`` id to the host's runtime
call that launched it, and assigned to the innermost of the benchmark's
spans (``user_annotation`` events, made by ``record_function``) whose host
range holds that launch. The window is the union of the ``episode`` spans
and the device operations they launched; in a trace without spans (the
device's activity alone), from the first device operation to the end of the
last.
"""

from __future__ import annotations

import bisect
import dataclasses

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
# the benchmark's spans, outermost first
SPANS = ("episode", "head", "policy", "solve", "plant")
NAME_CHARS = 120


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float  # µs, on the trace's clock
    end: float
    span: str | None  # innermost benchmark span holding the launch
    spans: tuple  # every benchmark span holding the launch


class Trace:
    def __init__(self, events: list):
        spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") in SPANS
                 and "dur" in e]
        self.spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                             for e in spans))
        launch_ts = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
                launch_ts[e["args"]["correlation"]] = float(e["ts"])
        self.ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            ts = launch_ts.get(e.get("args", {}).get("correlation"))
            holding = () if ts is None else tuple(s for s in self.spans if s[0] <= ts <= s[1])
            names = tuple(s[2] for s in sorted(holding, key=lambda s: SPANS.index(s[2])))
            self.ops.append(DeviceOp(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                     names[-1] if names else None, names))
        self.ops.sort(key=lambda o: o.start)
        host = [e for e in events if e.get("ph") == "X" and "dur" in e
                and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime", "python_function")]
        # by start, the longer first, so that the innermost of events that
        # start together comes last
        self.host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                            for e in host), key=lambda h: (h[0], -h[1]))
        episodes = [s for s in self.spans if s[2] == "episode"]
        ends = [s[1] for s in episodes] + [o.end for o in self.ops if "episode" in o.spans]
        if episodes:
            self.window = (episodes[0][0], max(ends))
        elif self.ops:
            self.window = (self.ops[0].start, max(o.end for o in self.ops))
        else:
            self.window = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return 1e-6 * (self.window[1] - self.window[0])

    def busy_intervals(self) -> list:
        """The union of device operations inside the window, as sorted
        disjoint ``(start, end)`` pairs."""
        lo, hi = self.window
        merged = []
        for o in self.ops:
            s, e = max(o.start, lo), min(o.end, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return 1e-6 * sum(e - s for s, e in self.busy_intervals())

    def device_s(self, span: str, exclude: str | None = None) -> float:
        """Device seconds of the operations launched inside ``span`` (and
        not inside ``exclude``)."""
        return 1e-6 * sum(o.end - o.start for o in self.ops
                          if span in o.spans and (exclude is None or exclude not in o.spans))

    def count(self, span: str | None = None, exclude: str | None = None) -> int:
        return sum(1 for o in self.ops if (span is None or span in o.spans)
                   and (exclude is None or exclude not in o.spans))

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations that took most time, by name (cut
        to :data:`NAME_CHARS` characters: templated kernel names run long)."""
        total = {}
        for o in self.ops:
            name = o.name[:NAME_CHARS]
            total[name] = total.get(name, 0.0) + 1e-6 * (o.end - o.start)
        return sorted(([n, t] for n, t in total.items()), key=lambda p: -p[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time inside the window, summed by what the host
        was doing when each gap began (its innermost host event), the ``k``
        largest."""
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for b in busy for x in b] + [hi]
        starts = [h[0] for h in self.host]
        total = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            i = bisect.bisect_right(starts, a)
            label = "host outside traced calls"
            for s, e, name in reversed(self.host[max(0, i - 200):i]):
                if s <= a < e:
                    label = name
                    break
            total[label] = total.get(label, 0.0) + 1e-6 * (b - a)
        return sorted(([n, t] for n, t in total.items()), key=lambda p: -p[1])[:k]
