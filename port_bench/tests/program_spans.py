"""The program's own spans on a cell: the draft of the readers a later
change to the harness moves into ``port_bench/metrics/``, and the probe that
reads them on the card until then.

The port marks its closed loop from inside (``obs.profiling.span``):
``loop.step`` holds ``policy.qp``, ``admm.prepare``, ``admm.launch``,
``admm.finish``, ``policy.shift`` and ``loop.plant``; ``presolve``,
``loop.logs`` and ``build`` lie outside the steps. The harness does not
record them yet. :func:`readings` reads, from the device-only trace of a
traced run with the spans added (:func:`with_spans`):

- ``host_ms_per_step``: the mean host ms of a ``loop.step`` span;
  ``host_ms_per_step.admm``: of the ``admm.*`` spans inside the steps (the
  presolve's left out); ``host_ms_by_span``: each step part's;
- ``self_ms_*``: the same less the time in CUDA runtime calls, where the
  host waits when it runs ahead of the card and the launch queue is full
  (the span's length then reads the card's pace); with
  ``runtime_calls_per_step`` and ``runtime_call_us_median`` they bound the
  host's own cost of enqueuing a step;
- ``idle_program_pct``: the device's idle time whose gap began inside a
  program span, over the window; ``idle_ms_by_span``: the idle time by the
  innermost program span at each gap's start; ``idle_small_gap_pct``: the
  share of idle time in gaps of at most ``SMALL_GAP_US``; ``host_lead_ms``:
  the median time from K1's launch call to the kernel's start;
- ``clock``: every ``admm_tile_kernel`` launch call inside an
  ``admm.launch`` span, the largest distance outside one (µs).

Run on the card, from the root of a checkout::

    python3 port_bench/tests/program_spans.py --workload <cell> --seed <n> --trace 1
    python3 port_bench/tests/program_spans.py --workload <cell> --seed <n> --trace 0

``--trace 1`` runs the cell's traced run with its device-only pass repeated
``--repeats`` times with recording off and on, in turns (the cost of
recording: the episode's time on against off), then once recorded as the
run's own pass, whose breakdown then labels idle gaps with the program's
spans; prints one JSON line with the readings. ``--trace 0`` runs the
untraced run of ``--seconds`` and prints the allocator's counters and the
kernel builds over the measured window (read at the harness's synchronizes,
outside the window).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import pathlib
import statistics
import sys
import tempfile
import time
import timeit

T0 = time.perf_counter()
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from model_predictive_control_tpu_torch.obs import profiling  # noqa: E402
from port_bench import harness  # noqa: E402
from port_bench.trace import Trace  # noqa: E402

STEP_PARTS = ("policy.qp", "admm.prepare", "admm.launch", "admm.finish", "policy.shift",
              "loop.plant")
ADMM = ("admm.prepare", "admm.launch", "admm.finish")
SMALL_GAP_US = 5.0
STALL_KEYS = ("num_device_alloc", "num_alloc_retries", "num_sync_all_streams")


def with_spans(raw: dict, log) -> list:
    """The program's spans of ``log`` as events on the clock of the exported
    trace ``raw``."""
    return profiling.trace_events(log, int(raw["baseTimeNanoseconds"]))


def _runtime_calls(events) -> list:
    return sorted((float(e["ts"]), float(e["dur"])) for e in events
                  if e.get("cat") == "cuda_runtime" and "dur" in e)


def _inside(calls, starts, s0, s1) -> list:
    i, j = bisect.bisect_left(starts, s0), bisect.bisect_right(starts, s1)
    return [d for t, d in calls[i:j] if t + d <= s1]


def readings(events: list, spans: list) -> dict:
    """The readings above, from a device-only trace's ``events`` and the
    program's ``spans`` (Chrome events, on the trace's clock)."""
    tr = Trace(events + spans)
    lo, hi = tr.window
    inwin = sorted((s for s in spans if lo <= s["ts"] and s["ts"] + s["dur"] <= hi),
                   key=lambda s: (s["ts"], -s["dur"]))
    steps = [(s["ts"], s["ts"] + s["dur"]) for s in inwin if s["name"] == "loop.step"]
    n = len(steps)
    out = {"steps": n}
    if not n:
        return out
    calls = _runtime_calls(events)
    cstarts = [c[0] for c in calls]
    median_call = statistics.median(d for _, d in calls) if calls else 0.0
    firsts = [s[0] for s in steps]

    def in_step(s):
        i = bisect.bisect_right(firsts, s["ts"]) - 1
        return i >= 0 and s["ts"] + s["dur"] <= steps[i][1]

    def host_ms(group):
        total = sum(s["dur"] for s in group)
        runtime = sum(d for s in group for d in _inside(calls, cstarts, s["ts"], s["ts"] + s["dur"]))
        return 1e-3 * total / n, 1e-3 * (total - runtime) / n

    out["host_ms_per_step"], out["self_ms_per_step"] = host_ms(
        [s for s in inwin if s["name"] == "loop.step"])
    out["host_ms_per_step.admm"], out["self_ms_per_step.admm"] = host_ms(
        [s for s in inwin if s["name"] in ADMM and in_step(s)])
    out["host_ms_by_span"], out["self_ms_by_span"] = {}, {}
    for name in STEP_PARTS:
        out["host_ms_by_span"][name], out["self_ms_by_span"][name] = host_ms(
            [s for s in inwin if s["name"] == name])
    out["runtime_calls_per_step"] = sum(
        len(_inside(calls, cstarts, a, b)) for a, b in steps) / n
    out["runtime_call_us_median"] = median_call

    busy = tr.busy_intervals()
    edges = [lo] + [x for b in busy for x in b] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    window_us = hi - lo
    ordered = sorted(spans, key=lambda s: (s["ts"], -s["dur"]))
    sstarts = [s["ts"] for s in ordered]
    by_span, in_program = {}, 0.0
    for a, b in gaps:
        i = bisect.bisect_right(sstarts, a)
        holders = [s for s in ordered[max(0, i - 64):i] if a < s["ts"] + s["dur"]]
        label = (max(holders, key=lambda s: s["args"]["depth"])["name"] if holders
                 else "outside program spans")
        in_program += (b - a) if holders else 0.0
        by_span[label] = by_span.get(label, 0.0) + 1e-3 * (b - a)
    idle_us = sum(b - a for a, b in gaps)
    out["device_idle_pct"] = 100.0 * idle_us / window_us
    out["idle_program_pct"] = 100.0 * in_program / window_us
    out["idle_ms_by_span"] = dict(sorted(by_span.items(), key=lambda p: -p[1]))
    out["idle_small_gap_pct"] = (100.0 * sum(b - a for a, b in gaps if b - a <= SMALL_GAP_US)
                                 / idle_us if idle_us else None)
    out["idle_gap_us_median"] = statistics.median(b - a for a, b in gaps) if gaps else None
    out["idle_gaps"] = tr.idle_gaps()

    launch = {e["args"]["correlation"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    boxes = sorted((s["ts"], s["ts"] + s["dur"]) for s in spans if s["name"] == "admm.launch")
    bstarts = [b[0] for b in boxes]
    held, worst, lead = 0, 0.0, []
    for e in events:
        if e.get("cat") != "kernel" or "admm_tile_kernel" not in e.get("name", ""):
            continue
        call = launch.get(e.get("args", {}).get("correlation"))
        if call is None:
            continue
        lead.append(1e-3 * (float(e["ts"]) - call[0]))
        i = bisect.bisect_right(bstarts, call[0])
        off = min((max(0.0, s - call[0], call[1] - t) for s, t in boxes[max(0, i - 2):i + 1]),
                  default=float("inf"))
        held += off == 0.0
        worst = max(worst, off)
    out["host_lead_ms"] = statistics.median(lead) if lead else None
    out["clock"] = {"admm_launches": len(lead), "held": held, "largest_off_us": worst}
    return out


def _pass(runner, first, n_eps, acts, record):
    """``harness._profiled`` with the spans recorded (``record``): the
    episodes, the exported trace and the log."""
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        sched = torch.profiler.schedule(wait=0, warmup=1, active=n_eps, repeat=1)
        rec = profiling.recording() if record else contextlib.nullcontext([])
        with rec as log, torch.profiler.profile(
                activities=acts, schedule=sched,
                on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
            episodes = []
            for k in range(first, first + n_eps + 1):
                episodes.append(runner.episode(k))
                if k in (first, first + n_eps):
                    harness._sync(runner.device)
                prof.step()
        return episodes, json.loads(path.read_text()), list(log)


def _episode_s(raw, n_eps) -> float:
    tr = Trace(raw["traceEvents"])
    if tr.window_s:
        return tr.window_s / n_eps
    (window,) = [e for e in raw["traceEvents"] if e.get("cat") == "Trace" and e.get("ph") == "X"]
    return 1e-6 * window["dur"] / n_eps  # no device activity (the CPU)


def traced(workload, seed, device, repeats, mix_override=None) -> dict:
    report = {"on_s": [], "off_s": []}
    real = harness._profiled

    def profiled(runner, first, n_eps, acts):
        if report.get("spans") is not None:  # the pass with the host's activity
            return real(runner, first, n_eps, acts)
        # the comparison passes without the harness's launch records
        wrapped = [(m, a, getattr(m, a)) for m, a in runner.program.kernel_entries]
        for m, a, fn in wrapped:
            setattr(m, a, fn.__kwdefaults__["_fn"])
        try:
            for _ in range(repeats):
                for record in (False, True):
                    _, raw, _ = _pass(runner, first, n_eps, acts, record)
                    report["on_s" if record else "off_s"].append(_episode_s(raw, n_eps))
        finally:
            for m, a, fn in wrapped:
                setattr(m, a, fn)
        episodes, raw, log = _pass(runner, first, n_eps, acts, True)
        spans = with_spans(raw, log)
        report["spans"] = readings(raw["traceEvents"], spans)
        return episodes, Trace(raw["traceEvents"] + spans)

    harness._profiled = profiled
    try:
        result, _ = harness.run_cell(workload, seed, 10.0, True, device, T0,
                                     mix_override=mix_override)
    finally:
        harness._profiled = real
    on, off = report["on_s"], report["off_s"]
    report["recording_cost_pct"] = 100.0 * (statistics.median(on) / statistics.median(off) - 1)
    g = {"span": profiling.span}
    with profiling.recording():
        report["span_on_ns"] = min(timeit.repeat('with span("loop.step"): pass', globals=g,
                                                 number=100_000, repeat=3)) / 100_000 * 1e9
    report["span_off_ns"] = min(timeit.repeat('with span("loop.step"): pass', globals=g,
                                              number=200_000, repeat=3)) / 200_000 * 1e9
    report["span_call_off_ns"] = min(timeit.repeat('span("loop.step")', globals=g,
                                                   number=200_000, repeat=3)) / 200_000 * 1e9
    report["result"] = {k: result[k] for k in ("correct", "metrics", "breakdown", "device")}
    return report


def untraced(workload, seed, seconds, device, mix_override=None) -> dict:
    """The untraced run with the allocator's counters and the builds read at
    the harness's synchronizes: after the warm-up, before the window, after
    it."""
    from model_predictive_control_tpu_torch.ops.cuda import _build

    snaps, real = [], harness._sync

    def sync(dev):
        real(dev)
        stats = torch.cuda.memory_stats(dev) if dev.type == "cuda" else {}
        snaps.append(({k: stats.get(k, 0) for k in STALL_KEYS}, dict(_build.BUILD_SECONDS)))

    harness._sync = sync
    try:
        result, _ = harness.run_cell(workload, seed, seconds, False, device, T0,
                                     mix_override=mix_override)
    finally:
        harness._sync = real
    (a, built_a), (b, built_b) = snaps[1], snaps[2]
    return {"window": {k: b[k] - a[k] for k in STALL_KEYS},
            "builds": {k: v for k, v in built_b.items() if k not in built_a},
            "result": {k: result[k] for k in ("correct", "metrics", "device")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if args.trace:
        out = traced(args.workload, args.seed, device, args.repeats)
    else:
        out = untraced(args.workload, args.seed, args.seconds, device)
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    print(json.dumps({"workload": args.workload, "seed": args.seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
