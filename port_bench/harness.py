"""The benchmark's harness: one run of one cell.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by name:

- ``BENCHMARK.json`` (the repository's root): the cells, their
  configuration and traffic, the metrics and which cells report them;
- ``cells/<cell>.json``: the cell's configuration and traffic (as in
  ``BENCHMARK.json``), the judge's sample and its limits, the traced
  episodes;
- ``configs/<config>.json``: the configuration, its ``family`` naming
  ``systems/<family>.py`` (drives the port) and ``reference/<family>.py``
  (the plain reference that judges it);
- ``traffic/<traffic>.json``: read by :mod:`.generator` (or by the
  family's own ``systems/<family>.py::Program.draw``, where it has one);
- ``metrics/<metric>.py``: a reader, ``read(ctx)``, of one per-layer metric.

A run: set-up (the port, its kernel library from the build cache, the
controller, one warm-up episode at the cell's shapes), then closed-loop
episodes back to back for ``seconds`` (``trace=False``; CUDA events at every
step boundary, no synchronize between steps) or, with ``trace=True``, a few
episodes under ``torch.profiler`` twice: with the device's activity alone
(the host runs as it does untraced: the device's busy and idle time), then
with the host's as well (the benchmark's spans, to which each device
operation is assigned); then the judge on a sample of the answers the window
produced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import tempfile
import time

import numpy as np
import torch

from . import generator
from .trace import Trace

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent


def load_json(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict  # cells/<name>.json
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<traffic>.json
    per_layer: list  # BENCHMARK.json's per-layer metrics this cell reports


def find_cell(name: str, bench: dict | None = None, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` with its files, from ``bench`` (the repository's
    ``BENCHMARK.json`` when ``None``) and the folders under ``root``."""
    bench = load_json(REPO / "BENCHMARK.json") if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = load_json(root / "cells" / f"{name}.json")
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"cells/{name}.json has {key} {spec[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    config = load_json(root / "configs" / f"{entry['config']}.json")
    mix = generator.load(entry["traffic"], root / "traffic")
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return Cell(name, spec, config, mix, per_layer)


def load_reader(metric: str, root: pathlib.Path = ROOT):
    """The reader module of ``metrics/<metric>.py`` (a name may hold dots)."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family(kind: str, name: str):
    """``systems/<name>.py`` or ``reference/<name>.py`` of a configuration's
    family."""
    return importlib.import_module(f"{__package__}.{kind}.{name}")


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the host's clock (CPU runs,
    which time nothing that is reported)."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return 1e3 * (other.t - self.t)


def _event(device):
    if device.type != "cuda":
        return _HostEvent()
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Runner:
    """Runs a cell's episodes through the program, recording a CUDA event at
    every step boundary and keeping the sampled rows of every episode."""

    def __init__(self, cell: Cell, program, mix: generator.Mix, seed: int, device):
        self.cell, self.program, self.mix, self.seed = cell, program, mix, seed
        self.device = device
        self.span = lambda name: contextlib.nullcontext()  # see _instrumented
        self.in_head = False
        self.k = 0  # the episode running

    def episode(self, k: int) -> dict:
        self.k = k
        gen = generator.generator(self.seed, k, self.device)
        span, program, dev = self.span, self.program, self.device
        draw_fn = getattr(program, "draw", None)
        bounds = []

        def policy(x, t, carry):
            bounds.append(_event(dev))
            with span("policy"):
                return program.policy(x, t, carry)

        def plant(x, u):
            with span("plant"):
                return program.plant(x, u)

        with span("episode"):
            with span("head"):
                self.in_head = True
                draw = draw_fn(self.mix, gen) if draw_fn else self.mix.draw(gen)
                draw, carry = program.head(draw)
                self.in_head = False
            res = program.episode(draw, carry, policy, plant)
            bounds.append(_event(dev))
        rows = torch.randperm(self.mix.scenarios, generator=gen, device=dev)
        rows = rows[: int(self.cell.spec["check"]["rows_per_episode"])]
        ok = res.logs["solver_success"]
        w = draw["w"]
        return {
            "bounds": bounds,
            "fails": (~ok).sum(1),
            "x": res.states[:, rows],
            "u": res.inputs[:, rows],
            "w": None if w is None else w[:, rows],
            "params": {k: v[rows] for k, v in draw.items() if k not in ("x0", "w")},
        }


@contextlib.contextmanager
def _instrumented(program, runner: Runner, spans: bool):
    """Records each kernel launch (``program.launch_record``) while the block
    runs and, with ``spans``, puts the benchmark's spans around the
    episode's parts and the ``solve`` span around the program's solve
    entry."""
    table, key = program.solve_entry
    solve = table[key]
    launches = []

    def traced_solve(*args, **kw):
        with torch.profiler.record_function("solve"):
            return solve(*args, **kw)

    saved = []
    for module, attr in program.kernel_entries:
        fn = getattr(module, attr)

        def recorded(*args, _fn=fn, **kw):
            out = _fn(*args, **kw)
            launches.append(dict(program.launch_record(args, kw, out), head=runner.in_head,
                                 episode=runner.k))
            return out

        saved.append((module, attr, fn))
        setattr(module, attr, recorded)
    if spans:
        table[key] = traced_solve
        runner.span = torch.profiler.record_function
    try:
        yield launches
    finally:
        table[key] = solve
        runner.span = lambda name: contextlib.nullcontext()
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def _profiled(runner: Runner, first: int, n_eps: int, acts: list) -> tuple[list, Trace]:
    """Episodes ``first .. first + n_eps`` under ``torch.profiler`` with the
    activities ``acts``: the first warms the profiler up and is not
    recorded. Returns the episodes and the recorded ones' trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        sched = torch.profiler.schedule(wait=0, warmup=1, active=n_eps, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched,
                                    on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                                    ) as prof:
            episodes = []
            for k in range(first, first + n_eps + 1):
                episodes.append(runner.episode(k))
                if k in (first, first + n_eps):
                    _sync(runner.device)
                prof.step()
        return episodes, Trace(json.loads(path.read_text())["traceEvents"])


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the trace with the benchmark's spans
    and the kernel launches its window made (``launch_record`` dicts with
    ``head``), the window's size (each traced window has as many episodes),
    and the trace of the device's activity alone (``device``, the host
    unslowed) with its launches (``device_launches``)."""

    trace: Trace
    launches: list
    episodes: int
    steps: int  # closed-loop steps in a traced window
    scenarios: int
    device: Trace | None = None
    device_launches: list | None = None


def _samples(episodes: list, done: list) -> dict:
    """The judged answers of the steps each episode completed in the window,
    one row a step and scenario: ``x``, ``xn`` (the next state), ``u``,
    ``w`` (``None`` without a disturbance) and each drawn parameter."""
    parts = {}
    for ep, n in zip(episodes, done):
        if n == 0:
            continue
        nx, rows = ep["x"].shape[-1], ep["x"].shape[1]
        row = {"x": ep["x"][:n].reshape(-1, nx), "xn": ep["x"][1:n + 1].reshape(-1, nx),
               "u": ep["u"][:n].reshape(-1, ep["u"].shape[-1])}
        if ep["w"] is not None:
            row["w"] = ep["w"][:n].reshape(-1, nx)
        for k, v in ep["params"].items():
            row[k] = v.expand(n, rows, *v.shape[1:]).reshape(n * rows, *v.shape[1:])
        for k, v in row.items():
            parts.setdefault(k, []).append(v)
    sample = {k: torch.cat(v) for k, v in parts.items()}
    sample.setdefault("w", None)
    return sample


def judge(cell: Cell, sample: dict, seed: int, device) -> dict:
    """The reference's readings of at most ``check.max_solves`` answers,
    drawn from the seed."""
    cap = int(cell.spec["check"]["max_solves"])
    if sample["x"].shape[0] > cap:
        gen = generator.generator(seed, -2, sample["x"].device)
        pick = torch.randperm(sample["x"].shape[0], generator=gen, device=sample["x"].device)[:cap]
        sample = {k: None if v is None else v[pick] for k, v in sample.items()}
    ref = family("reference", cell.config["family"])
    return ref.judge(cell.config, sample, device)


def checks_of(cell: Cell, readings: dict) -> tuple[bool, dict]:
    """``correct`` and each compared reading beside its limit."""
    limits = cell.spec["check"]["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             bench: dict | None = None, root: pathlib.Path = ROOT,
             mix_override: dict | None = None) -> tuple[dict, dict]:
    """One run of the cell ``name``: returns the result line (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` with
    ``trace``, ``checks`` last) and what is printed before it (``info``).
    ``t0`` is the process's start on ``time.perf_counter``'s clock;
    ``mix_override`` replaces traffic keys (the CPU tests' small fleets)."""
    device = torch.device(device)
    cell = find_cell(name, bench, root)
    spec = dict(cell.mix, **(mix_override or {}))
    mix = generator.Mix(spec, device)
    built = time.perf_counter()
    program = family("systems", cell.config["family"]).Program(cell.config, mix.steps, device)
    runner = Runner(cell, program, mix, seed, device)
    runner.episode(-1)  # warm-up at the cell's shapes
    _sync(device)
    info = {"program_setup_s": time.perf_counter() - built}

    if trace:
        n_eps = int(cell.spec["trace"]["episodes"])
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # the launch records a traced pass keeps grow the allocator's cache:
        # grown once here, outside the profiler, the traced passes reuse it
        # instead of waiting in cudaMalloc inside their windows
        with _instrumented(program, runner, spans=False):
            for k in range(n_eps + 1):
                runner.episode(k)
            _sync(device)
        # then the device's activity alone (on the CPU, which has none, the
        # host's), then with the host's, which is what records the spans
        first, second = n_eps + 1, 2 * n_eps + 2
        with _instrumented(program, runner, spans=False) as dev_launches:
            episodes, dev_tr = _profiled(runner, first, n_eps, acts[-1:])
        with _instrumented(program, runner, spans=True) as launches:
            more, tr = _profiled(runner, second, n_eps, acts)
        episodes += more
        done = ([0] + [mix.steps] * n_eps) * 2
        ctx = Context(tr, [r for r in launches if r["episode"] > second], n_eps,
                      n_eps * mix.steps, mix.scenarios, dev_tr,
                      [r for r in dev_launches if r["episode"] > first])
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        counted_steps = 2 * n_eps * mix.steps
        info.update(episode_s_device_traced=dev_tr.window_s / n_eps,
                    episode_s_span_traced=tr.window_s / n_eps)
    else:
        _sync(device)
        t_start = time.perf_counter()
        e0 = _event(device)
        episodes, k = [], 0
        while True:
            episodes.append(runner.episode(k))
            k += 1
            if time.perf_counter() - t_start >= seconds:
                break
        _sync(device)
        end_ms = 1e3 * seconds
        step_ms, done = [], []
        for ep in episodes:
            t = [e0.elapsed_time(b) for b in ep["bounds"]]
            n = sum(1 for v in t[1:] if v <= end_ms)
            done.append(n)
            step_ms += [t[i + 1] - t[i] for i in range(n)]
        counted_steps = len(step_ms)
        metrics = {
            "solves_per_s": {"value": counted_steps * mix.scenarios / seconds, "unit": "solves/s"},
            "step_ms_p95": {"value": float(np.percentile(step_ms, 95)), "unit": "ms"},
            "setup_s": {"value": t_start - t0, "unit": "s"},
        }
        info.update(episodes=len(episodes), steps=counted_steps,
                    step_ms_median=float(np.median(step_ms)))

    failed = sum(int(ep["fails"][:n].sum()) for ep, n in zip(episodes, done))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    result = {"correct": False, "attempted": counted_steps * mix.scenarios, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = dev_tr.busy_s, dev_tr.window_s
        result["breakdown"] = {"device_ops": dev_tr.top_ops(), "idle_gaps": dev_tr.idle_gaps()}

    samples = _samples(episodes, done)
    del episodes, runner, program
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = judge(cell, samples, seed, device)
    result["correct"], result["checks"] = checks_of(cell, readings)
    info["readings"] = readings
    return result, info
