"""The program's spans (``obs/profiling.py``) on the CPU: off, a shared no-op;
on, each step of the linear closed loop (the kernel's twin behind
``batched_policy(backend="cuda")``) holds its parts in order, and the loop's
answers are those of a run without recording; ``profile_trace`` writes the
spans into its Chrome trace on the profiler's clock; the policy's
``admm_iters`` is the solver's own count."""

import json
import os
import threading

import pytest
import torch

import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch.obs import profile_trace, recording, span, summarize_run
from model_predictive_control_tpu_torch.obs import profiling
from model_predictive_control_tpu_torch.ops.cuda import admm_kernel as K

B, STEPS = 64, 3
STEP_PARTS = ["policy.qp", "admm.prepare", "admm.launch", "admm.finish", "policy.shift",
              "loop.plant"]
ADMM_PARTS = ["admm.prepare", "admm.launch", "admm.finish"]
NAMES = ["loop.step", "loop.plant", "loop.logs", "presolve", "build", *STEP_PARTS[:5]]


def _setup(n=B, horizon=10, iters=200):
    problem = port.session2_problem(N=horizon)
    ctrl = port.make_linear_mpc(problem, solver="admm", iters=iters, dtype=torch.float32,
                                device="cpu")
    gen = torch.Generator().manual_seed(20)
    x0 = torch.stack([torch.empty(n).uniform_(-130.0, -70.0, generator=gen),
                      torch.empty(n).uniform_(10.0, 20.0, generator=gen)], dim=1)
    w = 0.12 * torch.randn(STEPS, n, 2, generator=gen)
    return ctrl, problem.system(torch.float32, "cpu"), x0, w


def _episode(ctrl, system, x0, w, steps=STEPS):
    carry = ctrl.presolve_batch_carry(x0, backend="cuda")
    return port.simulate_batch(x0, system, steps, ctrl.batched_policy(backend="cuda"), carry,
                               batched_dynamics=True, disturbances=w[:steps])


@pytest.fixture(scope="module")
def loops():
    """The same episode without and with recording, and the log."""
    ctrl, system, x0, w = _setup()
    off = _episode(ctrl, system, x0, w)
    with recording() as log:
        on = _episode(ctrl, system, x0, w)
    return off, on, sorted(log, key=lambda s: (s[2], -s[3]))


def _children(log, parent):
    _, depth, t0, t1, tid = parent
    return [s for s in log if s[1] == depth + 1 and t0 <= s[2] and s[3] <= t1 and s[4] == tid]


@pytest.mark.parametrize("name", NAMES)
def test_span_off_is_a_shared_noop(name):
    assert profiling._log is None
    s = span(name)
    assert s is span("another") and s is profiling._NOOP
    with s as entered:
        assert entered is None
    with recording() as log:
        pass
    assert log == []


def test_recording_is_one_at_a_time():
    with recording() as log:
        with pytest.raises(RuntimeError, match="already"):
            with recording():
                pass
        with span("loop.step"):
            with span("loop.plant"):
                pass
    assert [(n, d) for n, d, *_ in log] == [("loop.plant", 1), ("loop.step", 0)]
    assert {s[4] for s in log} == {threading.get_native_id()}
    assert profiling._log is None and span("loop.step") is profiling._NOOP


def test_spans_nest_per_thread():
    """A span closed on another thread (a kernel build on a build thread)
    has that thread's id and depth, whatever is open on this one."""
    ids = []

    def build():
        ids.append(threading.get_native_id())
        with span("build"):
            pass

    with recording() as log:
        with span("loop.step"):
            thread = threading.Thread(target=build)
            thread.start()
            thread.join()
    (b,) = [s for s in log if s[0] == "build"]
    (step,) = [s for s in log if s[0] == "loop.step"]
    assert b[1] == 0 and b[4] == ids[0] != step[4] == threading.get_native_id()
    assert step[1] == 0


@pytest.mark.parametrize("step", range(STEPS))
def test_each_step_holds_its_parts_in_order(loops, step):
    log = loops[2]
    steps = [s for s in log if s[0] == "loop.step"]
    assert len(steps) == STEPS and all(s[1] == 0 for s in steps)
    parts = _children(log, steps[step])
    assert [s[0] for s in parts] == STEP_PARTS
    for a, b in zip(parts, parts[1:]):
        assert a[3] <= b[2]
    assert all(s[2] <= s[3] for s in parts)


def test_presolve_and_logs_spans(loops):
    log = loops[2]
    presolve = [s for s in log if s[0] == "presolve"]
    assert len(presolve) == 1 and presolve[0][1] == 0
    assert [s[0] for s in _children(log, presolve[0])] == ADMM_PARTS
    last_step = [s for s in log if s[0] == "loop.step"][-1]
    (logs,) = [s for s in log if s[0] == "loop.logs"]
    assert logs[1] == 0 and logs[2] >= last_step[3]
    assert {s[0] for s in log} == {"presolve", "loop.step", "loop.logs", *STEP_PARTS}


@pytest.mark.parametrize("field", ["states", "inputs", "logs"])
def test_recording_changes_no_answer(loops, field):
    off, on = getattr(loops[0], field), getattr(loops[1], field)
    if field == "logs":
        assert off.keys() == on.keys() and "admm_iters" in off
        for k in off:
            assert torch.equal(off[k], on[k]), k
    else:
        assert torch.equal(off, on)


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    ctrl, system, x0, w = _setup(n=8, horizon=5, iters=8)
    carry = ctrl.initial_batch_carry(8, device="cpu")
    logdir = tmp_path_factory.mktemp("trace")
    with profile_trace(str(logdir)):
        port.simulate_batch(x0, system, 2, ctrl.batched_policy(backend="cuda"), carry,
                            batched_dynamics=True, disturbances=w[:2])
    return json.loads((logdir / "trace.json").read_text())["traceEvents"]


def _program_spans(events):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] in ("loop.step", "loop.logs", *STEP_PARTS)]


def test_profile_trace_writes_spans_inside_its_window(profiled):
    (window,) = [e for e in profiled if e.get("cat") == "Trace" and e.get("ph") == "X"]
    lo, hi = window["ts"], window["ts"] + window["dur"]
    spans = _program_spans(profiled)
    assert [e["name"] for e in spans].count("loop.step") == 2 and len(spans) == 2 * 7 + 1
    for e in spans:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, e
        assert e["ph"] == "X" and e["args"]["depth"] in (0, 1)


def test_profile_trace_plant_span_holds_the_plants_ops(profiled):
    ops = [e for e in profiled if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    for e in (s for s in _program_spans(profiled) if s["name"] == "loop.plant"):
        end = e["ts"] + e["dur"]
        held = {o["name"] for o in ops
                if o["tid"] == e["tid"] and e["ts"] <= o["ts"] and o["ts"] + o["dur"] <= end}
        assert held & {"aten::matmul", "aten::mm", "aten::addmm"}, held
        assert "aten::add" in held  # the disturbance


def test_trace_events_convert_to_the_trace_clock():
    (e,) = profiling.trace_events([("loop.step", 0, 5_000_250_000, 5_000_251_500, 4242)],
                                  5_000_000_000)
    assert e == {"ph": "X", "cat": "user_annotation", "name": "loop.step", "pid": os.getpid(),
                 "tid": 4242, "ts": 250.0, "dur": 1.5, "args": {"depth": 0}}


@pytest.mark.parametrize("backend", ["cuda", "twin"])
def test_policy_admm_iters_are_the_solvers_count(backend):
    ctrl, _, x0, _ = _setup(n=16, horizon=5)
    carry = ctrl.presolve_batch_carry(x0, backend=backend)
    _, _, aux = ctrl.batched_policy(backend=backend)(x0, 0, carry)
    q, l, u = ctrl.qp.qp_vectors(x0)
    _, ni = K.admm_solve_cuda(ctrl.op, q, l, u, *carry, iters=ctrl.iters, return_iters=True)
    assert aux["admm_iters"].shape == (16,) and torch.equal(aux["admm_iters"], ni)


def test_summarize_run_reports_mean_admm_iters(loops):
    res = loops[0]
    summary = summarize_run(res)
    want = res.logs["admm_iters"].double().mean().item()
    assert summary["admm_iters_mean"] == pytest.approx(want)


@pytest.mark.cuda
def test_profile_trace_on_the_card_holds_each_kernel_launch(tmp_path):
    """On the card the spans share the profiler's clock: every K1 launch's
    runtime call lies inside an ``admm.launch`` span of the exported trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    problem = port.session2_problem(N=20)
    ctrl = port.make_linear_mpc(problem, iters=80, rho=0.035, dtype=torch.float32, device="cuda")
    x0 = _setup(n=4096)[2].cuda()
    system = problem.system(torch.float32, "cuda")
    policy = ctrl.batched_policy(max_rho_moves=0, polish=False, probe_iters=8)

    def run():
        carry = ctrl.presolve_batch_carry(x0, iters_mult=2)
        return port.simulate_batch(x0, system, STEPS, policy, carry, batched_dynamics=True)

    run()
    torch.cuda.synchronize()
    with profile_trace(str(tmp_path)):
        run()
        torch.cuda.synchronize()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    boxes = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "admm.launch"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "admm_tile_kernel" in e["name"]]
    assert len(boxes) == STEPS + 1 and len(kernels) >= STEPS + 1
    for k in kernels:
        call = launch[k["args"]["correlation"]]
        assert any(b["ts"] <= call["ts"] and call["ts"] + call["dur"] <= b["ts"] + b["dur"]
                   for b in boxes), call
