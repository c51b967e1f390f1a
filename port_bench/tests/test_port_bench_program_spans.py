"""The draft readers of the program's spans (``program_spans.py``) on a
hand-made device-only trace: the host's time a step, in all and outside
its runtime calls, K1's host wrapper inside the steps alone, idle
time by program span, and the clock check; then the probe through a small
cell on the CPU."""

import pytest

from port_bench.tests import program_spans as P


def _span(name, depth, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "args": {"depth": depth}}


def _trace():
    call = lambda c, ts, dur=1: {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                                 "ts": ts, "dur": dur, "args": {"correlation": c}}
    kernel = lambda c, name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                                       "dur": dur, "args": {"correlation": c}}
    events = [
        call(1, 3), kernel(1, "admm_tile_kernel<5, 16>", 4, 5),  # the presolve: 4-9
        call(2, 11), kernel(2, "qp", 12, 2),  # 12-14
        call(3, 19, 4), kernel(3, "admm_tile_kernel<5, 16>", 20, 10),  # a call that waited
        call(4, 25), kernel(4, "finish", 30, 3),
        call(5, 31), kernel(5, "shift", 33, 2),  # busy 20-35
        call(6, 35), kernel(6, "plant", 38, 2),  # 38-40
        call(7, 62), kernel(7, "stack", 64, 2),  # outside every span: 64-66
    ]
    spans = [
        _span("presolve", 0, 0, 10), _span("admm.launch", 1, 2, 4),
        _span("loop.step", 0, 10, 30), _span("policy.qp", 1, 10, 4),
        _span("admm.prepare", 1, 14, 4), _span("admm.launch", 1, 18, 6),
        _span("admm.finish", 1, 24, 6), _span("policy.shift", 1, 30, 4),
        _span("loop.plant", 1, 34, 6),
    ]
    return events, spans


def test_host_time_a_step_and_outside_runtime_calls():
    r = P.readings(*_trace())
    assert r["steps"] == 1 and r["runtime_calls_per_step"] == 5
    assert r["runtime_call_us_median"] == 1
    assert r["host_ms_per_step"] == pytest.approx(0.030)
    assert r["self_ms_per_step"] == pytest.approx(0.022)  # less the five calls' 8 µs
    # the step's admm spans alone: the presolve's launch lies outside every step
    assert r["host_ms_per_step.admm"] == pytest.approx(0.016)
    assert r["self_ms_per_step.admm"] == pytest.approx(0.011)
    assert r["host_ms_by_span"] == pytest.approx(
        {"policy.qp": 0.004, "admm.prepare": 0.004, "admm.launch": 0.006, "admm.finish": 0.006,
         "policy.shift": 0.004, "loop.plant": 0.006})
    assert r["self_ms_by_span"]["admm.launch"] == pytest.approx(0.002)


def test_idle_by_program_span():
    r = P.readings(*_trace())
    # window 4-66; gaps 9-12 (the presolve), 14-20 (admm.prepare), 35-38
    # (loop.plant), 40-64 (outside)
    assert r["device_idle_pct"] == pytest.approx(100 * 36 / 62)
    assert r["idle_program_pct"] == pytest.approx(100 * 12 / 62)
    assert r["idle_ms_by_span"] == pytest.approx(
        {"outside program spans": 0.024, "admm.prepare": 0.006, "presolve": 0.003,
         "loop.plant": 0.003})
    assert r["idle_small_gap_pct"] == pytest.approx(100 * 6 / 36)
    assert r["idle_gap_us_median"] == 4.5
    # the breakdown the harness stores, with the spans among the host's
    # events: the innermost host event at each gap's start
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"host outside traced calls": 24e-6, "admm.prepare": 6e-6, "presolve": 3e-6,
         "cudaLaunchKernel": 3e-6})


@pytest.mark.parametrize("shift, held, off", [(0, 2, 0.0), (1.5, 1, 0.5)])
def test_clock_check(shift, held, off):
    events, spans = _trace()
    spans[5] = _span("admm.launch", 1, 18 + shift, 6)  # the step's launch span moved later
    r = P.readings(events, spans)
    assert r["clock"] == {"admm_launches": 2, "held": held, "largest_off_us": off}
    assert r["host_lead_ms"] == pytest.approx(0.001)


def test_no_step_in_the_window():
    events, spans = _trace()
    assert P.readings(events, spans[:2]) == {"steps": 0}


@pytest.mark.parametrize("trace", [1, 0])
def test_probe_runs_a_cell_on_the_cpu(trace):
    small = {"scenarios": 16, "steps": 3}
    if trace:
        out = P.traced("cruise_n20.fleet128k", 2**31 + 11, "cpu", 1, mix_override=small)
        assert len(out["on_s"]) == len(out["off_s"]) == 1
        assert out["span_on_ns"] > out["span_off_ns"] > 0
        assert "spans" in out and out["result"]["correct"]
    else:
        out = P.untraced("cruise_n20.fleet128k", 2**31 + 11, 0.5, "cpu", mix_override=small)
        assert out["window"] == dict.fromkeys(P.STALL_KEYS, 0) and out["builds"] == {}
