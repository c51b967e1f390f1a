"""The trace reduction on a hand-made trace: device operations assigned to
the innermost span holding their launch, the busy union, idle gaps by what
the host was doing, and the readers on top of it."""

from port_bench import harness
from port_bench.trace import Trace


def _events():
    ann = lambda name, ts, dur: {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
                                 "dur": dur}
    launch = lambda c, ts: {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                            "ts": ts, "dur": 1, "args": {"correlation": c}}
    kernel = lambda c, name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                                       "dur": dur, "args": {"correlation": c}}
    return [
        ann("episode", 0, 100), ann("head", 0, 20), ann("policy", 20, 40), ann("solve", 25, 10),
        ann("plant", 60, 10), {"ph": "X", "cat": "cpu_op", "name": "aten::stack", "ts": 70,
                               "dur": 30},
        launch(1, 5), kernel(1, "draw", 10, 10),  # head: 10-20
        launch(2, 22), kernel(2, "qp_vectors", 22, 3),  # policy glue: 22-25
        launch(3, 26), kernel(3, "admm", 26, 30),  # solve: 26-56
        launch(4, 61), kernel(4, "plant", 61, 4),  # plant: 61-65
        launch(5, 71), kernel(5, "stack", 90, 10),  # the loop: 90-100
    ]


def test_trace_assigns_and_sums():
    tr = Trace(_events())
    assert [o.span for o in tr.ops] == ["head", "policy", "solve", "plant", "episode"]
    assert tr.window == (0.0, 100.0)
    assert abs(tr.busy_s - 57e-6) < 1e-12
    assert abs(tr.device_s("policy") - 33e-6) < 1e-12
    assert abs(tr.device_s("policy", exclude="solve") - 3e-6) < 1e-12
    assert tr.count("episode", exclude="head") == 4
    assert [n for n, _ in tr.top_ops(2)] == ["admm", "draw"]
    assert abs(tr.top_ops(1)[0][1] - 30e-6) < 1e-12
    gaps = dict(tr.idle_gaps())
    # 0-10 in the head, 20-22 and 56-61 in the policy, 25-26 in the solve,
    # 65-90 in the plant's span
    want = {"head": 10e-6, "policy": 7e-6, "solve": 1e-6, "plant": 25e-6}
    assert set(gaps) == set(want)
    assert all(abs(gaps[k] - want[k]) < 1e-12 for k in want)


def test_readers_on_the_trace():
    import torch

    tr = Trace(_events())
    launches = [{"kernel": "admm", "rows": 4, "iters": torch.tensor([10.0, 10.0, 20.0, 20.0]),
                 "flops": lambda: 67e12 * 15e-6, "bytes": 0, "head": False}]
    ctx = harness.Context(tr, launches, episodes=1, steps=1, scenarios=4, device=tr,
                          device_launches=launches)
    read = lambda name: harness.load_reader(name).read(ctx)
    assert abs(read("device_idle_pct") - 43.0) < 1e-9
    assert read("launches_per_step") == 4
    assert abs(read("head_ms") - 0.010) < 1e-12
    assert abs(read("glue_ms_per_step") - 0.003) < 1e-12
    assert abs(read("plant_ms_per_step") - 0.004) < 1e-12
    assert abs(read("admm_roofline") - 50.0) < 1e-9
    assert read("iters_per_solve.admm") == 15.0
    assert abs(read("step_mfu") - 15.0) < 1e-9
    empty = harness.Context(Trace([]), [], episodes=1, steps=1, scenarios=4, device=Trace([]),
                            device_launches=[])
    assert all(harness.load_reader(n).read(empty) is None for n in (
        "device_idle_pct", "launches_per_step", "admm_roofline", "iters_per_solve.admm",
        "step_mfu", "head_ms", "glue_ms_per_step", "plant_ms_per_step"))


def test_a_trace_without_spans_spans_its_device_operations():
    """The device's activity alone: no spans, the window from the first
    device operation to the end of the last, gaps labelled by the runtime
    call under way or as the host outside traced calls."""
    events = [e for e in _events() if e["cat"] in ("kernel", "cuda_runtime")]
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 64,
                   "dur": 5})
    tr = Trace(events)
    assert tr.window == (10.0, 100.0) and all(o.span is None for o in tr.ops)
    assert abs(tr.busy_s - 57e-6) < 1e-12
    gaps = dict(tr.idle_gaps())
    # 20-22, 25-26 and 56-61 between calls; 65-90 in the synchronize
    assert set(gaps) == {"cudaStreamSynchronize", "host outside traced calls"}
    assert abs(gaps["cudaStreamSynchronize"] - 25e-6) < 1e-12
    assert abs(gaps["host outside traced calls"] - 8e-6) < 1e-12
