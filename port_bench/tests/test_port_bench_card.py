"""A run of each cell on the card, short, through the command the benchmark
names: exit 0, a result line of the contract's keys, correct. Skips without
a CUDA device (decided in the fixture)."""

import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, workload, trace):
    out = subprocess.run([*BENCH["command"], "--workload", workload, "--seed", "2147483999",
                          "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks" and result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    names = {m["name"] for m in (BENCH["per_layer"] if trace else BENCH["end_to_end"])}
    assert set(result["metrics"]) <= names
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    else:
        assert set(result["metrics"]) == names
