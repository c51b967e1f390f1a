"""Nothing the benchmark loads is JAX or the JAX package (compared by the
whole top-level module name: the port's name begins with the JAX
package's), and the run refuses without a CUDA device."""

import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]

PROBE = """
import json, sys, time
sys.path.insert(0, {repo!r})
from port_bench import control, counts, generator, harness, run, trace
bench = harness.load_json({repo!r} + "/BENCHMARK.json")
for m in bench["per_layer"]:
    harness.load_reader(m["name"])
for w in bench["workloads"]:
    cell = harness.find_cell(w["name"])
    harness.family("systems", cell.config["family"])
    harness.family("reference", cell.config["family"])
harness.run_cell(bench["workloads"][0]["name"], 3, 0.2, True, "cpu", time.perf_counter(),
                 mix_override={{"scenarios": 16, "steps": 3}})
print(json.dumps(run.forbidden_modules()))
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    top = set(json.loads(lines[-1]))
    assert "model_predictive_control_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "model_predictive_control_tpu"}


def test_forbidden_names_are_compared_whole():
    from port_bench import run

    assert run.forbidden_modules(["model_predictive_control_tpu_torch.ops", "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["model_predictive_control_tpu.ops", "jaxlib.xla", "flax"]) == [
        "flax", "jaxlib", "model_predictive_control_tpu"]


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "cruise_n20.fleet128k",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
