"""The benchmark's files: BENCHMARK.json against the contract's shape, every
configuration, cell, traffic mix and metric reader loaded by name, and a
throwaway cell, traffic mix and metric added as new files alone."""

import json
import pathlib
import re
import shutil
import time

import pytest

from port_bench import generator, harness

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    assert all(NAME.match(n) for n in names), names
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + [
            m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", [])) <= {w["name"] for w in BENCH["workloads"]}


def test_command_and_files_lie_under_paths():
    root = BENCH["paths"][0]
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert word.startswith(root + "/") and (REPO / word).exists()
    for c in BENCH["configs"]:
        assert c["file"] == f"{root}/configs/{c['name']}.json" and (REPO / c["file"]).exists()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(workload):
    cell = harness.find_cell(workload)
    assert cell.config["family"] == "linear_mpc"
    assert cell.mix["scenarios"] in (65536, 131072) and cell.mix["steps"] == 50
    assert set(cell.spec["check"]["limits"]) == {"u_gap", "plant_gap"}
    assert {m["name"] for m in cell.per_layer} >= {"device_idle_pct", "step_mfu"}
    harness.family("systems", cell.config["family"])
    harness.family("reference", cell.config["family"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_loads_by_name(metric):
    assert callable(harness.load_reader(metric).read)


@pytest.mark.parametrize("traffic", sorted(p.stem for p in (REPO / "port_bench/traffic").glob("*.json")))
def test_every_traffic_mix_loads_by_name(traffic):
    mix = generator.load(traffic)
    assert mix["scenarios"] > 0 and mix["steps"] > 0


def test_a_cell_a_mix_and_a_metric_added_as_files_alone(tmp_path):
    """A throwaway traffic mix, cell and per-layer metric, written as new
    files in a folder of their own, run through the harness unchanged."""
    for sub in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(REPO / "port_bench" / sub, tmp_path / sub)
    (tmp_path / "traffic" / "tiny.json").write_text(json.dumps({
        "scenarios": 24, "steps": 4, "start": [{"uniform": [-60.0, -30.0]}, {"uniform": [0.0, 5.0]}],
        "disturbance": [{"normal": 0.0}, {"normal": 0.05}]}))
    spec = json.loads((tmp_path / "cells" / "cruise_n20.fleet128k.json").read_text())
    spec.update(traffic="tiny", trace={"episodes": 1})
    (tmp_path / "cells" / "cruise_n20.tiny.json").write_text(json.dumps(spec))
    (tmp_path / "metrics" / "steps_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "cruise_n20.tiny", "config": "cruise_n20",
                               "traffic": "tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "loop",
                               "moves": "solves_per_s", "workloads": ["cruise_n20.tiny"]})
    result, _ = harness.run_cell("cruise_n20.tiny", 5, 0.2, True, "cpu", time.perf_counter(),
                                 bench=bench, root=tmp_path)
    assert result["metrics"]["steps_seen"] == {"value": 4.0, "unit": "steps"}
    assert result["correct"] and list(result)[-1] == "checks"


def test_traffic_parameters_and_a_familys_own_draw(monkeypatch):
    """A mix's per-scenario parameters are drawn from the seed, follow their
    scenarios into the judged sample, and a family's ``Program.draw``, where
    it has one, takes the generator's place."""
    import torch

    from port_bench.systems import linear_mpc

    spec = {"scenarios": 32, "steps": 3, "start": [{"uniform": [-60.0, -30.0]},
                                                   {"uniform": [0.0, 5.0]}],
            "params": {"mass": {"uniform": [1.0, 2.0]}, "mu": {"normal": [0.5, 0.1]}}}
    mix = generator.Mix(spec, "cpu")
    a, b = (mix.draw(generator.generator(9, 0, "cpu")) for _ in range(2))
    assert a["w"] is None and a["mass"].shape == (32,) and a["mu"].shape == (32,)
    assert torch.equal(a["mass"], b["mass"]) and ((1.0 <= a["mass"]) & (a["mass"] < 2.0)).all()
    ep = {"x": torch.zeros(4, 2, 2), "u": torch.zeros(3, 2, 1), "w": None,
          "params": {"mass": torch.tensor([1.5, 1.25])}}
    sample = harness._samples([ep], [3])
    assert sample["mass"].tolist() == [1.5, 1.25] * 3 and sample["w"] is None
    calls = []

    def own_draw(self, mix, gen):
        calls.append(mix.scenarios)
        return mix.draw(gen)

    monkeypatch.setattr(linear_mpc.Program, "draw", own_draw, raising=False)
    harness.run_cell("cruise_n20.fleet128k", 5, 0.1, False, "cpu", time.perf_counter(),
                     mix_override={"scenarios": 16, "steps": 3})
    assert calls and set(calls) == {16}


def test_a_configuration_states_what_the_program_builds():
    from port_bench.systems.linear_mpc import Program

    cfg = harness.find_cell("cruise_n20.fleet128k").config
    for key, value in (("method", "ip"), ("dtype", "float64"), ("tf32", True)):
        bad = dict(cfg, solver=dict(cfg["solver"], **{key: value}))
        with pytest.raises(ValueError, match="float32 ADMM"):
            Program(bad, 3, "cpu")
