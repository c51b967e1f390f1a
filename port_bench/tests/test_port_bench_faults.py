"""``correct`` against the faults a cell can have, and against the control.

Each fault is planted underneath the timed path (the port's CPU twin), the
rest of a run is driven as on the card (the harness's look for a chip
skipped), and ``correct`` has to come out false:

- a step that returns its state unchanged (the plant);
- half of the batch left out (the solver's second half of rows never
  solved: their answers stay zero);
- an answer altered where it is produced (the solve entry's first input of
  every seventh scenario moved by a quarter of the input range).

A cell on one chip has no exchange between chips to leave out. The control,
the plain reference in TF32 put in the program's place, has to come out not
correct too (its emulated TF32 runs on the CPU as on the card)."""

import dataclasses
import time

import pytest

from model_predictive_control_tpu_torch.models.linear import LinearSystem
from model_predictive_control_tpu_torch.ops.cuda import admm_kernel
from model_predictive_control_tpu_torch.solvers import linear_mpc
from port_bench import control, harness

SMALL = {"scenarios": 64, "steps": 10}


def state_unchanged(monkeypatch):
    monkeypatch.setattr(LinearSystem, "__call__", lambda self, x, u: x)


def half_batch(monkeypatch):
    twin = admm_kernel.admm_solve_tiles_reference

    def half(*args, **kw):
        x, z, y, ni = twin(*args, **kw)
        h = x.shape[0] // 2
        x, z, y = x.clone(), z.clone(), y.clone()
        x[h:], z[h:], y[h:] = 0.0, 0.0, 0.0
        return x, z, y, ni

    monkeypatch.setattr(admm_kernel, "admm_solve_tiles_reference", half)


def answer_altered(monkeypatch):
    solve = linear_mpc._TILED["cuda"]

    def altered(*args, **kw):
        sol = solve(*args, **kw)
        x = sol.x.clone()
        x[::7, 0] += 7.5
        return dataclasses.replace(sol, x=x)

    monkeypatch.setitem(linear_mpc._TILED, "cuda", altered)


@pytest.mark.parametrize("workload", ["cruise_n20.fleet128k", "cruise_n20_chance.stochastic64k"])
@pytest.mark.parametrize("fault", [state_unchanged, half_batch, answer_altered])
def test_fault_makes_the_run_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    result, info = harness.run_cell(workload, 31337, 1.0, False, "cpu", time.perf_counter(),
                                    mix_override=SMALL)
    assert not result["correct"], (fault.__name__, result["checks"])


@pytest.mark.parametrize("workload", ["cruise_n20.fleet128k", "cruise_n20_chance.stochastic64k"])
def test_sound_run_is_correct(workload):
    result, _ = harness.run_cell(workload, 31337, 1.0, False, "cpu", time.perf_counter(),
                                 mix_override=SMALL)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("workload", ["cruise_n20.fleet128k", "cruise_n20_chance.stochastic64k"])
def test_control_is_not_correct(workload):
    readings = control.control_readings(workload, 7, "cpu", 1, {"scenarios": 128, "steps": 20})
    assert not readings["correct"], readings
    limits = harness.find_cell(workload).spec["check"]["limits"]
    assert readings["plant_gap"] > 10 * limits["plant_gap"]
