"""The port's command line and its observability and plotting layers on the
CPU (the counterparts of ``tests/test_experiments.py``'s CLI cases and the
``obs``/``viz`` half of ``tests/test_obs_viz.py``).

Every subcommand of the JAX package's ``cli.py`` runs through
``cli.main([...] + ["--device", "cpu"])`` at a tiny size and prints, last,
one JSON line with the JAX command's keys (for ``session1``, ``session2``
and ``podscale`` the keys are read from the JAX command run alike). A sweep
checkpointed in segments resumes bit for bit; the JSONL logger, the timer,
the run summary, the profiler hook and the plot set work as the JAX ones.
"""

import json

import numpy as np
import pytest
import torch

from model_predictive_control_tpu import cli as jax_cli

import model_predictive_control_tpu_torch as port
from model_predictive_control_tpu_torch import cli
from model_predictive_control_tpu_torch.obs import (
    MetricsLogger,
    Timer,
    load_sweep_state,
    profile_trace,
    save_sweep_state,
    summarize_run,
)

SWEEP = {"batch", "steps", "success_rate", "rel_scale"}
TIMED = {"wall_s", "solves_per_s", "wall_steady_s"}
SESSION23 = {"steps", "unstable_frac", "success_rate", "success_rate_warm", "prim_res_p50",
             "prim_res_p99", "prim_res_max", "dual_res_p50", "dual_res_p99", "dual_res_max",
             "solver_iters", "session", "N", "final_state", "p_max_violation",
             "u_box_violation", "constraints_respected"}
# subcommand: (arguments, the keys its JSON line holds (the JAX command's))
COMMANDS = {
    "session1": (["session1", "--steps", "6"],
                 {"unstable_by_horizon", "final_norm_by_horizon", "cost_to_go", "v_inf"}),
    "session2": (["session2", "--horizon", "6", "--steps", "4", "--iters", "60"], SESSION23),
    "session3": (["session3", "--horizon", "6", "--steps", "4", "--iters", "60", "--soft"],
                 SESSION23),
    "session4": (["session4", "--steps", "1", "--sqp-iters", "1"],
                 {"variant", "steps", "final_pose", "final_dist_to_spot", "success_rate",
                  "kkt_res_max", "viol_max"}),
    "session4_exercise": (["session4", "--exercise", "4", "--sqp-iters", "1"],
                          {"exercise", "N", "ts", "x0", "rel_err_max_pct",
                           "final_dist_predicted", "final_dist_real"}),
    "sweep": (["sweep", "--batch", "2", "--steps", "1", "--horizon", "4", "--backend",
               "factory"],
              SWEEP | {"median_final_dist", "parked_frac_5cm", "controller_knows",
                       "mean_inner_iters", "wall_s", "solves_per_s", "wall_s_steady",
                       "solves_per_s_steady"}),
    "racesweep": (["racesweep", "--batch", "2", "--steps", "1", "--horizon", "4"],
                  SWEEP | TIMED | {"mean_tracking_error"}),
    "racesweep_dynamic": (["racesweep", "--batch", "2", "--steps", "1", "--horizon", "3",
                           "--dynamic"], SWEEP | TIMED | {"mean_tracking_error"}),
    "quadsweep": (["quadsweep", "--batch", "2", "--steps", "1"],
                  SWEEP | TIMED | {"model", "mean_tracking_error", "p95_tracking_error"}),
    "thrustersweep": (["thrustersweep", "--batch", "2", "--steps", "1"],
                      SWEEP | TIMED | {"model", "mean_tracking_error"}),
    "windsweep": (["windsweep", "--batch", "2", "--steps", "1"],
                  {"batch", "steps", "wind_per_step", "compensate", "success_rate",
                   "steady_tracking_error", "wind_estimate_rms_error"} | TIMED),
    "tune": (["tune", "--horizon", "3", "--steps", "3", "--batch", "2", "--updates", "1",
              "--iters", "40"],
             {"experiment", "initial_loss", "final_loss", "best_loss", "reduction"}),
    "estimate": (["estimate", "--horizon", "6", "--steps", "4"],
                 {"experiment", "steps", "success_rate", "final_state", "est_rmse_pos",
                  "est_rmse_vel", "meas_sigma", "kalman_gain"}),
    "race": (["race", "--steps", "1", "--horizon", "3", "--kinematic"],
             {"model", "steps", "speed", "lap_time_s", "mean_tracking_error_m",
              "max_tracking_error_m", "success_rate", "unstable"}),
    "race_wind": (["race", "--steps", "1", "--horizon", "3", "--wind", "0.004"],
                  {"wind_per_step", "nominal_steady_error_m", "compensated_steady_error_m",
                   "compensated_success", "wind_estimate"}),
    "robust": (["robust", "--batch", "2", "--steps", "3", "--no-nonlinear"],
               {"batch", "steps", "bounded.nominal_violation_frac",
                "bounded.tube_violation_frac", "bounded.tube_ok_frac", "gaussian.eps",
                "gaussian.nominal_violation_rate", "gaussian.stochastic_violation_rate",
                "bias.bias", "bias.nominal_offset", "bias.offset_free_offset",
                "bias.disturbance_estimate"}),
    "podscale": (["podscale", "--batch", "8", "--steps", "2", "--horizon", "6", "--iters",
                  "40", "--backend", "xla"],
                 {"metric", "batch", "steps", "devices", "backend", "solves_per_s",
                  "success_rate", "wall_s"}),
}


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(COMMANDS))
def test_every_subcommand_prints_the_jax_keys(name, capsys):
    argv, keys = COMMANDS[name]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = _last_json(capsys)
    missing = keys - out.keys()
    assert not missing, missing
    if name in ("session2", "session3"):
        assert isinstance(out["constraints_respected"], bool)
    if name == "podscale":
        assert out["batch"] == 8 and out["devices"] == 1 and out["solves_per_s"] > 0


@pytest.mark.parametrize("name", ["session1", "session2", "podscale"])
def test_keys_equal_the_jax_commands(name, capsys):
    """The JAX command and the port's, run alike: the same keys."""
    argv, _ = COMMANDS[name]
    assert jax_cli.main(argv) == 0
    want = _last_json(capsys)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert got.keys() == want.keys()
    if name == "session1":
        assert got["unstable_by_horizon"] == want["unstable_by_horizon"]


def test_session1_writes_its_plots(tmp_path, capsys):
    assert cli.main(["session1", "--steps", "12", "--outdir", str(tmp_path),
                     "--platform", "cpu"]) == 0
    assert "v_inf" in _last_json(capsys)
    assert (tmp_path / "session1_cost_to_go.png").exists()


def test_backend_names_and_refusals(capsys):
    """The JAX package's ``xla`` route is refused by the sweeps, naming the
    port's ``torch``; ``podscale --scaling`` runs (its ladder on one CPU
    rank, labelled non-performance)."""
    with pytest.raises(ValueError, match="backend='torch'"):
        cli.main(["sweep", "--batch", "2", "--steps", "1", "--backend", "xla", "--device", "cpu"])
    assert cli.main(["podscale", "--scaling", "--batch", "8", "--steps", "2", "--horizon", "4",
                     "--iters", "20", "--device", "cpu"]) == 0
    report = _last_json(capsys)
    assert report["non_performance"] is True and [p["devices"] for p in report["points"]] == [1]
    assert cli._backend("pallas") == "cuda" and cli._backend("factory") == "factory"


def test_tune_nonlinear_prints_the_jax_keys(capsys):
    assert cli.main(["tune", "--nonlinear", "--steps", "1", "--batch", "1", "--updates", "1",
                     "--device", "cpu"]) == 0
    out = _last_json(capsys)
    assert out.keys() == {"tier", "loss_initial", "loss_final", "improvement_pct", "tuned_Q",
                          "tuned_R"}
    assert np.isfinite(out["loss_final"])


# ---------------------------------------------------------------------------
# obs and viz (the half of tests/test_obs_viz.py that is not JAX's own)
# ---------------------------------------------------------------------------


def test_timer_fences_device_work():
    x = torch.ones(256, 256)
    with Timer() as t:
        y = (x @ x).sum()
        t.fence(y)
    assert t.elapsed is not None and t.elapsed > 0.0


def test_metrics_logger_jsonl_roundtrip(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    with MetricsLogger(path) as log:
        log.write({"solves_per_s": torch.tensor(123.5), "batch": 64})
        log.write({"vec": torch.arange(3)})
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["solves_per_s"] == pytest.approx(123.5)
    assert lines[0]["batch"] == 64 and "ts" in lines[0]
    assert lines[1]["vec"] == [0, 1, 2]


def test_summarize_run_health_fields():
    problem = port.session2_problem(N=5)
    ctrl = port.make_linear_mpc(problem, solver="admm", iters=60, dtype=torch.float64,
                                device="cpu")
    res = port.simulate(torch.tensor([-10.0, 2.0], dtype=torch.float64),
                        problem.system(torch.float64, "cpu"), steps=10, policy=ctrl.policy(),
                        policy_carry=ctrl.initial_carry(torch.float64, "cpu"))
    summary = summarize_run(res)
    assert summary["steps"] == 10
    assert 0.0 <= summary["success_rate"] <= 1.0
    assert summary["prim_res_max"] >= summary["prim_res_p50"] >= 0.0


def test_checkpoint_resume_bitexact(tmp_path):
    path = str(tmp_path / "sweep.npz")
    state = {
        "x": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "key": torch.Generator().manual_seed(7).get_state(),
        "warm": (torch.ones(4), torch.zeros(2, dtype=torch.float64)),
    }
    save_sweep_state(path, step=17, state_pytree=state)
    step, loaded = load_sweep_state(path, state)
    assert step == 17
    for k in ("x", "key"):
        assert torch.equal(loaded[k], state[k]) and loaded[k].dtype == state[k].dtype
    for a, b in zip(loaded["warm"], state["warm"]):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_parking_sweep_resumes_bit_for_bit(tmp_path):
    """An uninterrupted sweep and one checkpointed after every step, stopped
    at step 2 and resumed: the resumed run's states are the last three of
    the uninterrupted run's, bit for bit, and the summaries are equal."""
    kw = dict(N=5, outer_iters=2, inner_iters=2, plant_substeps=2, device="cpu")
    full, s_full = port.parking_sweep(3, 4, **kw)
    path = str(tmp_path / "sweep.npz")
    port.parking_sweep(3, 2, checkpoint_path=path, checkpoint_every=1, **kw)
    resumed, s_res = port.parking_sweep(3, 4, checkpoint_path=path, checkpoint_every=1, **kw)
    assert torch.equal(resumed.states, full.states[2:])
    assert torch.equal(resumed.inputs, full.inputs[2:])
    assert s_res == s_full


def test_profile_trace_noop_and_real(tmp_path):
    with profile_trace(None):
        pass
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


@pytest.fixture(scope="module")
def parking_run():
    """A tiny parking trajectory: states, inputs, predictions."""
    T, N = 6, 4
    t = np.linspace(0.0, 1.0, T)
    states = np.stack([0.3 - 0.3 * t, -0.1 + 0.1 * t, 0.2 * t, 0.1 + 0 * t], 1)
    inputs = np.stack([np.cos(t), 0.1 * np.sin(t)], 1)
    preds = states[:, None, :] + 0.01 * np.arange(N + 1)[None, :, None]
    return states, inputs, preds


def test_plot_set_builds(tmp_path, parking_run):
    from model_predictive_control_tpu_torch.viz import (
        plot_cost_to_go_comparison,
        plot_cover_circles,
        plot_input_sequence,
        plot_integration_error,
        plot_phase_trajectory,
        plot_state_trajectory,
        plot_states_separately,
    )

    states, inputs, preds = parking_run
    params = port.VehicleParameters()
    assert plot_input_sequence(inputs, params, ts=0.08) is not None
    assert plot_state_trajectory(states, params, save=str(tmp_path / "traj.png")) is not None
    assert (tmp_path / "traj.png").exists()
    assert plot_states_separately(states, ts=0.08) is not None
    assert plot_phase_trajectory(states[:, :2], predictions=preds[..., :2]) is not None
    assert plot_cost_to_go_comparison([4, 6, 10], [3.0, 2.5, 2.2], 2.1) is not None
    assert plot_cover_circles(states[0], params) is not None
    assert plot_integration_error(0.05, {"euler": np.abs(np.sin(np.linspace(0, 1, 6)))})
    import matplotlib.pyplot as plt

    plt.close("all")


def test_animation_renders_gif(tmp_path, parking_run):
    from model_predictive_control_tpu_torch.viz import ParkingAnimator, animate_parking

    states, _, preds = parking_run
    params = port.VehicleParameters()
    out = animate_parking(states, params, str(tmp_path / "park.gif"), predictions=preds,
                          comparison=states[::-1], fps=5)
    assert (tmp_path / "park.gif").stat().st_size > 0 and out.endswith(".gif")
    anim = ParkingAnimator(params)
    with pytest.raises(ValueError):
        anim.add_car_trajectory(states[:, :2])  # needs pose columns
    with pytest.raises(ValueError):
        anim.bundle(preds[0])  # needs 3-D
