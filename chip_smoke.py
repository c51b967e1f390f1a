"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written kernel libraries from
``model_predictive_control_tpu_torch/csrc`` with nvcc (in parallel), then for
each of the port's paths checks the path's kernel against its plain-PyTorch
twin on the card at the path's shapes, drives the path through the port's
public entry points, checks that every solve of that run launched the
kernel, and times it:

- the headline closed loop (session-2 linear MPC, N=20, 65,536 scenarios ×
  50 steps) on the fused ADMM kernel (held to its twin's gates; with CUDA
  events around every launch of one episode, a profiled window and one
  round of the episode per tile, informational);
- the rest of the linear ADMM family on the same kernel: its wide mode
  (a warp per quad of rows, the operator read from device memory) held to
  the twin on the MHE loop's slack-softened MPC at N=20 (n + m = 200, 4,096
  scenarios, the polished cold presolve and the first warm step), the
  build of the MHE loop's windows (n + m = 44) held to the twin on the
  loop's own first two batches of windows at 2,048 (cold and warm), then
  the tube sweep (65,536 × 50), the stochastic sweep (65,536 × 50) and the
  MHE-in-the-loop sweep (2,048 × 50, two launches a step: the MHE windows
  and the soft MPC in the wide mode), each with its launches counted, the
  contract's quality gates, a kernel-vs-twin closed loop on four draws of
  256 scenarios × 3 steps (every final state within 5e-2 of the twin's or
  of the twin's algorithm run in float64) and one timed round (best of 3,
  CUDA events around every launch; the MHE loop's two builds each timed and
  bounded on a launch of the loop);
- the nonlinear obstacle-parking sweep (N=30, 2,048 scenarios × 50 steps)
  on the fused AL-iLQR kernel (held to its twin bit for bit at one thread
  per lane and at two thread groups, on the launch's operands and through
  the wrapper; with CUDA events around every launch of one sweep and the
  sweeps per tile × group, informational);
- the kinematic and the Pacejka lap-tracking sweeps (N=15, 2,048 scenarios
  × 50 steps each) on the two instantiations of the fused tracker kernel
  (held to its twin bit for bit at one thread per lane and at two thread
  groups, on the launch's operands and through the policy; with CUDA
  events around every launch of one sweep and a profiled window, both
  informational);
- the AL-iLQR kernel's operand modes (``refs`` alone, and ``refs``,
  ``dist``, ``urefs`` together) held to the twin bit for bit on the launches
  of the offset-free sweeps' first two steps (2,048 × N=15 crosswind,
  1,024 × N=12 slope parking) at one thread per lane and at two thread
  groups; then the three loops on those modes, each with its launches
  counted and the contract's quality gates: ``racing_sweep(2048, 50,
  backend="pallas-hand")``, ``wind_sweep(2048, 50)`` and
  ``offset_free_sweep(1024, 240)``, the last two with their ablations
  (``compensate=False``) showing the offset they remove; a kernel-vs-twin
  closed loop of each (64 scenarios); and one small run of the
  per-scenario route on the card (``batched_parking_policy(backend=
  "torch")``, the batched AL-iLQR with ``torch.func`` derivatives) held
  against the kernel on the same states;
- the tracker kernel's benchmark models (cart-pole nu=1, planar quadrotor
  nu=2, omnidirectional base nu=3 with and without a per-scenario mass,
  thrust cluster nu=4): each instantiation held to its twin bit for bit at
  one thread per lane and at two thread groups, in regulation and tracking
  and without an input box; then ``quadrotor_sweep(2048, 50)`` and
  ``thruster_sweep(2048, 50)`` (N=10, RK4x2 prediction, 8 plant substeps)
  with their launches counted and the contract's quality gates, the other
  models' solves, a kernel-vs-twin closed loop of each sweep, and each sweep
  timed with CUDA events around its launches;
- the tracker kernel's second library (``csrc/ilqr_factory_ext.cu``): the
  factory parking launches (the sweep's warm step at derivative order 2 with
  its warm multipliers, order 1, seeded per-lane weights, and per-lane
  weights equal to the constants, which must give the constant build's bits)
  held to the twin bit for bit at a 2 × 3 budget and the MHE windows (4,096
  × M=10, 4 × 8) at their full budget, each at one thread per lane and at two
  thread groups; a (tile, group) launch sweep (informational); then
  ``parking_sweep(2048, 50, backend="factory", inner_iters=14)`` and
  ``NonlinearMHE.solve_batch_fused`` on 4,096 windows with their launches
  counted and the contract's quality gates, the windows held to the
  Gauss-Newton oracle on 64 of them, the 6 × 15 sweep beside the hand
  kernel's (informational), CUDA events around the launches and each launch
  timed alone;
- the long-horizon closed loop (session-2 linear MPC on the stagewise
  interior-point solver, N=100, 20 iterations, 4,096 scenarios × 50 steps)
  on the fused stagewise-IP kernel (held to its twin bit for bit at one
  thread per lane and at two thread groups, on the launch's operands and
  through the wrapper), beside the batched plain-torch solver (with CUDA
  events around every launch of one loop, a profiled window, the loop per
  tile × group, the placements of the working set and a profile of the
  plain-torch solver, all informational).

Each kernel's line of the ``kernels`` object carries its time beside its
bound: the least time the card could take for the same work, the larger of
the operations over the FP32 peak outside the tensor cores and the bytes
(each operand read once, each result written once) over the memory rate. The
operations are the algorithm's, counted by hand per stage and executed
iteration and multiplied by the iterations this run's inputs executed: what
the function needs when every intermediate is computed once, not what a
kernel's source spends (a value is charged once, however often a kernel
recomputes it).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and exits non-zero without one, or when any phase
fails. The last line of its output is one JSON object
``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py --headline-loop
DIR [--outputs PATH]`` times the headline episode alone (wall, the presolve
and steady launches, idle share, the warm launch) for the port found under
``DIR``; with ``--outputs`` it also saves the launch's outputs on the cold
unpolished presolve and the first warm step to ``PATH``, or compares them bit
for bit with another version's already there. ``python3 chip_smoke.py
--long-horizon-loop DIR`` times the long-horizon loop alone (wall, time in
the kernel, idle share) for the port found under ``DIR``: run it on two
checkouts in one call to compare two versions on one card. ``python3
chip_smoke.py --long-horizon-phases`` prints where a stagewise-IP launch
spends its cycles, phase by phase, from a clocked build of the kernel.
``python3 chip_smoke.py --family-phases`` runs the linear family's phases
alone (the ADMM kernel's builds they launch, then the phases above);
``python3 chip_smoke.py --benchmark-phases`` runs the tracker kernel's
benchmark-model phases alone (its libraries, then those phases);
``python3 chip_smoke.py --factory-phases`` runs the factory parking and MHE
windows' phases alone (their libraries and the hand parking kernel's, then
those phases); ``python3 chip_smoke.py --tracker-launches DIR`` times the
racing tiers' warm tracker launch alone for the port found under ``DIR``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

BATCH = 65536
STEPS = 50
HORIZON = 20
ADMM_ITERS = 80
PROBE_ITERS = 8
PRESOLVE_MULT = 2
RHO = 0.035
CONTRACT_SUCCESS = 0.999  # BENCH_CONTRACT.json headline floor_success_rate: gated
TWIN_SCENARIOS = 512
ADMM_SWEEP_TILES = (4, 8, 16, 32)  # one round each, informational
ADMM_COLS = -(-(HORIZON + 3 * HORIZON) // 16)  # the K1 library of n + m = 4 N

# kernel vs twin on the card (both FP32, sums in another order). x lies in
# [-20, 10]. Rows converged on both sides after the same iterations are held
# on the 99.9th percentile of max|Δx|: FP32 noise near the fixed point is
# ~1e-4, while a rare row meets the success test (eps·(1 + ‖q‖∞), about 0.7
# on the dual residual here) with both iterates still moving, so its max is
# reported, not gated. The CG polish is not held on x at all: in FP32 it is
# chaotic at N=20 (the twin in float32 against float64 moves 677 of 2048
# rows by more than 2e-2), so the polished config is held on its iterations
# and its success mask.
TOL_X_Q999 = 2e-3
TOL_CONV_AGREE = {"cold": 0.999, "polished": 0.95, "warm": 0.999}
TOL_CONV_RATE = 0.01  # |success(kernel) - success(twin)|, polished config
TOL_NI_AGREE = 0.99  # share of scenarios whose tile ran the same iterations
TOL_STATES = 5e-2  # closed-loop final states, kernel vs twin episode

# parking sweep (BENCH_CONTRACT.json "sweep": config, floors and ceiling)
PARK_BATCH = 2048
PARK_STEPS = 50
PARK_N = 30
PARK_TS = 0.08
PARK_OBSTACLE = (0.25, 0.0, 0.0, 0.0)
PARK_SUCCESS_FLOOR = 0.90
PARK_PARKED_FLOOR = 0.95
PARK_MEDIAN_CEILING = 0.05
PARK_TWIN_SCENARIOS = 64
PARK_TWIN_STEPS = 1
# AL-iLQR kernel vs twin on the card: the same float program (no FMA
# contraction) at every thread group, so all six outputs are gated bit for
# bit, at every group built here (one thread per lane and two groups).
PARK_GROUPS = (1, 8, 32)
TOL_PARK_STATES = 5e-2  # closed loop, tests/test_pallas_ilqr.py:117
# Informational sweep of whole sweeps over (tile, group), one round to keep
# the script's time: the default tile and the widest that keeps all but the
# candidates in shared memory. PERF.md's full table is this script's with
# PARK_SWEEP_TILES = (8, 16, 32) and 2 rounds. At tile 32
# the summary is the one-thread-per-lane kernel's of the first port
# (success, parked within 5 cm, mean inner iterations), whatever the group:
# gated.
PARK_SWEEP_TILES = (16, 32)
PARK_SWEEP_ROUNDS = 1
PARK_TILE32_SUMMARY = {"success_rate": (0.93378, 5), "parked_frac_5cm": (0.97656, 5),
                       "mean_inner_iters": (74.86, 2)}

# racing sweeps (BENCH_CONTRACT.json "racing_sweep" / "racing_sweep_dynamic":
# batch, steps and the quality floors; the solves/s there were taken on a TPU)
RACE_BATCH = 2048
RACE_STEPS = 50
RACE_N = 15
RACE_SUCCESS_FLOOR = 0.99
RACE_TWIN_SCENARIOS = 64
RACE_TWIN_STEPS = 2
# tracker kernel vs twin on the card: the same float program (no FMA
# contraction) at every thread group, so all six outputs are gated bit for bit.
# The groups built and held here: one thread per lane, and both defaults.
RACE_GROUPS = (1, 8, 32)
# Informational sweep of whole sweeps over (tile, group): none, to keep the
# script's time (the kernel-vs-twin checks at every group hold
# the group's independence). PERF.md's full tables are this script's with
# RACE_GROUPS = (1, 8, 16, 32), RACE_SWEEP_TILES = (8, 16, 32, 64) and 4
# rounds.
RACE_SWEEP_TILES = ()
RACE_SWEEP_ROUNDS = 1
RACE_PROFILE_STEPS = 5  # the window of each sweep run under torch.profiler (parking too)

# the tracker kernel's benchmark models (BENCH_CONTRACT.json "quadrotor_sweep",
# "thruster_sweep": batch, steps, N=10, RK4x2 prediction, 8 plant substeps and
# the quality gates, read from the file; the solves/s there were a TPU's).
# Models no sweep uses are driven by one solve each through make_fused_tracker
# at the sweeps' batch: the JAX tests' problems (cart-pole regulation with a
# binding force box, tests/test_ilqr_factory.py:140; the omnibase in
# regulation, test_ilqr_factory_wide.py:60, and with a per-scenario mass,
# test_ilqr_factory_constrained.py:179), N=10, RK4x2.
BENCH_BATCH = 2048
BENCH_STEPS = 50
BENCH_N = 10
BENCH_SWEEPS = {"quadrotor": "quadrotor_sweep", "thruster": "thruster_sweep"}
BENCH_SOLVES = {
    # instantiation: (builder, limits, weights, start spread, per-lane mass range)
    "cartpole": ("make_cartpole_ode_rows", ((-3.0,), (3.0,)),
                 ((1.0, 2.0, 0.1, 0.1), (0.01,), 10.0), (2.0, 0.5, 0.2, 0.2), None),
    "omnibase": ("make_omnibase_ode_rows", ((-12.0, -12.0, -3.0), (12.0, 12.0, 3.0)),
                 ((5.0, 5.0, 1.0, 0.5, 0.5, 0.1), (0.01, 0.01, 0.005), 10.0),
                 (2.5, 0.5, 1.0, 0.2, 0.1, 0.3), None),
    "omnibase_param": ("make_omnibase_param_ode_rows", ((-12.0, -12.0, -3.0), (12.0, 12.0, 3.0)),
                       ((5.0, 5.0, 1.0, 0.5, 0.5, 0.1), (0.01, 0.01, 0.005), 10.0),
                       (2.5, 0.5, 1.0, 0.2, 0.1, 0.3), (4.0, 10.0)),
}
BENCH_FUNCTORS = {"cartpole": "CartpoleRows", "quadrotor": "QuadrotorRows",
                  "omnibase": "OmnibaseRows", "omnibase_param": "OmnibaseParamRows",
                  "thruster": "ThrusterRows"}
# the solves' sanity floor: the share of lanes converged within the 6 x 15
# budget from the seeded starts (the omnibase's far starts leave ~1% short;
# the kernel is held to the twin bit for bit above)
BENCH_SOLVE_CONVERGED = 0.95
BENCH_TWIN_SCENARIOS = 64
BENCH_TWIN_STEPS = 2
TOL_BENCH_STATES = 5e-3  # closed loop, as the kinematic racing tier's
BENCH_TILES = (8, 16, 32)  # informational launch sweep of (tile, group)
# long-horizon stagewise-IP loop (the JAX package's README "Long-horizon
# box-QP" workload: N=100, batch 4096, 20 iterations; nothing cut)
LH_BATCH = 4096
LH_STEPS = 50
LH_N = 100
LH_ITERS = 20
LH_SUCCESS_FLOOR = 0.99
LH_BACKEND_AGREE = 0.01  # |success(kernel loop) - success(torch-backend loop)|
# the batched plain-torch solver is host-bound at ~3 s per step of 4,096
# scenarios: its loop runs the first steps only, against the kernel loop's same steps
LH_TORCH_STEPS = 5
# The two backends are two float32 programs of one algorithm, so a lane's
# states agree within the JAX package's bar between its two backends
# (tests/test_pallas_riccati_ip.py:193) as long as both took the same number
# of iterations, which shows in final duality measures equal within
# TOL_LH_MU. A lane whose μ after some iteration lands on the freeze
# threshold (50 eps) freezes there in one program and takes one more
# iteration in the other: both answers pass the success test, but they
# differ by the last iteration's progress (measured on an H100: 1 lane of
# 4,096, μ 5.960e-06 against 4.392e-08 at step 3, |Δu0| 8.7e-03, |Δstate|
# 2.6e-03). Such lanes are listed and counted, and their share is gated.
TOL_LH_BACKEND_STATES = 2e-3
TOL_LH_MU = 0.1  # relative; lanes beyond it took different iteration counts
TOL_LH_EDGE_SHARE = 1e-3  # share of lanes allowed on the freeze threshold's edge
# stagewise-IP kernel vs twin on the card: the same float program (IEEE add,
# multiply, divide in one order, no FMA contraction) at every thread group, so
# all six outputs are gated bit for bit, at every group built here.
LH_GROUPS = (1, 8, 32)
# Informational: one round of the loop per (tile, group) the launch bounds
# take, CUDA events around every launch (the source of PERF.md's table). At
# tile 32 the loop's summary is the one-thread-per-lane kernel's of the first
# port (success share, mean executed iterations), whatever the group: gated.
LH_SWEEP_TILES = (8, 16, 32, 64)
LH_TILE32_SUMMARY = {"success": (0.99991, 5), "iterations": (7.65, 2)}
LH_TWIN_SCENARIOS = 64
LH_TWIN_STEPS = 3
LH_WIDE_BATCH = 65536  # informational point: how the card fills
LH_PROFILE_ITERS = 1  # iterations of the profiled plain-torch solve
LH_SMALL_N = 12  # the nx=3 / nu=2 case (dense R, infinite bounds)
TOL_LH_STATES = 2e-3  # closed loop, tests/test_pallas_riccati_ip.py:193

# K2's operand modes: the loops on them (BENCH_CONTRACT.json "racing_sweep",
# "wind_sweep", "offset_free_sweep": batch, steps and the quality gates,
# read from the file; its solves/s were taken on a TPU: printed, not gated),
# and the ablations' gates, the JAX package's (tests/test_wind_sweep.py:
# 117-120, tests/test_offset_free_sweep.py:35-41): the nominal tracker's
# steady error over 2.5 times the compensated one's, its wind estimate off
# by more than 1e-3; the nominal parking's median final distance over twice
# the compensated one's, its d-hat off by more than 5e-3.
MODE_LOOPS = {
    # name: (entry point, batch, steps, keywords, contract entry)
    "racing_hand": ("racing_sweep", 2048, 50, {"backend": "pallas-hand"}, "racing_sweep"),
    "wind": ("wind_sweep", 2048, 50, {}, "wind_sweep"),
    "offset_free": ("offset_free_sweep", 1024, 240, {}, "offset_free_sweep"),
}
MODE_ABLATIONS = {
    "wind": (("steady_tracking_error", 2.5), ("wind_estimate_rms_error", 1e-3)),
    "offset_free": (("median_final_dist", 2.0), ("d_hat_rms_error", 5e-3)),
}
MODE_TWIN_SCENARIOS = 64
MODE_TWIN_STEPS = 2
TOL_MODE_STATES = 5e-3  # closed loop, tests/test_wind_sweep.py:95-102
PER_SCENARIO_BATCH = 256
PER_SCENARIO_STEPS = 2
# the per-scenario route against the kernel, both float32 at N = 30 with
# the obstacle, where float32 AL iterations part (ROADMAP queue 3): the
# median scenario's final state within TOL_PARK_STATES, the success rates
# within 0.1
TOL_PER_SCENARIO_SUCCESS = 0.1

# the rest of the linear ADMM family on K1 (BENCH_CONTRACT.json "tube_sweep",
# "stochastic_sweep", "mhe_loop": batch, steps and the quality gates; the
# solves/s there were taken on a TPU). Each path's launches per run: a 4x
# presolve, then one launch a step (the MHE loop: two, the MHE windows and
# the soft MPC).
FAMILY = {
    "tube": ("tube_sweep", 65536, 50, 1,
             {"tube_ok_rate": (">=", 0.999), "success_rate": (">=", 0.97),
              "original_box_violation_frac": ("<=", 0.01)}),
    "stochastic": ("stochastic_sweep", 65536, 50, 1,
                   {"success_rate": (">=", 0.97), "near_limit_violation_rate": ("<=", 0.13)}),
    "mhe_loop": ("mhe_loop_sweep", 2048, 50, 2,
                 {"success_rate": (">=", 0.92), "mhe_converged_rate": (">=", 0.99),
                  "est_rmse_pos": ("<=", 0.12), "est_rmse_vel": ("<=", 0.12)}),
}
# Kernel-vs-twin closed loop of each path, FAMILY_TWIN_SEEDS draws of
# FAMILY_TWIN_SCENARIOS x FAMILY_TWIN_STEPS, with a third run: the twin's
# algorithm in float64 arithmetic on the same float32 operands. The steady
# solves stop loosely (eps (1 + |q|), |q| in the thousands), so two float32
# programs may stop at different points of that band and part by more than
# TOL_STATES in a scenario; the witness says which one rounding moved. On
# the card the kernel repeats bit for bit and the one scenario in 1,024 of
# the tube and of the MHE loop outside TOL_STATES of the twin lies within
# 1e-5 of the witness, the twin 6-8e-2 from both (PERF.md section 7). So
# every final state is held within TOL_STATES of the twin's or of the
# witness's, and the success rate within TOL_CONV_RATE of either.
FAMILY_TWIN_SCENARIOS = 256
FAMILY_TWIN_STEPS = 3
FAMILY_TWIN_SEEDS = (0, 1, 2, 3)
# K1's wide mode (n + m = 200: the MHE loop's soft-state MPC at N = 20),
# held to the twin at WIDE_BATCH scenarios of the MHE loop's starts
WIDE_BATCH = 4096
WIDE_N = 20
WIDE_ITERS = 200  # the MHE loop's MPC budget, 4x in its presolve
WIDE_RHO = 0.02
WIDE_SLACK_WEIGHT = 1e4
WIDE_COLS = -(-(3 * WIDE_N + 7 * WIDE_N) // 32)  # the wide library's columns a lane
MHE_COLS = -(-(2 + 2 * 10 + 2 + 2 * 10) // 16)  # the MHE windows' library (M = 10)

# Published peaks of one H100 SXM (NVIDIA's data sheet): FP32 outside the
# tensor cores, and the HBM rate. A card below 700 W runs under them.
PEAK_FP32 = 67e12  # FLOP/s
PEAK_HBM = 3.35e12  # B/s
# FP32 operations (a transcendental counted as one) that the algorithm needs
# per stage and executed iteration, counted by hand. A step Jacobian by
# dual numbers is charged its tangents only, two operations per operation of
# the step and direction: the step's value at the accepted point is one of
# the rollouts', already charged there, however often a kernel recomputes it:
# - parking AL-iLQR: backward ~1,100 (Jacobian 45, box rows 54, 9 clearance
#   pairs 495, Riccati algebra ~500), the 7 line-search rollouts 7 x 273
#   (control 22, stage cost 224, Euler step 27);
# - kinematic tracker / Euler: one step is 27; the tangents of 6 directions
#   6 x 2 x 27 = 324, nx=4 algebra and 12 box rows ~840, rollouts 7 x 134;
# - Pacejka tracker / RK4x4: one step is 16 model evaluations of 59 plus the
#   combination, 1,184; the tangents of 8 directions 8 x 2 x 1,184 = ~18,900,
#   nx=6 algebra ~1,900, rollouts 7 x 1,261.
# - parking AL-iLQR in its tracking modes (12 box rows, no clearance):
#   backward ~600 (Jacobian 45, box rows 54, reference errors 6, Riccati
#   algebra ~500), the 7 rollouts 7 x 155 (control 22, stage cost with the
#   reference and input-reference errors 100, Euler step with the offset 31).
# - the benchmark models (RK4x2 prediction, N=10): one step is 2 substeps of
#   4 model evaluations plus the combination; the tangents of nx + nu
#   directions charged 2 x that step; the Riccati algebra at (nx, nu) with the
#   Quu solve; the 7 rollouts (control, stage cost with its box rows, step):
#   cart-pole (25 a model evaluation; step 304, 5 directions; algebra ~500),
#   quadrotor (12; step 252, 8 directions, algebra with the tilt box ~1,950),
#   omnibase with or without the per-lane mass (17; step 292, 9 directions;
#   algebra ~2,400), thruster (50; step 556, 10 directions; algebra with the
#   4 x 4 Cholesky and its 7 right-hand sides ~2,900).
FLOPS_STAGE_ITER = {"parking": 3010, "kinematic": 2100, "pacejka": 29600, "tracking": 1690,
                    "cartpole": 6000, "quadrotor": 9000, "omnibase": 10500,
                    "omnibase_param": 10500, "thruster": 19000}


def bound(torch, flops: float, tensors) -> dict:
    """The ``bound_ms`` / ``bound_by`` / ``library_ms`` keys of a kernel's
    entry: ``flops`` over the FP32 peak against the bytes of ``tensors``
    (operands and results, each moved once) over the memory rate. ``flops``
    is the algorithm's minimum for this run's executed iterations (every
    intermediate computed once), whatever the kernel's source spends. No single
    PyTorch call computes any of these fused solves: ``library_ms`` is null."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))
    t_ops, t_bytes = 1e3 * flops / PEAK_FP32, 1e3 * nbytes / PEAK_HBM
    by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"bound: {flops:.4g} FP32 operations ({t_ops:.5f} ms at {PEAK_FP32:.3g}/s), "
          f"{nbytes:.4g} bytes ({t_bytes:.5f} ms at {PEAK_HBM:.3g} B/s): {by}", flush=True)
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": by, "library_ms": None}


def stagewise_flops(nx: int, nu: int, nb: int, N: int, iters_sum: float, lanes: int) -> float:
    """FP32 operations the stagewise interior-point algorithm needs, with
    every Newton bound step computed once per predictor and once per
    corrector (``nb`` finite bounds per stage). Per stage and executed
    iteration: the factor sweep; the predictor and corrector affine sweeps
    with their linear terms (8 operations a bound for the barrier gradient,
    13 with the Mehrotra correction); per direction the bound step (9
    operations a bound, 15 corrected), the ratio test (5 a bound) and the
    finiteness of the primal direction; the predictor's gap products (5 a
    bound); the update, one multiply-add per stored variable with its
    finiteness test (6 a bound, 3 a primal entry); the new gap (2 a bound).
    Per lane: the init rollout and the polish (one factor sweep, two affine
    sweeps, the acceptance)."""
    factor = (nx * nu * (2 * nx - 1) + nu * (nu + 1) // 2 * (1 + 2 * nx) + nu * nu
              + nx * nx * (2 * nx - 1) + nu * nx * (2 * nx - 1) + 2 * nu * nx
              + nx * (nx + 1) // 2 * (1 + 2 * nx + 2 * nu) + 2 * nb)
    affine = (nx * (2 * nx - 1) + nu * (2 * nu - 1) + 2 * nu * nx + 2 * nu * nu
              + nx * (2 * nx + 2 * nu) + 2 * nu * nx + nx * (2 * nx + 2 * nu - 1))
    per_iter = (factor + 2 * affine + nb * (8 + 13)  # sweeps, linear terms
                + nb * (9 + 5) + (nx + nu) + nb * 5  # predictor step, ratio test, gap
                + nb * (15 + 5) + (nx + nu)  # corrector step, ratio test
                + nb * 6 + 3 * (nx + nu) + 2 * nb)  # update, new gap
    per_lane = factor + 2 * (affine + 6 * nb) + 12 * nb + 2 * nx * (nx + nu) + 8 * nb
    return float(N) * (per_iter * iters_sum + per_lane * lanes)


RACE_TIERS = {
    # tier: (entry point, policy, mean tracking error ceiling, closed-loop
    # tolerance kernel vs twin policy: the JAX package's own bars,
    # tests/test_racing_sweep.py:116 and tests/test_pallas_ilqr_dyn.py:216)
    "kinematic": ("racing_sweep", "batched_racing_policy", 0.05, 5e-3),
    "pacejka": ("racing_sweep_dynamic", "batched_racing_dynamic_policy", 0.03, 2e-2),
}


_PHASE = {"name": None, "t0": 0.0}


def phase(name: str | None) -> None:
    """Start phase ``name`` (``None``: end the last one), printing the
    seconds the previous phase took."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"-- {_PHASE['name']}: {now - _PHASE['t0']:.1f} s", flush=True)
    _PHASE.update(name=name, t0=now)
    if name is not None:
        print(f"== {name}", flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def initial_states(torch, device, batch=BATCH):
    import numpy as np

    rng = np.random.default_rng(0)
    p = rng.uniform(-140.0, -20.0, batch)
    v = rng.uniform(-15.0, 24.0, batch)
    return torch.as_tensor(np.stack([p, v], axis=1), dtype=torch.float32, device=device)


def time_cuda(torch, fn, reps: int) -> float:
    """Milliseconds per call, CUDA events around ``reps`` calls after one
    warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(torch, name, got, ref, kind=None):
    """Print and gate kernel against twin; returns max|Δx| over the rows
    whose percentile is gated. ``kind`` (``name`` when ``None``) picks the
    tolerances: "cold", "polished" (held on iterations and success only) or
    "warm"."""
    kind = kind or name
    (sol_k, ni_k), (sol_t, ni_t) = got, ref
    same = ni_k == ni_t
    ni_agree = same.float().mean().item()
    conv_agree = (sol_k.converged == sol_t.converged).float().mean().item()
    rate_k = sol_k.converged.float().mean().item()
    rate_t = sol_t.converged.float().mean().item()
    row_err = (sol_k.x - sol_t.x).abs().amax(dim=1)
    # x is a solution only where the solve converged: gate rows that
    # converged on both sides after the same iterations
    both = same & sol_k.converged & sol_t.converged
    err = row_err[both]
    err_max = err.max().item()
    err_q999 = torch.quantile(err, 0.999).item()
    gate_x = kind != "polished"
    print(
        f"{name}: max|x_kernel - x_twin| on rows converged on both sides after "
        f"the same iterations: q999 {err_q999:.3e}"
        f"{f' (tol {TOL_X_Q999:.0e})' if gate_x else ' (not gated)'}, max "
        f"{err_max:.3e}; over all rows max {row_err.max().item():.3e}; converged agree {conv_agree:.5f} "
        f"(tol {TOL_CONV_AGREE[kind]}); converged {rate_k:.5f} vs twin {rate_t:.5f}; "
        f"executed iterations agree {ni_agree:.5f} (tol {TOL_NI_AGREE}); mean "
        f"executed {ni_k.mean().item():.2f} vs twin {ni_t.mean().item():.2f}",
        flush=True,
    )
    ok = conv_agree >= TOL_CONV_AGREE[kind] and ni_agree >= TOL_NI_AGREE
    ok = ok and (err_q999 <= TOL_X_Q999 if gate_x else abs(rate_k - rate_t) <= TOL_CONV_RATE)
    if not ok:
        raise SystemExit(f"kernel disagrees with its twin on the {name} config")
    return err_max if gate_x else 0.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--headline-loop"]:
        # the headline's timing alone, for the port found under the given
        # directory; with --outputs PATH also the launch's outputs saved to
        # PATH or compared with those already there
        sys.path.insert(0, os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else "."))
        import model_predictive_control_tpu_torch as port
        from model_predictive_control_tpu_torch.ops.cuda import admm_kernel as K

        card = smi()
        print(f"the port at {os.path.dirname(port.__file__)} [{card}]", flush=True)
        if "--outputs" in sys.argv:
            outputs_report(torch, port, K, card, torch.device("cuda"),
                           sys.argv[sys.argv.index("--outputs") + 1])
        headline_report(torch, port, K, card, torch.device("cuda"))
        return 0
    if sys.argv[1:2] == ["--long-horizon-loop"]:
        # the loop's timing alone, for the port found under the given
        # directory (another version of it, to compare two on one card)
        sys.path.insert(0, os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else "."))
        import model_predictive_control_tpu_torch as port
        from model_predictive_control_tpu_torch.ops.cuda import riccati_ip_kernel as KR

        card = smi()
        print(f"the port at {os.path.dirname(port.__file__)} [{card}]", flush=True)
        loop_report(torch, port, KR, card, torch.device("cuda"))
        return 0
    if sys.argv[1:2] == ["--tracker-launches"]:
        # the racing tiers' warm tracker launch alone, for the port found
        # under the given directory (another version of it, to compare two
        # on one card)
        sys.path.insert(0, os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else "."))
        import model_predictive_control_tpu_torch as port
        from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as KF

        card = smi()
        print(f"the port at {os.path.dirname(port.__file__)} [{card}]", flush=True)
        tracker_launch_report(torch, port, KF, card, torch.device("cuda"))
        return 0
    if sys.argv[1:2] == ["--long-horizon-phases"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import model_predictive_control_tpu_torch as port
        from model_predictive_control_tpu_torch.ops.cuda import riccati_ip_kernel as KR

        phase_report(torch, port, KR, smi(), torch.device("cuda"))
        return 0
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import model_predictive_control_tpu_torch as port
    from model_predictive_control_tpu_torch.ops.cuda import admm_kernel as K

    if sys.argv[1:2] == ["--family-phases"]:
        # the linear family's phases alone, on the ADMM kernel's two builds
        # they launch
        card = smi()
        build_all([(K.library_name(c, lanes), lambda c=c, lanes=lanes: K._build_library(c, lanes))
                   for c, lanes in ((MHE_COLS, 16), (WIDE_COLS, 32), (ADMM_COLS, 16))])
        print(json.dumps({"kernels": family_phases(torch, port, K, card, torch.device("cuda"))}))
        phase(None)
        return 0
    from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as KF
    from model_predictive_control_tpu_torch.ops.cuda import ilqr_kernel as KI
    from model_predictive_control_tpu_torch.ops.cuda import riccati_ip_kernel as KR

    device = torch.device("cuda")
    card = smi()
    if sys.argv[1:2] == ["--benchmark-phases"]:
        # the tracker kernel's benchmark models alone, on its libraries
        print(card, flush=True)
        build_all([(KF.library_name(g), lambda g=g: KF._build_library(g)) for g in RACE_GROUPS])
        print(json.dumps({"kernels": benchmark_phases(torch, port, KF, card, device)}))
        phase(None)
        return 0

    if sys.argv[1:2] == ["--factory-phases"]:
        # the tracker kernel's second library alone: factory parking, the MHE
        # windows (and the hand parking kernel for the informational sweep)
        print(card, flush=True)
        build_all([*((KF.library_name(g, True), lambda g=g: KF._build_library(g, True))
                     for g in FACTORY_GROUPS),
                   (KI.library_name(KI.DEFAULT_GROUP), lambda: KI._build_library(KI.DEFAULT_GROUP))])
        print(json.dumps({"kernels": factory_phases(torch, port, KF, card, device)}))
        phase(None)
        return 0

    phase("environment")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    print("nvcc:", (ver.stdout.strip().splitlines() or ["missing"])[-1])
    try:
        import triton

        print(f"triton {triton.__version__} imports")
    except ImportError as exc:
        print(f"triton does not import: {exc}")
    print(card, flush=True)

    phase("build")
    # the parking and tracker kernels are one library per thread group, the
    # stagewise-IP kernel one per (nx, nu) and group: the path's and the
    # nx=3 / nu=2 case's
    build_all([
        (K.library_name(ADMM_COLS), lambda: K._build_library(ADMM_COLS)),
        (K.library_name(MHE_COLS), lambda: K._build_library(MHE_COLS)),
        (K.library_name(WIDE_COLS, 32), lambda: K._build_library(WIDE_COLS, 32)),
        *((KI.library_name(g), lambda g=g: KI._build_library(g)) for g in PARK_GROUPS),
        *((KF.library_name(g), lambda g=g: KF._build_library(g)) for g in RACE_GROUPS),
        *((KF.library_name(g, True), lambda g=g: KF._build_library(g, True))
          for g in FACTORY_GROUPS),
        *((KR.library_name(nx, nu, g), lambda nx=nx, nu=nu, g=g: KR._build_library(nx, nu, g))
          for nx, nu in ((2, 1), (3, 2)) for g in LH_GROUPS),
    ])
    admm = admm_phases(torch, port, K, card, device)
    family = family_phases(torch, port, K, card, device)
    ilqr = ilqr_phases(torch, port, KI, card, device)
    modes = mode_phases(torch, port, KI, card, device)
    racing = [racing_phases(torch, port, KF, tier, card, device) for tier in RACE_TIERS]
    bench = benchmark_phases(torch, port, KF, card, device)
    factory = factory_phases(torch, port, KF, card, device)
    stagewise = stagewise_phases(torch, port, KR, card, device)
    kernels = [admm, *family, ilqr, modes, *racing, *bench, *factory, stagewise]
    phase(None)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def build_all(libraries) -> None:
    """Build every ``(library name, build function)`` at once (one nvcc per
    library), then print each build's seconds and ptxas's register and spill
    lines."""
    from model_predictive_control_tpu_torch.ops.cuda._build import ptxas_report

    seconds, errors = {}, {}

    def build(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as exc:  # reported below, for every library
            errors[name] = exc
        seconds[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=build, args=lib) for lib in libraries]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, _ in libraries:
        print(f"built {name}.cu in {seconds[name]:.1f} s", flush=True)
        report = ptxas_report(name)
        if name not in errors and report.exists():
            for line in report.read_text().splitlines():
                if "Compiling" in line or "registers" in line or "spill" in line:
                    print(f"ptxas {name}:", line.strip())
    if errors:
        raise SystemExit(f"kernel build failed: {errors}")


def headline(torch, port, K, device):
    """``(problem, ctrl, system, episode)``: the headline problem, its
    controller and plant, and
    ``episode(x0, backend="cuda", steps=STEPS, tile=None)``, the closed loop
    through the public entry points only (the same in every version of the
    port, so that two versions time alike): the compaction sort, the 2×
    presolve, ``steps`` warm steps."""
    problem = port.session2_problem(N=HORIZON)
    ctrl = port.make_linear_mpc(
        problem, iters=ADMM_ITERS, rho=RHO, dtype=torch.float32, device=device
    )
    system = problem.system(torch.float32, device)

    def episode(x0, backend="cuda", steps=STEPS, tile=None):
        tile = tile or K.DEFAULT_TILE
        x0 = x0[torch.argsort(port.boundary_compaction_key(problem.p_max, x0), stable=True)]
        carry = ctrl.presolve_batch_carry(x0, iters_mult=PRESOLVE_MULT, backend=backend, tile=tile)
        policy = ctrl.batched_policy(
            backend=backend, tile=tile, max_rho_moves=0, polish=False, probe_iters=PROBE_ITERS,
        )
        return port.simulate_batch(x0, system, steps, policy, carry, batched_dynamics=True)

    return problem, ctrl, system, episode


def headline_events(torch, K, episode, x0, **kw):
    """One episode with CUDA events around every launch: its wall, the
    event pairs (the presolve's first) and its result."""
    events = []
    launch = K._launch
    K._launch = timed_launches(torch, K, events)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = episode(x0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        K._launch = launch
    return wall, events, res


def headline_report(torch, port, K, card, device) -> float:
    """Times the headline episode at the kernel's default tile: the wall
    (best of 3, after a warm-up), CUDA events around every launch of one
    more episode (the presolve launch, the steady ones, the kernel's share
    of the wall), a 5-step window under ``torch.profiler`` (the device's
    idle share) and the warm launch alone. Returns the best wall."""
    problem, ctrl, system, episode = headline(torch, port, K, device)
    x0 = initial_states(torch, device)
    episode(x0)  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = episode(x0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    print(f"headline episode {BATCH} x {STEPS} steps, tile {K.DEFAULT_TILE}: wall {dt:.4f} s (best "
          f"of 3: {', '.join(f'{t:.4f}' for t in times)}); {BATCH * STEPS / dt:.1f} solves/s; step "
          f"{1e3 * dt / STEPS:.3f} ms; success "
          f"{res.logs['solver_success'].float().mean().item():.5f} [{card}]", flush=True)
    wall, events, _ = headline_events(torch, K, episode, x0)
    print_events(wall, events, card)
    profile_sweep(torch, lambda b, steps, device: episode(x0, steps=steps), BATCH, card, device,
                  kernel="admm_tile_kernel")
    x0s = x0[torch.argsort(port.boundary_compaction_key(problem.p_max, x0), stable=True)]
    args, kw = warm_operands(torch, K, ctrl, system, x0s)
    print(f"warm launch alone at tile {K.DEFAULT_TILE}: "
          f"{time_cuda(torch, lambda: K._launch(*args, **kw), 10):.4f} ms [{card}]", flush=True)
    return dt


def warm_operands(torch, K, ctrl, system, x0s, tile=None, cold=None):
    """The prepared operands of the headline's first warm step at ``tile``
    (the default when ``None``), from the twin's polished presolve (the same
    float program in every version of the port), as ``(args, kw)`` for
    ``K._launch``; ``cold``: those of the unpolished presolve instead."""
    tile = tile or K.DEFAULT_TILE
    q, l, u = ctrl.qp.qp_vectors(x0s)
    base = dict(schedule="uniform", cg_iters=40, alpha=1.6, eps_abs=None, tile=tile)
    if cold:
        return K.prepare_tiles(ctrl.op, q, l, u, None, None, iters=ADMM_ITERS * PRESOLVE_MULT,
                               chunks=2 * PRESOLVE_MULT, probe_iters=0, max_rho_moves=None,
                               polish=False, **base)
    sol = K.admm_solve_twin(ctrl.op, q, l, u, iters=ADMM_ITERS * PRESOLVE_MULT,
                            chunks=2 * PRESOLVE_MULT, probe_iters=0, tile=tile)
    x1 = system(x0s, sol.x[:, : ctrl.qp.nu])
    wx, wy = ctrl._shift_warm(sol.x, sol.y, axis=1)
    q1, l1, u1 = ctrl.qp.qp_vectors(x1)
    return K.prepare_tiles(ctrl.op, q1, l1, u1, wx, wy, iters=ADMM_ITERS, chunks=2,
                           probe_iters=PROBE_ITERS, max_rho_moves=0, polish=False, **base)


def outputs_report(torch, port, K, card, device, path) -> None:
    """The launch's outputs on the headline's cold unpolished presolve and
    its first warm step at the default tile: saved to ``path``, or, where
    ``path`` holds another version's, compared with them bit for bit (the
    first differing output named with its largest difference)."""
    problem, ctrl, system, _ = headline(torch, port, K, device)
    x0s = initial_states(torch, device)
    x0s = x0s[torch.argsort(port.boundary_compaction_key(problem.p_max, x0s), stable=True)]
    outs = {}
    for name, cold in (("cold", True), ("warm", False)):
        args, kw = warm_operands(torch, K, ctrl, system, x0s, cold=cold)
        outs[name] = [t.cpu() for t in K._launch(*args, **kw)]
    if not os.path.exists(path):
        torch.save(outs, path)
        print(f"saved the launch's outputs to {path}", flush=True)
        return
    ref = torch.load(path)
    for name in outs:
        for field, a, b in zip(("x", "z", "y", "executed iterations"), outs[name], ref[name]):
            diff = (a - b).abs()
            print(f"{name} {field}: {'bit for bit' if torch.equal(a, b) else 'DIFFERS'} against "
                  f"{path} (max |difference| {diff.max().item():.3e}, "
                  f"{int((diff > 0).sum())} of {diff.numel()} elements) [{card}]", flush=True)


def admm_phases(torch, port, K, card, device) -> dict:
    """The linear path: ADMM kernel vs twin, the headline closed loop, its
    timing, the tile sweep. Returns the kernel's entry of the ``kernels``
    line."""
    problem, ctrl, system, episode = headline(torch, port, K, device)
    x0s = initial_states(torch, device)
    x0s = x0s[torch.argsort(port.boundary_compaction_key(problem.p_max, x0s), stable=True)]

    phase(f"ADMM kernel vs twin on the card (B={BATCH}, n={ctrl.qp.n}, m={ctrl.qp.m}, tile={K.DEFAULT_TILE})")
    q, l, u = ctrl.qp.qp_vectors(x0s)
    cold_kw = dict(iters=ADMM_ITERS * PRESOLVE_MULT, chunks=2 * PRESOLVE_MULT,
                   probe_iters=0, polish=False, tile=K.DEFAULT_TILE, return_iters=True)
    err = compare(torch, "cold", K.admm_solve_cuda(ctrl.op, q, l, u, **cold_kw),
                  K.admm_solve_twin(ctrl.op, q, l, u, **cold_kw))
    cold_kw["polish"] = True  # the presolve's config
    cold_k = K.admm_solve_cuda(ctrl.op, q, l, u, **cold_kw)
    compare(torch, "polished", cold_k, K.admm_solve_twin(ctrl.op, q, l, u, **cold_kw))

    x1 = system(x0s, cold_k[0].x[:, : ctrl.qp.nu])
    wx, wy = ctrl._shift_warm(cold_k[0].x, cold_k[0].y, axis=1)
    q1, l1, u1 = ctrl.qp.qp_vectors(x1)
    warm_kw = dict(iters=ADMM_ITERS, chunks=2, probe_iters=PROBE_ITERS,
                   max_rho_moves=0, polish=False, tile=K.DEFAULT_TILE, return_iters=True)
    warm_k = K.admm_solve_cuda(ctrl.op, q1, l1, u1, wx, wy, **warm_kw)
    warm_t = K.admm_solve_twin(ctrl.op, q1, l1, u1, wx, wy, **warm_kw)
    err = max(err, compare(torch, "warm", warm_k, warm_t))

    ms = {}
    for name, kw, args in (("polished", cold_kw, (q, l, u)), ("warm", warm_kw, (q1, l1, u1, wx, wy))):
        kw = {**kw, "return_iters": False}
        ms[name] = (
            time_cuda(torch, lambda: K.admm_solve_cuda(ctrl.op, *args, **kw), 10),
            time_cuda(torch, lambda: K.admm_solve_twin(ctrl.op, *args, **kw), 2),
        )
        print(f"{name}: wrapper {ms[name][0]:.3f} ms per solve of {BATCH} (kernel), "
              f"{ms[name][1]:.3f} ms (twin) [{card}]", flush=True)
    # the kernel alone: launches on prepared operands, no scaling or finish
    raw = {k: v for k, v in warm_kw.items() if k != "return_iters"}
    args, raw_kw = K.prepare_tiles(ctrl.op, q1, l1, u1, wx, wy, cg_iters=40,
                                   alpha=1.6, eps_abs=None, schedule="uniform", **raw)
    kernel_ms = time_cuda(torch, lambda: K._launch(*args, **raw_kw), 10)
    twin_ms = time_cuda(torch, lambda: K.admm_solve_tiles_reference(*args, **raw_kw), 2)
    plan = K.launch_plan(ctrl.qp.n, ctrl.qp.m, K.DEFAULT_TILE, False)
    print(f"warm kernel alone {kernel_ms:.3f} ms per launch, twin alone {twin_ms:.3f} ms; "
          f"{plan.threads_per_tile} threads a tile, {plan.tiles_per_cta} tiles a CTA of "
          f"{plan.threads} threads, {plan.smem_bytes} bytes of shared memory [{card}]", flush=True)
    pre_args, pre_kw = K.prepare_tiles(ctrl.op, q, l, u, None, None, iters=ADMM_ITERS * PRESOLVE_MULT,
                                       chunks=2 * PRESOLVE_MULT, probe_iters=0, max_rho_moves=None,
                                       schedule="uniform", tile=K.DEFAULT_TILE, cg_iters=40,
                                       alpha=1.6, eps_abs=None, polish=True)
    print(f"presolve launch alone (160 iterations, rho moves, CG polish): "
          f"{time_cuda(torch, lambda: K._launch(*pre_args, **pre_kw), 3):.3f} ms [{card}]",
          flush=True)
    # per scenario and executed iteration: the product [x | rho z - y] W,
    # 2 (n + m)^2, and ~12 operations on each of the n + m columns
    k = ctrl.qp.n + ctrl.qp.m
    outs = K._launch(*args, **raw_kw)
    roof = bound(torch, float(outs[3].sum()) * (2 * k * k + 12 * k), [*args, *outs])

    phase(f"linear main path: {BATCH} scenarios x {STEPS} steps, tile {K.DEFAULT_TILE}")
    x0_all = initial_states(torch, device)
    K.LAUNCHES = 0
    res = episode(x0_all)
    torch.cuda.synchronize()
    launches = K.LAUNCHES
    print(f"kernel launches in the episode: {launches} (expected {STEPS + 1})")
    if launches != STEPS + 1:
        raise SystemExit("the main path did not go through the kernel once per solve")
    if not bool(torch.isfinite(res.states).all()):
        raise SystemExit("non-finite states")
    if res.states.shape != (STEPS + 1, BATCH, 2) or res.inputs.shape != (STEPS, BATCH, 1):
        raise SystemExit(f"unexpected shapes {res.states.shape} {res.inputs.shape}")
    success = res.logs["solver_success"].float().mean().item()
    print(f"success rate {success:.5f} (gate: the contract floor {CONTRACT_SUCCESS})")
    if success < CONTRACT_SUCCESS:
        raise SystemExit("success rate below the contract floor")
    sub = x0_all[torch.argsort(port.boundary_compaction_key(problem.p_max, x0_all), stable=True)]
    sub = sub[:TWIN_SCENARIOS]
    ref = episode(sub, backend="twin")
    got = episode(sub)
    d_final = (got.states[-1] - ref.states[-1]).abs().max().item()
    d_sorted = (res.states[-1, :TWIN_SCENARIOS] - ref.states[-1]).abs().max().item()
    print(f"first {TWIN_SCENARIOS} sorted scenarios, final states kernel vs twin episode: "
          f"{d_final:.3e} alone, {d_sorted:.3e} within the full batch (tol {TOL_STATES})")
    if not (d_final <= TOL_STATES and d_sorted <= TOL_STATES):
        raise SystemExit("closed loop disagrees with the twin episode")

    phase("linear main path timing")
    headline_report(torch, port, K, card, device)

    phase("headline per tile, one round (informational)")
    for tile in ADMM_SWEEP_TILES:
        wall, events, out = headline_events(torch, K, episode, x0_all, tile=tile)
        per = sorted(a.elapsed_time(b) for a, b in events[1:])
        share = out.logs["solver_success"].float().mean().item()
        t_args, t_kw = warm_operands(torch, K, ctrl, system, x0s, tile=tile)
        print(f"tile {tile}: episode wall {wall:.4f} s, {BATCH * STEPS / wall:.1f} solves/s, in the "
              f"kernel {sum(a.elapsed_time(b) for a, b in events):.1f} ms over {len(events)} "
              f"launches (presolve {events[0][0].elapsed_time(events[0][1]):.3f} ms, steady median "
              f"{per[len(per) // 2]:.3f} ms); success {share:.5f}; warm launch alone "
              f"{time_cuda(torch, lambda: K._launch(*t_args, **t_kw), 5):.4f} ms [{card}]",
              flush=True)
    del out

    return {
        "name": "admm_tile_kernel",
        "route": "cuda",
        "source": "model_predictive_control_tpu_torch/csrc/admm_kernel.cu",
        "replaces": "model_predictive_control_tpu/ops/pallas/admm_kernel.py:82",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
        **roof,
    }


def wide_controller(torch, port, device):
    """The MHE loop's slack-softened MPC at N = 20 (n = 60, m = 140: K1's
    wide mode), as ``mhe_loop_sweep`` builds it."""
    problem = port.session2_problem(N=WIDE_N)
    return problem, port.make_linear_mpc(problem, iters=WIDE_ITERS, dtype=torch.float32,
                                         device=device, soft_state=True,
                                         slack_weight=WIDE_SLACK_WEIGHT, rho=WIDE_RHO)


def gate_summary(path, summary, gates) -> None:
    """Print a sweep's summary and fail on any quality gate it misses."""
    bad = [f"{k} {summary[k]:.5f} (gate {op} {v})" for k, (op, v) in gates.items()
           if not (summary[k] >= v if op == ">=" else summary[k] <= v)]
    print(f"{path}: " + ", ".join(f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
                                  for k, v in summary.items()), flush=True)
    if bad:
        raise SystemExit(f"the {path} path misses its gates: {'; '.join(bad)}")


def mhe_windows(torch, port, batch, device):
    """The MHE loop's first two batches of windows at ``batch`` scenarios,
    as ``mhe_loop_sweep`` poses them to the kernel: ``[(mhe, q, l, u, (wx,
    wy)), ...]`` of step 0 (its warm start zero: a cold start) and step 1
    (warm from step 0's solution)."""
    from model_predictive_control_tpu_torch import estimation
    from model_predictive_control_tpu_torch.parallel import batch as PB

    seen = []
    solve = estimation.MHE.solve_batch

    def spy(self, xbars, us, ys, *args, warm=None, **kw):
        if len(seen) < 2:
            l, u, _ = self._bounds(us)
            seen.append((self, self._linear_term(xbars, us, ys), l, u, warm))
        return solve(self, xbars, us, ys, *args, warm=warm, **kw)

    estimation.MHE.solve_batch = spy
    try:
        PB.mhe_loop_sweep(batch, 2, device=device)
    finally:
        estimation.MHE.solve_batch = solve
    return seen


def float64_twin(torch, plain):
    """The twin's algorithm in float64 on the same float32 operands, its
    results rounded back to float32: a witness of which side float32
    rounding moved a closed loop to."""
    def witness(*args, **kw):
        return tuple(o.float() for o in plain(*(a.double() for a in args), **kw))

    return witness


def family_twin_loop(torch, K, sweep, path, device) -> None:
    """Kernel against twin in closed loop: FAMILY_TWIN_SCENARIOS scenarios x
    FAMILY_TWIN_STEPS steps of each draw in FAMILY_TWIN_SEEDS through the
    kernel (twice: it must repeat bit for bit), the twin and the twin's
    float64 witness. Every scenario's final state lies within TOL_STATES of
    the twin's or of the witness's; the success rate over all draws within
    TOL_CONV_RATE of the twin's or of the witness's, and the success masks
    agree with the twin's on TOL_CONV_AGREE["polished"] of each draw's
    entries. Every scenario outside TOL_STATES of the twin is printed with
    its distances to the witness."""
    d_kt, d_kw, d_tw, agree, succ = [], [], [], [], {"kernel": [], "twin": [], "witness": []}
    for seed in FAMILY_TWIN_SEEDS:
        def run(**kw):
            res, _ = sweep(FAMILY_TWIN_SCENARIOS, FAMILY_TWIN_STEPS, device=device,
                           generator=torch.Generator().manual_seed(seed), **kw)
            return res

        got, again, ref = run(), run(), run(backend="twin")
        plain = K.admm_solve_tiles_reference
        K.admm_solve_tiles_reference = float64_twin(torch, plain)
        try:
            wit = run(backend="twin")
        finally:
            K.admm_solve_tiles_reference = plain
        if not (torch.equal(got.states, again.states) and torch.equal(got.inputs, again.inputs)):
            raise SystemExit(f"the {path} path's kernel closed loop does not repeat bit for bit")
        fin = lambda a, b: (a.states[-1] - b.states[-1]).abs().amax(dim=1)
        d_kt.append(fin(got, ref))
        d_kw.append(fin(got, wit))
        d_tw.append(fin(ref, wit))
        masks = {k: r.logs["solver_success"] for k, r in (("kernel", got), ("twin", ref),
                                                          ("witness", wit))}
        for k, v in masks.items():
            succ[k].append(v)
        agree.append((masks["kernel"] == masks["twin"]).float().mean().item())
        print(f"  seed {seed}: success kernel / twin / witness "
              + " / ".join(f"{v.float().mean().item():.5f}" for v in masks.values())
              + f", masks agree {agree[-1]:.5f}", flush=True)
        for i in torch.nonzero(d_kt[-1] > TOL_STATES).flatten().tolist():
            traj = lambda r: " ".join(f"({a:.4f}, {b:.4f})" for a, b in r.states[:, i].tolist())
            print(f"  seed {seed} scenario {i} outside {TOL_STATES}: kernel-twin "
                  f"{d_kt[-1][i].item():.3e}, kernel-witness {d_kw[-1][i].item():.3e}, "
                  f"twin-witness {d_tw[-1][i].item():.3e}; success kernel "
                  f"{masks['kernel'][:, i].int().tolist()} twin {masks['twin'][:, i].int().tolist()} "
                  f"witness {masks['witness'][:, i].int().tolist()}; states kernel {traj(got)}; "
                  f"twin {traj(ref)}; witness {traj(wit)}", flush=True)
    d_kt, d_kw, d_tw = (torch.cat(d) for d in (d_kt, d_kw, d_tw))
    rate = {k: torch.cat(v, dim=1).float().mean().item() for k, v in succ.items()}
    held = torch.minimum(d_kt, d_kw)
    rate_d = min(abs(rate["kernel"] - rate["twin"]), abs(rate["kernel"] - rate["witness"]))
    print(f"{len(FAMILY_TWIN_SEEDS)} draws of {FAMILY_TWIN_SCENARIOS} scenarios x "
          f"{FAMILY_TWIN_STEPS} steps (the kernel repeats bit for bit): final states of the kernel "
          f"within {TOL_STATES} of the twin's on {(d_kt <= TOL_STATES).float().mean().item():.5f} "
          f"of the scenarios (max {d_kt.max().item():.3e}), of the float64 witness's on "
          f"{(d_kw <= TOL_STATES).float().mean().item():.5f} (max {d_kw.max().item():.3e}); twin "
          f"to witness within on {(d_tw <= TOL_STATES).float().mean().item():.5f} (max "
          f"{d_tw.max().item():.3e}); of either, max {held.max().item():.3e} (tol {TOL_STATES}); "
          f"success kernel {rate['kernel']:.5f}, twin {rate['twin']:.5f}, witness "
          f"{rate['witness']:.5f} (tol {TOL_CONV_RATE} to either); masks agree {min(agree):.5f} at "
          f"worst (tol {TOL_CONV_AGREE['polished']})", flush=True)
    if not (held.max().item() <= TOL_STATES and rate_d <= TOL_CONV_RATE
            and min(agree) >= TOL_CONV_AGREE["polished"]):
        raise SystemExit(f"the {path} path's closed loop disagrees with its twin")


def loop_launch_entry(torch, K, name, launches, card) -> dict:
    """The ``kernels`` entry of one instantiation from a closed loop's
    launches ``[(ms, args, kw, outs), ...]`` (CUDA events around each):
    prints every launch's time and executed iterations (mean, max over the
    scenarios), then times the launch of median time after the first (a
    cold start) alone (the kernel, 10 calls; the twin, 2) and takes its
    bound from that launch's executed iterations."""
    print(f"{name}: {len(launches)} launches, ms / mean / max executed iterations: "
          + ", ".join(f"{ms:.3f}/{o[3].mean().item():.1f}/{o[3].max().item():.0f}"
                      for ms, _, _, o in launches) + f" [{card}]", flush=True)
    ms, args, kw, _ = sorted(launches[1:], key=lambda r: r[0])[(len(launches) - 1) // 2]
    kernel_ms = time_cuda(torch, lambda: K._launch(*args, **kw), 10)
    twin_ms = time_cuda(torch, lambda: K.admm_solve_tiles_reference(*args, **kw), 2)
    outs = K._launch(*args, **kw)
    k = args[9].shape[1] + args[10].shape[1]
    print(f"{name}: the launch of median time ({ms:.3f} ms in the loop; mean executed "
          f"{outs[3].mean().item():.2f}, max {outs[3].max().item():.0f}) alone: kernel "
          f"{kernel_ms:.3f} ms, twin {twin_ms:.3f} ms [{card}]", flush=True)
    # per scenario and executed iteration: [x | rho z - y] W, 2 (n + m)^2,
    # and ~12 operations on each of the n + m columns
    roof = bound(torch, float(outs[3].sum()) * (2 * k * k + 12 * k), [*args, *outs])
    return {"ms": kernel_ms, "plain_ms": twin_ms, **roof}


def family_phases(torch, port, K, card, device) -> list:
    """The rest of the linear ADMM family on K1: the wide mode against its
    twin on the soft-state MPC at N = 20, the MHE loop's windows against the
    twin, then the tube, stochastic and MHE-loop paths at the contract's
    sizes (launches counted, quality gated, a kernel-vs-twin closed loop
    with a float64 witness, one timed round each). Returns the ``kernels``
    entries of the wide instantiation and of the MHE windows' one, each
    timed and bounded on a launch of the MHE loop."""
    from model_predictive_control_tpu_torch.parallel import batch as PB

    problem, ctrl = wide_controller(torch, port, device)
    wide_name, mhe_name = K.library_name(WIDE_COLS, 32), K.library_name(MHE_COLS)
    n, m = ctrl.qp.n, ctrl.qp.m
    plan = K.launch_plan(n, m, K.DEFAULT_TILE, True)
    phase(f"ADMM kernel wide mode vs twin on the card (soft-state MPC, B={WIDE_BATCH}, n={n}, "
          f"m={m}, tile={K.DEFAULT_TILE})")
    if not plan.wide or K.library_name(plan.cols, plan.lanes) != wide_name:
        raise SystemExit(f"the soft-state operator does not take the wide mode: {plan}")
    g = torch.Generator().manual_seed(0)
    x0s = PB.mhe_loop_scenarios(g, WIDE_BATCH, 1, 10, problem.Ts, 0.02, 0.1)[0].to(
        dtype=torch.float32, device=device)
    q, l, u = ctrl.qp.qp_vectors(x0s)
    cold_kw = dict(iters=4 * WIDE_ITERS, chunks=8, probe_iters=0, polish=False,
                   tile=K.DEFAULT_TILE, return_iters=True)
    wide_err = compare(torch, "wide cold", K.admm_solve_cuda(ctrl.op, q, l, u, **cold_kw),
                       K.admm_solve_twin(ctrl.op, q, l, u, **cold_kw), kind="cold")
    cold_kw["polish"] = True  # the presolve's config
    cold_k = K.admm_solve_cuda(ctrl.op, q, l, u, **cold_kw)
    compare(torch, "wide polished", cold_k, K.admm_solve_twin(ctrl.op, q, l, u, **cold_kw),
            kind="polished")
    x1 = problem.system(torch.float32, device)(x0s, cold_k[0].x[:, : ctrl.qp.nu])
    wx, wy = ctrl._shift_warm(cold_k[0].x, cold_k[0].y, axis=1)
    q1, l1, u1 = ctrl.qp.qp_vectors(x1)
    # the loop's steady solve (polish on) on iterations and success; the
    # same step without the polish also on x
    warm_kw = dict(iters=WIDE_ITERS, tile=K.DEFAULT_TILE, return_iters=True)
    compare(torch, "wide warm polished", K.admm_solve_cuda(ctrl.op, q1, l1, u1, wx, wy, **warm_kw),
            K.admm_solve_twin(ctrl.op, q1, l1, u1, wx, wy, **warm_kw), kind="polished")
    warm_kw["polish"] = False
    wide_err = max(wide_err, compare(torch, "wide warm",
                                     K.admm_solve_cuda(ctrl.op, q1, l1, u1, wx, wy, **warm_kw),
                                     K.admm_solve_twin(ctrl.op, q1, l1, u1, wx, wy, **warm_kw),
                                     kind="warm"))
    args, raw_kw = K.prepare_tiles(ctrl.op, q1, l1, u1, wx, wy, iters=WIDE_ITERS, chunks=2,
                                   probe_iters=32, max_rho_moves=None, schedule="uniform",
                                   tile=K.DEFAULT_TILE, cg_iters=40, alpha=1.6, eps_abs=None,
                                   polish=True)
    ni = K._launch(*args, **raw_kw)[3]
    print(f"informational: wide first warm step (the MHE loop's MPC solve: {WIDE_ITERS} "
          f"iterations, probe 32, polish; executed mean {ni.mean().item():.2f}, max "
          f"{ni.max().item():.0f}) alone: kernel "
          f"{time_cuda(torch, lambda: K._launch(*args, **raw_kw), 10):.3f} ms per launch of "
          f"{WIDE_BATCH}; {plan.threads_per_tile} threads a tile, {plan.tiles_per_cta} tiles a "
          f"CTA of {plan.threads} threads, {plan.smem_bytes} bytes of shared memory [{card}]",
          flush=True)

    mhe_batch = FAMILY["mhe_loop"][1]
    windows = mhe_windows(torch, port, mhe_batch, device)
    mhe = windows[0][0]
    wn, wm = mhe.op.P.shape[0], mhe.op.A_c.shape[0]
    phase(f"ADMM kernel vs twin on the MHE loop's windows (B={mhe_batch}, n={wn}, m={wm}, "
          f"tile={K.DEFAULT_TILE})")
    wplan = K.launch_plan(wn, wm, K.DEFAULT_TILE, True)
    if wplan.wide or K.library_name(wplan.cols, wplan.lanes) != mhe_name:
        raise SystemExit(f"the MHE windows do not take the {mhe_name} build: {wplan}")
    mhe_err = 0.0
    for step, (name, (_, q, l, u, (wx, wy))) in enumerate(zip(("cold", "warm"), windows)):
        kw = dict(iters=mhe.iters, tile=K.DEFAULT_TILE, return_iters=True)
        compare(torch, f"MHE windows step {step} (the loop's config, polished)",
                K.admm_solve_cuda(mhe.op, q, l, u, wx, wy, **kw),
                K.admm_solve_twin(mhe.op, q, l, u, wx, wy, **kw), kind="polished")
        kw["polish"] = False
        mhe_err = max(mhe_err, compare(torch, f"MHE windows step {step} ({name})",
                                       K.admm_solve_cuda(mhe.op, q, l, u, wx, wy, **kw),
                                       K.admm_solve_twin(mhe.op, q, l, u, wx, wy, **kw),
                                       kind=name))

    launches, loop = {}, {}
    for path, (name, batch, steps, per_step, gates) in FAMILY.items():
        sweep = getattr(PB, name)
        phase(f"{path} path: {name}({batch}, {steps}), tile {K.DEFAULT_TILE}")
        K.LAUNCHES = 0
        K.LAUNCHES_BY_LIBRARY.clear()
        res, summary = sweep(batch, steps, device=device)
        torch.cuda.synchronize()
        launches[path] = (K.LAUNCHES, dict(K.LAUNCHES_BY_LIBRARY))
        expected = per_step * steps + 1
        print(f"kernel launches in the run: {K.LAUNCHES} (expected {expected}), by library "
              f"{launches[path][1]}", flush=True)
        if K.LAUNCHES != expected:
            raise SystemExit(f"the {path} path did not go through the kernel once per solve")
        if path == "mhe_loop" and (launches[path][1].get(wide_name, 0) != steps + 1
                                   or launches[path][1].get(mhe_name, 0) != steps):
            raise SystemExit("the MHE loop did not go through the wide mode once per MPC solve "
                             f"and {mhe_name} once per batch of windows")
        if not bool(torch.isfinite(res.states).all()) or res.states.shape != (steps + 1, batch, 2):
            raise SystemExit(f"the {path} path's states: {res.states.shape}, or not finite")
        gate_summary(path, summary, gates)
        del res
        family_twin_loop(torch, K, sweep, path, device)
        # one timed round: best of 3 after a warm-up, then CUDA events around
        # every launch of one more run
        sweep(batch, steps, device=device)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sweep(batch, steps, device=device)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        dt = min(times)
        unit = "loop-steps" if path == "mhe_loop" else "solves"
        print(f"{path}: wall {dt:.4f} s (best of 3: {', '.join(f'{t:.4f}' for t in times)}); "
              f"{batch * steps / dt:.1f} {unit}/s; step {1e3 * dt / steps:.3f} ms [{card}]",
              flush=True)
        kept = []
        wall, events, _ = timed_sweep(torch, K, sweep, batch, device, steps=steps, kept=kept)
        print_events(wall, events, card)
        if path == "mhe_loop":
            for lib in (wide_name, mhe_name):
                loop[lib] = [(a.elapsed_time(b), *rest) for (a, b), rest in zip(events, kept)
                             if _library(K, rest[0], rest[1]) == lib]

    entries = []
    for lib, label, err in ((wide_name, "wide mode", wide_err),
                            (mhe_name, "MHE windows", mhe_err)):
        entries.append({
            "name": f"admm_tile_kernel ({label})",
            "route": "cuda",
            "source": "model_predictive_control_tpu_torch/csrc/admm_kernel.cu",
            "replaces": "model_predictive_control_tpu/ops/pallas/admm_kernel.py:82",
            "launches": launches["mhe_loop"][1].get(lib, 0),
            "max_abs_err": err,
            **loop_launch_entry(torch, K, f"mhe_loop {lib}", loop[lib], card),
        })
    return entries


def _library(K, args, kw) -> str:
    """The library a launch with ``args`` and ``kw`` goes through."""
    plan = K.launch_plan(args[9].shape[1], args[10].shape[1], kw["tile"], kw["polish"])
    return K.library_name(plan.cols, plan.lanes)


def parking_scenarios(torch, port, batch, device):
    """The sweep's scenarios: plant parameters, then initial states, from
    one generator seeded 0 (what ``parking_sweep`` draws by default)."""
    from model_predictive_control_tpu_torch.parallel import batch as PB

    g = torch.Generator().manual_seed(0)
    plant = PB.perturb_parameters(g, port.VehicleParameters(), batch, device=device)
    x0 = PB.random_initial_states(g, batch, x_obs=PARK_OBSTACLE, device=device)
    return plant, x0


KERNEL_FIELDS = ("us", "xs", "viol", "converged", "lam", "inner_iters_executed")


def compare_launches(torch, kernel, name, outs, ref, twin_s, card) -> float:
    """Gate a kernel's six outputs at every group in ``outs`` (``group ->
    _launch``'s tuple) bit for bit against the twin's ``ref`` on the same
    operands; returns max|Δu| over all lanes and groups."""
    err = 0.0
    for group, got in outs.items():
        equal = [f for f, a, b in zip(KERNEL_FIELDS, got, ref) if torch.equal(a, b)]
        du = (got[0] - ref[0]).abs().amax(dim=(0, 1))
        err = max(err, du.max().item())
        print(
            f"{name}, group {group}: bitwise equal fields {equal} of {len(KERNEL_FIELDS)}; "
            f"max|u_kernel - u_twin| over all lanes {du.max().item():.3e}, bitwise-equal lanes "
            f"{(du == 0).float().mean().item():.5f}; converged {got[3].float().mean().item():.5f} "
            f"vs twin {ref[3].float().mean().item():.5f}; mean inner iterations "
            f"{got[5].mean().item():.2f}; twin {1e3 * twin_s:.1f} ms per solve (timed once) "
            f"[{card}]",
            flush=True,
        )
        if len(equal) != len(KERNEL_FIELDS):
            raise SystemExit(f"{kernel} (group {group}) is not its twin bit for bit on the "
                             f"{name} config")
    return err


def timed_launches(torch, K, events, kept=None):
    """A stand-in for ``K._launch`` that appends a CUDA event pair around
    each launch to ``events`` (and, with ``kept``, its ``(args, kwargs,
    outputs)`` to ``kept``)."""
    launch = K._launch

    def timed(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kw)
        end.record()
        events.append((start, end))
        if kept is not None:
            kept.append((args, kw, out))
        return out

    return timed


def timed_sweep(torch, K, sweep, B, device, kept=None, **kw):
    """One ``sweep(B, steps)`` with CUDA events around every launch of
    ``K``'s kernel: its wall, the event pairs and its summary (``kept``: as
    :func:`timed_launches`)."""
    events = []
    launch = K._launch
    K._launch = timed_launches(torch, K, events, kept)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, summary = sweep(B, device=device, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        K._launch = launch
    return wall, events, summary


def print_events(wall, events, card) -> None:
    """The kernel's share of one run's wall from its launches' events."""
    per = sorted(a.elapsed_time(b) for a, b in events[1:])
    cold_ms = events[0][0].elapsed_time(events[0][1])
    total = cold_ms + sum(per)
    print(f"informational: one run with events around its {len(events)} launches: wall "
          f"{wall:.4f} s, in the kernel {total:.1f} ms ({100 * total / (1e3 * wall):.1f}% of the "
          f"wall); cold first launch {cold_ms:.3f} ms, steady launches median "
          f"{per[len(per) // 2]:.3f} ms, min {per[0]:.3f}, max {per[-1]:.3f} [{card}]", flush=True)


def sweep_points(torch, K, sweep, B, steps, points, rounds, device, card) -> dict:
    """Whole sweeps per (tile, group) in ``points``, ``rounds`` rounds in
    alternating order, each with events around its launches; prints walls,
    time in the kernel and quality; returns each point's summary."""
    walls, in_kernel, quality = {pt: [] for pt in points}, {pt: [] for pt in points}, {}
    for r in range(rounds):
        for pt in points[:: 1 if r % 2 == 0 else -1]:
            wall, events, quality[pt] = timed_sweep(torch, K, sweep, B, device, steps=steps,
                                                    tile=pt[0], group=pt[1])
            walls[pt].append(wall)
            in_kernel[pt].append(sum(a.elapsed_time(b) for a, b in events))
    for (t, g), w in walls.items():
        w, sm = sorted(w), quality[(t, g)]
        extra = (f"parked {sm['parked_frac_5cm']:.5f}, median {sm['median_final_dist']:.5f} m"
                 if "parked_frac_5cm" in sm else
                 f"mean tracking error {sm['mean_tracking_error']:.5f} m")
        print(f"tile {t} group {g}: {B * steps / w[0]:.1f} solves/s best, "
              f"{B * steps / w[len(w) // 2]:.1f} median of {len(w)} (walls "
              f"{', '.join(f'{v:.4f}' for v in w)} s; in the kernel "
              f"{min(in_kernel[(t, g)]):.1f} ms per sweep at best); success "
              f"{sm['success_rate']:.5f}, {extra}, mean inner iterations "
              f"{sm['mean_inner_iters']:.2f} [{card}]", flush=True)
    return quality


def sweep_grid(K, groups, tiles) -> list:
    """The (tile, group) pairs the kernel's launch bounds take."""
    return [(t, g) for g in groups for t in tiles if t * g <= K.MAX_THREADS[g]]


@contextlib.contextmanager
def spied(torch, K, twin_name, seen):
    """Within the block, ``K._launch`` keeps the last launch's operands in
    ``seen`` and ``K.<twin_name>`` the twin's operands, result and time."""
    launch, reference = K._launch, getattr(K, twin_name)

    def spy_launch(*args, **kw):
        seen.update(args=args, kw=kw)
        return launch(*args, **kw)

    def spy_reference(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = reference(*args, **kw)
        torch.cuda.synchronize()
        seen.update(twin_args=args, twin_kw=kw, want=want, twin_s=time.perf_counter() - t0)
        return want

    K._launch = spy_launch
    setattr(K, twin_name, spy_reference)
    try:
        yield
    finally:
        K._launch = launch
        setattr(K, twin_name, reference)


def held_at_groups(torch, K, kernel, name, seen, groups, group, tile, card,
                   compare=compare_launches):
    """The last spied launch's operands through the kernel at every group of
    ``groups``: checks that the kernel's and the twin's wrappers prepared
    the same solve at the default ``group``, times each group, and gates the
    six outputs bit for bit against the twin's solve (``compare``). Returns
    max|Δu|, the ms per group and the launch's operands and keywords
    (without group)."""
    args, kw = seen["args"], dict(seen["kw"])
    if kw.pop("group") != group:
        raise SystemExit(f"the {kernel} was not launched at the default group")
    same = all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(args, seen["twin_args"], strict=True))
    plain = lambda d: {k: v for k, v in d.items() if k != "ode_rows"}
    if not (same and plain(kw) == plain(seen["twin_kw"])):
        raise SystemExit(f"the {kernel}'s wrapper and the twin's prepared different solves")
    want, twin_s = seen["want"], seen["twin_s"]
    outs = {g: K._launch(*args, group=g, **kw) for g in groups}
    ms = {g: time_cuda(torch, lambda: K._launch(*args, group=g, **kw), 5) for g in groups}
    print(f"{name}: kernel alone, ms per launch by group: "
          f"{', '.join(f'{g}: {v:.3f}' for g, v in ms.items())}; twin {1e3 * twin_s:.1f} ms "
          f"(timed once); tile {tile} [{card}]", flush=True)
    return compare(torch, kernel, name, outs, want, twin_s, card), ms, args, kw


def launch_points(torch, K, args, kw, points, card) -> None:
    """Informational: the same operands launched per (tile, group) of
    ``points`` (the batch is a multiple of every tile, so the padded layout
    is the same; the tile moves the iterations)."""
    for t, g in points:
        at = {**kw, "tile": t, "group": g}
        ni = K._launch(*args, **at)[5].mean().item()
        print(f"informational: warm launch at tile {t} group {g}: "
              f"{time_cuda(torch, lambda: K._launch(*args, **at), 3):.3f} ms, {ni:.2f} executed "
              f"(inner) iterations [{card}]", flush=True)


def ilqr_phases(torch, port, K, card, device) -> dict:
    """The parking path: the AL-iLQR kernel against its twin at the sweep's
    shapes (cold and warm: the wrapper's solution against the twin
    wrapper's, and the launch's operands through the kernel at every group
    of ``PARK_GROUPS`` against that twin solve, all bit for bit), the sweep
    through ``parking_sweep`` with the contract's floors, a small
    kernel-vs-twin closed loop, the timing, CUDA events around every launch
    of one sweep, and the sweep per (tile, group). Returns the kernel's
    entry of the ``kernels`` line."""
    from model_predictive_control_tpu_torch.parallel import batch as PB
    from model_predictive_control_tpu_torch.solvers.parking import Q_MAIN, QN_SCALE_MAIN, R_MAIN

    B, N, tile, group = PARK_BATCH, PARK_N, K.DEFAULT_TILE, K.DEFAULT_GROUP
    groups = [g for g in PARK_GROUPS if tile * g <= K.MAX_THREADS[g]]
    base = port.VehicleParameters()
    plant_params, x0 = parking_scenarios(torch, port, B, device)
    geom, limits = K.parking_geometry(base, PARK_OBSTACLE)
    kw = dict(
        N=N, ts=PARK_TS, geom=geom, limits=limits,
        weights=(tuple(Q_MAIN), tuple(R_MAIN), float(QN_SCALE_MAIN)), n_circles=3,
        outer_iters=6, inner_iters=15, mu_init=10.0, viol_tol=1e-4, tile=tile,
    )
    acc = torch.full((B,), float(base.acceleration), device=device)
    fric = torch.full((B,), float(base.friction), device=device)
    nc = K.n_constraints(3)

    phase(f"AL-iLQR kernel vs twin on the card (B={B}, N={N}, nc={nc}, tile={tile}, default "
          f"group {group}, held at groups {groups})")
    seen = {}

    def both(name, *args, **extra):
        """The wrapper's solve on the kernel and on the twin, held field by
        field; then the launch's operands through the kernel at every group,
        held against the twin's solve."""
        with spied(torch, K, "al_ilqr_tiles_reference", seen):
            got = K.al_ilqr_solve_cuda(*args, **extra, **kw)
            ref = K.al_ilqr_solve_twin(*args, **extra, **kw)
        differ = [f for f in KERNEL_FIELDS if not torch.equal(getattr(got, f), getattr(ref, f))]
        print(f"{name}: al_ilqr_solve_cuda against al_ilqr_solve_twin at {B} lanes: "
              f"{'all fields bitwise equal' if not differ else f'{differ} differ'}; converged "
              f"{got.converged.float().mean().item():.5f}", flush=True)
        if differ:
            raise SystemExit(f"the AL-iLQR wrapper on the kernel is not the twin ({name})")
        return got, *held_at_groups(torch, K, "AL-iLQR kernel", name, seen, groups, group,
                                    tile, card)

    cold, err, _, _, _ = both("cold", x0, torch.zeros(B, N, 2, device=device), acc, fric)
    # the warm config as the policy makes it: one plant step with u0, the
    # shifted controls and the shifted, decayed multipliers
    x1 = port.batched_plant(plant_params, PARK_TS)(x0, cold.us[:, 0])
    u1 = torch.cat([cold.us[:, 1:], cold.us[:, -1:]], dim=1)
    lam1 = 0.7 * torch.where(
        cold.converged[:, None, None], torch.cat([cold.lam[:, 1:], cold.lam[:, -1:]], dim=1), 0.0
    )
    _, err_w, ms, args, raw = both("warm", x1, u1, acc, fric, lam_init=lam1)
    err = max(err, err_w)
    # the entry's times: the warm launch at the default group, and the twin
    # on the same operands (its solve above)
    kernel_ms, twin_ms = ms[group], 1e3 * seen["twin_s"]
    wrapper_ms = time_cuda(torch, lambda: K.al_ilqr_solve_cuda(x1, u1, acc, fric, lam_init=lam1, **kw), 5)
    print(f"warm: wrapper {wrapper_ms:.3f} ms per solve of {B}, kernel alone {kernel_ms:.3f} ms "
          f"per launch (group {group}), twin {twin_ms:.1f} ms per solve (timed once) [{card}]",
          flush=True)
    outs = K._launch(*args, group=group, **raw)
    roof = bound(torch, FLOPS_STAGE_ITER["parking"] * N * float(outs[5].sum()), [*args, *outs])
    points = sweep_grid(K, PARK_GROUPS, PARK_SWEEP_TILES)
    launch_points(torch, K, args, raw, points, card)

    phase(f"parking main path: parking_sweep({B}, {PARK_STEPS}), N={N}, tile {tile}, group "
          f"{group}")
    K.LAUNCHES = 0
    res, summary = port.parking_sweep(B, PARK_STEPS, device=device)
    torch.cuda.synchronize()
    launches = K.LAUNCHES
    print(f"AL-iLQR kernel launches in the sweep: {launches} (expected {PARK_STEPS})")
    if launches != PARK_STEPS:
        raise SystemExit("the parking sweep did not go through the kernel once per step")
    if res.states.shape != (PARK_STEPS + 1, B, 4) or res.inputs.shape != (PARK_STEPS, B, 2):
        raise SystemExit(f"unexpected shapes {res.states.shape} {res.inputs.shape}")
    if not bool(torch.isfinite(res.states).all()):
        raise SystemExit("non-finite states in the parking sweep")
    print("summary:", json.dumps(summary))
    print(f"success {summary['success_rate']:.5f} (floor {PARK_SUCCESS_FLOOR}), parked within "
          f"5 cm {summary['parked_frac_5cm']:.5f} (floor {PARK_PARKED_FLOOR}), median final "
          f"distance {summary['median_final_dist']:.5f} m (ceiling {PARK_MEDIAN_CEILING}), mean "
          f"inner iterations {summary['mean_inner_iters']:.2f}", flush=True)
    if not (summary["success_rate"] >= PARK_SUCCESS_FLOOR
            and summary["parked_frac_5cm"] >= PARK_PARKED_FLOOR
            and summary["median_final_dist"] <= PARK_MEDIAN_CEILING):
        raise SystemExit("the parking sweep misses the contract's quality floors")

    # the first scenarios over a few steps, kernel policy against twin policy
    S = PARK_TWIN_SCENARIOS
    sub = dataclasses.replace(plant_params, acceleration=plant_params.acceleration[:S],
                              friction=plant_params.friction[:S])
    finals = {}
    for backend in ("cuda", "twin"):
        pol = PB.batched_parking_policy(base, N, PARK_TS, x_obs=PARK_OBSTACLE, backend=backend)
        out = port.simulate_batch(x0[:S], port.batched_plant(sub, PARK_TS), PARK_TWIN_STEPS,
                                  pol, pol.initial_carry(S, device), batched_dynamics=True)
        finals[backend] = out.states[-1]
    d_final = (finals["cuda"] - finals["twin"]).abs().max().item()
    print(f"first {S} scenarios over {PARK_TWIN_STEPS} steps, final states kernel vs twin "
          f"policy: {d_final:.3e} (tol {TOL_PARK_STATES})", flush=True)
    if not d_final <= TOL_PARK_STATES:
        raise SystemExit("the parking closed loop disagrees with the twin policy")

    phase("parking main path timing")
    sweep = port.parking_sweep
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep(B, PARK_STEPS, device=device)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    print(f"sweep wall {dt:.4f} s (best of 3: {', '.join(f'{t:.4f}' for t in times)}); "
          f"{B * PARK_STEPS / dt:.1f} solves/s; step {1e3 * dt / PARK_STEPS:.3f} ms; mean inner "
          f"iterations {summary['mean_inner_iters']:.2f}; tile {tile}, group {group} [{card}]",
          flush=True)
    # CUDA events around every launch of one more sweep: the kernel's share
    print_events(*timed_sweep(torch, K, sweep, B, device, steps=PARK_STEPS)[:2], card)
    profile_sweep(torch, sweep, B, card, device, kernel="alilqr_tile_kernel")

    phase("parking sweep per tile x group (informational)")
    quality = sweep_points(torch, K, sweep, B, PARK_STEPS, points, PARK_SWEEP_ROUNDS, device, card)
    keys = ("success_rate", "parked_frac_5cm", "median_final_dist", "mean_inner_iters")
    for t in PARK_SWEEP_TILES:
        at_tile = [quality[pt] for pt in points if pt[0] == t] + ([summary] if t == tile else [])
        if any(sm[k] != at_tile[0][k] for sm in at_tile for k in keys):
            raise SystemExit(f"parking_sweep's summary depends on the group at tile {t}")
        if t == 32 and any(round(at_tile[0][k], d) != v for k, (v, d) in PARK_TILE32_SUMMARY.items()):
            raise SystemExit("parking_sweep at tile 32 is not the first port's summary")

    return {
        "name": "alilqr_tile_kernel",
        "route": "cuda",
        "source": "model_predictive_control_tpu_torch/csrc/ilqr_kernel.cu",
        "replaces": "model_predictive_control_tpu/ops/pallas/ilqr_kernel.py:70",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
        **roof,
    }


def contract_gates(name) -> dict:
    """The quality gates of ``name`` in BENCH_CONTRACT.json: its floors
    (``>=``) and ceilings (``<=``), without the solves/s or windows/s (a
    TPU's rate)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BENCH_CONTRACT.json")
    entry = json.load(open(path))[name]
    gates = {k: (">=", v) for k, v in entry["floors"].items() if not k.endswith("_per_s")}
    return {**gates, **{k: ("<=", v) for k, v in entry["ceilings"].items()}}


def captured_launches(torch, K, run, count=2) -> list:
    """The operands and keywords of the first ``count`` launches of ``K``'s
    kernel while ``run()`` runs: ``[(args, kw), ...]``."""
    seen = []
    launch = K._launch

    def spy(*args, **kw):
        if len(seen) < count:
            seen.append((args, dict(kw)))
        return launch(*args, **kw)

    K._launch = spy
    try:
        run()
    finally:
        K._launch = launch
    return seen


def mode_phases(torch, port, K, card, device) -> dict:
    """K2's operand modes: the kernel against its twin on the first two
    launches (cold, warm) of the crosswind and slope sweeps, with all three
    operands and with ``refs`` alone, at every group of ``PARK_GROUPS`` that
    fits the default tile, bit for bit; the three loops on the modes
    (counted, gated, the ablations), the kernel-vs-twin closed loops and
    the per-scenario route on the card. Returns the modes' ``kernels``
    entry."""
    from model_predictive_control_tpu_torch.parallel import batch as PB

    tile = K.DEFAULT_TILE
    groups = [g for g in PARK_GROUPS if tile * g <= K.MAX_THREADS[g]]
    phase(f"AL-iLQR kernel's operand modes vs twin on the card (tile {tile}, groups {groups})")
    err = 0.0
    for name in ("wind", "offset_free"):
        entry, B, _, _, _ = MODE_LOOPS[name]
        sweep = getattr(port, entry)
        seen = captured_launches(torch, K, lambda: sweep(B, 2, device=device))
        for (args, kw), when in zip(seen, ("cold", "warm")):
            kw.pop("group")
            for mode, operands in (("refs, dist, urefs", args), ("refs alone", (*args[:5], None, None))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = K.al_ilqr_tiles_reference(*operands, **kw)
                torch.cuda.synchronize()
                twin_s = time.perf_counter() - t0
                outs = {g: K._launch(*operands, group=g, **kw) for g in groups}
                label = f"{name} {when}, {mode} ({B} lanes, N={kw['N']})"
                err = max(err, compare_launches(torch, "AL-iLQR kernel", label, outs, want, twin_s,
                                                card))

    phase("the loops on the operand modes (main path)")
    launches, wind_loop, summaries = 0, None, {}
    for name, (entry, B, steps, extra, contract) in MODE_LOOPS.items():
        sweep = getattr(port, entry)
        for compensate in ((True, False) if name in MODE_ABLATIONS else (None,)):
            kw = dict(extra, **({} if compensate is None else {"compensate": compensate}))
            K.LAUNCHES = 0
            kept = [] if name == "wind" and compensate else None
            wall, events, summary = timed_sweep(torch, K, sweep, B, device, steps=steps,
                                                kept=kept, **kw)
            torch.cuda.synchronize()
            n = K.LAUNCHES
            label = f"{entry}({B}, {steps}{''.join(f', {k}={v!r}' for k, v in kw.items())})"
            print(f"{label}: {n} AL-iLQR kernel launches (expected {steps}); wall {wall:.4f} s, "
                  f"{B * steps / wall:.1f} solves/s (not gated: the contract's rate is a TPU's) "
                  f"[{card}]", flush=True)
            print_events(wall, events, card)
            if n != steps:
                raise SystemExit(f"{label} did not go through the kernel once per step")
            launches += n
            summaries[(name, compensate)] = summary
            if compensate is not False:
                gate_summary(label, summary, contract_gates(contract))
            else:
                gate_summary(label, summary, {})
            if kept is not None:
                wind_loop = [(a.elapsed_time(b), *rest) for (a, b), rest in zip(events, kept)]
    for name, rules in MODE_ABLATIONS.items():
        on, off = summaries[(name, True)], summaries[(name, False)]
        (ratio_key, ratio), (est_key, est_floor) = rules
        print(f"{name} ablation: {ratio_key} {off[ratio_key]:.5f} without compensation vs "
              f"{on[ratio_key]:.5f} with (gate: over {ratio}x); {est_key} {off[est_key]:.5f} "
              f"(gate: over {est_floor})", flush=True)
        if not (off[ratio_key] > ratio * on[ratio_key] and off[est_key] > est_floor):
            raise SystemExit(f"the {name} ablation does not show the offset removed")

    phase(f"kernel-vs-twin closed loops on the modes ({MODE_TWIN_SCENARIOS} scenarios, "
          f"{MODE_TWIN_STEPS} steps)")
    launch = K._launch
    on_twin = lambda *args, group=None, **kw: K.al_ilqr_tiles_reference(*args, **kw)
    for name, (entry, _, _, extra, _) in MODE_LOOPS.items():
        finals = {}
        for side in ("kernel", "twin"):
            # the twin: the same loop with the launch answered by the twin
            # on the card's tensors
            K._launch = launch if side == "kernel" else on_twin
            try:
                res, _ = getattr(port, entry)(MODE_TWIN_SCENARIOS, MODE_TWIN_STEPS,
                                              device=device, **extra)
            finally:
                K._launch = launch
            finals[side] = res.states[-1]
        a, b = finals["kernel"], finals["twin"]
        d = (a - b).abs().max().item()
        print(f"{entry}: final states, kernel vs twin: max {d:.3e}, bitwise equal "
              f"{torch.equal(a, b)} (tol {TOL_MODE_STATES})", flush=True)
        if not d <= TOL_MODE_STATES:
            raise SystemExit(f"the {entry} closed loop disagrees with the twin's")

    phase(f"the per-scenario route on the card: batched_parking_policy(backend='torch'), "
          f"{PER_SCENARIO_BATCH} scenarios x {PER_SCENARIO_STEPS} steps, N={PARK_N}")
    base = port.VehicleParameters()
    plant_params, x0 = parking_scenarios(torch, port, PER_SCENARIO_BATCH, device)
    S = PER_SCENARIO_BATCH
    sub = dataclasses.replace(plant_params, acceleration=plant_params.acceleration[:S],
                              friction=plant_params.friction[:S])
    out = {}
    for backend in ("torch", "cuda"):
        pol = PB.batched_parking_policy(base, PARK_N, PARK_TS, x_obs=PARK_OBSTACLE, backend=backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[backend] = port.simulate_batch(x0[:S], port.batched_plant(sub, PARK_TS),
                                           PER_SCENARIO_STEPS, pol, pol.initial_carry(S, device),
                                           batched_dynamics=True)
        torch.cuda.synchronize()
        print(f"{backend}: {PER_SCENARIO_STEPS} steps in {time.perf_counter() - t0:.2f} s "
              f"[{card}]", flush=True)
    d = (out["torch"].states[-1] - out["cuda"].states[-1]).abs().amax(dim=1)
    succ = {b: o.logs["solver_success"].float().mean().item() for b, o in out.items()}
    print(f"per-scenario route vs kernel: final states max|dx| median {d.median().item():.3e}, "
          f"q90 {torch.quantile(d, 0.9).item():.3e}, max {d.max().item():.3e} (median gated at "
          f"{TOL_PARK_STATES}); success {succ['torch']:.4f} vs {succ['cuda']:.4f} (within "
          f"{TOL_PER_SCENARIO_SUCCESS})", flush=True)
    if not (d.median().item() <= TOL_PARK_STATES
            and abs(succ["torch"] - succ["cuda"]) <= TOL_PER_SCENARIO_SUCCESS):
        raise SystemExit("the per-scenario route disagrees with the kernel on the card")

    # the entry: the wind loop's launch of median time after the first (a
    # cold start), timed alone, with the twin and the bound on its operands
    print("wind loop, ms / mean / max executed inner iterations a launch: "
          + ", ".join(f"{ms:.3f}/{o[5].mean().item():.1f}/{o[5].max().item():.0f}"
                      for ms, _, _, o in wind_loop) + f" [{card}]", flush=True)
    loop_ms, args, kw, _ = sorted(wind_loop[1:], key=lambda r: r[0])[(len(wind_loop) - 1) // 2]
    kernel_ms = time_cuda(torch, lambda: K._launch(*args, **kw), 10)
    plain = {k: v for k, v in kw.items() if k != "group"}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = K.al_ilqr_tiles_reference(*args, **plain)
    torch.cuda.synchronize()
    twin_ms = 1e3 * (time.perf_counter() - t0)
    outs = K._launch(*args, **kw)
    err = max(err, compare_launches(torch, "AL-iLQR kernel", "wind loop's median launch",
                                    {kw["group"]: outs}, want, twin_ms / 1e3, card))
    print(f"tracking modes: the wind loop's launch of median time ({loop_ms:.3f} ms in the "
          f"loop; mean executed {outs[5].mean().item():.2f}) alone: kernel {kernel_ms:.3f} ms "
          f"(group {kw['group']}), twin {twin_ms:.1f} ms (timed once); {launches} launches in "
          f"the loops [{card}]", flush=True)
    roof = bound(torch, FLOPS_STAGE_ITER["tracking"] * kw["N"] * float(outs[5].sum()),
                 [a for a in args if torch.is_tensor(a)] + list(outs))
    return {
        "name": "alilqr_tile_kernel<0, M_TRACK | M_ALL>",
        "route": "cuda",
        "source": "model_predictive_control_tpu_torch/csrc/ilqr_kernel.cu",
        "replaces": "model_predictive_control_tpu/ops/pallas/ilqr_kernel.py:70",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
        **roof,
    }


def racing_phases(torch, port, K, tier, card, device) -> dict:
    """One racing tier: the tracker kernel against its twin at the sweep's
    shapes (the policy's cold and warm steps: the kernel policy's outputs
    against the twin policy's, and the launch's operands through the kernel
    at every group of ``RACE_GROUPS``), the sweep through its entry point
    with the contract's floors, a small kernel-vs-twin closed loop, the
    timing, CUDA events around every launch of one sweep, a profiled window,
    and the sweep per (tile, group). Returns the instantiation's entry of
    the ``kernels`` line."""
    from model_predictive_control_tpu_torch.experiments.racing import ellipse_reference
    from model_predictive_control_tpu_torch.parallel import batch as PB

    sweep_name, policy_name, err_ceiling, tol_states = RACE_TIERS[tier]
    sweep, make_policy = getattr(port, sweep_name), getattr(PB, policy_name)
    B, N, tile, group = RACE_BATCH, RACE_N, K.DEFAULT_TILE, K.DEFAULT_GROUP[tier]
    groups = [g for g in RACE_GROUPS if tile * g <= K.MAX_THREADS[g]]
    dynamic = tier == "pacejka"
    ref = ellipse_reference(RACE_STEPS + N + 1, speed=1.2 if dynamic else 0.35,
                            dynamic=dynamic, device=device)
    # the sweep's own start states (one solve, before the counted run)
    x0 = sweep(B, 1, device=device)[0].states[0]
    pol = make_policy(ref, N=N, backend="cuda", tile=tile)
    pol_twin = make_policy(ref, N=N, backend="twin", tile=tile)
    plant = (PB.batched_dynamic_plant if dynamic else PB.batched_plant)(port.VehicleParameters(), 0.05)

    phase(f"tracker kernel vs twin on the card ({tier}: B={B}, N={N}, tile={tile}, default "
          f"group {group}, held at groups {groups})")
    seen = {}

    def both(name, x, t, carry):
        """The policy's step on the kernel and on the twin, held output by
        output; then the launch's operands through the kernel at every
        group, held against the twin policy's solve."""
        with spied(torch, K, "tracker_tiles_reference", seen):
            step, step_twin = pol(x, t, carry), pol_twin(x, t, carry)
        # u0, the warm carry and every log, through both wrappers' unpadding
        names = ("u0", "carry", *step[2])
        flat = lambda s: (s[0], s[1], *(s[2][k] for k in names[2:]))
        differ = [n for n, a, b in zip(names, flat(step), flat(step_twin), strict=True)
                  if not torch.equal(a, b)]
        print(f"{name}: kernel policy against twin policy at {B} lanes, outputs {list(names)}: "
              f"{'all bitwise equal' if not differ else f'{differ} differ'}", flush=True)
        if differ:
            raise SystemExit(f"the {tier} policy on the kernel is not the policy on the twin "
                             f"({name} step)")
        return step, *held_at_groups(torch, K, "tracker kernel", name, seen, groups, group,
                                     tile, card)

    cold, err, _, _, _ = both("cold", x0, 0, pol.initial_carry(B, device))
    # warm: one plant step with u0, then the shifted controls
    _, err_w, ms, args, kw = both("warm", plant(x0, cold[0]), 1, cold[1])
    err = max(err, err_w)
    # the entry's times: the warm policy step's launch at the default group,
    # and the twin on the same operands
    kernel_ms, twin_ms = ms[group], 1e3 * seen["twin_s"]
    outs = K._launch(*args, group=group, **kw)
    roof = bound(torch, FLOPS_STAGE_ITER[tier] * N * float(outs[5].sum()), [*args, *outs])
    points = sweep_grid(K, RACE_GROUPS, RACE_SWEEP_TILES)
    launch_points(torch, K, args, kw, points, card)

    phase(f"racing main path ({tier}): {sweep_name}({B}, {RACE_STEPS}), N={N}, tile {tile}, "
          f"group {group}")
    K.LAUNCHES = 0
    res, summary = sweep(B, RACE_STEPS, device=device)
    torch.cuda.synchronize()
    launches = K.LAUNCHES
    print(f"tracker kernel launches in the sweep: {launches} (expected {RACE_STEPS})")
    if launches != RACE_STEPS:
        raise SystemExit(f"{sweep_name} did not go through the kernel once per step")
    nx = 6 if dynamic else 4
    if res.states.shape != (RACE_STEPS + 1, B, nx) or res.inputs.shape != (RACE_STEPS, B, 2):
        raise SystemExit(f"unexpected shapes {res.states.shape} {res.inputs.shape}")
    if not bool(torch.isfinite(res.states).all()):
        raise SystemExit(f"non-finite states in {sweep_name}")
    print("summary:", json.dumps(summary))
    print(f"success {summary['success_rate']:.5f} (floor {RACE_SUCCESS_FLOOR}), mean tracking "
          f"error {summary['mean_tracking_error']:.5f} m (ceiling {err_ceiling}), p95 "
          f"{summary['p95_tracking_error']:.5f} m, mean inner iterations "
          f"{summary['mean_inner_iters']:.2f}", flush=True)
    if not (summary["success_rate"] >= RACE_SUCCESS_FLOOR
            and summary["mean_tracking_error"] <= err_ceiling):
        raise SystemExit(f"{sweep_name} misses the contract's quality floors")

    S, steps = RACE_TWIN_SCENARIOS, RACE_TWIN_STEPS
    finals = {b: sweep(S, steps, backend=b, device=device)[0].states[-1] for b in ("cuda", "twin")}
    d_final = (finals["cuda"] - finals["twin"]).abs().max().item()
    print(f"{sweep_name}({S}, {steps}), final states kernel vs twin policy: {d_final:.3e} "
          f"(tol {tol_states})", flush=True)
    if not d_final <= tol_states:
        raise SystemExit(f"the {tier} closed loop disagrees with the twin policy")

    phase(f"racing main path timing ({tier})")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep(B, RACE_STEPS, device=device)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    print(f"sweep wall {dt:.4f} s (best of 3: {', '.join(f'{t:.4f}' for t in times)}); "
          f"{B * RACE_STEPS / dt:.1f} solves/s; step {1e3 * dt / RACE_STEPS:.3f} ms; mean inner "
          f"iterations {summary['mean_inner_iters']:.2f}; tile {tile}, group {group} [{card}]",
          flush=True)

    # CUDA events around every launch of one more sweep: the kernel's share
    print_events(*timed_sweep(torch, K, sweep, B, device, steps=RACE_STEPS)[:2], card)

    profile_sweep(torch, sweep, B, card, device)

    if points:
        phase(f"racing sweep per tile x group ({tier}; informational)")
        quality = sweep_points(torch, K, sweep, B, RACE_STEPS, points, RACE_SWEEP_ROUNDS,
                               device, card)
        same_tile = {pt: quality[pt] for pt in points if pt[0] == tile}
        keys = ("success_rate", "mean_tracking_error", "mean_inner_iters")
        if any(sm[k] != summary[k] for sm in same_tile.values() for k in keys):
            raise SystemExit(f"{sweep_name}'s summary depends on the group at tile {tile}")

    return {
        "name": f"tracker_tile_kernel<{'PacejkaRows' if dynamic else 'KinematicRows'}>",
        "route": "cuda",
        "source": "model_predictive_control_tpu_torch/csrc/ilqr_factory.cu",
        "replaces": "model_predictive_control_tpu/ops/pallas/ilqr_factory.py:204",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
        **roof,
    }


def bench_solve(torch, port, K, name, device, limits="box"):
    """One regulation solve of a benchmark model no sweep uses, through
    ``make_fused_tracker`` at ``BENCH_BATCH`` lanes from seeded starts (and,
    for the per-lane mass, seeded masses); returns the solution."""
    builder, box, weights, spread, masses = BENCH_SOLVES[name]
    model = getattr(port, builder)()
    g = torch.Generator().manual_seed(0)
    x0 = (2.0 * torch.rand(BENCH_BATCH, model.nx, generator=g) - 1.0) * torch.tensor(spread)
    kw = {}
    if masses is not None:
        lo, hi = masses
        kw = dict(params=(lo + (hi - lo) * torch.rand(BENCH_BATCH, 1, generator=g)).to(device))
    step = K.make_fused_tracker(model, model.nx, model.nu, N=BENCH_N, ts=0.1, substeps=2,
                                limits=box, weights=weights, n_params=model.n_params,
                                viol_tol=1e-4)
    return step(x0.to(device), torch.zeros(BENCH_BATCH, BENCH_N, model.nu, device=device), **kw)


def twin_launch(torch, K, args, kw):
    """The twin on a launch's operands (the card's tensors): its outputs and
    seconds."""
    plain = {k: v for k, v in kw.items() if k != "group"}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = K.tracker_tiles_reference(*args, **plain)
    torch.cuda.synchronize()
    return want, time.perf_counter() - t0


def benchmark_phases(torch, port, K, card, device) -> list:
    """The tracker kernel's benchmark models: each new instantiation against
    its twin on the card, bit for bit at every group of ``RACE_GROUPS`` that
    fits the default tile, on one launch (the loiter sweeps' warm step, the
    other models' regulation solve, and the quadrotor's warm step without
    its input box); an informational (tile, group) launch sweep; then the
    main path, counted: ``quadrotor_sweep`` and ``thruster_sweep`` at their
    contract shapes with the contract's quality gates, and the other models'
    solves; a kernel-vs-twin closed loop of each sweep; each sweep timed with
    CUDA events around its launches, its launch of median time timed alone.
    Returns one ``kernels`` entry per instantiation."""
    tile = K.DEFAULT_TILE
    B, N = BENCH_BATCH, BENCH_N
    phase(f"tracker kernel vs twin on the card, benchmark models ({B} lanes, N={N}, tile {tile})")
    held = {}  # instantiation -> (args, kw) of the launch held bit for bit
    err, twin_times = {}, {}
    for name, entry in BENCH_SWEEPS.items():
        seen = captured_launches(torch, K, lambda: getattr(port, entry)(B, 2, device=device))
        held[name] = seen[1]  # the warm step
    held["quadrotor, no input box"] = (held["quadrotor"][0], {**held["quadrotor"][1],
                                                              "limits": None})
    for name in BENCH_SOLVES:
        solve = lambda: bench_solve(torch, port, K, name, device)
        held[name] = captured_launches(torch, K, solve)[0]
    for name, (args, kw) in held.items():
        kernel = kw["ode_rows"].kernel
        group = K.DEFAULT_GROUP[kernel]
        groups = [g for g in RACE_GROUPS if tile * g <= K.MAX_THREADS[g]]
        want, twin_s = twin_launch(torch, K, args, kw)
        twin_times[name] = twin_s
        at = {k: v for k, v in kw.items() if k != "group"}
        outs = {g: K._launch(*args, group=g, **at) for g in groups}
        label = (f"{name} ({'tracking' if args[2] is not None else 'regulation'}, nu "
                 f"{kw['nu']}, nc {want[4].shape[1]}, default group {group})")
        e = compare_launches(torch, "tracker kernel", label, outs, want, twin_s, card)
        err[kernel] = max(err.get(kernel, 0.0), e)
        if kernel == "cartpole":
            at_box = (want[0].abs() >= 3.0 - 1e-3).any(dim=(0, 1)).float().mean().item()
            print(f"cart-pole: share of lanes whose force reaches the box |u| = 3: {at_box:.4f}",
                  flush=True)
            if at_box == 0.0:
                raise SystemExit("the cart-pole solve's force box never binds")

    phase("tracker kernel, benchmark models: launch per (tile, group) (informational)")
    for name, (args, kw) in held.items():
        print(f"{name}:", flush=True)
        launch_points(torch, K, args, kw, sweep_grid(K, RACE_GROUPS, BENCH_TILES), card)

    sweeps = ", ".join(f"{e}({B}, {BENCH_STEPS})" for e in BENCH_SWEEPS.values())
    phase(f"benchmark models main path: {sweeps}, the solves of {', '.join(BENCH_SOLVES)}")
    for k in K.LAUNCHES_BY_KERNEL:
        K.LAUNCHES_BY_KERNEL[k] = 0
    runs = {}
    for name, entry in BENCH_SWEEPS.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, summary = getattr(port, entry)(B, BENCH_STEPS, device=device)
        torch.cuda.synchronize()
        runs[name] = time.perf_counter() - t0
        nu = {"quadrotor": 2, "thruster": 4}[name]
        if res.states.shape != (BENCH_STEPS + 1, B, 6) or res.inputs.shape != (BENCH_STEPS, B, nu):
            raise SystemExit(f"unexpected shapes {res.states.shape} {res.inputs.shape}")
        if not bool(torch.isfinite(res.states).all()):
            raise SystemExit(f"non-finite states in {entry}")
        gate_summary(entry, summary, contract_gates(entry))
        print(f"{entry}({B}, {BENCH_STEPS}): wall {runs[name]:.4f} s (first run), "
              f"{B * BENCH_STEPS / runs[name]:.1f} solves/s [{card}]", flush=True)
    for name in BENCH_SOLVES:
        sol = bench_solve(torch, port, K, name, device)
        conv = sol.converged.float().mean().item()
        print(f"{name} solve ({B} lanes): converged {conv:.5f}, max viol "
              f"{sol.viol.max().item():.2e}, mean inner iterations "
              f"{sol.inner_iters_executed.mean().item():.2f}", flush=True)
        if not (conv >= BENCH_SOLVE_CONVERGED and bool(torch.isfinite(sol.us).all())):
            raise SystemExit(f"the {name} solve does not converge")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES_BY_KERNEL)
    print(f"tracker kernel launches by instantiation: {launches} (expected {BENCH_STEPS} a "
          f"sweep, 1 a solve)", flush=True)
    expected = {**{n: BENCH_STEPS for n in BENCH_SWEEPS}, **{n: 1 for n in BENCH_SOLVES}}
    if any(launches[n] != c for n, c in expected.items()):
        raise SystemExit("the benchmark models' path did not go through the kernel as expected")

    phase(f"benchmark sweeps: kernel-vs-twin closed loops ({BENCH_TWIN_SCENARIOS} scenarios, "
          f"{BENCH_TWIN_STEPS} steps)")
    for entry in BENCH_SWEEPS.values():
        finals = {b: getattr(port, entry)(BENCH_TWIN_SCENARIOS, BENCH_TWIN_STEPS, backend=b,
                                          device=device)[0].states[-1] for b in ("cuda", "twin")}
        d = (finals["cuda"] - finals["twin"]).abs().max().item()
        print(f"{entry}: final states, kernel vs twin policy: max {d:.3e}, bitwise equal "
              f"{torch.equal(finals['cuda'], finals['twin'])} (tol {TOL_BENCH_STATES})", flush=True)
        if not d <= TOL_BENCH_STATES:
            raise SystemExit(f"the {entry} closed loop disagrees with the twin policy")

    phase("benchmark sweeps timed: CUDA events around every launch, the launch of median time "
          "alone")
    entries = {}
    for name, entry in BENCH_SWEEPS.items():
        kept = []
        wall, events, summary = timed_sweep(torch, K, getattr(port, entry), B, device,
                                            steps=BENCH_STEPS, kept=kept)
        print(f"{entry}({B}, {BENCH_STEPS}) with events: wall {wall:.4f} s, "
              f"{B * BENCH_STEPS / wall:.1f} solves/s; mean inner iterations "
              f"{summary['mean_inner_iters']:.2f}; tile {tile}, group "
              f"{K.DEFAULT_GROUP[name]} [{card}]", flush=True)
        print_events(wall, events, card)
        loop = [(a.elapsed_time(b), *rest) for (a, b), rest in zip(events, kept)]
        loop_ms, args, kw, _ = sorted(loop[1:], key=lambda r: r[0])[(len(loop) - 1) // 2]
        kernel_ms = time_cuda(torch, lambda: K._launch(*args, **kw), 10)
        want, twin_s = twin_launch(torch, K, args, kw)
        outs = K._launch(*args, **kw)
        err[name] = max(err[name], compare_launches(
            torch, "tracker kernel", f"{entry}'s launch of median time", {kw["group"]: outs},
            want, twin_s, card))
        print(f"{name}: the loop's launch of median time ({loop_ms:.3f} ms in the loop; mean "
              f"executed {outs[5].mean().item():.2f}) alone: kernel {kernel_ms:.3f} ms, twin "
              f"{1e3 * twin_s:.1f} ms [{card}]", flush=True)
        entries[name] = (kernel_ms, 1e3 * twin_s, args, kw, outs)
    for name in BENCH_SOLVES:
        # the solve's launch held above: its twin time from there
        args, kw = held[name]
        kernel_ms = time_cuda(torch, lambda: K._launch(*args, **kw), 10)
        outs = K._launch(*args, **kw)
        twin_ms = 1e3 * twin_times[name]
        print(f"{name}: the solve's launch alone: kernel {kernel_ms:.3f} ms (group "
              f"{kw['group']}), twin {twin_ms:.1f} ms [{card}]", flush=True)
        entries[name] = (kernel_ms, twin_ms, args, kw, outs)

    kernels = []
    for name, functor in BENCH_FUNCTORS.items():
        kernel_ms, twin_ms, args, kw, outs = entries[name]
        print(f"{functor}:", end=" ")
        roof = bound(torch, FLOPS_STAGE_ITER[name] * kw["N"] * float(outs[5].sum()),
                     [a for a in args if torch.is_tensor(a)] + list(outs))
        kernels.append({
            "name": f"tracker_tile_kernel<{functor}>",
            "route": "cuda",
            "source": "model_predictive_control_tpu_torch/csrc/ilqr_factory.cu",
            "replaces": "model_predictive_control_tpu/ops/pallas/ilqr_factory.py:204",
            "launches": launches[name],
            "max_abs_err": err[name],
            "ms": kernel_ms,
            "plain_ms": twin_ms,
            **roof,
        })
    return kernels


# ---------------------------------------------------------------------------
# the tracker kernel's second library (csrc/ilqr_factory_ext.cu): factory
# parking and the MHE windows
# ---------------------------------------------------------------------------

FACTORY_BATCH = 2048
FACTORY_STEPS = 50
FACTORY_INNER = 14  # BENCH_CONTRACT.json sweep_factory's configuration
FACTORY_GROUPS = (1, 8, 32)
FACTORY_TILES = (8, 16, 32)  # informational launch sweep of (tile, group)
# the budget at which the parking launches' operands are held to the twin bit
# for bit: the twin takes ~0.8 s an inner iteration at N=30 on the card, so the
# warm step's full budget (~65 inner iterations) would take ~50 s a launch
FACTORY_TWIN_BUDGET = (2, 3)
MHE_NL_BATCH, MHE_NL_M, MHE_NL_TS = 4096, 10, 0.05  # tools/bench_suite.py seg_mhe_batch_nl
MHE_NL_BUDGET = (4, 8)
MHE_NL_ORACLE = 64  # windows held to the Gauss-Newton oracle
# FP32 operations per stage and executed inner iteration, counted from the
# code as FLOPS_STAGE_ITER's entries are (a value charged once, tangents two
# operations per operation and direction):
# - factory parking, kinematic bicycle with Euler and the nine clearance rows
#   (68 operations for their values): the step's 6 Jacobian directions 6 x 2
#   x 27 = 324; the rows' gradient pack Dual<3> 3 x 2 x 68 = 408 with act,
#   the gradient and the Gauss-Newton sums ~230; at order 2 three curvature
#   passes, each the second-order tangents of 3 directions 3 x 2 x 68 = 408
#   and the contraction ~72, ~1,440; the 12 box rows 54; the Riccati algebra
#   at nx=4, nu=2 with the extra Hessian entries ~510; the 7 line-search
#   rollouts 7 x 240 (control 22, stage cost with 21 AL rows 191, step 27):
#   ~4,650 at order 2, ~3,210 at order 1;
# - the MHE windows, the gated kinematic model with RK4 in the additive mode
#   (one step: 4 evaluations of 34 and the combination, ~165): the 4 Jacobian
#   directions 4 x 2 x 165 = 1,320; the 8 box rows 36; the Riccati algebra at
#   nx = nu = 4 with the 4 x 4 Cholesky and its 5 right-hand sides ~1,000;
#   the 7 rollouts 7 x 277 (control 44, stage cost 64, step 169): ~4,300.
FLOPS_STAGE_ITER.update({"factory_parking": 4650, "factory_parking_o1": 3210,
                         "mhe_windows": 4300})


def mhe_nl_problem(torch, port, device, batch=None, seed=0):
    """``tools/bench_suite.py::seg_mhe_batch_nl``'s estimator and data,
    regenerated with torch from ``seed``: the kinematic bicycle with RK4,
    position-only measurements, v bounded to [0, 1], windows of M=10 from
    starts uniform in [-0.5, 0.5] at v = 0.3 under (0.2, 0.05), 0.1 m noise.
    Returns ``(mhe, ode_rows, x0, us, ys, Xs)``."""
    from model_predictive_control_tpu_torch.models.bicycle import kinematic_bicycle_ode
    from model_predictive_control_tpu_torch.ops.integrators import rk4

    params = port.VehicleParameters()
    f32 = torch.float32
    step = rk4(lambda x, u: kinematic_bicycle_ode(params, x, u), MHE_NL_TS)
    mhe = port.NonlinearMHE(
        step, lambda x: x[..., :2],
        torch.diag(torch.tensor([1e-6, 1e-6, 1e-5, 1e-3], dtype=f32)).to(device),
        (0.1 ** 2) * torch.eye(2, dtype=f32, device=device),
        torch.diag(torch.tensor([1e-4, 1e-4, 1e-3, 1e-2], dtype=f32)).to(device),
        MHE_NL_M, nx=4, x_min=[-3.0, -2.0, -7.0, 0.0], x_max=[3.0, 2.0, 7.0, 1.0],
        gn_iters=3, qp_iters=60, qp_solver="admm")
    rows = port.make_kinematic_ode_rows(
        float(params.axis_rear) / float(params.axis_front + params.axis_rear),
        float(params.axis_rear), float(params.acceleration), float(params.friction))
    batch = MHE_NL_BATCH if batch is None else batch
    g = torch.Generator().manual_seed(seed)
    x0 = torch.rand(batch, 4, generator=g) - 0.5
    x0[:, 3] = 0.3
    us = torch.tensor([[0.2, 0.05]]).repeat(batch, MHE_NL_M, 1)
    x0, us = x0.to(device), us.to(device)
    xs = [x0]
    for k in range(MHE_NL_M):
        xs.append(step(xs[-1], us[:, k]))
    Xs = torch.stack(xs, dim=1)
    ys = Xs[..., :2] + 0.1 * torch.randn(batch, MHE_NL_M + 1, 2, generator=g).to(device)
    return mhe, rows, x0, us, ys, Xs


def factory_phases(torch, port, K, card, device) -> list:
    """The tracker kernel's second library on the card: factory parking (the
    clearance rows at derivative order 2 and 1, warm multipliers, per-lane
    weights) and the MHE windows (additive mode, terminal rows): each launch
    held to its twin bit for bit at every group of ``FACTORY_GROUPS``, a
    per-lane weight row equal to the constants giving the constant build's
    bits; then the main path, counted: ``parking_sweep(2048, 50,
    backend="factory", inner_iters=14)`` and ``solve_batch_fused`` on 4,096
    windows with their contract's quality gates, the windows held to the
    Gauss-Newton oracle on 64 of them; the 6 x 15 sweep beside the hand
    kernel's (informational); each launch timed alone and between the loop's
    events. Returns the two instantiations' ``kernels`` entries."""
    from model_predictive_control_tpu_torch import estimation_nl
    from model_predictive_control_tpu_torch.ops.cuda import parking_factory

    B = FACTORY_BATCH
    phase(f"factory parking and MHE windows vs twin on the card ({B} lanes, N=30; "
          f"{MHE_NL_BATCH} windows, M={MHE_NL_M})")
    cold, warm = captured_launches(torch, K, lambda: port.parking_sweep(
        B, 2, backend="factory", inner_iters=FACTORY_INNER, device=device))
    args, kw = warm
    kw = {k: v for k, v in kw.items() if k != "group"}
    tile = kw["tile"]
    QD, RD, QN = kw["weights"]
    w = torch.tensor([*QD, *RD, QN], dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    rows = {"seeded": (w * (1.0 + 0.2 * (torch.rand(B, 7, generator=g) - 0.5))).to(device),
            "static": w.expand(B, 7).contiguous().to(device)}
    wrt = {k: K.prepare_operands(B, tile=tile, weights_rt=v)["wrt"] for k, v in rows.items()}
    cut = dict(outer_iters=FACTORY_TWIN_BUDGET[0], inner_iters=FACTORY_TWIN_BUDGET[1])
    held = {
        "order 2, warm multipliers": {**kw, **cut},
        "order 1, warm multipliers": {**kw, **cut, "extra_order": 1},
        "order 2, seeded per-lane weights": {**kw, **cut, "weights": None, "wrt": wrt["seeded"]},
        "order 2, per-lane weights equal to the constants": {**kw, **cut, "weights": None,
                                                              "wrt": wrt["static"]},
    }
    err, twin_s = {}, {}
    outs_at = {}
    for name, at in held.items():
        key = K.instantiation(at["ode_rows"], at["extra_constraints"], at["extra_order"],
                              at.get("wrt") is not None)
        want, twin_s[key] = twin_launch(torch, K, args, at)
        outs_at[name] = {grp: K._launch(*args, group=grp, **at) for grp in FACTORY_GROUPS}
        label = (f"factory parking warm step, {name} ({key}, lam_init from the step before, "
                 f"budget {cut['outer_iters']} x {cut['inner_iters']}, tile {tile})")
        err[key] = max(err.get(key, 0.0), compare_launches(
            torch, "tracker kernel", label, outs_at[name], want, twin_s[key], card))
    static = outs_at["order 2, warm multipliers"]
    same = outs_at["order 2, per-lane weights equal to the constants"]
    for grp in FACTORY_GROUPS:
        if not all(torch.equal(a, b) for a, b in zip(static[grp], same[grp])):
            raise SystemExit("a launch with per-lane weights equal to the constants differs "
                             f"from the constant build (group {grp})")
    print("per-lane weights equal to the constants: bit for bit the constant build's at groups "
          f"{FACTORY_GROUPS}", flush=True)

    mhe, ode_rows, x0, us, ys, Xs = mhe_nl_problem(torch, port, device)
    solve = lambda **k: mhe.solve_batch_fused(
        x0, us, ys, ode_rows=ode_rows, ts=MHE_NL_TS, obs_indices=(0, 1),
        outer_iters=MHE_NL_BUDGET[0], inner_iters=MHE_NL_BUDGET[1], **k)
    margs, mkw = captured_launches(torch, K, solve, count=1)[0]
    mkw = {k: v for k, v in mkw.items() if k != "group"}
    want, twin_s["gated_kinematic"] = twin_launch(torch, K, margs, mkw)
    mouts = {grp: K._launch(*margs, group=grp, **mkw) for grp in FACTORY_GROUPS}
    err["gated_kinematic"] = compare_launches(
        torch, "tracker kernel", f"MHE windows ({MHE_NL_BATCH} x M={MHE_NL_M}, "
        f"{MHE_NL_BUDGET[0]} x {MHE_NL_BUDGET[1]}, additive, terminal rows, tile {mkw['tile']})",
        mouts, want, twin_s["gated_kinematic"], card)

    phase("factory parking and MHE windows: launch per (tile, group) (informational)")
    for name, (a, at) in {"factory parking order 2, the warm step": (args, kw),
                          "factory parking order 1, the warm step": (args, {**kw,
                                                                            "extra_order": 1}),
                          "MHE windows": (margs, mkw)}.items():
        print(f"{name}:", flush=True)
        launch_points(torch, K, a, at, sweep_grid(K, FACTORY_GROUPS, FACTORY_TILES), card)

    phase(f"factory parking and MHE main path: parking_sweep({B}, {FACTORY_STEPS}, "
          f"backend='factory', inner_iters={FACTORY_INNER}), solve_batch_fused({MHE_NL_BATCH} "
          f"windows)")
    for k in K.LAUNCHES_BY_KERNEL:
        K.LAUNCHES_BY_KERNEL[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, summary = port.parking_sweep(B, FACTORY_STEPS, backend="factory",
                                      inner_iters=FACTORY_INNER, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if res.states.shape != (FACTORY_STEPS + 1, B, 4) or not bool(torch.isfinite(res.states).all()):
        raise SystemExit("the factory parking sweep's states are not finite of the expected shape")
    gate_summary("parking_sweep(backend='factory')", summary, contract_gates("sweep_factory"))
    print(f"parking_sweep({B}, {FACTORY_STEPS}, backend='factory', inner_iters={FACTORY_INNER}): "
          f"wall {wall:.4f} s (first run), {B * FACTORY_STEPS / wall:.1f} solves/s [{card}]",
          flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xM, X, W_, conv = solve()
    torch.cuda.synchronize()
    mhe_wall = time.perf_counter() - t0
    err_pos = torch.linalg.vector_norm(xM[:, :2] - Xs[:, -1, :2], dim=-1)
    if X.shape != (MHE_NL_BATCH, MHE_NL_M + 1, 4) or not bool(torch.isfinite(X).all()):
        raise SystemExit("the fused MHE windows are not finite of the expected shape")
    mhe_summary = {"median_pos_err": torch.quantile(err_pos, 0.5).item(),
                   "min_v_estimate": X[..., 3].min().item(),
                   "converged_frac": conv.float().mean().item()}
    gate_summary("NonlinearMHE.solve_batch_fused", mhe_summary, contract_gates("mhe_batch_nl"))
    print(f"solve_batch_fused({MHE_NL_BATCH} windows, M={MHE_NL_M}): wall {mhe_wall:.4f} s "
          f"(first run), {MHE_NL_BATCH / mhe_wall:.1f} windows/s [{card}]", flush=True)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES_BY_KERNEL)
    print(f"tracker kernel launches by instantiation: {launches} (expected {FACTORY_STEPS} "
          "kinematic_clearance_o2, 1 gated_kinematic)", flush=True)
    if launches["kinematic_clearance_o2"] != FACTORY_STEPS or launches["gated_kinematic"] != 1:
        raise SystemExit("the factory parking and MHE paths did not go through the kernel")

    phase(f"MHE windows: the fused kernel vs the Gauss-Newton oracle ({MHE_NL_ORACLE} windows)")
    n = MHE_NL_ORACLE
    xM_g, X_g, _ = mhe.solve_batch(x0[:n], us[:n], ys[:n])
    xM_f, X_f = xM[:n], X[:n]
    e_f = torch.linalg.vector_norm(xM_f[:, :2] - Xs[:n, -1, :2], dim=-1)
    e_g = torch.linalg.vector_norm(xM_g[:, :2] - Xs[:n, -1, :2], dim=-1)
    dxm, dX = (xM_f - xM_g).abs().max().item(), (X_f - X_g).abs().max().item()
    med_f, med_g = torch.quantile(e_f, 0.5).item(), torch.quantile(e_g, 0.5).item()
    print(f"fused vs Gauss-Newton + ADMM windows: max|x_M| {dxm:.3e} (tol 2e-2), max|X| "
          f"{dX:.3e} (tol 3e-2); converged {conv[:n].float().mean().item():.3f}; min v "
          f"{X_f[..., 3].min().item():.3e} (>= -1e-5); median position error {med_f:.4f} m vs "
          f"{med_g:.4f} m (< 0.06, < oracle + 0.02)", flush=True)
    if not (bool(conv[:n].all()) and X_f[..., 3].min().item() >= -1e-5 and dxm <= 2e-2
            and dX <= 3e-2 and med_f < 0.06 and med_f < med_g + 0.02):
        raise SystemExit("the fused MHE windows disagree with the Gauss-Newton oracle")

    phase("factory parking at the hand tier's 6 x 15 budget beside the hand kernel "
          "(informational)")
    for backend in ("factory", "cuda"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, sm = port.parking_sweep(B, FACTORY_STEPS, backend=backend, device=device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"informational: parking_sweep({B}, {FACTORY_STEPS}, backend={backend!r}) at 6 x 15: "
              f"success {sm['success_rate']:.5f}, parked {sm['parked_frac_5cm']:.5f}, median "
              f"{sm['median_final_dist']:.5f} m, mean inner iterations "
              f"{sm['mean_inner_iters']:.2f}, wall {dt:.4f} s, {B * FACTORY_STEPS / dt:.1f} "
              f"solves/s [{card}]", flush=True)

    phase("factory parking and MHE windows timed: CUDA events around the launches, launches "
          "alone")
    kept = []
    sweep = lambda batch, **k: port.parking_sweep(batch, backend="factory",
                                                  inner_iters=FACTORY_INNER, **k)
    wall, events, summary = timed_sweep(torch, K, sweep, B, device, kept=kept,
                                        steps=FACTORY_STEPS)
    print(f"parking_sweep(backend='factory') with events: wall {wall:.4f} s, "
          f"{B * FACTORY_STEPS / wall:.1f} solves/s; mean inner iterations "
          f"{summary['mean_inner_iters']:.2f}; tile {tile}, group "
          f"{K.DEFAULT_GROUP['kinematic_clearance_o2']} [{card}]", flush=True)
    print_events(wall, events, card)
    loop = [(a.elapsed_time(b), *rest) for (a, b), rest in zip(events, kept)]
    loop_ms, pargs, pkw, _ = sorted(loop[1:], key=lambda r: r[0])[(len(loop) - 1) // 2]
    park_ms = time_cuda(torch, lambda: K._launch(*pargs, **pkw), 10)
    pouts = K._launch(*pargs, **pkw)
    cut_ms = time_cuda(torch, lambda: K._launch(*pargs, **{**pkw, **cut}), 10)
    print(f"factory parking: the sweep's launch of median time ({loop_ms:.3f} ms in the loop; "
          f"mean executed {pouts[5].mean().item():.2f}) alone: kernel {park_ms:.3f} ms; at the "
          f"{cut['outer_iters']} x {cut['inner_iters']} budget kernel {cut_ms:.3f} ms, twin "
          f"{1e3 * twin_s['kinematic_clearance_o2']:.1f} ms (timed once) [{card}]", flush=True)
    others = {}
    for name, at in held.items():
        key = K.instantiation(at["ode_rows"], at["extra_constraints"], at["extra_order"],
                              at.get("wrt") is not None)
        if key == "kinematic_clearance_o2":
            continue
        full = {**at, "outer_iters": kw["outer_iters"], "inner_iters": kw["inner_iters"],
                "group": K.DEFAULT_GROUP[key]}
        ms = time_cuda(torch, lambda: K._launch(*args, **full), 5)
        ni = K._launch(*args, **full)[5]
        flops = FLOPS_STAGE_ITER["factory_parking_o1" if "_o1" in key else "factory_parking"]
        print(f"{key} ({name}): the warm step's launch alone at the sweep's budget: kernel "
              f"{ms:.3f} ms, {ni.mean().item():.2f} executed iterations; twin at the cut budget "
              f"{1e3 * twin_s[key]:.1f} ms [{card}]; ", end="")
        others[key] = bound(torch, flops * kw["N"] * float(ni.sum()), [*args, *full.values()])
    mevents, mkept = [], []
    launch = K._launch
    K._launch = timed_launches(torch, K, mevents, mkept)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        mwall = time.perf_counter() - t0
    finally:
        K._launch = launch
    mloop_ms = mevents[0][0].elapsed_time(mevents[0][1])
    mkw = {**mkw, "group": K.DEFAULT_GROUP["gated_kinematic"]}  # the path's group
    mhe_ms = time_cuda(torch, lambda: K._launch(*margs, **mkw), 10)
    mo = K._launch(*margs, **mkw)
    print(f"MHE windows: solve_batch_fused wall {mwall:.4f} s, the launch {mloop_ms:.3f} ms "
          f"between its events ({100 * mloop_ms / (1e3 * mwall):.1f}% of the wall); alone: kernel "
          f"{mhe_ms:.3f} ms (group {mkw['group']}), mean executed {mo[5].mean().item():.2f}; twin "
          f"{1e3 * twin_s['gated_kinematic']:.1f} ms (timed once) [{card}]", flush=True)

    print("KinematicRows + ClearanceRows, order 2:", end=" ")
    park_roof = bound(torch, FLOPS_STAGE_ITER["factory_parking"] * pkw["N"]
                      * float(pouts[5].sum()), [*pargs, *pouts])
    print("GatedKinematicRows (additive):", end=" ")
    mhe_roof = bound(torch, FLOPS_STAGE_ITER["mhe_windows"] * mkw["N"] * float(mo[5].sum()),
                     [a for a in (*margs, mkw["exo"], mkw["rw"]) if torch.is_tensor(a)] + list(mo))
    common = {"route": "cuda",
              "source": "model_predictive_control_tpu_torch/csrc/ilqr_factory_ext.cu",
              "replaces": "model_predictive_control_tpu/ops/pallas/ilqr_factory.py:204"}
    return [
        {"name": "tracker_tile_kernel<Problem<KinematicRows, ClearanceRows, 2>>", **common,
         "launches": launches["kinematic_clearance_o2"], "max_abs_err": err["kinematic_clearance_o2"],
         "ms": park_ms, "plain_ms": 1e3 * twin_s["kinematic_clearance_o2"], **park_roof},
        {"name": "tracker_tile_kernel<Problem<GatedKinematicRows, additive, terminal rows>>",
         **common, "launches": launches["gated_kinematic"], "max_abs_err": err["gated_kinematic"],
         "ms": mhe_ms, "plain_ms": 1e3 * twin_s["gated_kinematic"], **mhe_roof},
    ]

def tracker_launch_report(torch, port, K, card, device) -> None:
    """The warm step's tracker launch of each racing tier (``RACE_BATCH``
    lanes, N=15, the default tile and group), timed alone (20 calls after a
    warm-up), with its library's ptxas report."""
    groups = sorted({K.DEFAULT_GROUP[tier] for tier in RACE_TIERS})
    build_all([(K.library_name(g), lambda g=g: K._build_library(g)) for g in groups])
    for tier, (sweep_name, *_) in RACE_TIERS.items():
        sweep = getattr(port, sweep_name)
        args, kw = captured_launches(torch, K, lambda: sweep(RACE_BATCH, 2, device=device))[1]
        ms = time_cuda(torch, lambda: K._launch(*args, **kw), 20)
        print(f"{tier}: warm launch alone {ms:.4f} ms (tile {kw['tile']}, group {kw['group']}) "
              f"[{card}]", flush=True)


def profile_sweep(torch, sweep, B, card, device, kernel="tracker_tile_kernel") -> None:
    """Device busy share and ``kernel``'s device time of a
    ``RACE_PROFILE_STEPS``-step window of ``sweep`` under ``torch.profiler``.
    Informational."""
    from torch.profiler import ProfilerActivity, profile

    sweep(B, 2, device=device)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep(B, RACE_PROFILE_STEPS, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events)
    kernel_us = sum(e.self_device_time_total for e in events if kernel in e.key)
    launches = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel"))
    print(f"profiled {RACE_PROFILE_STEPS}-step window (under the profiler): wall {wall:.4f} s, "
          f"device busy {device_us / 1e3:.1f} ms ({100 * device_us / (1e6 * wall):.1f}% of the "
          f"wall, idle {100 - 100 * device_us / (1e6 * wall):.1f}%), {kernel} "
          f"{kernel_us / 1e3:.1f} ms ({100 * kernel_us / max(device_us, 1):.1f}% of device "
          f"time), {launches} kernel launches [{card}]", flush=True)


STAGEWISE_FIELDS = ("us", "xs", "mu", "prim_res", "success", "iters_executed")


def compare_stagewise(torch, name, got, ref, twin_s, card) -> float:
    """Print and gate the stagewise-IP wrapper's solution against the twin
    wrapper's, all six fields bit for bit; returns max|Δu|."""
    equal = [f for f in STAGEWISE_FIELDS if torch.equal(getattr(got, f), getattr(ref, f))]
    err = (got.us - ref.us).abs().max().item()
    print(
        f"{name}: the wrapper's solution against the twin wrapper's: bitwise equal fields "
        f"{equal} of {len(STAGEWISE_FIELDS)}; max|u_kernel - u_twin| {err:.3e}; success "
        f"{got.success.float().mean().item():.5f} vs twin {ref.success.float().mean().item():.5f}; "
        f"mean executed iterations {got.iters_executed.mean().item():.2f}; twin "
        f"{1e3 * twin_s:.1f} ms per solve (timed once) [{card}]",
        flush=True,
    )
    if len(equal) != len(STAGEWISE_FIELDS):
        raise SystemExit(f"stagewise-IP kernel disagrees with its twin on the {name} config")
    return err


def compare_stagewise_launches(torch, kernel, name, outs, ref, twin_s, card) -> float:
    """Gate the stagewise-IP kernel's six outputs at every group in ``outs``
    (``group -> _launch``'s tuple) bit for bit against the twin's ``ref`` on
    the same operands; returns max|Δu| over all lanes and groups."""
    err = 0.0
    for group, got in outs.items():
        equal = [f for f, a, b in zip(STAGEWISE_FIELDS, got, ref) if torch.equal(a, b)]
        du = (got[0] - ref[0]).abs().amax(dim=(0, 1))
        err = max(err, du.max().item())
        print(
            f"{name}, group {group}: bitwise equal fields {equal} of {len(STAGEWISE_FIELDS)}; "
            f"max|u_kernel - u_twin| over all lanes {du.max().item():.3e}; success "
            f"{got[4].float().mean().item():.5f} vs twin {ref[4].float().mean().item():.5f}; mean "
            f"executed iterations {got[5].mean().item():.2f} [{card}]",
            flush=True,
        )
        if len(equal) != len(STAGEWISE_FIELDS):
            raise SystemExit(f"{kernel} (group {group}) is not its twin bit for bit on the "
                             f"{name} config")
    return err


def profile_torch_solve(torch, port, problem, x0, card) -> None:
    """Host against device time of the batched plain-torch solver: one solve
    of ``LH_PROFILE_ITERS`` iterations (and the polish) at the path's shapes
    under ``torch.profiler``. Informational."""
    from torch.profiler import ProfilerActivity, profile

    ctrl = port.make_stagewise_mpc(problem, N=LH_N, iters=LH_PROFILE_ITERS, device=x0.device)
    warm = ctrl.initial_batch_carry(x0.shape[0], device=x0.device)
    ctrl.solve(x0[:64], warm[:64])  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ctrl.solve(x0, warm)
        torch.cuda.synchronize()
    events = prof.key_averages()
    host_us = sum(e.self_cpu_time_total for e in events)
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel"))
    print(f"torch solver, {x0.shape[0]} x N={LH_N}, {LH_PROFILE_ITERS} iteration(s), profiled: "
          f"host self time "
          f"{host_us / 1e3:.1f} ms, device time {device_us / 1e3:.1f} ms "
          f"({100 * device_us / max(host_us, 1):.1f}% of the host's), {launches} kernel launches "
          f"[{card}]", flush=True)


def long_horizon_loop(torch, port, K, device, batch=None, **policy_kw):
    """``run(steps)``: the long-horizon main path from the same states and
    zero warm controls (``batch`` of them, ``LH_BATCH`` when ``None``),
    through the public entry points only (the same in every version of the
    port, so that two versions time alike)."""
    batch = batch or LH_BATCH
    problem = port.session2_problem()
    ctrl = port.make_stagewise_mpc(problem, N=LH_N, iters=LH_ITERS, device=device)
    system = problem.system(torch.float32, device)
    x0 = initial_states(torch, device, batch)

    def run(steps=LH_STEPS, **kw):
        policy = ctrl.batched_policy(backend="cuda", **{**policy_kw, **kw})
        return port.simulate_batch(x0, system, steps, policy,
                                   ctrl.initial_batch_carry(batch, device=device),
                                   batched_dynamics=True)

    return run


def loop_report(torch, port, K, card, device) -> float:
    """Times the long-horizon loop at the kernel's defaults: the wall (best
    of 3, after a warm-up), CUDA events around every launch of one more run
    (time in the kernel, its share of the wall) and a 5-step window under
    ``torch.profiler`` (the device's idle share). Returns the best wall."""
    run = long_horizon_loop(torch, port, K, device)
    run()  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    print(f"long-horizon loop {LH_BATCH} x {LH_STEPS} steps, N={LH_N}: wall {dt:.4f} s (best of "
          f"3: {', '.join(f'{t:.4f}' for t in times)}), {LH_BATCH * LH_STEPS / dt:.1f} solves/s, "
          f"step {1e3 * dt / LH_STEPS:.3f} ms, success "
          f"{res.logs['solver_success'].float().mean().item():.5f} [{card}]", flush=True)
    events = []
    launch = K._launch
    K._launch = timed_launches(torch, K, events)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        K._launch = launch
    print_events(wall, events, card)
    profile_sweep(torch, lambda b, steps, device: run(steps), LH_BATCH, card, device,
                  kernel="stagewise_ip_tile_kernel")
    return dt


PHASE_NAMES = ("init", "factorization and gap sum", "predictor forward",
               "predictor ratio test", "predictor gap products", "predictor gap sum",
               "corrector linear terms", "corrector backward", "corrector forward",
               "corrector ratio test", "candidate check", "update", "polish",
               "polish acceptance")


def phase_report(torch, port, K, card, device, points=((32, 8), (8, 32), (32, 1))) -> None:
    """Informational: the cycles of each phase of the stagewise-IP solve at
    the long-horizon path's warm launch, per (tile, group) of ``points``,
    from a measurement build of the kernel (``-DIP_PHASE_CLOCKS``: thread 0
    of every CTA adds each phase's ``clock64`` cycles), averaged over CTA
    iterations; the outputs are held to the plain build's bit for bit."""
    import ctypes

    from model_predictive_control_tpu_torch.ops.cuda._build import load_library

    def clocked(nx=2, nu=1, group=1):
        def configure(lib):
            K._configure(lib)
            lib.stagewise_ip_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]

        return load_library(
            K.library_name(nx, nu, group) + "_clocks", K._SOURCES, configure,
            extra_flags=(*K.NVCC_EXTRA, f"-DNX={nx}", f"-DNU={nu}", f"-DIP_GROUP={group}",
                         "-DIP_PHASE_CLOCKS"),
        )

    ctrl = port.make_stagewise_mpc(port.session2_problem(), N=LH_N, iters=LH_ITERS, device=device)
    system = port.session2_problem().system(torch.float32, device)
    names = ("A", "B", "Q", "R", "Pf", "x_lb", "x_ub", "u_lb", "u_ub")
    kp = K.prepare_problem(*(getattr(ctrl, k).cpu().numpy() for k in names), device=device)
    x0 = initial_states(torch, device, LH_BATCH)
    cold = K.stagewise_ip_solve_prepared(kp, x0, None, N=LH_N, iters=LH_ITERS)
    x1 = system(x0, cold.us[:, 0])
    u1 = torch.cat([cold.us[:, 1:], cold.us[:, -1:]], dim=1)
    buf = (ctypes.c_ulonglong * (len(PHASE_NAMES) + 1))()
    for tile, group in points:
        args = K.prepare_tiles(kp, x1, u1, N=LH_N, tile=tile)
        kw = dict(N=LH_N, problem=kp.problem, iters=LH_ITERS, tau=0.995, tile=tile, group=group)
        plain = K._launch(*args, **kw)
        build = K._build_library
        K._build_library = clocked
        try:
            lib = clocked(2, 1, group)
            out = K._launch(*args, **kw)
            lib.stagewise_ip_phase_cycles(ctypes.addressof(buf), 1)
            ms = time_cuda(torch, lambda: K._launch(*args, **kw), 1)
            lib.stagewise_ip_phase_cycles(ctypes.addressof(buf), 1)
        finally:
            K._build_library = build
        same = all(torch.equal(a, b) for a, b in zip(out, plain))
        cycles, its = list(buf[: len(PHASE_NAMES)]), buf[len(PHASE_NAMES)]
        total = sum(cycles)
        print(f"phase clocks, tile {tile} group {group}: {ms:.3f} ms per clocked launch, outputs "
              f"bit for bit the plain build's: {same}; {its / 2:.0f} CTA iterations a launch, "
              f"{total / its:.0f} cycles per CTA iteration [{card}]", flush=True)
        for name, cyc in zip(PHASE_NAMES, cycles):
            print(f"  {name:28s} {100 * cyc / total:5.1f}%  {cyc / its:9.0f} cycles per CTA "
                  f"iteration", flush=True)
        if not same:
            raise SystemExit("the clocked build of the stagewise-IP kernel changed its outputs")


def executed_iterations(torch, K, static, x0, system, device, **kw):
    """The long-horizon loop once more through the wrapper (the executed
    iterations are no key of the policy's logs): the mean executed
    iterations and the final states."""
    executed = []
    x = x0
    u = torch.zeros(x0.shape[0], kw["N"], 1, dtype=torch.float32, device=device)
    for _ in range(LH_STEPS):
        sol = K.stagewise_ip_solve_cuda(*static, x, u, **kw)
        executed.append(sol.iters_executed)
        x, u = system(x, sol.us[:, 0]), torch.cat([sol.us[:, 1:], sol.us[:, -1:]], dim=1)
    return torch.stack(executed).mean().item(), x


def stagewise_phases(torch, port, K, card, device) -> dict:
    """The long-horizon path: the stagewise-IP kernel against its twin (cold,
    warm, and the nx=3 / nu=2 case; the wrapper's solution against the twin
    wrapper's, and the launch's operands at every group of ``LH_GROUPS``
    against that twin solve, all bit for bit), the closed loop through
    ``make_stagewise_mpc`` / ``batched_policy`` / ``simulate_batch`` beside
    the batched plain-torch solver (success shares and states compared), a
    small kernel-vs-twin closed loop, the timing (events around every launch,
    a profiled window), and, informational, the loop per (tile, group), the
    placements of the working set and a profile of the plain-torch solver. Returns the kernel's entry of the ``kernels`` line."""
    import numpy as np

    B, N, tile, group = LH_BATCH, LH_N, K.DEFAULT_TILE, K.DEFAULT_GROUP
    groups = [g for g in LH_GROUPS if tile * g <= K.MAX_THREADS[g]]
    problem = port.session2_problem()
    ctrl = port.make_stagewise_mpc(problem, N=N, iters=LH_ITERS, device=device)
    system = problem.system(torch.float32, device)
    x0 = initial_states(torch, device, B)
    names = ("A", "B", "Q", "R", "Pf", "x_lb", "x_ub", "u_lb", "u_ub")
    static = tuple(getattr(ctrl, k).cpu().numpy() for k in names)
    kw = dict(N=N, iters=LH_ITERS, tile=tile)

    phase(f"stagewise-IP kernel vs twin on the card (B={B}, N={N}, {LH_ITERS} iterations, "
          f"nx=2, nu=1, tile={tile}, groups {groups})")

    def both(name, data, x, u, **kw):
        """The wrapper's solution against the twin wrapper's, then the
        launch's operands at every group against that twin solve."""
        seen = {}
        with spied(torch, K, "stagewise_ip_tiles_reference", seen):
            got = K.stagewise_ip_solve_cuda(*data, x, u, **kw)
            torch.cuda.synchronize()
            ref = K.stagewise_ip_solve_twin(*data, x, u, **kw)
        err = compare_stagewise(torch, name, got, ref, seen["twin_s"], card)
        err_g, ms, args, launch_kw = held_at_groups(
            torch, K, "stagewise-IP kernel", name, seen, groups, group, tile, card,
            compare=compare_stagewise_launches,
        )
        return got, max(err, err_g), ms, args, launch_kw, seen["twin_s"]

    cold, err, _, _, _, _ = both("cold", static, x0, None, **kw)
    # the warm config as the policy makes it: one plant step with u0, the
    # controls shifted one stage
    x1 = system(x0, cold.us[:, 0])
    u1 = torch.cat([cold.us[:, 1:], cold.us[:, -1:]], dim=1)
    _, err_w, ms, args, launch_kw, twin_s = both("warm", static, x1, u1, **kw)
    rng = np.random.default_rng(1)
    q3 = np.diag([5.0, 1.0, 0.5])
    synthetic = (  # nx=3 / nu=2, a dense R, infinite bounds, Pf != Q
        [[1.0, 0.1, 0.0], [0.0, 1.0, 0.1], [0.0, 0.0, 0.95]],
        [[0.0, 0.005], [0.1, 0.0], [0.0, 0.1]], q3, [[0.1, 0.01], [0.01, 0.2]], 2.0 * q3,
        [-4.0, -2.0, -np.inf], [4.0, 2.0, 1.5], [-1.0, -0.8], [1.0, 0.8],
    )
    x3 = torch.as_tensor(rng.uniform(-1, 1, (B, 3)) * np.array([3.5, 1.9, 1.4]),
                         dtype=torch.float32, device=device)
    err_3 = both(f"nx=3, nu=2, N={LH_SMALL_N}", synthetic, x3, None,
                 N=LH_SMALL_N, iters=18, tile=tile)[1]
    err = max(err, err_w, err_3)
    kernel_ms, twin_ms = ms[group], 1e3 * twin_s
    print(f"warm: kernel alone {kernel_ms:.3f} ms per launch of {B} (group {group}), twin "
          f"{twin_ms:.1f} ms per solve (timed once) [{card}]", flush=True)
    outs = K._launch(*args, group=group, **launch_kw)
    nb = sum(np.isfinite(v).sum() for v in static[5:])
    roof = bound(torch, stagewise_flops(2, 1, int(nb), N, float(outs[5].sum()), args[0].shape[-1]),
                 [*args, *outs])

    phase(f"long-horizon main path: {B} scenarios x {LH_STEPS} steps, N={N}, "
          f"{LH_ITERS} iterations, tile {tile}, group {group}")
    run = long_horizon_loop(torch, port, K, device)

    def loop(x, backend, steps=LH_STEPS):
        policy = ctrl.batched_policy(backend=backend)
        return port.simulate_batch(
            x, system, steps, policy, ctrl.initial_batch_carry(x.shape[0], device=device),
            batched_dynamics=True
        )

    K.LAUNCHES = 0
    res = run()
    torch.cuda.synchronize()
    launches = K.LAUNCHES
    print(f"stagewise-IP kernel launches in the loop: {launches} (expected {LH_STEPS})")
    if launches != LH_STEPS:
        raise SystemExit("the long-horizon loop did not go through the kernel once per step")
    if res.states.shape != (LH_STEPS + 1, B, 2) or res.inputs.shape != (LH_STEPS, B, 1):
        raise SystemExit(f"unexpected shapes {res.states.shape} {res.inputs.shape}")
    if not bool(torch.isfinite(res.states).all()):
        raise SystemExit("non-finite states in the long-horizon loop")
    # the same loop once more through the wrapper, outside the counted run
    executed, x = executed_iterations(torch, K, static, x0, system, device, **kw)
    if not torch.equal(x, res.states[-1]):
        raise SystemExit("the loop through the wrapper differs from the loop through the policy")
    ok = res.logs["solver_success"]
    success = ok.float().mean().item()
    print(f"success {success:.5f} (floor {LH_SUCCESS_FLOOR}), mean μ of the solved "
          f"{res.logs['mu'][ok].mean().item():.3e}, mean executed iterations "
          f"{executed:.2f} of {LH_ITERS}, final |p| max "
          f"{res.states[-1, :, 0].abs().max().item():.3e}", flush=True)
    if success < LH_SUCCESS_FLOOR:
        raise SystemExit("the long-horizon loop's success share is below the floor")

    T = LH_TORCH_STEPS
    loop(x0[:64], "torch", 1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = loop(x0, "torch", T)
    torch.cuda.synchronize()
    torch_s = time.perf_counter() - t0
    torch_rate = B * T / torch_s
    success_t = ref.logs["solver_success"].float().mean().item()
    success_k = ok[:T].float().mean().item()
    print(f"backend='torch' on the same loop's first {T} steps (timed once): wall {torch_s:.3f} s, "
          f"{torch_rate:.1f} solves/s, step {1e3 * torch_s / T:.1f} ms; success {success_t:.5f} "
          f"vs the kernel loop's {success_k:.5f} over the same steps (tol {LH_BACKEND_AGREE}) "
          f"[{card}]", flush=True)
    if abs(success_k - success_t) > LH_BACKEND_AGREE:
        raise SystemExit("the kernel loop's success share differs from the torch backend's")
    # states, over the scenarios both backends solved at every step: held to
    # the bar where both took the same iterations, the others listed
    ok_t, mu_k, mu_t = ref.logs["solver_success"], res.logs["mu"][:T], ref.logs["mu"]
    solved = (ok[:T] & ok_t).all(dim=0)
    same_iters = ((mu_k - mu_t).abs() <= TOL_LH_MU * torch.maximum(mu_k, mu_t)).all(dim=0)
    d_lane = (res.states[: T + 1] - ref.states).abs().amax(dim=(0, 2))
    held, edge = solved & same_iters, solved & ~same_iters
    d_held = d_lane[held]
    edge_share = edge.float().mean().item()
    print(f"|Δstates| kernel vs torch loop over the {int(held.sum())} scenarios both solved at "
          f"every step with μ equal within {TOL_LH_MU:.0%}: q999 "
          f"{torch.quantile(d_held, 0.999).item():.3e}, max {d_held.max().item():.3e} (tol "
          f"{TOL_LH_BACKEND_STATES}); not solved at some step on either side: "
          f"{torch.nonzero(~solved).flatten().tolist()}; on the freeze threshold's edge: "
          f"{int(edge.sum())} (share {edge_share:.5f}, tol {TOL_LH_EDGE_SHARE})", flush=True)
    for lane in torch.nonzero(edge).flatten().tolist():
        step = int(torch.nonzero(
            (mu_k[:, lane] - mu_t[:, lane]).abs() > TOL_LH_MU * torch.maximum(mu_k[:, lane], mu_t[:, lane])
        )[0])
        print(f"  lane {lane} (x0 {x0[lane].tolist()}) parts at step {step}: μ kernel "
              f"{mu_k[step, lane].item():.3e} torch {mu_t[step, lane].item():.3e} (freeze below "
              f"{K.EPS50:.3e}), |Δstate| entering the step "
              f"{(res.states[step, lane] - ref.states[step, lane]).abs().max().item():.3e}, u0 kernel "
              f"{res.inputs[step, lane, 0].item():.6f} torch {ref.inputs[step, lane, 0].item():.6f}, "
              f"max |Δstates| {d_lane[lane].item():.3e}; solved on both sides at every step",
              flush=True)
    if not (d_held.max().item() <= TOL_LH_BACKEND_STATES and edge_share <= TOL_LH_EDGE_SHARE):
        raise SystemExit("the kernel loop's states differ from the torch backend's")

    S = LH_TWIN_SCENARIOS
    finals = {b: loop(x0[:S], b, LH_TWIN_STEPS).states[-1] for b in ("cuda", "twin")}
    d_final = (finals["cuda"] - finals["twin"]).abs().max().item()
    print(f"first {S} scenarios over {LH_TWIN_STEPS} steps, final states kernel vs twin policy: "
          f"{d_final:.3e} (tol {TOL_LH_STATES})", flush=True)
    if not d_final <= TOL_LH_STATES:
        raise SystemExit("the long-horizon closed loop disagrees with the twin policy")

    phase("long-horizon main path timing")
    dt = loop_report(torch, port, K, card, device)
    print(f"{B * LH_STEPS / dt / torch_rate:.1f}x the torch backend [{card}]", flush=True)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wide = long_horizon_loop(torch, port, K, device, LH_WIDE_BATCH)()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"informational, not gated: {LH_WIDE_BATCH} scenarios x {LH_STEPS} steps wall {dt:.4f} s, "
          f"{LH_WIDE_BATCH * LH_STEPS / dt:.1f} solves/s, success "
          f"{wide.logs['solver_success'].float().mean().item():.5f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB [{card}]", flush=True)
    del wide

    phase("long-horizon loop per (tile, group), placements and the torch solver profiled "
          "(informational)")
    for t, g in sweep_grid(K, LH_GROUPS, LH_SWEEP_TILES):
        events = []
        launch = K._launch
        K._launch = timed_launches(torch, K, events)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(tile=t, group=g)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            K._launch = launch
        plan = K.launch_plan(N, 2, 1, t, g)
        share = out.logs["solver_success"].float().mean().item()
        print(f"tile {t} group {g}: loop wall {wall:.4f} s, {B * LH_STEPS / wall:.1f} solves/s, "
              f"in the kernel {sum(a.elapsed_time(b) for a, b in events):.1f} ms over "
              f"{len(events)} launches; success {share:.5f}; shared regions "
              f"{plan.smask:#08b}, {plan.smem_bytes} bytes a CTA [{card}]", flush=True)
        if t == 32:
            iterations = executed_iterations(torch, K, static, x0, system, device,
                                             **{**kw, "tile": t, "group": g})[0]
            got = {"success": share, "iterations": iterations}
            print(f"tile 32 group {g}: mean executed iterations {iterations:.2f} (the first "
                  f"port's summary: {LH_TILE32_SUMMARY})", flush=True)
            if any(round(got[k], d) != v for k, (v, d) in LH_TILE32_SUMMARY.items()):
                raise SystemExit("the long-horizon loop at tile 32 is not the first port's summary")
    del out
    launch_points(torch, K, args, launch_kw, sweep_grid(K, LH_GROUPS, LH_SWEEP_TILES), card)
    at = {**launch_kw, "group": group}
    sizes = {name: n for name, n, _ in K.regions(N, 2, 1, group)}
    transients = sizes["exchange"] + sizes["gain"] + sizes["scratch"] + sizes["dir"]
    for label, limit in (("the exchange area, gains, scratch and directions",
                          4 * tile * (transients + 1)), ("nothing", 0)):
        limit_was = K.SMEM_LIMIT
        K.SMEM_LIMIT = limit
        try:
            plan = K.launch_plan(N, 2, 1, tile, group)
            placed_ms = time_cuda(torch, lambda: K._launch(*args, **at), 3)
        finally:
            K.SMEM_LIMIT = limit_was
        print(f"informational: warm launch at tile {tile} group {group} with {label} in shared "
              f"memory (regions {plan.smask:#08b}): {placed_ms:.3f} ms [{card}]", flush=True)
    profile_torch_solve(torch, port, problem, x0, card)

    return {
        "name": "stagewise_ip_tile_kernel",
        "route": "cuda",
        "source": "model_predictive_control_tpu_torch/csrc/riccati_ip_kernel.cu",
        "replaces": "model_predictive_control_tpu/experimental/riccati_ip_kernel.py:132",
        "group": group,
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
        **roof,
    }


if __name__ == "__main__":
    sys.exit(main())
