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
- the rest of the linear ADMM family on the same kernel: its panel mode
  (warps per quad of rows, the operator streamed through shared memory in
  panels) held to the twin on the MHE loop's slack-softened MPC at N=20
  (n + m = 200, 4,096 scenarios, the polished cold presolve and the first
  warm step), the
  build of the MHE loop's windows (n + m = 44) held to the twin on the
  loop's own first two batches of windows at 2,048 (cold and warm), then
  the tube sweep (65,536 × 50), the stochastic sweep (65,536 × 50) and the
  MHE-in-the-loop sweep (2,048 × 50, two launches a step: the MHE windows
  and the soft MPC in the panel mode), each with its launches counted, the
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
- the differentiable layer and the parallel horizon: the tracker kernel's
  no-obstacle parking build with per-lane weights (``kinematic_wrt``, the
  fused forward of the tuning layer) held to its twin bit for bit at one
  thread per lane and at two thread groups (2,048 lanes, N=8, the 8 × 30
  budget) and a (tile, group) launch sweep on the same operands that sets
  its default group; the fused closed-loop tuning loss (2,048 starts × 4 steps) with its
  launches counted, one gradient timed forward and backward apart and held
  to central differences on all six weights, three updates of
  ``tune_parking_weights(forward="fused")`` and ``experiments.tuning.run()``
  at the CLI defaults (the linear tier) with falling losses; the stagewise
  interior point with the parallel KKT solver against the sequential one
  (256 starts, N=100, float64) and the parallel LQ solve against the
  sequential pair at N=1,024, both timed;
- K1's panel mode past 256 columns: the condensed long-horizon closed loop
  (the hard box at N=100, n + m = 400, ``make_linear_mpc(solver="admm")``
  at its defaults, 4,096 scenarios × 50 steps from the long-horizon loop's
  starts; launches counted, the presolve and a warm launch held to the
  twin, a 256 × 10 kernel-vs-twin loop, the wall, the kernel's share from
  events, beside K4's stagewise loop's success on the same starts) and the
  soft-state MPC at N=30 and 100 (n + m = 300 and 1,000; a cold and a warm
  launch on 1,024 of the MHE loop's starts, held to the twin);
- the float64 oracle tier (``oracle/``, built with g++ beside the kernels):
  the headline's first warm launch on 256 of its scenarios drawn by seed,
  and the condensed hard box at N=100 (32 starts) through K1's panel mode
  (its loop's first warm launch) and K4 (its loop's first solve), held to
  the native ADMM + polish oracle's KKT certificate and solution at bars
  fixed from each kernel's stopping rule (``PERF.md``), and the card's
  float64 DARE to LAPACK;
- the long-horizon closed loop (session-2 linear MPC on the stagewise
  interior-point solver, N=100, 20 iterations, 4,096 scenarios × 50 steps)
  on the fused stagewise-IP kernel (held to its twin bit for bit at one
  thread per lane and at two thread groups, on the launch's operands and
  through the wrapper), beside the batched plain-torch solver (with CUDA
  events around every launch of one loop, a profiled window, the loop per
  tile × group, the placements of the working set and a profile of the
  plain-torch solver, all informational);
- the scale-out layer (``parallel/``): the headline through
  ``batched_policy(mesh=)`` on a world-1 NCCL mesh, bit for bit with the
  unsharded episode and both walls timed in turns; ``admm_solve_tp`` at
  model 1 against ``admm_solve`` at a fixed ρ (float64); two spawned ranks
  sharing the card (gloo, CUDA tensors staged through the host for its
  collectives; non-performance): K1 on 2 × 32,768 headline scenarios and
  K2's parking sweep on 2 × 1,024 × 10 steps, each bit for bit with the
  unsharded launches and its launches counted a rank; ``podscale
  --scaling`` through ``cli.main`` at the card's count; the multi-rank dry
  run (``parallel/dryrun.py``) on NCCL ranks, one a card.

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
``python3 chip_smoke.py --k1-panel-phases`` runs K1's panel-mode phases
alone; ``python3 chip_smoke.py --mhe-loop-launch DIR [--operands PATH]``
times the MHE loop's soft-MPC launch of median time alone for the port
under ``DIR``, on that loop's operands or on those saved at ``PATH``;
``python3 chip_smoke.py --benchmark-phases`` runs the tracker kernel's
benchmark-model phases alone (its libraries, then those phases);
``python3 chip_smoke.py --factory-phases`` runs the factory parking and MHE
windows' phases alone (their libraries and the hand parking kernel's, then
those phases); ``python3 chip_smoke.py --differentiable-phases`` runs the
differentiable layer's and the parallel horizon's phases alone (the tracker
kernel's second library, then those phases); ``python3 chip_smoke.py
--user-model-phases`` runs the user-model phases alone: the tracker
instantiations generated from row functions (the JAX tests' quadrotor disc
at orders 2 and 1, the thrust cluster's keep-out, the kinematic model as a
bare function, the kinematic model under RK4 without its input box), each
held bit for bit against its twin and the bare function against the hand
``kinematic`` launch, launched once each through ``fused_tracker_solve_cuda``
(counted), timed alone with its bound and nvcc's seconds, then the command
line in process (``cli.main``: session2, ``sweep --backend factory``,
quadsweep, tune, estimate) with its gates; the full run ends with the same
phases. ``python3 chip_smoke.py --oracle-phases`` runs the oracle phase
alone (the two oracle libraries and the kernel builds it launches, then the
phase). ``python3 chip_smoke.py --scaleout-phases`` runs the scale-out
phases alone (the kernel builds they launch, then those phases).
``python3 chip_smoke.py --tracker-launches DIR`` times the
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
# K1's panel mode at n + m = 200 (the MHE loop's soft-state MPC at N = 20),
# held to the twin at WIDE_BATCH scenarios of the MHE loop's starts
WIDE_BATCH = 4096
WIDE_N = 20
WIDE_ITERS = 200  # the MHE loop's MPC budget, 4x in its presolve
WIDE_RHO = 0.02
WIDE_SLACK_WEIGHT = 1e4
WIDE_COLS = -(-(3 * WIDE_N + 7 * WIDE_N) // 32)  # the panel library's columns a lane (one warp a quad)
MHE_COLS = -(-(2 + 2 * 10 + 2 + 2 * 10) // 16)  # the MHE windows' library (M = 10)
DRYRUN_COLS = 1  # the dry run's QP (N=4: n + m = 16)

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
    PyTorch call computes any of these fused solves: ``library_ms`` is null.
    The peaks are the H100's of :mod:`model_predictive_control_tpu_torch.obs.roofline`."""
    from model_predictive_control_tpu_torch.obs.roofline import FP32_PEAK, HBM_BW_PEAK

    nbytes = sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))
    t_ops, t_bytes = 1e3 * flops / FP32_PEAK, 1e3 * nbytes / HBM_BW_PEAK
    by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"bound: {flops:.4g} FP32 operations ({t_ops:.5f} ms at {FP32_PEAK:.3g}/s), "
          f"{nbytes:.4g} bytes ({t_bytes:.5f} ms at {HBM_BW_PEAK:.3g} B/s): {by}", flush=True)
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
    if sys.argv[1:2] == ["--mhe-loop-launch"]:
        # the MHE loop's soft-MPC launch of median time alone, for the port
        # found under the given directory (another version of it, to compare
        # two on one card); --operands PATH saves that launch's operands to
        # PATH or, where PATH exists, times the launch on them
        sys.path.insert(0, os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else "."))
        import model_predictive_control_tpu_torch as port
        from model_predictive_control_tpu_torch.ops.cuda import admm_kernel as K

        card = smi()
        print(f"the port at {os.path.dirname(port.__file__)} [{card}]", flush=True)
        path = sys.argv[sys.argv.index("--operands") + 1] if "--operands" in sys.argv else None
        mhe_loop_launch_report(torch, port, K, card, torch.device("cuda"), path)
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
        # the linear family's phases alone, on the ADMM kernel's builds they
        # launch
        card = smi()
        build_all([(K.library_name(c, lanes), lambda c=c, lanes=lanes: K._build_library(c, lanes))
                   for c, lanes in ((MHE_COLS, 16), (WIDE_COLS, 32), (ADMM_COLS, 16))])
        print(json.dumps({"kernels": family_phases(torch, port, K, card, torch.device("cuda"))}))
        phase(None)
        return 0
    if sys.argv[1:2] == ["--oracle-phases"]:
        # the card's solutions against the float64 oracle tier alone: the
        # oracle libraries and the kernel builds the phase launches
        from model_predictive_control_tpu_torch.ops.cuda import riccati_ip_kernel as KR

        card = smi()
        print(card, flush=True)
        g = KR.DEFAULT_GROUP
        cols = K.columns(PANEL_LH_N, 3 * PANEL_LH_N, 32)  # the hard box: n = N, m = 3 N
        build_all([*oracle_libraries(),
                   (K.library_name(ADMM_COLS), lambda: K._build_library(ADMM_COLS)),
                   (K.library_name(cols, 32), lambda: K._build_library(cols, 32)),
                   (KR.library_name(2, 1, g), lambda: KR._build_library(2, 1, g))])
        oracle_phases(torch, port, K, KR, card, torch.device("cuda"))
        phase(None)
        return 0
    if sys.argv[1:2] == ["--k1-panel-phases"]:
        # K1's panel mode past 256 columns alone: its libraries, and K4's
        # default one for the stagewise loop beside the condensed one
        from model_predictive_control_tpu_torch.ops.cuda import riccati_ip_kernel as KR

        card = smi()
        print(card, flush=True)
        g = KR.DEFAULT_GROUP
        build_all([*panel_libraries(K),
                   (KR.library_name(2, 1, g), lambda: KR._build_library(2, 1, g))])
        print(json.dumps({"kernels": k1_panel_phases(torch, port, K, KR, card,
                                                     torch.device("cuda"))}))
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

    if sys.argv[1:2] == ["--differentiable-phases"]:
        # the differentiable layer and the parallel horizon alone, on the
        # tracker kernel's second library
        print(card, flush=True)
        build_all([(KF.library_name(g, True), lambda g=g: KF._build_library(g, True))
                   for g in DIFF_GROUPS])
        print(json.dumps({"kernels": differentiable_phases(torch, port, KF, card, device)}))
        phase(None)
        return 0

    if sys.argv[1:2] == ["--scaleout-phases"]:
        # the scale-out layer alone, on the kernel builds its paths launch
        print(card, flush=True)
        build_all([(K.library_name(ADMM_COLS), lambda: K._build_library(ADMM_COLS)),
                   (K.library_name(DRYRUN_COLS), lambda: K._build_library(DRYRUN_COLS)),
                   (KI.library_name(KI.DEFAULT_GROUP), lambda: KI._build_library(KI.DEFAULT_GROUP)),
                   (KF.library_name(KF.DEFAULT_GROUP["kinematic"]),
                    lambda: KF._build_library(KF.DEFAULT_GROUP["kinematic"]))])
        scaleout_phases(torch, port, K, KI, card, device)
        phase(None)
        return 0

    if sys.argv[1:2] == ["--user-model-phases"]:
        # user models on the card (the instantiations generated from row
        # functions, and the hand kinematic one they are compared with)
        print(card, flush=True)
        build_all([*user_libraries(torch, port, KF, device),
                   (KF.library_name(8), lambda: KF._build_library(8))])
        kernels = user_model_phases(torch, port, KF, card, device)
        cli_phases(torch, card)
        phase(None)
        print(json.dumps({"kernels": kernels}))
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
        *oracle_libraries(),
        (K.library_name(ADMM_COLS), lambda: K._build_library(ADMM_COLS)),
        (K.library_name(MHE_COLS), lambda: K._build_library(MHE_COLS)),
        *panel_libraries(K),
        (K.library_name(DRYRUN_COLS), lambda: K._build_library(DRYRUN_COLS)),
        *((KI.library_name(g), lambda g=g: KI._build_library(g)) for g in PARK_GROUPS),
        *((KF.library_name(g), lambda g=g: KF._build_library(g)) for g in RACE_GROUPS),
        *((KF.library_name(g, True), lambda g=g: KF._build_library(g, True))
          for g in FACTORY_GROUPS),
        *((KR.library_name(nx, nu, g), lambda nx=nx, nu=nu, g=g: KR._build_library(nx, nu, g))
          for nx, nu in ((2, 1), (3, 2)) for g in LH_GROUPS),
        *user_libraries(torch, port, KF, device),
    ])
    admm = admm_phases(torch, port, K, card, device)
    family = family_phases(torch, port, K, card, device)
    panel = k1_panel_phases(torch, port, K, KR, card, device)
    oracle_phases(torch, port, K, KR, card, device)
    ilqr = ilqr_phases(torch, port, KI, card, device)
    modes = mode_phases(torch, port, KI, card, device)
    racing = [racing_phases(torch, port, KF, tier, card, device) for tier in RACE_TIERS]
    bench = benchmark_phases(torch, port, KF, card, device)
    factory = factory_phases(torch, port, KF, card, device)
    differentiable = differentiable_phases(torch, port, KF, card, device)
    stagewise = stagewise_phases(torch, port, KR, card, device)
    user = user_model_phases(torch, port, KF, card, device)
    cli_phases(torch, card)
    scaleout_phases(torch, port, K, KI, card, device)
    kernels = [admm, *family, *panel, ilqr, modes, *racing, *bench, *factory, *differentiable,
               stagewise, *user]
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
        print(f"built {name} in {seconds[name]:.1f} s", flush=True)
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
    presolve, ``steps`` warm steps; with ``mesh``, the policy's mesh path,
    each rank presolving and solving its data slice."""
    problem = port.session2_problem(N=HORIZON)
    ctrl = port.make_linear_mpc(
        problem, iters=ADMM_ITERS, rho=RHO, dtype=torch.float32, device=device
    )
    system = problem.system(torch.float32, device)

    def episode(x0, backend="cuda", steps=STEPS, tile=None, mesh=None):
        tile = tile or K.DEFAULT_TILE
        x0 = x0[torch.argsort(port.boundary_compaction_key(problem.p_max, x0), stable=True)]
        rows = x0
        if mesh is not None:  # each rank presolves its own rows, which its policy keeps
            from model_predictive_control_tpu_torch.parallel.mesh import shard_rows

            rows = shard_rows(mesh, x0)
        carry = ctrl.presolve_batch_carry(rows, iters_mult=PRESOLVE_MULT, backend=backend,
                                          tile=tile)
        policy = ctrl.batched_policy(
            backend=backend, tile=tile, max_rho_moves=0, polish=False, probe_iters=PROBE_ITERS,
            mesh=mesh,
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


def wide_controller(torch, port, device, N=WIDE_N):
    """The MHE loop's slack-softened MPC at N = 20 (n = 60, m = 140: K1's
    panel mode), as ``mhe_loop_sweep`` builds it (or at horizon ``N``)."""
    problem = port.session2_problem(N=N)
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
    """The rest of the linear ADMM family on K1: the panel mode against its
    twin on the soft-state MPC at N = 20, the MHE loop's windows against the
    twin, then the tube, stochastic and MHE-loop paths at the contract's
    sizes (launches counted, quality gated, a kernel-vs-twin closed loop
    with a float64 witness, one timed round each). Returns the ``kernels``
    entries of the panel instantiation at n + m = 200 and of the MHE
    windows' one, each timed and bounded on a launch of the MHE loop."""
    from model_predictive_control_tpu_torch.parallel import batch as PB

    problem, ctrl = wide_controller(torch, port, device)
    wide_name, mhe_name = K.library_name(WIDE_COLS, 32), K.library_name(MHE_COLS)
    n, m = ctrl.qp.n, ctrl.qp.m
    plan = K.launch_plan(n, m, K.DEFAULT_TILE, True)
    phase(f"ADMM kernel panel mode vs twin on the card (soft-state MPC, B={WIDE_BATCH}, n={n}, "
          f"m={m}, tile={K.DEFAULT_TILE})")
    if not plan.panel or K.library_name(plan.cols, plan.lanes) != wide_name:
        raise SystemExit(f"the soft-state operator does not take the panel mode: {plan}")
    g = torch.Generator().manual_seed(0)
    x0s = PB.mhe_loop_scenarios(g, WIDE_BATCH, 1, 10, problem.Ts, 0.02, 0.1)[0].to(
        dtype=torch.float32, device=device)
    q, l, u = ctrl.qp.qp_vectors(x0s)
    cold_kw = dict(iters=4 * WIDE_ITERS, chunks=8, probe_iters=0, polish=False,
                   tile=K.DEFAULT_TILE, return_iters=True)
    wide_err = compare(torch, "n+m=200 cold", K.admm_solve_cuda(ctrl.op, q, l, u, **cold_kw),
                       K.admm_solve_twin(ctrl.op, q, l, u, **cold_kw), kind="cold")
    cold_kw["polish"] = True  # the presolve's config
    cold_k = K.admm_solve_cuda(ctrl.op, q, l, u, **cold_kw)
    compare(torch, "n+m=200 polished", cold_k, K.admm_solve_twin(ctrl.op, q, l, u, **cold_kw),
            kind="polished")
    x1 = problem.system(torch.float32, device)(x0s, cold_k[0].x[:, : ctrl.qp.nu])
    wx, wy = ctrl._shift_warm(cold_k[0].x, cold_k[0].y, axis=1)
    q1, l1, u1 = ctrl.qp.qp_vectors(x1)
    # the loop's steady solve (polish on) on iterations and success; the
    # same step without the polish also on x
    warm_kw = dict(iters=WIDE_ITERS, tile=K.DEFAULT_TILE, return_iters=True)
    compare(torch, "n+m=200 warm polished", K.admm_solve_cuda(ctrl.op, q1, l1, u1, wx, wy, **warm_kw),
            K.admm_solve_twin(ctrl.op, q1, l1, u1, wx, wy, **warm_kw), kind="polished")
    warm_kw["polish"] = False
    wide_err = max(wide_err, compare(torch, "n+m=200 warm",
                                     K.admm_solve_cuda(ctrl.op, q1, l1, u1, wx, wy, **warm_kw),
                                     K.admm_solve_twin(ctrl.op, q1, l1, u1, wx, wy, **warm_kw),
                                     kind="warm"))
    args, raw_kw = K.prepare_tiles(ctrl.op, q1, l1, u1, wx, wy, iters=WIDE_ITERS, chunks=2,
                                   probe_iters=32, max_rho_moves=None, schedule="uniform",
                                   tile=K.DEFAULT_TILE, cg_iters=40, alpha=1.6, eps_abs=None,
                                   polish=True)
    ni = K._launch(*args, **raw_kw)[3]
    print(f"informational: n+m=200 first warm step (the MHE loop's MPC solve: {WIDE_ITERS} "
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
    if wplan.panel or K.library_name(wplan.cols, wplan.lanes) != mhe_name:
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
            raise SystemExit("the MHE loop did not go through the panel mode once per MPC solve "
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
    for lib, label, err in ((wide_name, "panel mode, n + m = 200", wide_err),
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


# K1's panel mode past 256 columns: (a) the condensed long-horizon
# closed loop, the hard box at N = 100 (n = 100, m = 300) through
# make_linear_mpc(solver="admm") at its defaults and batched_policy, from the
# starts of long_horizon_loop; (b) the soft-state MPC at N = 30 and 100
# (n + m = 300 and 1,000) at the MHE loop's settings, a cold launch (the
# presolve's) and a warm one from its solution.
PANEL_LH_N = 100
PANEL_LH_BATCH = 4096
PANEL_LH_STEPS = 50
PANEL_TWIN = (256, 10)  # the kernel-vs-twin closed loop: first scenarios, steps
TOL_PANEL_SUCCESS = 0.01  # |success(kernel loop) - success(twin loop)| over those
PANEL_SOFT_N = (30, 100)
PANEL_SOFT_BATCH = 1024


def panel_libraries(K) -> list:
    """``(name, build)`` of the panel-mode libraries the paths take: n + m =
    200 (the MHE loop), 300, 400 and 1,000."""
    cols = sorted({K.columns(n, m, 32) for n, m in ((60, 140), (90, 210), (100, 300), (300, 700))})
    return [(K.library_name(c, 32), lambda c=c: K._build_library(c, 32)) for c in cols]


def held_to_twin(torch, name, got, ref, polished, witness=None) -> float:
    """tests/test_torch_cuda.py's bars on one launch through the wrapper
    (``(solution, executed iterations)`` of the kernel and of the twin):
    executed iterations agree on 90% of the scenarios and converged masks on
    95%; x within 2e-2 where the iterations agree, or (``polished``, the bars
    of test_wide_mode_matches_twin) the success rates within 0.05. With a
    ``witness`` (the twin's algorithm in float64 on the same operands), x is
    held within the larger of 2e-2 and the twin's own distance to it: past
    a few iterations float32 rounding moves these ill-conditioned iterates
    further than 2e-2. Returns max|Δx| over the rows held."""
    (sol_k, ni_k), (sol_t, ni_t) = got, ref
    same = ni_k == ni_t
    agree = same.float().mean().item()
    conv = (sol_k.converged == sol_t.converged).float().mean().item()
    rate_k, rate_t = sol_k.converged.float().mean().item(), sol_t.converged.float().mean().item()
    dx = (sol_k.x - sol_t.x).abs().amax(dim=1)
    err = dx[same].max().item() if bool(same.any()) else 0.0
    tol = 2e-2
    if witness is not None:
        tol = max(tol, (sol_t.x - witness.x).abs().amax(dim=1)[same].max().item())
    print(f"{name}: executed iterations agree {agree:.5f} (tol 0.9; mean {ni_k.mean().item():.2f} vs "
          f"twin {ni_t.mean().item():.2f}); converged agree {conv:.5f} (tol 0.95), "
          f"{rate_k:.5f} vs twin {rate_t:.5f}; max|x_kernel - x_twin| where the iterations agree "
          f"{err:.3e}{' (not gated)' if polished else f' (tol {tol:.3e})'}, over all rows "
          f"{dx.max().item():.3e}", flush=True)
    ok = agree >= 0.9 and conv >= 0.95 and all(bool(torch.isfinite(a).all()) for a in (sol_k.x, sol_k.y))
    ok = ok and (abs(rate_k - rate_t) <= 0.05 if polished else err <= tol)
    if not ok:
        raise SystemExit(f"the panel mode disagrees with its twin on {name}")
    return 0.0 if polished else err


def panel_entry(torch, K, label, launches, err, args, kw, card) -> dict:
    """The ``kernels`` entry of one panel-mode shape: the launch on ``args``,
    ``kw`` timed alone (the kernel, 5 calls after a warm-up; the twin, 1) and
    bounded at its executed iterations."""
    kernel_ms = time_cuda(torch, lambda: K._launch(*args, **kw), 5)
    twin_ms = time_cuda(torch, lambda: K.admm_solve_tiles_reference(*args, **kw), 1)
    outs = K._launch(*args, **kw)
    n, m = args[9].shape[1], args[10].shape[1]
    k = n + m
    plan = K.launch_plan(n, m, kw["tile"], kw["polish"])
    print(f"{label}: launch alone {kernel_ms:.3f} ms (executed mean {outs[3].mean().item():.2f}, max "
          f"{outs[3].max().item():.0f}; {plan.warps_per_quad} warps a quad, panels of "
          f"{plan.panel_rows} rows, {plan.threads} threads and {plan.smem_bytes} bytes a CTA), twin "
          f"{twin_ms:.3f} ms [{card}]", flush=True)
    # per scenario and executed iteration: [x | rho z - y] W, 2 (n + m)^2,
    # and ~12 operations on each of the n + m columns
    return {
        "name": f"admm_tile_kernel ({label})",
        "route": "cuda",
        "source": "model_predictive_control_tpu_torch/csrc/admm_kernel.cu",
        "replaces": "model_predictive_control_tpu/ops/pallas/admm_kernel.py:82",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
        **bound(torch, float(outs[3].sum()) * (2 * k * k + 12 * k), [*args, *outs]),
    }


def k1_panel_phases(torch, port, K, KR, card, device) -> list:
    """K1's panel mode on the paths that need it past 256 columns: (a) the
    condensed long-horizon closed loop (launches counted, the presolve and a
    warm launch held to the twin, a kernel-vs-twin closed loop, the wall,
    the kernel's share from events, K4's stagewise loop's success on the
    same starts beside it); (b) the soft-state operator at n + m = 300 and
    1,000, a cold and a warm launch, each held to the twin. Returns their
    ``kernels`` entries."""
    from model_predictive_control_tpu_torch.obs.roofline import admm_kernel_roofline
    from model_predictive_control_tpu_torch.parallel import batch as PB

    tile = K.DEFAULT_TILE
    problem = port.session2_problem(N=PANEL_LH_N)
    ctrl = port.make_linear_mpc(problem, solver="admm", device=device)
    n, m, B = ctrl.qp.n, ctrl.qp.m, PANEL_LH_BATCH
    lib = K.library_name(K.columns(n, m, 32), 32)
    plan = K.launch_plan(n, m, tile, True)
    phase(f"K1 panel mode: condensed long-horizon closed loop (hard box N={PANEL_LH_N}, n={n}, "
          f"m={m}, {B} x {PANEL_LH_STEPS}, tile {tile}, {lib})")
    if not plan.panel:
        raise SystemExit(f"the condensed long-horizon operator does not take the panel mode: {plan}")
    system = problem.system(torch.float32, device)
    x0 = initial_states(torch, device, B)

    def episode(x, steps=PANEL_LH_STEPS, backend="cuda"):
        carry = ctrl.presolve_batch_carry(x, backend=backend, tile=tile)
        return port.simulate_batch(x, system, steps, ctrl.batched_policy(backend=backend, tile=tile),
                                   carry, batched_dynamics=True)

    K.LAUNCHES = 0
    K.LAUNCHES_BY_LIBRARY.clear()
    res = episode(x0)
    torch.cuda.synchronize()
    launches = K.LAUNCHES_BY_LIBRARY.get(lib, 0)
    print(f"launches in the closed loop: {K.LAUNCHES}, by library {dict(K.LAUNCHES_BY_LIBRARY)} "
          f"(expected {PANEL_LH_STEPS + 1} of {lib})", flush=True)
    if K.LAUNCHES != PANEL_LH_STEPS + 1 or launches != PANEL_LH_STEPS + 1:
        raise SystemExit("the condensed long-horizon loop did not go through the panel mode "
                         "once per solve")
    if (not bool(torch.isfinite(res.states).all())
            or res.states.shape != (PANEL_LH_STEPS + 1, B, 2)
            or res.inputs.shape != (PANEL_LH_STEPS, B, 1)):
        raise SystemExit(f"the condensed loop's states {res.states.shape}, or not finite")
    success = res.logs["solver_success"].float().mean().item()
    stagewise = long_horizon_loop(torch, port, KR, device, B)()
    print(f"condensed ADMM loop success {success:.5f}; K4's stagewise interior-point loop on the "
          f"same starts {stagewise.logs['solver_success'].float().mean().item():.5f} "
          f"(informational: one QP, two algorithms)", flush=True)
    del stagewise

    # the presolve launch and the first warm launch at full batch
    q, l, u = ctrl.qp.qp_vectors(x0)
    cold_kw = dict(iters=4 * ctrl.iters, chunks=8, probe_iters=0, tile=tile, return_iters=True)
    cold = K.admm_solve_cuda(ctrl.op, q, l, u, **cold_kw)
    err = held_to_twin(torch, "the presolve launch", cold,
                       K.admm_solve_twin(ctrl.op, q, l, u, **cold_kw), polished=False)
    x1 = system(x0, cold[0].x[:, : ctrl.qp.nu])
    wx, wy = ctrl._shift_warm(cold[0].x, cold[0].y, axis=1)
    q1, l1, u1 = ctrl.qp.qp_vectors(x1)
    warm_kw = dict(iters=ctrl.iters, tile=tile, return_iters=True)
    err = max(err, held_to_twin(torch, "the first warm launch",
                                K.admm_solve_cuda(ctrl.op, q1, l1, u1, wx, wy, **warm_kw),
                                K.admm_solve_twin(ctrl.op, q1, l1, u1, wx, wy, **warm_kw),
                                polished=False))
    n_twin, steps_twin = PANEL_TWIN
    got = episode(x0[:n_twin], steps_twin)
    ref = episode(x0[:n_twin], steps_twin, backend="twin")
    rate_k = got.logs["solver_success"].float().mean().item()
    rate_t = ref.logs["solver_success"].float().mean().item()
    print(f"kernel vs twin closed loop, {n_twin} scenarios x {steps_twin} steps: success "
          f"{rate_k:.5f} vs twin {rate_t:.5f} (tol {TOL_PANEL_SUCCESS}); max|final state "
          f"difference| {(got.states[-1] - ref.states[-1]).abs().max().item():.3e} "
          f"(informational)", flush=True)
    if abs(rate_k - rate_t) > TOL_PANEL_SUCCESS:
        raise SystemExit("the condensed long-horizon closed loop disagrees with its twin")

    episode(x0)  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        episode(x0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    print(f"condensed long-horizon loop {B} x {PANEL_LH_STEPS}: wall {dt:.4f} s (best of 3: "
          f"{', '.join(f'{t:.4f}' for t in times)}), {B * PANEL_LH_STEPS / dt:.1f} solves/s "
          f"[{card}]", flush=True)
    events = []
    launch = K._launch
    K._launch = timed_launches(torch, K, events)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        episode(x0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        K._launch = launch
    print_events(wall, events, card)
    args, kw = K.prepare_tiles(ctrl.op, q1, l1, u1, wx, wy, iters=ctrl.iters, chunks=2,
                               probe_iters=32, max_rho_moves=None, schedule="uniform", tile=tile,
                               cg_iters=40, alpha=1.6, eps_abs=None, polish=True)
    entry = panel_entry(torch, K, f"panel mode, n + m = {n + m}, the condensed long-horizon "
                        f"loop's first warm launch", launches, err, args, kw, card)
    ni = K._launch(*args, **kw)[3].mean().item()
    rl = admm_kernel_roofline(n, m, iters=round(ni))
    print(f"obs/roofline.py::admm_kernel_roofline at the mean executed iterations ({ni:.1f}, the "
          f"polish's full CG budget): {B * rl.flops_per_solve:.4g} FP32 operations, "
          f"{1e3 * B * rl.flops_per_solve / 67e12:.4f} ms at the FP32 peak", flush=True)
    entries = [entry]
    del res, got, ref

    for N in PANEL_SOFT_N:
        sproblem, sctrl = wide_controller(torch, port, device, N=N)
        n, m = sctrl.qp.n, sctrl.qp.m
        lib = K.library_name(K.columns(n, m, 32), 32)
        phase(f"K1 panel mode: soft-state MPC at N={N} (n={n}, m={m}, {PANEL_SOFT_BATCH} "
              f"scenarios of the MHE loop, tile {tile}, {lib})")
        x0 = PB.mhe_loop_scenarios(torch.Generator().manual_seed(0), PANEL_SOFT_BATCH, 1, 10,
                                   sproblem.Ts, 0.02, 0.1)[0].to(dtype=torch.float32, device=device)
        q, l, u = sctrl.qp.qp_vectors(x0)
        # the MHE loop's presolve (4x budget, 8 chunks, rho moves, no probe,
        # polish), then a warm launch from its solution at the policy's flags
        cold_kw = dict(iters=4 * sctrl.iters, chunks=8, probe_iters=0, tile=tile,
                       return_iters=True)
        K.LAUNCHES_BY_LIBRARY.clear()
        cold = K.admm_solve_cuda(sctrl.op, q, l, u, **cold_kw)
        x1 = sproblem.system(torch.float32, device)(x0, cold[0].x[:, : sctrl.qp.nu])
        wx, wy = sctrl._shift_warm(cold[0].x, cold[0].y, axis=1)
        q1, l1, u1 = sctrl.qp.qp_vectors(x1)
        warm_kw = dict(iters=sctrl.iters, tile=tile, return_iters=True)
        warm = K.admm_solve_cuda(sctrl.op, q1, l1, u1, wx, wy, **warm_kw)
        torch.cuda.synchronize()
        launches = K.LAUNCHES_BY_LIBRARY.get(lib, 0)
        print(f"launches: {dict(K.LAUNCHES_BY_LIBRARY)} (expected 2 of {lib})", flush=True)
        if launches != 2:
            raise SystemExit(f"the soft-state operator at N={N} did not go through {lib}")
        held_to_twin(torch, f"N={N} cold (the presolve)", cold,
                     K.admm_solve_twin(sctrl.op, q, l, u, **cold_kw), polished=True)
        held_to_twin(torch, f"N={N} warm (the policy)", warm,
                     K.admm_solve_twin(sctrl.op, q1, l1, u1, wx, wy, **warm_kw), polished=True)
        plain = K.admm_solve_tiles_reference
        K.admm_solve_tiles_reference = float64_twin(torch, plain)
        try:
            wit = K.admm_solve_twin(sctrl.op, q1, l1, u1, wx, wy, polish=False, **warm_kw)[0]
        finally:
            K.admm_solve_tiles_reference = plain
        err = held_to_twin(torch, f"N={N} warm without the polish",
                           K.admm_solve_cuda(sctrl.op, q1, l1, u1, wx, wy, polish=False, **warm_kw),
                           K.admm_solve_twin(sctrl.op, q1, l1, u1, wx, wy, polish=False,
                                             **warm_kw), polished=False, witness=wit)
        base = dict(schedule="uniform", tile=tile, cg_iters=40, alpha=1.6, eps_abs=None,
                    polish=True, max_rho_moves=None)
        args, kw = K.prepare_tiles(sctrl.op, q, l, u, None, None, iters=4 * sctrl.iters,
                                   chunks=8, probe_iters=0, **base)
        entries.append(panel_entry(torch, K, f"panel mode, n + m = {n + m}, the soft MPC's "
                                   f"presolve launch", launches, err, args, kw, card))
        args, kw = K.prepare_tiles(sctrl.op, q1, l1, u1, wx, wy, iters=sctrl.iters, chunks=2,
                                   probe_iters=32, **base)
        ms = time_cuda(torch, lambda: K._launch(*args, **kw), 5)
        outs = K._launch(*args, **kw)
        k = n + m
        print(f"N={N} warm launch alone: {ms:.3f} ms (executed mean {outs[3].mean().item():.2f}) "
              f"[{card}]", flush=True)
        bound(torch, float(outs[3].sum()) * (2 * k * k + 12 * k), [*args, *outs])
    return entries


def mhe_loop_launch_report(torch, port, K, card, device, path=None) -> None:
    """Times the soft MPC's launch of median time in
    ``mhe_loop_sweep(2048, 50)`` (n + m = 200; after the cold first launch)
    alone, 10 calls after a warm-up, on the operands the loop gave it, or on
    those saved at ``path`` by another version (saved there when ``path``
    does not exist yet)."""
    from model_predictive_control_tpu_torch.parallel import batch as PB

    name, batch, steps, _, _ = FAMILY["mhe_loop"]
    if path is not None and os.path.exists(path):
        saved = torch.load(path)
        args, kw = [a.to(device) for a in saved["args"]], saved["kw"]
        print(f"the launch's operands from {path}", flush=True)
    else:
        sweep = getattr(PB, name)
        sweep(batch, steps, device=device)  # warm-up
        kept = []
        _, events, _ = timed_sweep(torch, K, sweep, batch, device, steps=steps, kept=kept)
        rows = [(a.elapsed_time(b), *rest) for (a, b), rest in zip(events, kept)
                if rest[0][9].shape[1] == 3 * WIDE_N]
        ms, args, kw, _ = sorted(rows[1:], key=lambda r: r[0])[(len(rows) - 1) // 2]
        print(f"the soft MPC's launch of median time: {ms:.3f} ms in the loop [{card}]",
              flush=True)
        if path is not None:
            torch.save({"args": [a.cpu() for a in args], "kw": kw}, path)
    plan = K.launch_plan(args[9].shape[1], args[10].shape[1], kw["tile"], kw["polish"])
    outs = K._launch(*args, **kw)
    print(f"{plan}: the MHE loop's median n + m = 200 launch alone "
          f"{time_cuda(torch, lambda: K._launch(*args, **kw), 10):.3f} ms (executed mean "
          f"{outs[3].mean().item():.2f}) [{card}]", flush=True)


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
    launches, kept_loops, summaries = 0, {}, {}
    for name, (entry, B, steps, extra, contract) in MODE_LOOPS.items():
        sweep = getattr(port, entry)
        for compensate in ((True, False) if name in MODE_ABLATIONS else (None,)):
            kw = dict(extra, **({} if compensate is None else {"compensate": compensate}))
            K.LAUNCHES = 0
            kept = [] if name in ("wind", "offset_free") and compensate else None
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
                kept_loops[name] = [(a.elapsed_time(b), *rest) for (a, b), rest in zip(events, kept)]
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

    # the slope loop's launch of median time after the first, timed alone
    # and bounded (informational: its loop is host-bound)
    loop_ms, args, kw, _ = sorted(kept_loops["offset_free"][1:],
                                  key=lambda r: r[0])[(len(kept_loops["offset_free"]) - 1) // 2]
    slope_ms = time_cuda(torch, lambda: K._launch(*args, **kw), 10)
    outs = K._launch(*args, **kw)
    print(f"tracking modes: the slope loop's launch of median time ({loop_ms:.3f} ms in the loop; "
          f"N={kw['N']}, mean executed inner iterations {outs[5].mean().item():.2f}) alone: "
          f"{slope_ms:.3f} ms [{card}]", flush=True)
    bound(torch, FLOPS_STAGE_ITER["tracking"] * kw["N"] * float(outs[5].sum()),
          [a for a in args if torch.is_tensor(a)] + list(outs))
    # the entry: the wind loop's launch of median time after the first (a
    # cold start), timed alone, with the twin and the bound on its operands
    wind_loop = kept_loops["wind"]
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

# The differentiable layer (the fused tuning loss) and the parallel horizon.
DIFF_LANES = 256  # starts of the untimed first gradient
DIFF_BATCH = 2048  # starts of the tuning loss, lanes of the held and timed launch
DIFF_STEPS = 4
DIFF_N, DIFF_TS = 8, 0.05
DIFF_BUDGET = (8, 30)  # the tuning layer's outer x inner AL-iLQR budget
DIFF_TILE = 16  # the tracker's default tile
DIFF_GROUPS = (1, 8, 32)
DIFF_TILES = (8, 16, 32)  # the launch sweep of (tile, group) that sets the default group
DIFF_CENTER = (0.6, -0.25, 0.0, 0.0)  # the CLI's draw, JAX cli.py:294-296
DIFF_TRUE_Q, DIFF_TRUE_R = (10.0, 10.0, 0.1, 0.1), (0.1, 0.01)  # the CLI's true objective
# the weights the gradient is taken at (tests/test_implicit_fused.py's)
DIFF_THETA = {"logQ": (0.8, 2.0, 0.15, 0.02), "logR": (0.7, 0.02)}
DIFF_FD_EPS = 3e-3  # tests/test_implicit_fused.py:57-67: |g - fd| <= 5e-2 (1 + |fd|)
DIFF_UPDATES = 3
LH_PAR_BATCH = 256  # starts of the parallel-vs-sequential interior point
LQT_N = 1024
TOL_PARALLEL = 1e-8
TOL_GRAPH = 1e-6  # graphed against eager ADMM iterations, float32, of 1 + max|x|
# the no-obstacle parking build per stage and executed inner iteration: the
# kinematic tracker's count (Euler step 27, 6 tangent directions, nx=4
# algebra with the 12 box rows, 7 rollouts) in regulation
FLOPS_STAGE_ITER["kinematic_wrt"] = FLOPS_STAGE_ITER["kinematic"]


def graph_vs_eager_admm(torch, port, card, device) -> None:
    """The plain ADMM solve at ``experiments.tuning.run()``'s shapes
    (session 2 at N=6, 8 starts, 400 iterations, float32) without autograd,
    where its iterations replay a CUDA graph, against the eager loop of the
    same solve with autograd on: the same kernels in the same order, held to
    ``TOL_GRAPH`` of the solution's scale; both timed."""
    from model_predictive_control_tpu_torch.ops.condensed import build_condensed_qp
    from model_predictive_control_tpu_torch.solvers.qp import admm_solve, qp_setup

    f32 = torch.float32
    problem = port.session2_problem(N=6)
    system = problem.system(f32, device)
    t = lambda v: torch.tensor(v, dtype=f32, device=device)
    cq = build_condensed_qp(system.A, system.B, torch.diag(t(problem.Q)), torch.diag(t(problem.R)),
                            torch.diag(t(problem.Q)), problem.N, u_min=t([problem.u_min]),
                            u_max=t([problem.u_max]), x_min=t([problem.p_min, problem.v_min]),
                            x_max=t([problem.p_max, problem.v_max]))
    op = qp_setup(cq.P, cq.A_c, rho=0.1)
    g = torch.Generator().manual_seed(3)
    x0s = torch.stack([-10.0 + 8.0 * torch.rand(8, generator=g),
                       -2.0 + 7.0 * torch.rand(8, generator=g)], dim=1).to(device)
    qlu = cq.qp_vectors(x0s)
    with torch.no_grad():
        graphed = admm_solve(op, *qlu, iters=400)
        graph_ms = time_cuda(torch, lambda: admm_solve(op, *qlu, iters=400), 10)
    with torch.enable_grad():
        eager = admm_solve(op, *qlu, iters=400)
        eager_ms = time_cuda(torch, lambda: admm_solve(op, *qlu, iters=400), 3)
    diff = max((a - b).abs().max().item() for a, b in
               ((graphed.x, eager.x), (graphed.y, eager.y), (graphed.z, eager.z)))
    scale = 1.0 + eager.x.abs().max().item()
    print(f"admm_solve at experiments.tuning.run()'s shapes (8 x n=6, 400 iterations, float32): "
          f"graphed {graph_ms:.3f} ms, eager {eager_ms:.3f} ms; max difference {diff:.3e} "
          f"(bitwise {diff == 0.0}; tol {TOL_GRAPH:.0e} x {scale:.3f}) [{card}]", flush=True)
    if not diff <= TOL_GRAPH * scale:
        raise SystemExit("the graphed ADMM iterations disagree with the eager loop")


def differentiable_phases(torch, port, K, card, device) -> list:
    """The differentiable layer and the parallel horizon on the card:
    ``kinematic_wrt`` (the tuning layer's fused forward) held to its twin bit
    for bit at every group of ``DIFF_GROUPS`` on the forward's own operands
    (``DIFF_BATCH`` lanes), a launch sweep on them; then the main path,
    counted: the
    fused closed-loop tuning loss's value and gradient (one launch a step),
    the gradient against central differences on every weight, three Adam
    updates of ``tune_parking_weights(forward="fused")``, and the linear
    tier's ``experiments.tuning.run()`` at the CLI defaults; the parallel
    horizon against the sequential solvers. Returns ``kinematic_wrt``'s
    ``kernels`` entry."""
    import numpy as np

    from model_predictive_control_tpu_torch import tuning
    from model_predictive_control_tpu_torch.experiments import tuning as tuning_exp
    from model_predictive_control_tpu_torch.ops import parallel_horizon as PH
    from model_predictive_control_tpu_torch.solvers import riccati_ip as RI

    f64 = torch.float64
    g = torch.Generator().manual_seed(0)
    starts = lambda b: (torch.tensor(DIFF_CENTER, dtype=f64)
                        + 0.1 * torch.randn(b, 4, generator=g, dtype=f64)).to(device)
    theta = {k: torch.log(torch.tensor(v, dtype=f64, device=device))
             for k, v in DIFF_THETA.items()}
    fwd = tuning.make_fused_parking_forward(N=DIFF_N, ts=DIFF_TS, outer_iters=DIFF_BUDGET[0],
                                            inner_iters=DIFF_BUDGET[1], tile=DIFF_TILE)
    budget = f"{DIFF_BUDGET[0]} x {DIFF_BUDGET[1]}"

    phase(f"kinematic_wrt vs twin on the card ({DIFF_BATCH} lanes of the fused forward, "
          f"N={DIFF_N}, {budget}, tile {DIFF_TILE}), then timed alone per (tile, group)")
    # the twin takes ~8 s a solve on the card at 256 lanes as at 2,048 (its
    # eager ops are launch-bound): the hold runs on the timed launch's own
    # operands, so that one twin solve gives both
    zeros = lambda b: torch.zeros(b, DIFF_N, 2, dtype=f64, device=device)
    x_big = starts(DIFF_BATCH)
    (args, kw), = captured_launches(torch, K, lambda: fwd(theta, x_big, zeros(DIFF_BATCH)),
                                    count=1)
    kw = {k: v for k, v in kw.items() if k != "group"}
    key = K.instantiation(kw["ode_rows"], kw.get("extra_constraints"), kw["extra_order"], True)
    if key != "kinematic_wrt":
        raise SystemExit(f"the fused forward launched {key}, not kinematic_wrt")
    want, twin_s = twin_launch(torch, K, args, kw)
    outs = {grp: K._launch(*args, group=grp, **kw) for grp in DIFF_GROUPS}
    err = compare_launches(torch, "tracker kernel", f"kinematic_wrt, the fused forward's launch "
                           f"({DIFF_BATCH} lanes, {budget})", outs, want, twin_s, card)
    points = {}
    for t, grp in sweep_grid(K, DIFF_GROUPS, DIFF_TILES):
        at = {**kw, "tile": t, "group": grp}
        points[(t, grp)] = time_cuda(torch, lambda: K._launch(*args, **at), 5)
        print(f"kinematic_wrt at tile {t} group {grp}: {points[(t, grp)]:.3f} ms [{card}]",
              flush=True)
    at_tile = {grp: ms for (t, grp), ms in points.items() if t == DIFF_TILE}
    best = min(at_tile, key=at_tile.get)
    print(f"kinematic_wrt: fastest group at tile {DIFF_TILE}: {best} ({at_tile[best]:.3f} ms); "
          f"the default is {K.DEFAULT_GROUP['kinematic_wrt']} [{card}]", flush=True)
    dkw = {**kw, "group": K.DEFAULT_GROUP["kinematic_wrt"]}
    wrt_ms = time_cuda(torch, lambda: K._launch(*args, **dkw), 10)
    bouts = outs[dkw["group"]]
    print(f"kinematic_wrt at {DIFF_BATCH} lanes, tile {DIFF_TILE}, group {dkw['group']}: kernel "
          f"{wrt_ms:.3f} ms, mean executed {bouts[5].mean().item():.2f}; twin "
          f"{1e3 * twin_s:.1f} ms (timed once) [{card}]; ", end="")
    roof = bound(torch, FLOPS_STAGE_ITER["kinematic_wrt"] * DIFF_N * float(bouts[5].sum()),
                 [*args, kw["wrt"], *bouts])

    phase(f"the fused tuning loss: make_parking_closed_loop_cost({DIFF_BATCH} starts, "
          f"steps={DIFF_STEPS}, N={DIFF_N}, forward='fused'), value and gradient, FD gate")
    loss = tuning.make_parking_closed_loop_cost(
        x_big, DIFF_STEPS, DIFF_TRUE_Q, DIFF_TRUE_R, N=DIFF_N, ts=DIFF_TS,
        outer_iters=DIFF_BUDGET[0], inner_iters=DIFF_BUDGET[1], forward="fused", tile=DIFF_TILE)
    # the first gradient pays the CUDA libraries' start (the batched solves,
    # torch.func's transforms): one untimed on DIFF_LANES starts, one step
    t0 = time.perf_counter()
    small = tuning.make_parking_closed_loop_cost(
        starts(DIFF_LANES), 1, DIFF_TRUE_Q, DIFF_TRUE_R, N=DIFF_N, ts=DIFF_TS,
        outer_iters=DIFF_BUDGET[0], inner_iters=DIFF_BUDGET[1], forward="fused", tile=DIFF_TILE)
    warm = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
    torch.autograd.grad(small(warm), list(warm.values()))
    torch.cuda.synchronize()
    print(f"first gradient ({DIFF_LANES} starts, one step; the libraries' start): "
          f"{time.perf_counter() - t0:.3f} s [{card}]", flush=True)
    for k in K.LAUNCHES_BY_KERNEL:
        K.LAUNCHES_BY_KERNEL[k] = 0
    leaves = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = loss(leaves)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(val, [leaves["logQ"], leaves["logR"]])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counted = K.LAUNCHES_BY_KERNEL["kinematic_wrt"]
    print(f"fused tuning loss {val.item():.6f}: forward {t1 - t0:.4f} s, backward (the KKT "
          f"solves, one vmap over {DIFF_BATCH} scenarios a step) {t2 - t1:.4f} s; "
          f"kinematic_wrt launches {counted} (expected {DIFF_STEPS}) [{card}]", flush=True)
    if counted != DIFF_STEPS or not bool(torch.isfinite(val)):
        raise SystemExit("the fused tuning loss did not go through kinematic_wrt once a step")
    worst = 0.0
    with torch.no_grad():
        for key_, gk in zip(("logQ", "logR"), grads):
            if not bool(torch.isfinite(gk).all()):
                raise SystemExit("the fused tuning gradient is not finite")
            for i in range(gk.shape[0]):
                vals = []
                for sgn in (1.0, -1.0):
                    th = {k: v.clone() for k, v in theta.items()}
                    th[key_][i] += sgn * DIFF_FD_EPS
                    vals.append(loss(th).item())
                fd = (vals[0] - vals[1]) / (2 * DIFF_FD_EPS)
                gi = gk[i].item()
                worst = max(worst, abs(gi - fd) / (5e-2 * (1.0 + abs(fd))))
                print(f"d loss / d {key_}[{i}]: implicit {gi:.6f}, central difference {fd:.6f} "
                      f"(gate |g - fd| <= 5e-2 (1 + |fd|))", flush=True)
    if worst > 1.0:
        raise SystemExit("the fused tuning gradient fails the central-difference gate")

    phase(f"tune_parking_weights({DIFF_BATCH} starts x {DIFF_STEPS} steps, forward='fused', "
          f"{DIFF_UPDATES} updates) and experiments.tuning.run() at the CLI defaults")
    for k in K.LAUNCHES_BY_KERNEL:
        K.LAUNCHES_BY_KERNEL[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tuning.tune_parking_weights(x_big, DIFF_STEPS, DIFF_TRUE_Q, DIFF_TRUE_R,
                                      updates=DIFF_UPDATES, N=DIFF_N, ts=DIFF_TS,
                                      forward="fused", tile=DIFF_TILE)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    launches = K.LAUNCHES_BY_KERNEL["kinematic_wrt"]
    losses = out["losses"].tolist()
    # one loss a step for each update's value and gradient, and the last's
    expected = (DIFF_UPDATES + 1) * DIFF_STEPS
    print(f"tune_parking_weights(fused): losses {losses}, {tune_s:.3f} s; tuned Q "
          f"{out['Q'].tolist()}, R {out['R'].tolist()}; kinematic_wrt launches {launches} "
          f"(expected {expected}) [{card}]", flush=True)
    if launches != expected:
        raise SystemExit("tune_parking_weights(forward='fused') did not go through kinematic_wrt "
                         "once a step")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise SystemExit("tune_parking_weights(forward='fused') did not lower the loss")
    graph_vs_eager_admm(torch, port, card, device)
    t0 = time.perf_counter()
    summary = tuning_exp.run(device=device)
    print(f"experiments.tuning.run(): {summary} in {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    if not summary["reduction"] > 0.0:
        raise SystemExit("experiments.tuning.run() did not reduce the loss")

    phase(f"the parallel horizon: stagewise_ip_solve(parallel=True) vs sequential "
          f"({LH_PAR_BATCH} starts, N={LH_N}, float64); lqt_solve_parallel at N={LQT_N}")
    box = port.session2_problem()
    data = [torch.as_tensor(np.asarray(v, dtype=np.float64), device=device) for v in (
        [[1.0, box.Ts], [0.0, 1.0]], [[0.0], [box.Ts]], np.diag(box.Q), np.diag(box.R),
        np.diag(box.Q), [box.p_min, box.v_min], [box.p_max, box.v_max], [box.u_min],
        [box.u_max])]
    x_lh = initial_states(torch, device, LH_PAR_BATCH).to(f64)
    res, secs = {}, {}
    for par in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[par] = RI.stagewise_ip_solve(*data, x_lh, N=LH_N, iters=LH_ITERS, parallel=par)
        torch.cuda.synchronize()
        secs[par] = time.perf_counter() - t0
    du = (res[True].us - res[False].us).abs().max().item()
    print(f"stagewise_ip_solve({LH_PAR_BATCH} x N={LH_N}, float64): parallel {secs[True]:.4f} s, "
          f"sequential {secs[False]:.4f} s; max|us_parallel - us_sequential| {du:.3e} (tol "
          f"{TOL_PARALLEL:.0e}); success {res[True].success.float().mean().item():.5f} vs "
          f"{res[False].success.float().mean().item():.5f} [{card}]", flush=True)
    if not du <= TOL_PARALLEL:
        raise SystemExit("the parallel stagewise interior point disagrees with the sequential")
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=f64, device=device)
    As, Bs = t(np.broadcast_to(data[0].cpu().numpy(), (LQT_N, 2, 2))), t(
        np.broadcast_to(data[1].cpu().numpy(), (LQT_N, 2, 1)))
    Qts = t(np.broadcast_to(np.diag(box.Q), (LQT_N + 1, 2, 2)))
    Rts = t(np.broadcast_to(np.diag(box.R), (LQT_N, 1, 1)))
    qts, rts, x_init = t(rng.normal(size=(LQT_N + 1, 2))), t(rng.normal(size=(LQT_N, 1))), t(
        [-30.0, 10.0])
    par = lambda: PH.lqt_solve_parallel(As, Bs, Qts, Rts, qts, rts, x_init)
    seq = lambda: RI.lq_affine_solve(RI.lq_factor(As, Bs, Qts, Rts), As, Bs, qts, rts,
                                     x_init=x_init)
    (xp, up), (xq, uq) = par(), seq()
    par_ms, seq_ms = time_cuda(torch, par, 3), time_cuda(torch, seq, 1)
    dl = max((xp - xq).abs().max().item(), (up - uq).abs().max().item())
    print(f"lqt_solve_parallel at N={LQT_N}: {par_ms:.3f} ms; the sequential factor and affine "
          f"solve {seq_ms:.3f} ms; max difference {dl:.3e} (tol {TOL_PARALLEL:.0e}) [{card}]",
          flush=True)
    if not dl <= TOL_PARALLEL:
        raise SystemExit("lqt_solve_parallel disagrees with the sequential LQ solve")

    return [{
        "name": "tracker_tile_kernel<Problem<KinematicRows, NoRows, WRT>>", "route": "cuda",
        "source": "model_predictive_control_tpu_torch/csrc/ilqr_factory_ext.cu",
        "replaces": "model_predictive_control_tpu/ops/pallas/ilqr_factory.py:204",
        "launches": launches, "max_abs_err": err, "ms": wrt_ms, "plain_ms": 1e3 * twin_s,
        **roof,
    }]


# ---------------------------------------------------------------------------
# user models: K3 instantiations generated from row functions
# ---------------------------------------------------------------------------

USER_BATCH = 2048  # lanes of the held, counted and timed launches
USER_HOLD_BUDGET = (2, 4)  # outer x inner of the bitwise holds: the twin under 10 s
USER_BUDGET = (6, 15)  # the tracker's default budget: the main path and the timing
USER_GROUPS = {"quadrotor_disc_o2": (8, 1)}  # groups held; the others at 8 alone
USER_OBS = (0.55, -0.05, 0.3)  # tests/test_ilqr_factory_constrained.py:37
USER_KEEPOUT = (0.45, 0.0, 0.1, 0.25)  # tests/test_ilqr_factory_constrained.py:152
USER_CONVERGED = 0.9  # the share of lanes each main-path solve converges on, at least


def quad_clearance_rows(xr, ur):
    """The JAX tests' keep-out disc of the planar quadrotor, c = r² − ‖p −
    p_obs‖² ≤ 0 (``tests/test_ilqr_factory_constrained.py:47``)."""
    ox, oz, r = USER_OBS
    wx = xr[0] - ox
    wz = xr[1] - oz
    return (r * r - (wx * wx + wz * wz),)


def keepout_rows(xr, ur):
    """The JAX tests' spherical keep-out of the thrust cluster
    (``tests/test_ilqr_factory_constrained.py:145``)."""
    ox, oy, oz, orad = USER_KEEPOUT
    wx, wy, wz = xr[0] - ox, xr[1] - oy, xr[2] - oz
    return (orad * orad - (wx * wx + wy * wy + wz * wz),)


def user_cases(torch, port, K, device) -> dict:
    """``name -> (x0s, u_init, kw)`` of each user-model solve at
    ``USER_BATCH`` seeded lanes: the quadrotor with the disc row at orders 2
    and 1, the thrust cluster (nu = 4) with the keep-out, the kinematic
    model as a bare row function (Euler, input box), and the kinematic
    model under RK4 without an input box, its state box alone (a combination
    the hand libraries do not hold: they build it with its input box)."""
    import numpy as np

    from model_predictive_control_tpu_torch.models import benchmarks as BM
    from model_predictive_control_tpu_torch.ops.cuda.parking_factory import make_parking_ode_rows

    rng = np.random.default_rng(14)
    B = USER_BATCH
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    m, _, _, g = BM.QUADROTOR_PARAMS
    quad = dict(ode_rows=BM.make_planar_quadrotor_ode_rows(BM.QUADROTOR_PARAMS), nx=6, nu=2,
                N=10, ts=0.1, substeps=2, integrator="rk4",
                limits=((0.0, 0.0), (1.5 * m * g, 1.5 * m * g)),
                weights=((5.0, 5.0, 1.0, 0.5, 0.5, 0.1), (0.02, 0.02), 10.0),
                extra_constraints=quad_clearance_rows, n_extra=1, extra_deps="x")
    x_quad = f(np.array([1.1, -0.1, 0.0, -0.3, 0.0, 0.0]) + rng.uniform(-0.2, 0.2, (B, 6)))
    x_thr = f(np.array([0.95, 0.05, 0.15, -0.3, 0.0, 0.0]) + rng.uniform(-0.15, 0.15, (B, 6)))
    kin_rows = make_parking_ode_rows(0.05 / 0.097, 0.05)
    kin = dict(nx=4, nu=2, N=15, ts=0.05, substeps=1, integrator="euler",
               limits=((-1.0, -0.384), (1.0, 0.384)),
               state_limits=((-3.0, -2.0, -100.0, -0.5), (3.0, 2.0, 100.0, 0.5)),
               weights=((40.0, 40.0, 4.0, 1.0), (0.5, 0.5), 5.0),
               params=f(np.stack([rng.uniform(1.5, 2.5, B), rng.uniform(0.5, 1.5, B)], -1)),
               n_params=2)
    x_kin = f(rng.uniform([-1.0, -0.8, -0.5, 0.0], [1.0, 0.8, 0.5, 0.4], (B, 4)))
    zeros = lambda nu, N: torch.zeros(B, N, nu, device=device)
    return {
        "quadrotor_disc_o2": (x_quad, zeros(2, 10), {**quad, "extra_order": 2}),
        "quadrotor_disc_o1": (x_quad, zeros(2, 10), {**quad, "extra_order": 1}),
        "thruster_keepout": (x_thr, zeros(4, 10), dict(
            ode_rows=BM.make_thruster_ode_rows(BM.THRUSTER_PARAMS), nx=6, nu=4, N=10, ts=0.1,
            substeps=2, integrator="rk4", limits=((0.0,) * 4, (6.0,) * 4),
            weights=((5.0, 5.0, 5.0, 0.5, 0.5, 0.5), (0.02,) * 4, 10.0),
            extra_constraints=keepout_rows, n_extra=1, extra_deps=(0, 1, 2), extra_order=2)),
        "kinematic_bare": (x_kin, zeros(2, 15), {**kin, "ode_rows": kin_rows.rows}),
        "kinematic_rk4_nobox": (x_kin, zeros(2, 15), {**kin, "ode_rows": kin_rows,
                                                      "integrator": "rk4", "substeps": 2,
                                                      "limits": None}),
    }


def user_instantiations(torch, port, K, device) -> dict:
    """``name -> generated instantiation`` of each user-model solve (what
    ``fused_tracker_solve_cuda`` builds at first use)."""
    out = {}
    for name, (x0s, _, kw) in user_cases(torch, port, K, device).items():
        out[name] = K.generated_instantiation(
            kw["ode_rows"], nx=kw["nx"], nu=kw["nu"], n_params=kw.get("n_params", 0),
            integrator=kw["integrator"], limits=kw["limits"],
            extra_constraints=kw.get("extra_constraints"), n_extra=kw.get("n_extra", 0),
            extra_deps=K._resolve_deps(kw.get("extra_deps", "xu"), kw["nx"], kw["nu"]),
            extra_order=kw.get("extra_order", 2))
    return out


def user_libraries(torch, port, K, device) -> list:
    """``(library name, build function)`` of every generated library the
    user-model phases launch, for :func:`build_all`."""
    from model_predictive_control_tpu_torch.ops.cuda import tracker_codegen as TC

    libs = []
    for name, inst in user_instantiations(torch, port, K, device).items():
        for g in USER_GROUPS.get(name, (K.GENERATED_GROUP,)):
            libs.append((TC.library_name(inst, g),
                         lambda inst=inst, g=g: K._generated_library(inst, g)))
    return libs


def generated_flops(K, inst_trace_ops, kw, executed_stage_iters: float) -> float:
    """FP32 operations the AL-iLQR algorithm needs for a generated
    instantiation, counted from its traces per stage and executed inner
    iteration and multiplied by this run's executed iterations (× N): ``e``
    operations a model evaluation, ``r`` a constraint-row evaluation. A step
    is ``substeps`` × (4 e + 14 nx) under RK4, × (e + 2 nx) under Euler; its
    tangents 2 × step per Jacobian direction (nx + nu); the constraint rows'
    gradient 2 r per dependency column, their curvature (order 2) 4 (NE + 1)
    r per column; the Riccati algebra 2 nx³ + 6 nx² nu + 4 nx nu² + nu³; the 7
    rollouts each the control (2 nx nu), the stage cost (3 nx + 2 nu + 4 nc),
    the rows' values and a step."""
    e, r = inst_trace_ops
    nx, nu, sub = kw["nx"], kw["nu"], kw["substeps"]
    step = sub * ((4 * e + 14 * nx) if kw["integrator"] == "rk4" else (e + 2 * nx))
    ne = len(K._resolve_deps(kw["extra_deps"], nx, nu)) if kw.get("extra_constraints") else 0
    nc = ((2 * nu if kw.get("limits") else 0) + (2 * nx if kw.get("state_limits") else 0)
          + kw.get("n_extra", 0))
    rows = 2 * r * ne + (4 * (ne + 1) * r * ne if kw.get("extra_order", 2) == 2 and r else 0)
    algebra = 2 * nx ** 3 + 6 * nx * nx * nu + 4 * nx * nu * nu + nu ** 3
    rollouts = 7 * (2 * nx * nu + 3 * nx + 2 * nu + 4 * nc + r + step)
    return float(2 * step * (nx + nu) + rows + algebra + rollouts) * executed_stage_iters


def user_model_phases(torch, port, K, card, device) -> list:
    """User models on the card: each generated instantiation against its
    twin bit for bit (``USER_HOLD_BUDGET``, at group 8, the first also at
    group 1), the bare kinematic function against the hand ``kinematic``
    instantiation's launch on the same inputs (one float program), then the
    main path: each solve once through ``fused_tracker_solve_cuda`` at
    ``USER_BATCH`` lanes and the default budget, counted by instantiation;
    each launch timed alone with its bound, the twin's time, nvcc's seconds
    and ptxas's registers and spills. Returns one ``kernels`` entry per
    generated instantiation."""
    from model_predictive_control_tpu_torch.ops.cuda import _build
    from model_predictive_control_tpu_torch.ops.cuda import tracker_codegen as TC

    cases = user_cases(torch, port, K, device)
    insts = user_instantiations(torch, port, K, device)
    phase(f"user models: generated K3 instantiations vs twin on the card ({USER_BATCH} lanes, "
          f"budget {USER_HOLD_BUDGET}, tile {K.DEFAULT_TILE})")
    held, err, twin_s = {}, {}, {}
    hold = dict(outer_iters=USER_HOLD_BUDGET[0], inner_iters=USER_HOLD_BUDGET[1])
    for name, (x0s, u0, kw) in cases.items():
        (args, lkw), = captured_launches(
            torch, K, lambda: K.fused_tracker_solve_cuda(x0s, u0, None, **kw, **hold), count=1)
        lkw = {k: v for k, v in lkw.items() if k != "group"}
        held[name] = (args, lkw)
        want, twin_s[name] = twin_launch(torch, K, args, lkw)
        outs = {g: K._launch(*args, group=g, **lkw) for g in USER_GROUPS.get(name, (8,))}
        err[name] = compare_launches(torch, "generated tracker kernel", f"{name} ({insts[name].key})",
                                     outs, want, twin_s[name], card)
        if twin_s[name] >= 10.0:
            print(f"note: the twin took {twin_s[name]:.1f} s on {name} (asked: under 10 s)",
                  flush=True)
    args, lkw = held["kinematic_bare"]
    hand_kw = {**lkw, "ode_rows": cases["kinematic_rk4_nobox"][2]["ode_rows"]}
    if K.instantiation(hand_kw["ode_rows"]) != "kinematic":
        raise SystemExit("the hand kinematic instantiation is not the one compared")
    hand = K._launch(*args, group=8, **hand_kw)
    gen = K._launch(*args, group=8, **lkw)
    same = [f for f, a, b in zip(KERNEL_FIELDS, gen, hand) if torch.equal(a, b)]
    print(f"kinematic as a bare function vs the hand kinematic instantiation (same operands, "
          f"group 8): bitwise equal fields {same} of {len(KERNEL_FIELDS)} [{card}]", flush=True)
    if len(same) != len(KERNEL_FIELDS):
        raise SystemExit("the generated kinematic functor is not the hand one's float program")

    phase(f"user models main path: fused_tracker_solve_cuda once per model ({USER_BATCH} lanes, "
          f"budget {USER_BUDGET}), counted")
    full = dict(outer_iters=USER_BUDGET[0], inner_iters=USER_BUDGET[1])
    for k in K.LAUNCHES_BY_KERNEL:
        K.LAUNCHES_BY_KERNEL[k] = 0
    sols = {}
    for name, (x0s, u0, kw) in cases.items():
        sols[name] = K.fused_tracker_solve_cuda(x0s, u0, None, **kw, **full)
    torch.cuda.synchronize()
    launches = {name: K.LAUNCHES_BY_KERNEL.get(inst.key, 0) for name, inst in insts.items()}
    print(f"generated instantiations' launches: {launches} (expected 1 each)", flush=True)
    if any(v != 1 for v in launches.values()):
        raise SystemExit("the user models' path did not go through its generated kernels")
    for name, sol in sols.items():
        conv = sol.converged.float().mean().item()
        fin = bool(torch.isfinite(sol.us).all()) and bool(torch.isfinite(sol.xs).all())
        print(f"{name}: converged {conv:.5f}, max viol {sol.viol.max().item():.2e}, mean inner "
              f"iterations {sol.inner_iters_executed.mean().item():.2f}", flush=True)
        if not fin or sol.us.shape != (USER_BATCH, cases[name][2]["N"], cases[name][2]["nu"]):
            raise SystemExit(f"the {name} solve is not finite or has the wrong shape")
        if conv < USER_CONVERGED:
            raise SystemExit(f"the {name} solve converges on {conv:.3f} of the lanes")
    # the disc holds on the converged lanes (their violation below viol_tol;
    # tests/test_ilqr_factory_constrained.py's gate, r - 2e-3)
    sol = sols["quadrotor_disc_o2"]
    p = sol.xs[:, :, :2]
    d = ((p[..., 0] - USER_OBS[0]) ** 2 + (p[..., 1] - USER_OBS[1]) ** 2).sqrt().amin(dim=1)
    clear = d[sol.converged].min().item()
    print(f"quadrotor disc: min clearance over the converged lanes {clear:.4f}, over all "
          f"{d.min().item():.4f} (radius {USER_OBS[2]})", flush=True)
    if clear < USER_OBS[2] - 2e-3:
        raise SystemExit("the generated disc row does not keep the quadrotor out")

    phase("user models: each generated launch timed alone (the held launch: the twin's "
          "work), at the default budget too, bound, build")
    entries = []
    for name, (x0s, u0, kw) in cases.items():
        args, lkw = held[name]
        outs = K._launch(*args, group=8, **lkw)
        ms = time_cuda(torch, lambda: K._launch(*args, group=8, **lkw), 5)
        at = {**lkw, **full}
        full_ms = time_cuda(torch, lambda: K._launch(*args, group=8, **at), 3)
        inst = insts[name]
        lib = TC.library_name(inst, 8)
        secs = _build.BUILD_SECONDS.get(lib)
        report = _build.ptxas_report(lib)
        regs = [ln.strip() for ln in (report.read_text().splitlines() if report.exists() else [])
                if "registers" in ln or "spill" in ln]
        ops = lambda tr: sum(1 for n in tr.nodes if n.op not in ("x", "u", "p"))
        trace_ops = (ops(TC.trace(kw["ode_rows"], kw["nx"], kw["nu"], kw.get("n_params", 0))),
                     ops(TC.trace(kw["extra_constraints"], kw["nx"], kw["nu"]))
                     if kw.get("extra_constraints") else 0)
        executed = kw["N"] * float(outs[5].sum())
        print(f"{name} ({lib}): launch alone {ms:.3f} ms at {USER_BATCH} lanes, budget "
              f"{USER_HOLD_BUDGET}, tile {K.DEFAULT_TILE}, group 8, mean executed "
              f"{outs[5].mean().item():.2f} ({full_ms:.3f} ms at budget {USER_BUDGET}); twin "
              f"{1e3 * twin_s[name]:.1f} ms on the same launch (timed once); nvcc "
              f"{'reused' if secs is None else f'{secs:.1f} s'}; ptxas {regs[-2:]} [{card}]; ",
              end="", flush=True)
        roof = bound(torch, generated_flops(K, trace_ops, kw, executed),
                     [*args, *(v for v in lkw.values() if torch.is_tensor(v)), *outs])
        entries.append({
            "name": f"tracker_tile_kernel<Problem<generated {name}>>", "route": "cuda",
            "source": "model_predictive_control_tpu_torch/csrc/ilqr_factory_ext.cu",
            "generated_by": "model_predictive_control_tpu_torch/ops/cuda/tracker_codegen.py",
            "replaces": "model_predictive_control_tpu/ops/pallas/ilqr_factory.py:204",
            "launches": launches[name], "max_abs_err": err[name], "ms": ms,
            "plain_ms": 1e3 * twin_s[name], "ms_default_budget": full_ms, "nvcc_s": secs,
            **roof,
        })
    return entries


# the CLI in process on the card: (arguments, gates on the summary it prints)
CLI_RUNS = {
    "session2": (["session2"], {"constraints_respected": True, "success_rate": (0.9, None)}),
    "sweep": (["sweep", "--batch", "512", "--steps", "10", "--backend", "factory"],
              {"success_rate": (0.8, None)}),
    "quadsweep": (["quadsweep", "--batch", "512", "--steps", "10"],
                  {"success_rate": (0.95, None)}),
    "tune": (["tune", "--updates", "4"], {"reduction": (1e-6, None)}),
    "estimate": (["estimate"], {"success_rate": (0.9, None), "est_rmse_pos": (None, 0.1)}),
}


def cli_phases(torch, card) -> None:
    """``cli.main([...])`` in process on the card for ``CLI_RUNS``: each
    exits 0 and its summary (the last line it prints) meets its gates."""
    import io

    from model_predictive_control_tpu_torch import cli

    phase(f"the CLI in process on the card: {', '.join(CLI_RUNS)}")
    for name, (argv, gates) in CLI_RUNS.items():
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        secs = time.perf_counter() - t0
        summary = json.loads(out.getvalue().strip().splitlines()[-1])
        short = {k: v for k, v in summary.items() if not isinstance(v, (list, dict))}
        print(f"cli {' '.join(argv)}: exit {rc} in {secs:.2f} s, {short} [{card}]", flush=True)
        if rc != 0:
            raise SystemExit(f"cli {name} exited {rc}")
        for key, want in gates.items():
            got = summary[key]
            if isinstance(want, tuple):
                lo, hi = want
                ok = (lo is None or got >= lo) and (hi is None or got <= hi)
            else:
                ok = got == want
            if not ok:
                raise SystemExit(f"cli {name}: {key} = {got}, gate {want}")


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



# the scale-out phases: the world-1 NCCL mesh, two ranks on one card, the
# weak-scaling ladder and the dry run
MESH_ROUNDS = 5  # timed rounds of each episode, plain and mesh in turns
TP_SCENARIOS = 256  # the tensor-parallel check at model 1, float64
TP_ITERS = 400
TOL_TP = 5e-8  # tests/test_tensor_parallel.py's bar
TWO_RANK_PARK = (2048, 10)  # parking sweep: global batch, steps
SCALING_GATES = {"non_performance": False, "success_rate": 0.99}


def same(torch, a, b) -> bool:
    """Bit for bit: equal shapes, dtypes and bytes (signed zeros and NaNs
    alike)."""
    raw = lambda t: t.contiguous().flatten().view(torch.uint8)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(raw(a), raw(b))


def same_result(torch, a, b) -> bool:
    """Two ``BatchSimResult``s bit for bit: states, inputs and every log."""
    return (same(torch, a.states, b.states) and same(torch, a.inputs, b.inputs)
            and a.logs.keys() == b.logs.keys()
            and all(same(torch, a.logs[k], b.logs[k]) for k in a.logs))


def two_rank_program(out_dir: str, device: str = "cuda") -> None:
    """One of two ranks on one card (gloo, CUDA tensors): the headline episode
    through the mesh policy (each rank 32,768 scenarios) and the parking
    sweep on a mesh, each with its launches counted; rank 0 then runs both
    unsharded and writes the comparison to ``out_dir/two_ranks.json``."""
    import torch
    import torch.distributed as dist

    import model_predictive_control_tpu_torch as port
    from model_predictive_control_tpu_torch.ops.cuda import admm_kernel as K
    from model_predictive_control_tpu_torch.ops.cuda import ilqr_kernel as KI
    from model_predictive_control_tpu_torch.parallel import make_mesh

    device = torch.device(device)
    mesh = make_mesh(2, device=device)
    _, _, _, episode = headline(torch, port, K, device)
    x0 = initial_states(torch, device)
    t0 = time.perf_counter()
    K.LAUNCHES = 0
    meshed = episode(x0, mesh=mesh)
    k1 = K.LAUNCHES
    KI.LAUNCHES = 0
    park, park_summary = port.parking_sweep(*TWO_RANK_PARK, mesh=mesh, device=device)
    k2 = KI.LAUNCHES
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, {"k1": k1, "k2": k2, "seconds": seconds})
    if dist.get_rank() == 0:
        plain = episode(x0)
        plain_park, plain_summary = port.parking_sweep(*TWO_RANK_PARK, device=device)
        with open(os.path.join(out_dir, "two_ranks.json"), "w") as f:
            json.dump({
                "ranks": counts,
                "k1_bit_for_bit": same_result(torch, meshed, plain),
                "k2_bit_for_bit": same_result(torch, park, plain_park),
                "k2_summary_equal": park_summary == plain_summary,
                "k1_success": meshed.logs["solver_success"].float().mean().item(),
                "k2_summary": park_summary,
            }, f)
    dist.barrier()


def scaleout_phases(torch, port, K, KI, card, device) -> None:
    """The scale-out layer on the card: the headline through
    ``batched_policy(mesh=)`` on a world-1 NCCL mesh, bit for bit with the
    unsharded episode, both walls timed; ``admm_solve_tp`` at model 1 against
    ``admm_solve`` at a fixed ρ; two spawned ranks sharing the card (gloo,
    CUDA tensors staged through the host for its collectives): K1 on 2 ×
    32,768 headline scenarios and K2's parking sweep on 2 × 1,024, each bit
    for bit with the unsharded launches (non-performance); ``podscale
    --scaling`` through ``cli.main`` at the card's count; the dry run at the
    card's count. Every path's launches are counted; any failure stops the
    script."""
    import io
    import tempfile

    import torch.distributed as dist

    from model_predictive_control_tpu_torch import cli
    from model_predictive_control_tpu_torch.parallel import admm_solve_tp, make_mesh
    from model_predictive_control_tpu_torch.parallel.dryrun import dryrun_multichip, run_ranks
    from model_predictive_control_tpu_torch.solvers.qp import admm_solve

    phase(f"mesh: the headline ({BATCH} x {STEPS}) through batched_policy(mesh=) on a world-1 "
          "NCCL mesh, and admm_solve_tp at model 1")
    mesh = make_mesh(1, device=device)
    try:
        print(f"process group backend {dist.get_backend()}, mesh {mesh}", flush=True)
        _, _, _, episode = headline(torch, port, K, device)
        x0 = initial_states(torch, device)
        episode(x0), episode(x0, mesh=mesh)  # warm-up
        K.LAUNCHES = 0
        meshed = episode(x0, mesh=mesh)
        torch.cuda.synchronize()
        launches = K.LAUNCHES
        plain = episode(x0)
        equal = same_result(torch, meshed, plain)
        print(f"mesh episode: {launches} ADMM kernel launches (expected {STEPS + 1}); states, "
              f"inputs and logs {'bit for bit' if equal else 'DIFFER'} against the unsharded "
              f"episode; success {meshed.logs['solver_success'].float().mean().item():.5f}",
              flush=True)
        if launches != STEPS + 1 or not equal:
            raise SystemExit("the mesh headline is not the unsharded episode")
        del meshed, plain
        walls = {"plain": [], "mesh": []}
        for _ in range(MESH_ROUNDS):
            for name in ("plain", "mesh", "mesh", "plain"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                episode(x0, mesh=mesh if name == "mesh" else None)
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t0)
        best = {k: min(v) for k, v in walls.items()}
        print(f"headline wall, best of {2 * MESH_ROUNDS} in turns (plain, mesh, mesh, plain): "
              f"unsharded {best['plain']:.4f} s, world-1 mesh {best['mesh']:.4f} s "
              f"({100.0 * (best['mesh'] / best['plain'] - 1.0):+.2f}%); all: "
              f"{json.dumps({k: [round(t, 4) for t in v] for k, v in walls.items()})} [{card}]",
              flush=True)

        ctrl64 = port.make_linear_mpc(port.session2_problem(N=HORIZON), iters=ADMM_ITERS,
                                      dtype=torch.float64, device=device)
        q, l, u = ctrl64.qp.qp_vectors(x0[:TP_SCENARIOS].double())
        tp = admm_solve_tp(ctrl64.op, q, l, u, mesh=mesh, iters=TP_ITERS)
        ref = admm_solve(ctrl64.op, q, l, u, iters=TP_ITERS, adapt_chunks=1)
        err = (tp.x - ref.x).abs().max().item()
        conv_equal = torch.equal(tp.converged, ref.converged)
        print(f"admm_solve_tp (model 1, NCCL, {TP_ITERS} iterations, float64, "
              f"{TP_SCENARIOS} scenarios) vs admm_solve at fixed rho: max|dx| {err:.3e} "
              f"(tol {TOL_TP:.0e}), converged masks {'equal' if conv_equal else 'DIFFER'} "
              f"({tp.converged.float().mean().item():.4f})", flush=True)
        if not err <= TOL_TP or not conv_equal:
            raise SystemExit("admm_solve_tp disagrees with admm_solve")
    finally:
        dist.destroy_process_group()

    phase("two ranks on one card (gloo, CUDA tensors; non-performance)")
    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(two_rank_program, 2, args=(tmp, device.type), device=device, backend="gloo",
                  timeout_s=300)
        with open(os.path.join(tmp, "two_ranks.json")) as f:
            report = json.load(f)
    print(f"two ranks: {json.dumps(report)} [{card}]", flush=True)
    want = [{"k1": STEPS + 1, "k2": TWO_RANK_PARK[1]}] * 2
    got = [{k: r[k] for k in ("k1", "k2")} for r in report["ranks"]]
    if got != want or not (report["k1_bit_for_bit"] and report["k2_bit_for_bit"]
                           and report["k2_summary_equal"]):
        raise SystemExit(f"two ranks on one card: launches {got} (expected {want}) or results "
                         "differ from the unsharded launches")

    phase(f"podscale --scaling through cli.main at the card's count "
          f"({torch.cuda.device_count()})")
    out = io.StringIO()
    K.LAUNCHES = 0
    with contextlib.redirect_stdout(out):
        rc = cli.main(["podscale", "--scaling"])
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"cli podscale --scaling: exit {rc}, {K.LAUNCHES} ADMM kernel launches, "
          f"{json.dumps(report)} [{card}]", flush=True)
    point = report["points"][0]
    if (rc != 0 or K.LAUNCHES == 0 or dist.is_initialized()
            or report["non_performance"] != SCALING_GATES["non_performance"]
            or point["success_rate"] < SCALING_GATES["success_rate"]):
        raise SystemExit(f"podscale --scaling failed its gates {SCALING_GATES}")

    phase(f"dryrun_multichip at the card's count ({torch.cuda.device_count()}, NCCL)")
    dryrun_multichip(torch.cuda.device_count(), device=device)


# ---------------------------------------------------------------------------
# the float64 oracle tier: the card's solutions held to an independent truth
# ---------------------------------------------------------------------------

ORACLE_SAMPLE = 256  # headline scenarios held to the native oracle, drawn by seed
ORACLE_SEED = 0
ORACLE_LH_STARTS = 32  # starts of the condensed hard box at N=100
ORACLE_ITERS = 20000  # the native ADMM's budget (it stops at its tolerance); its polish finishes
ORACLE_THREADS = 8  # native solves split over host threads (ctypes frees the GIL)
TOL_ORACLE_KKT_REL = 1e-6  # the oracle's own KKT residual over 1 + |q|, where it is the truth
F32_UNIT = 2.0 ** -24  # float32's unit roundoff
K1_EPS = 1e-4  # the ADMM kernel's eps_abs (prepare_tiles: None means 1e-4)
K4_TOL = 1e-4  # the stagewise kernel's feasibility and mu tolerance, times its scale
TOL_DARE_REL = 1e-9  # float64 DARE on the card against LAPACK (tests/test_torch_lqr.py)


def oracle_libraries() -> list:
    """``(name, build)`` of the two native oracle libraries (g++)."""
    from model_predictive_control_tpu_torch.oracle import _native_build as NB

    return [(f"lib{s}", lambda s=s, srcs=srcs: NB.build_native_lib(f"lib{s}.so", srcs))
            for s, srcs in (("qp_oracle", ("qp_oracle.cpp",)),
                            ("nlp_oracle", ("nlp_oracle.cpp", "qp_oracle.cpp")))]


def cpu_model() -> str:
    """The host CPU's model name from ``/proc/cpuinfo``, or its vendor,
    family, model and clock where the name is not given, for labelling CPU
    times."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    name = fields.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"{fields.get('vendor_id', '?')} family {fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')} at {fields.get('cpu MHz', '?')} MHz (no model name)")


def gamma(k: int) -> float:
    """The float32 rounding bound of a k-term dot product, k·u / (1 − k·u)."""
    return k * F32_UNIT / (1.0 - k * F32_UNIT)


def native_family(P, A, Q, L, U):
    """The native oracle on a family, its rows split over host threads:
    ``(X, Y, converged, kkt residual over 1 + |q|, CPU seconds per QP)``.
    ρ is the family's trace(P) / trace(AᵀA) and the tolerance relative to
    the largest |q|: the oracle's settings, not a bar."""
    import concurrent.futures
    import numpy as np
    from model_predictive_control_tpu_torch.oracle import (
        kkt_residual_native, solve_qp_family_native)

    rho = float(np.trace(P) / np.trace(A.T @ A))
    eps = 1e-9 * (1.0 + float(np.abs(Q).max()))

    def solve(rows):
        t0 = time.thread_time()
        out = solve_qp_family_native(P, A, Q[rows], L[rows], U[rows], rho=rho,
                                     iters=ORACLE_ITERS, eps_abs=eps)
        return rows, out, time.thread_time() - t0

    chunks = np.array_split(np.arange(Q.shape[0]), min(ORACLE_THREADS, Q.shape[0]))
    X, Y = np.empty_like(Q), np.empty((Q.shape[0], A.shape[0]))
    conv = np.empty(Q.shape[0], dtype=bool)
    cpu = 0.0
    with concurrent.futures.ThreadPoolExecutor(len(chunks)) as pool:
        for rows, (x, y, c), sec in pool.map(solve, chunks):
            X[rows], Y[rows], conv[rows] = x, y, c
            cpu += sec
    kkt = np.array([kkt_residual_native(P, Q[i], A, L[i], U[i], X[i], Y[i])
                    for i in range(Q.shape[0])]) / (1.0 + np.abs(Q).max(axis=1))
    return X, Y, conv, kkt, cpu / Q.shape[0]


def k1_bars(P, A, q, l, u, x, y):
    """Each scenario's bar on the native KKT residual of the kernel's
    unscaled ``(x, y)``: the kernel's stopping rule, ``K1_EPS·(1 + |q|∞)`` on
    its unscaled primal and dual residuals (the scaled residuals times E⁻¹
    and (c·D)⁻¹ against ``eps·(1 + max|q_s·(c·D)⁻¹|)``), plus the float32
    rounding of evaluating them (γ over the n + m + 3 terms of a row, the
    unscaling included) on the magnitudes |P||x| + |q| + |Aᵀ||y|,
    |A||x| and the finite bounds."""
    import numpy as np

    stat = (np.abs(x) @ np.abs(P).T + np.abs(q) + np.abs(y) @ np.abs(A)).max(axis=1)
    prim = (np.abs(x) @ np.abs(A).T).max(axis=1) + finite_magnitude(l, u)
    return K1_EPS * (1.0 + np.abs(q).max(axis=1)) + gamma(P.shape[0] + A.shape[0] + 3) * (stat + prim)


def finite_magnitude(l, u):
    """Each row's largest finite bound magnitude."""
    import numpy as np

    fin = lambda v: np.where(np.isfinite(v), np.abs(v), 0.0)
    return np.maximum(fin(l), fin(u)).max(axis=1)


def f64(torch, t):
    return t.detach().to("cpu", torch.float64).numpy()


def hold_k1(torch, name, op, q, l, u, sol, rows, card):
    """The kernel's unscaled solutions on ``rows`` held to the native oracle:
    for each scenario the kernel reports converged, the oracle's KKT
    residual of its ``(x, y)`` within :func:`k1_bars`. Prints the objective
    gap and the distance to the oracle's solution, the oracle's converged
    share and its CPU seconds per QP. Returns the oracle's solutions."""
    import numpy as np
    from model_predictive_control_tpu_torch.oracle import kkt_residual_native

    P, A = f64(torch, op.P), f64(torch, op.A_c)
    q, l, u, x, y = (f64(torch, v[rows]) for v in (q, l, u, sol.x, sol.y))
    conv = sol.converged[rows].cpu().numpy()
    X, _, oconv, okkt, cpu_s = native_family(P, A, q, l, u)
    kkt = np.array([kkt_residual_native(P, q[i], A, l[i], u[i], x[i], y[i])
                    for i in range(len(rows))])
    bars = k1_bars(P, A, q, l, u, x, y)
    obj = lambda z: 0.5 * np.einsum("bi,ij,bj->b", z, P, z) + (q * z).sum(axis=1)
    gap = (obj(x) - obj(X)) / np.maximum(1.0, np.abs(obj(X)))
    print(f"{name}: {len(rows)} scenarios, the kernel converged on {conv.mean():.5f}; native "
          f"oracle: converged {oconv.mean():.5f}, its own KKT residual over 1 + |q| max "
          f"{okkt.max():.3e} (tol {TOL_ORACLE_KKT_REL:.0e}), CPU {cpu_s * 1e3:.3f} ms per QP "
          f"(a CPU time, one core: {cpu_model()}); the kernel's KKT residual over its bar max "
          f"{(kkt[conv] / bars[conv]).max() if conv.any() else float('nan'):.4f} (gate <= 1; "
          f"residual max {kkt[conv].max() if conv.any() else float('nan'):.4e}, bar min "
          f"{bars.min():.4e}); objective gap to the oracle over max(1, |f|) max {gap.max():.3e}, "
          f"min {gap.min():.3e}; max|x - x_oracle| {np.abs(x - X).max():.4e} [{card}]", flush=True)
    if not conv.any():
        raise SystemExit(f"{name}: no scenario converged, nothing to certify")
    if not (okkt <= TOL_ORACLE_KKT_REL).all():
        raise SystemExit(f"{name}: the oracle did not certify its own solutions")
    if not (kkt[conv] <= bars[conv]).all():
        raise SystemExit(f"{name}: a converged solution fails the oracle's KKT certificate")
    return X


def first_warm_solve(LM, run) -> tuple:
    """``(op, q, l, u, sol)`` of the second solve through the tiled backend
    while ``run()`` runs: a closed loop's first warm launch (its presolve
    is the first)."""
    seen = []
    tiled = LM._TILED["cuda"]

    def spy(op, q, l, u, *args, **kw):
        sol = tiled(op, q, l, u, *args, **kw)
        seen.append((op, q, l, u, sol))
        return sol

    LM._TILED["cuda"] = spy
    try:
        run()
    finally:
        LM._TILED["cuda"] = tiled
    return seen[1]


def oracle_phases(torch, port, K, KR, card, device, batch=BATCH) -> None:
    """The card's answers against the float64 oracle tier (``oracle/``):
    the headline's first warm launch on ``ORACLE_SAMPLE`` scenarios drawn
    across its sorted batch; the condensed hard box at N=100 (n + m = 400)
    on ``ORACLE_LH_STARTS`` starts, through K1's panel mode (the loop's first
    warm launch) and K4 (the stagewise loop's first solve), both held to the
    oracle's solution of the condensed QP; the DARE by SDA on the card
    against LAPACK. Every bar is fixed before the run (PERF.md)."""
    import numpy as np
    from model_predictive_control_tpu_torch.experiments.session1 import session1_weights
    from model_predictive_control_tpu_torch.oracle import dare_np
    from model_predictive_control_tpu_torch.solvers import linear_mpc as LM
    from model_predictive_control_tpu_torch.solvers.riccati_ip import bound_scale, cost_normalizer

    phase(f"oracle: the card's solutions against the native float64 oracle "
          f"({ORACLE_SAMPLE} headline scenarios, {ORACLE_LH_STARTS} condensed N={PANEL_LH_N} "
          f"starts through K1's panel mode and K4, the DARE)")
    problem, ctrl, _, episode = headline(torch, port, K, device)
    x0 = initial_states(torch, device, batch)
    op, q, l, u, sol = first_warm_solve(LM, lambda: episode(x0, steps=1))
    rows = np.sort(np.random.default_rng(ORACLE_SEED).choice(batch, min(ORACLE_SAMPLE, batch),
                                                             replace=False))
    hold_k1(torch, f"headline first warm launch (tile {K.DEFAULT_TILE}, n={ctrl.qp.n}, "
            f"m={ctrl.qp.m})", op, q, l, u, sol, rows, card)

    lh = port.session2_problem(N=PANEL_LH_N)
    cctrl = port.make_linear_mpc(lh, solver="admm", device=device)
    system = lh.system(torch.float32, device)
    xs = initial_states(torch, device, ORACLE_LH_STARTS)

    def condensed():
        carry = cctrl.presolve_batch_carry(xs, tile=K.DEFAULT_TILE)
        port.simulate_batch(xs, system, 1, cctrl.batched_policy(tile=K.DEFAULT_TILE), carry,
                            batched_dynamics=True)

    K.LAUNCHES_BY_LIBRARY.clear()
    op, q, l, u, sol = first_warm_solve(LM, condensed)
    lib = K.library_name(K.columns(cctrl.qp.n, cctrl.qp.m, 32), 32)
    if K.LAUNCHES_BY_LIBRARY.get(lib, 0) != 2:
        raise SystemExit(f"the condensed N={PANEL_LH_N} solves did not go through {lib}: "
                         f"{dict(K.LAUNCHES_BY_LIBRARY)}")
    rows = np.arange(ORACLE_LH_STARTS)
    X = hold_k1(torch, f"condensed N={PANEL_LH_N} first warm launch ({lib}, n={cctrl.qp.n}, "
                f"m={cctrl.qp.m})", op, q, l, u, sol, rows, card)

    # K4 on the same QPs: the stagewise loop's first solve from the same starts
    sctrl = port.make_stagewise_mpc(port.session2_problem(), N=PANEL_LH_N, iters=LH_ITERS,
                                    device=device)
    names = ("A", "B", "Q", "R", "Pf", "x_lb", "x_ub", "u_lb", "u_ub")
    data = [getattr(sctrl, k).cpu().numpy() for k in names]
    KR.LAUNCHES = 0
    k4 = KR.stagewise_ip_solve_cuda(*data, xs, sctrl.initial_batch_carry(ORACLE_LH_STARTS,
                                                                           device=device),
                                    N=PANEL_LH_N, iters=LH_ITERS)
    if KR.LAUNCHES != 1:
        raise SystemExit("K4's solve did not launch its kernel")
    A_np, B_np, Q_np, R_np, Pf_np, xlb, xub, ulb, uub = (np.asarray(v, np.float64) for v in data)
    w_x, w_u = bound_scale(xlb, xub, xp=np), bound_scale(ulb, uub, xp=np)
    c_cost = cost_normalizer(Q_np * np.outer(w_x, w_x), R_np * np.outer(w_u, w_u),
                             Pf_np * np.outer(w_x, w_x), xp=np)
    n_fin = PANEL_LH_N * int(sum(np.isfinite(v).sum() for v in (xlb, xub, ulb, uub)))
    P, A = f64(torch, op.P), f64(torch, op.A_c)
    qv, lv, uv = (f64(torch, v) for v in (q, l, u))
    us = f64(torch, k4.us)  # (B, N, nu): the condensed decision, stage-major
    k4_scale = 1.0 + np.maximum(np.abs(us / w_u).max(axis=(1, 2)),
                                np.abs(f64(torch, k4.xs) / w_x).max(axis=(1, 2)))
    us = us.reshape(ORACLE_LH_STARTS, -1)
    ok = k4.success.cpu().numpy()
    Au = us @ A.T
    viol = np.maximum(lv - Au, Au - uv).max(axis=1).clip(min=0.0)
    # feasibility: the scaled violation below K4_TOL·scale, times the
    # variable scalings, plus float32's rollout (γ over 2N + 2 terms of
    # |A_c||u| and the bounds, which hold the shifted x0)
    vbar = (K4_TOL * k4_scale * max(w_x.max(), w_u.max())
            + gamma(2 * PANEL_LH_N + 2) * ((np.abs(us) @ np.abs(A).T).max(axis=1)
                                           + finite_magnitude(lv, uv)))
    # optimality: the interior point's duality gap, n_fin·μ with μ below
    # K4_TOL·scale in its scaled cost, over its cost scaling c, doubled (the
    # condensed objective is twice the stagewise one)
    obj = lambda z: 0.5 * np.einsum("bi,ij,bj->b", z, P, z) + (qv * z).sum(axis=1)
    gap = obj(us) - obj(X)
    gbar = 2.0 * n_fin * K4_TOL * k4_scale / c_cost
    print(f"K4 stagewise solve (N={PANEL_LH_N}, {LH_ITERS} iterations, {ORACLE_LH_STARTS} starts): "
          f"success {ok.mean():.5f}; bound violation over its bar max "
          f"{(viol[ok] / vbar[ok]).max() if ok.any() else float('nan'):.4f} (gate <= 1; max "
          f"{viol.max():.4e}); objective gap to the oracle over its bar max "
          f"{(gap[ok] / gbar[ok]).max() if ok.any() else float('nan'):.4e} (gate <= 1; gap max "
          f"{gap.max():.4e}, relative {(gap / np.abs(obj(X))).max():.3e}); max|u - u_oracle| "
          f"{np.abs(us - X).max():.4e}; K4 against K1's panel mode max|u_K4 - u_K1| "
          f"{np.abs(us - f64(torch, sol.x)).max():.4e} [{card}]", flush=True)
    if not ok.any():
        raise SystemExit("K4 solved none of the starts")
    if not ((viol[ok] <= vbar[ok]).all() and (gap[ok] <= gbar[ok]).all()):
        raise SystemExit("a successful K4 solution fails the oracle's certificate")

    sys64 = port.double_integrator_discrete(0.5, dtype=torch.float64, device=device)
    Qw, Rw = session1_weights(torch.float64, device)
    P_card = f64(torch, port.dare_sda(sys64.A, sys64.B, Qw, Rw))
    P_ref = dare_np(sys64.A, sys64.B, Qw, Rw)
    err = np.abs(P_card - P_ref).max() / np.abs(P_ref).max()
    sys32 = port.double_integrator_discrete(0.5, device=device)
    err32 = (np.abs(f64(torch, port.dare_sda(sys32.A, sys32.B, *session1_weights(device=device)))
                    - P_ref).max() / np.abs(P_ref).max())
    print(f"DARE (session 1, Ts = 0.5): SDA on the card in float64 against LAPACK, max relative "
          f"difference {err:.3e} (tol {TOL_DARE_REL:.0e}); in float32 {err32:.3e} "
          f"(informational) [{card}]", flush=True)
    if not err <= TOL_DARE_REL:
        raise SystemExit("the card's DARE disagrees with LAPACK")


if __name__ == "__main__":
    sys.exit(main())
