"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the three hand-written kernel libraries from
``model_predictive_control_tpu_torch/csrc`` with nvcc (in parallel), then for
each of the port's paths checks the path's kernel against its plain-PyTorch
twin on the card at the path's shapes, drives the path through the port's
public entry points, checks that every solve of that run launched the
kernel, and times it:

- the headline closed loop (session-2 linear MPC, N=20, 65,536 scenarios ×
  50 steps) on the fused ADMM kernel;
- the nonlinear obstacle-parking sweep (N=30, 2,048 scenarios × 50 steps)
  on the fused AL-iLQR kernel;
- the kinematic and the Pacejka lap-tracking sweeps (N=15, 2,048 scenarios
  × 50 steps each) on the two instantiations of the fused tracker kernel.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and exits non-zero without one, or when any phase
fails. The last line of its output is one JSON object
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
SUCCESS_FLOOR = 0.99  # this script's gate
CONTRACT_SUCCESS = 0.999  # BENCH_CONTRACT.json headline floor_success_rate
TWIN_SCENARIOS = 512

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
PARK_TWIN_STEPS = 3
PARK_WIDE_BATCH = 16384  # informational point: how the card fills
# AL-iLQR kernel vs twin on the card. Both are float32 with the same
# operations in the same order (the kernel is built without FMA
# contraction), so they should agree bit for bit; the gates leave room for
# a transcendental function rounding one ulp apart, which the chaotic
# 90-iteration solve at N=30 amplifies on a few lanes. 5e-3 on controls is
# the JAX package's own gate between two float32 implementations of this
# OCP (tests/test_pallas_ilqr.py:86).
TOL_PARK_AGREE = 0.99  # converged masks, executed inner iterations
TOL_PARK_U_Q999 = 5e-3  # q999 of max|Δu| over lanes converged on both sides
TOL_PARK_STATES = 5e-2  # tests/test_pallas_ilqr.py:117

# racing sweeps (BENCH_CONTRACT.json "racing_sweep" / "racing_sweep_dynamic":
# batch, steps and the quality floors; the solves/s there were taken on a TPU)
RACE_BATCH = 2048
RACE_STEPS = 50
RACE_N = 15
RACE_SUCCESS_FLOOR = 0.99
RACE_TWIN_SCENARIOS = 64
RACE_TWIN_STEPS = 3
# tracker kernel vs twin on the card: the same float program (no FMA
# contraction), so bit for bit is expected; the gates are K2's.
TOL_RACE_AGREE = 0.99  # converged masks, executed inner iterations
TOL_RACE_U_Q999 = 5e-3  # q999 of max|Δu| over lanes converged on both sides
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


def initial_states(torch, device):
    import numpy as np

    rng = np.random.default_rng(0)
    p = rng.uniform(-140.0, -20.0, BATCH)
    v = rng.uniform(-15.0, 24.0, BATCH)
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


def compare(torch, name, got, ref):
    """Print and gate kernel against twin; returns max|Δx| over the rows
    whose percentile is gated."""
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
    gate_x = name != "polished"
    print(
        f"{name}: max|x_kernel - x_twin| on rows converged on both sides after "
        f"the same iterations: q999 {err_q999:.3e}"
        f"{f' (tol {TOL_X_Q999:.0e})' if gate_x else ' (not gated)'}, max "
        f"{err_max:.3e}; over all rows max {row_err.max().item():.3e}; converged agree {conv_agree:.5f} "
        f"(tol {TOL_CONV_AGREE[name]}); converged {rate_k:.5f} vs twin {rate_t:.5f}; "
        f"executed iterations agree {ni_agree:.5f} (tol {TOL_NI_AGREE}); mean "
        f"executed {ni_k.mean().item():.2f} vs twin {ni_t.mean().item():.2f}",
        flush=True,
    )
    ok = conv_agree >= TOL_CONV_AGREE[name] and ni_agree >= TOL_NI_AGREE
    ok = ok and (err_q999 <= TOL_X_Q999 if gate_x else abs(rate_k - rate_t) <= TOL_CONV_RATE)
    if not ok:
        raise SystemExit(f"kernel disagrees with its twin on the {name} config")
    return err_max if gate_x else 0.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import model_predictive_control_tpu_torch as port
    from model_predictive_control_tpu_torch.ops.cuda import admm_kernel as K
    from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as KF
    from model_predictive_control_tpu_torch.ops.cuda import ilqr_kernel as KI

    device = torch.device("cuda")
    card = smi()

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
    build_all([K, KI, KF])

    admm = admm_phases(torch, port, K, card, device)
    ilqr = ilqr_phases(torch, port, KI, card, device)
    racing = [racing_phases(torch, port, KF, tier, card, device) for tier in RACE_TIERS]
    phase(None)

    print(json.dumps({"kernels": [admm, ilqr, *racing]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def build_all(modules) -> None:
    """Build every kernel's library at once (one nvcc per source), then
    print each build's seconds and ptxas's register and spill lines."""
    from model_predictive_control_tpu_torch.ops.cuda._build import ptxas_report

    seconds, errors = {}, {}

    def build(mod):
        t0 = time.perf_counter()
        try:
            mod._build_library()
        except Exception as exc:  # reported below, for every library
            errors[mod.LIBRARY] = exc
        seconds[mod.LIBRARY] = time.perf_counter() - t0

    threads = [threading.Thread(target=build, args=(m,)) for m in modules]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for mod in modules:
        name = mod.LIBRARY
        print(f"built {name}.cu in {seconds[name]:.1f} s", flush=True)
        report = ptxas_report(name)
        if name not in errors and report.exists():
            for line in report.read_text().splitlines():
                if "Compiling" in line or "registers" in line or "spill" in line:
                    print(f"ptxas {name}:", line.strip())
    if errors:
        raise SystemExit(f"kernel build failed: {errors}")


def admm_phases(torch, port, K, card, device) -> dict:
    """The linear path: ADMM kernel vs twin, the headline closed loop, its
    timing. Returns the kernel's entry of the ``kernels`` line."""
    problem = port.session2_problem(N=HORIZON)
    ctrl = port.make_linear_mpc(
        problem, iters=ADMM_ITERS, rho=RHO, dtype=torch.float32, device=device
    )
    system = problem.system(torch.float32, device)
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
    print(f"warm kernel alone {kernel_ms:.3f} ms per launch, twin alone {twin_ms:.3f} ms "
          f"[{card}]", flush=True)

    phase(f"linear main path: {BATCH} scenarios x {STEPS} steps, tile {K.DEFAULT_TILE}")
    x0_all = initial_states(torch, device)

    def episode(x0, backend="cuda"):
        x0 = x0[torch.argsort(port.boundary_compaction_key(problem.p_max, x0), stable=True)]
        carry = ctrl.presolve_batch_carry(
            x0, iters_mult=PRESOLVE_MULT, backend=backend, tile=K.DEFAULT_TILE
        )
        policy = ctrl.batched_policy(
            backend=backend, tile=K.DEFAULT_TILE, max_rho_moves=0, polish=False,
            probe_iters=PROBE_ITERS,
        )
        return port.simulate_batch(x0, system, STEPS, policy, carry)

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
    print(f"success rate {success:.5f} (gate {SUCCESS_FLOOR}; contract floor "
          f"{CONTRACT_SUCCESS}: {'met' if success >= CONTRACT_SUCCESS else 'NOT met'})")
    if success < SUCCESS_FLOOR:
        raise SystemExit("success rate below the gate")
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
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = episode(x0_all)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    del out
    print(f"episode wall {dt:.4f} s (best of 3: {', '.join(f'{t:.4f}' for t in times)}); "
          f"{BATCH * STEPS / dt:.1f} solves/s; step {1e3 * dt / STEPS:.3f} ms [{card}]",
          flush=True)

    return {
        "name": "admm_tile_kernel",
        "route": "cuda",
        "source": "model_predictive_control_tpu_torch/csrc/admm_kernel.cu",
        "replaces": "model_predictive_control_tpu/ops/pallas/admm_kernel.py:82",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
    }


def parking_scenarios(torch, port, batch, device):
    """The sweep's scenarios: plant parameters, then initial states, from
    one generator seeded 0 (what ``parking_sweep`` draws by default)."""
    from model_predictive_control_tpu_torch.parallel import batch as PB

    g = torch.Generator().manual_seed(0)
    plant = PB.perturb_parameters(g, port.VehicleParameters(), batch, device=device)
    x0 = PB.random_initial_states(g, batch, x_obs=PARK_OBSTACLE, device=device)
    return plant, x0


def compare_ilqr(torch, name, got, ref, twin_s, card) -> float:
    """Print and gate the AL-iLQR kernel against its twin; returns the max
    of max|Δu| over lanes converged on both sides."""
    conv_agree = (got.converged == ref.converged).float().mean().item()
    ni_agree = (got.inner_iters_executed == ref.inner_iters_executed).float().mean().item()
    du = (got.us - ref.us).abs().amax(dim=(1, 2))
    both = got.converged & ref.converged
    err = du[both]
    err_max = err.max().item() if err.numel() else 0.0
    err_q999 = torch.quantile(err, 0.999).item() if err.numel() else 0.0
    print(
        f"{name}: max|u_kernel - u_twin| over lanes converged on both sides: q999 "
        f"{err_q999:.3e} (tol {TOL_PARK_U_Q999:.0e}), max {err_max:.3e}; over all lanes "
        f"max {du.max().item():.3e}, bitwise-equal lanes {(du == 0).float().mean().item():.5f}; "
        f"converged agree {conv_agree:.5f}, executed inner iterations agree {ni_agree:.5f} "
        f"(tol {TOL_PARK_AGREE}); converged {got.converged.float().mean().item():.5f} vs twin "
        f"{ref.converged.float().mean().item():.5f}; mean inner iterations "
        f"{got.inner_iters_executed.mean().item():.2f}; twin {1e3 * twin_s:.1f} ms per solve "
        f"(timed once) [{card}]",
        flush=True,
    )
    ok = conv_agree >= TOL_PARK_AGREE and ni_agree >= TOL_PARK_AGREE
    if not (ok and err_q999 <= TOL_PARK_U_Q999):
        raise SystemExit(f"AL-iLQR kernel disagrees with its twin on the {name} config")
    return err_max


def ilqr_phases(torch, port, K, card, device) -> dict:
    """The parking path: AL-iLQR kernel vs twin (cold and warm), the sweep
    through ``parking_sweep``, its timing. Returns the kernel's entry of the
    ``kernels`` line."""
    from model_predictive_control_tpu_torch.parallel import batch as PB
    from model_predictive_control_tpu_torch.solvers.parking import Q_MAIN, QN_SCALE_MAIN, R_MAIN

    B, N, tile = PARK_BATCH, PARK_N, K.DEFAULT_TILE
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

    phase(f"AL-iLQR kernel vs twin on the card (B={B}, N={N}, nc={nc}, tile={tile})")

    def both(name, *args, **extra):
        got = K.al_ilqr_solve_cuda(*args, **extra, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = K.al_ilqr_solve_twin(*args, **extra, **kw)
        torch.cuda.synchronize()
        return got, compare_ilqr(torch, name, got, ref, time.perf_counter() - t0, card)

    cold, err = both("cold", x0, torch.zeros(B, N, 2, device=device), acc, fric)
    # the warm config as the policy makes it: one plant step with u0, the
    # shifted controls and the shifted, decayed multipliers
    x1 = port.batched_plant(plant_params, PARK_TS)(x0, cold.us[:, 0])
    u1 = torch.cat([cold.us[:, 1:], cold.us[:, -1:]], dim=1)
    lam1 = 0.7 * torch.where(
        cold.converged[:, None, None], torch.cat([cold.lam[:, 1:], cold.lam[:, -1:]], dim=1), 0.0
    )
    _, err_w = both("warm", x1, u1, acc, fric, lam_init=lam1)
    err = max(err, err_w)

    wrapper_ms = time_cuda(torch, lambda: K.al_ilqr_solve_cuda(x1, u1, acc, fric, lam_init=lam1, **kw), 5)
    args = K.prepare_tiles(x1, u1, acc, fric, lam1, N=N, tile=tile, n_circles=3)
    raw = dict(N=N, n_circ=3, tile=tile, ts=PARK_TS, geom=geom, limits=limits,
               weights=kw["weights"], outer_iters=6, inner_iters=15, mu_init=10.0,
               mu_scale=10.0, mu_max=1e8, viol_tol=1e-4, tol=1e-6)
    kernel_ms = time_cuda(torch, lambda: K._launch(*args, **raw), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    K.al_ilqr_tiles_reference(*args, **raw)
    torch.cuda.synchronize()
    twin_ms = 1e3 * (time.perf_counter() - t0)
    print(f"warm: wrapper {wrapper_ms:.3f} ms per solve of {B}, kernel alone {kernel_ms:.3f} ms "
          f"per launch, twin alone {twin_ms:.1f} ms (timed once) [{card}]", flush=True)

    phase(f"parking main path: parking_sweep({B}, {PARK_STEPS}), N={N}, tile {tile}")
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
                                  pol, pol.initial_carry(S, device))
        finals[backend] = out.states[-1]
    d_final = (finals["cuda"] - finals["twin"]).abs().max().item()
    print(f"first {S} scenarios over {PARK_TWIN_STEPS} steps, final states kernel vs twin "
          f"policy: {d_final:.3e} (tol {TOL_PARK_STATES})", flush=True)
    if not d_final <= TOL_PARK_STATES:
        raise SystemExit("the parking closed loop disagrees with the twin policy")

    phase("parking main path timing")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port.parking_sweep(B, PARK_STEPS, device=device)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    print(f"sweep wall {dt:.4f} s (best of 3: {', '.join(f'{t:.4f}' for t in times)}); "
          f"{B * PARK_STEPS / dt:.1f} solves/s; step {1e3 * dt / PARK_STEPS:.3f} ms; mean inner "
          f"iterations {summary['mean_inner_iters']:.2f} [{card}]", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, wide = port.parking_sweep(PARK_WIDE_BATCH, PARK_STEPS, device=device)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"informational, not gated: parking_sweep({PARK_WIDE_BATCH}, {PARK_STEPS}) wall "
          f"{dt:.4f} s, {PARK_WIDE_BATCH * PARK_STEPS / dt:.1f} solves/s, success "
          f"{wide['success_rate']:.5f}, mean inner iterations {wide['mean_inner_iters']:.2f} "
          f"[{card}]", flush=True)

    return {
        "name": "alilqr_tile_kernel",
        "route": "cuda",
        "source": "model_predictive_control_tpu_torch/csrc/ilqr_kernel.cu",
        "replaces": "model_predictive_control_tpu/ops/pallas/ilqr_kernel.py:70",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
    }


def compare_tracker(torch, name, got, ref, twin_s, card) -> float:
    """Print and gate the tracker kernel's policy step against the twin's on
    the same inputs; returns the max of max|Δu| over lanes converged on
    both sides. ``got``/``ref`` are a policy's (u0, warm carry, logs)."""
    def controls(step):  # the solved (B, N, 2) controls: u0, then the shifted rest
        u0, warm, _ = step
        return torch.cat([u0[:, None], warm.reshape(u0.shape[0], -1, 2)[:, :-1]], dim=1)

    conv_k, conv_t = got[2]["solver_success"], ref[2]["solver_success"]
    ni_k, ni_t = got[2]["kernel_inner_iters"], ref[2]["kernel_inner_iters"]
    du = (controls(got) - controls(ref)).abs().amax(dim=(1, 2))
    conv_agree = (conv_k == conv_t).float().mean().item()
    ni_agree = (ni_k == ni_t).float().mean().item()
    err = du[conv_k & conv_t]
    err_max = err.max().item() if err.numel() else 0.0
    err_q999 = torch.quantile(err, 0.999).item() if err.numel() else 0.0
    print(
        f"{name}: max|u_kernel - u_twin| over lanes converged on both sides: q999 "
        f"{err_q999:.3e} (tol {TOL_RACE_U_Q999:.0e}), max {err_max:.3e}; over all lanes "
        f"max {du.max().item():.3e}, bitwise-equal lanes {(du == 0).float().mean().item():.5f}; "
        f"converged agree {conv_agree:.5f}, executed inner iterations agree {ni_agree:.5f} "
        f"(tol {TOL_RACE_AGREE}); converged {conv_k.float().mean().item():.5f} vs twin "
        f"{conv_t.float().mean().item():.5f}; mean inner iterations {ni_k.mean().item():.2f}; "
        f"twin {1e3 * twin_s:.1f} ms per solve (timed once) [{card}]",
        flush=True,
    )
    if not (conv_agree >= TOL_RACE_AGREE and ni_agree >= TOL_RACE_AGREE
            and err_q999 <= TOL_RACE_U_Q999):
        raise SystemExit(f"tracker kernel disagrees with its twin on the {name} config")
    return err_max


def racing_phases(torch, port, K, tier, card, device) -> dict:
    """One racing tier: the tracker kernel against its twin at the sweep's
    shapes (cold and warm policy steps), the sweep through its entry point
    with the contract's floors, a small kernel-vs-twin closed loop, and the
    timing. Returns the instantiation's entry of the ``kernels`` line."""
    from model_predictive_control_tpu_torch.experiments.racing import ellipse_reference
    from model_predictive_control_tpu_torch.parallel import batch as PB

    sweep_name, policy_name, err_ceiling, tol_states = RACE_TIERS[tier]
    sweep, make_policy = getattr(port, sweep_name), getattr(PB, policy_name)
    B, N, tile = RACE_BATCH, RACE_N, K.DEFAULT_TILE
    dynamic = tier == "pacejka"
    ref = ellipse_reference(RACE_STEPS + N + 1, speed=1.2 if dynamic else 0.35,
                            dynamic=dynamic, device=device)
    # the sweep's own start states (one solve, before the counted run)
    x0 = sweep(B, 1, device=device)[0].states[0]
    pol = {b: make_policy(ref, N=N, backend=b, tile=tile) for b in ("cuda", "twin")}
    plant = (PB.batched_dynamic_plant if dynamic else PB.batched_plant)(port.VehicleParameters(), 0.05)

    phase(f"tracker kernel vs twin on the card ({tier}: B={B}, N={N}, tile={tile})")
    launched = {}
    launch = K._launch

    def spy(*args, **kw):  # keep the last launch's operands for the timing
        launched.update(args=args, kw=kw)
        return launch(*args, **kw)

    def both(name, x, t, carry):
        K._launch = spy
        try:
            got = pol["cuda"](x, t, carry)
        finally:
            K._launch = launch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pol["twin"](x, t, carry)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        return got, compare_tracker(torch, name, got, want, twin_s, card), twin_s

    cold, err, _ = both("cold", x0, 0, pol["cuda"].initial_carry(B, device))
    # warm: one plant step with u0, then the shifted controls
    _, err_w, twin_s = both("warm", plant(x0, cold[0]), 1, cold[1])
    err = max(err, err_w)
    # the twin's time is its warm policy step above (the plain version of the
    # same launch, plus the wrapper's padding, which is negligible next to it)
    kernel_ms = time_cuda(torch, lambda: launch(*launched["args"], **launched["kw"]), 5)
    twin_ms = 1e3 * twin_s
    print(f"warm: kernel alone {kernel_ms:.3f} ms per launch, twin {twin_ms:.1f} ms per policy "
          f"step (timed once) [{card}]", flush=True)

    phase(f"racing main path ({tier}): {sweep_name}({B}, {RACE_STEPS}), N={N}, tile {tile}")
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
          f"iterations {summary['mean_inner_iters']:.2f} [{card}]", flush=True)

    return {
        "name": f"tracker_tile_kernel<{'PacejkaRows' if dynamic else 'KinematicRows'}>",
        "route": "cuda",
        "source": "model_predictive_control_tpu_torch/csrc/ilqr_factory.cu",
        "replaces": "model_predictive_control_tpu/ops/pallas/ilqr_factory.py:204",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
    }


if __name__ == "__main__":
    sys.exit(main())
