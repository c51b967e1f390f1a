"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the fused ADMM kernel from ``model_predictive_control_tpu_torch/csrc``
with nvcc, checks it against its plain-PyTorch twin on the card at the main
path's shapes, drives the headline closed loop (session-2 linear MPC, N=20,
65,536 scenarios × 50 steps) through the port's public entry points, checks
that every solve of that run launched the kernel, and times it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and exits non-zero without one, or when any phase
fails. The last line of its output is one JSON object
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


def phase(name: str) -> None:
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
    t0 = time.perf_counter()
    K._build_library()
    print(f"built admm_kernel.cu in {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = K._BUILD_DIR / "admm_kernel.ptxas.txt"
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip())

    problem = port.session2_problem(N=HORIZON)
    ctrl = port.make_linear_mpc(
        problem, iters=ADMM_ITERS, rho=RHO, dtype=torch.float32, device=device
    )
    system = problem.system(torch.float32, device)
    x0s = initial_states(torch, device)
    x0s = x0s[torch.argsort(port.boundary_compaction_key(problem.p_max, x0s), stable=True)]

    phase(f"kernel vs twin on the card (B={BATCH}, n={ctrl.qp.n}, m={ctrl.qp.m}, tile={K.DEFAULT_TILE})")
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

    phase(f"main path: {BATCH} scenarios x {STEPS} steps, tile {K.DEFAULT_TILE}")
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

    phase("timing")
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

    print(json.dumps({"kernels": [{
        "name": "admm_tile_kernel",
        "route": "cuda",
        "source": "model_predictive_control_tpu_torch/csrc/admm_kernel.cu",
        "replaces": "model_predictive_control_tpu/ops/pallas/admm_kernel.py:82",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
