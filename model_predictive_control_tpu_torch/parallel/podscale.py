"""Weak scaling of the headline closed loop over ranks (port of
``parallel/podscale.py``).

:func:`weak_scaling` measures batched closed-loop MPC solves/s over a ladder
of data-axis meshes with a FIXED batch per rank: at each ``d`` the first
``d`` ranks form a mesh, every one of them builds the same global batch from
the same seed, takes its slice, runs the session-2 closed loop on it with
the fused ADMM kernel on its own device, and the final states and success
flags are gathered over the data axis. The wall of a point is the slowest
rank's, from a barrier to the end of the gather.

The prediction: the per-scenario solves are independent, so the loop holds
no collective between devices (only the final gather), and each device's
traffic is its own memory's (the ADMM kernel's ``4·(2(n + 2m) + (n + m))``
bytes a solve, ~2.2 KB at N=20, :mod:`..obs.roofline`). Weak-scaling
efficiency is then ~1.0 up to launch and host overheads. Where the ranks run
on the CPU, or several share one device, the numbers say nothing about
devices: the report says so (``non_performance``).
"""

from __future__ import annotations

import socket
import time

import torch
import torch.distributed as dist

from ..control.batch_loop import simulate_batch
from ..utils.device import resolve_device
from .mesh import DATA_AXIS, gather_rows, make_mesh, shard_rows


def headline_starts(batch: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``(batch, 2)`` session-2 starts from seed 0, drawn on the CPU: ``p``
    in [−140, −20], ``v`` in [−15, 24]."""
    g = torch.Generator().manual_seed(0)
    p = -140.0 + 120.0 * torch.rand(batch, generator=g, dtype=dtype)
    v = -15.0 + 39.0 * torch.rand(batch, generator=g, dtype=dtype)
    return torch.stack([p, v], dim=1).to(resolve_device(device))


def _shares_devices(device: torch.device) -> bool:
    """Whether two ranks of the world run on one device."""
    if device.type != "cuda":
        return True
    here = (socket.gethostname(), torch.cuda.current_device())
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, here)
    return len(set(seen)) < len(seen)


def weak_scaling(
    batch_per_device: int = 2048,
    steps: int = 20,
    horizon: int = 20,
    iters: int = 80,
    tile: int | None = None,
    devices: list | None = None,
    ladder: list[int] | None = None,
    dtype=torch.float32,
    device=None,
) -> dict:
    """Weak-scaling measurement: ``batch_per_device`` scenarios per rank, a
    mesh over the first ``d`` ranks for each ``d`` of ``ladder`` (powers of
    two up to the world size when ``None``). Every rank of the world calls
    it and gets the same report. Without a process group it runs on one rank
    (a world-1 group for the call). ``devices`` lists one device per rank of
    the world, in rank order (this rank runs on its entry); without it every
    rank runs on ``device`` (the card when ``None``)."""
    from ..ops.cuda.admm_kernel import DEFAULT_TILE
    from ..solvers.linear_mpc import make_linear_mpc, session2_problem

    owned = not dist.is_initialized()
    world = 1 if owned else dist.get_world_size()
    if devices is not None:
        if device is not None:
            raise ValueError("pass devices or device, not both")
        if len(devices) != world:
            raise ValueError(f"devices lists {len(devices)} devices for {world} ranks")
        device = devices[0 if owned else dist.get_rank()]
    device = resolve_device(device)
    if ladder is None:
        ladder = [1 << i for i in range(world.bit_length()) if 1 << i <= world]
    tile = min(tile or DEFAULT_TILE, batch_per_device)

    problem = session2_problem(N=horizon)
    ctrl = make_linear_mpc(problem, solver="admm", iters=iters, dtype=dtype, rho=0.035,
                           device=device)
    system = problem.system(dtype, device)
    policy = ctrl.batched_policy(tile=tile, max_rho_moves=0, polish=False, probe_iters=16)
    points, base_rate = [], None
    try:
        for d in ladder:
            mesh = make_mesh(d, device=device)
            B = batch_per_device * d
            times, success = [], 0.0
            if mesh.get_coordinate() is not None:
                x0s = shard_rows(mesh, headline_starts(B, dtype, device))

                def run():
                    res = simulate_batch(x0s, system, steps, policy,
                                         ctrl.initial_batch_carry(x0s.shape[0], dtype, device),
                                         batched_dynamics=True)
                    return (gather_rows(mesh, res.states[-1]),
                            gather_rows(mesh, res.logs["solver_success"], 1))

                run()  # warm-up: the kernel's build and first launch
                group = mesh.get_group(DATA_AXIS)
                for _ in range(2):
                    dist.barrier(group=group)
                    t0 = time.perf_counter()
                    _, ok = run()
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                    wall = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                                        device=device)
                    times.append(gather_rows(mesh, wall).max().item())  # the slowest rank's
                success = ok.float().mean().item()
            dist.barrier()
            dt = min(times) if times else 0.0
            rate = B * steps / dt if dt else 0.0
            if base_rate is None:
                base_rate = rate
            points.append({
                "devices": d,
                "batch": B,
                "solves_per_s": round(rate, 1),
                "per_chip_solves_per_s": round(rate / d, 1),
                "efficiency_vs_1": round(rate / (d * base_rate), 4) if base_rate else 0.0,
                "success_rate": round(success, 4),
                "wall_s": round(dt, 4),
            })
        # ranks outside a point's mesh learn its numbers from rank 0
        dist.broadcast_object_list(shared := [points], src=0)
        points = shared[0]
        non_performance = _shares_devices(device)
    finally:
        if owned:
            dist.destroy_process_group()

    return {
        "metric": "weak_scaling_closed_loop_mpc",
        "batch_per_device": batch_per_device,
        "steps": steps,
        "horizon": horizon,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "ranks": world,
        "non_performance": non_performance,
        "predicted_real_efficiency": 1.0,
        "prediction_basis": (
            "no collective between devices in the loop, only the final gather; per-solve "
            "traffic is ~2.2 KB of the device's own memory (obs/roofline.py byte model): "
            "see parallel/podscale.py"
        ),
        "points": points,
    }
