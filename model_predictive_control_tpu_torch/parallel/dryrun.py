"""Multi-rank dry run of the scale-out layer, and the launcher of spawned
ranks.

:func:`dryrun_multichip` runs one mesh-sharded closed-loop MPC step on ``n``
ranks and prints one line, ``dryrun_multichip OK: ...``. The mesh is ``(n/2
× 2)`` where ``n`` is even, else ``(n × 1)``. Executed, not only built:

1. the closed-loop step with the QP solved by the tensor-parallel ADMM
   (:func:`.tensor_parallel.admm_solve_tp`, N=4, m=12): the batch over the
   data axis, the constraint rows over the model axis, one ``all_reduce`` of
   the model group an iteration, counted;
2. the success rate reduced over the data axis (``all_reduce``);
3. the fused ADMM kernel on each rank's slice of the batch, gathered;
4. the racing tracker (the fused tracker kernel) sharded over the data axis,
   the per-scenario plant parameters split alongside
   (:func:`.batch.racing_sweep` with ``mesh``);
5. the weak-scaling ladder at ``d = 1`` and ``d = n`` as a plumbing check.

:func:`run_ranks` spawns the ranks (``spawn``, a file store in a temporary
directory): gloo ranks on the CPU when asked for the CPU, else NCCL ranks,
one a GPU. It is also how the CPU tests run :func:`record_checks` on four
gloo ranks. The spawned ranks import ``torch`` and this package only.

Run on the card: ``python -m model_predictive_control_tpu_torch.parallel.dryrun
[N] [--device cpu]`` (``N`` defaults to the number of GPUs).
"""

from __future__ import annotations

import contextlib
import datetime
import io
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import DATA_AXIS, MODEL_AXIS, _backend_for, _group_device

# the command-line sweep record_checks runs on every rank: 64 lanes split in
# four slices of the tracker kernel's default tile (16), so that the tiles
# are the unsharded run's
CLI_SWEEP = ["racesweep", "--batch", "64", "--steps", "1", "--horizon", "4"]


def _rank_entry(rank, fn, world, store, device_type, backend, timeout_s, args):
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    backend = backend or _backend_for(device_type)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), device_id=_group_device(backend),
    )
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, nprocs: int, args=(), device=None, backend: str | None = None,
              timeout_s: float = 600.0) -> None:
    """Run ``fn(*args)`` on ``nprocs`` spawned ranks of one new process
    group: NCCL with ``cuda:rank`` on the card (``device`` ``None`` or CUDA),
    gloo where ``device`` is the CPU or ``backend="gloo"`` is named (ranks
    beyond the GPU count share a card, which NCCL refuses: name gloo there). ``fn`` is a module-level function. Raises
    where a rank raised, with its traceback."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank_entry, nprocs=nprocs, start_method="spawn", join=True,
            args=(fn, nprocs, os.path.join(tmp, "store"), device.type, backend, timeout_s,
                  tuple(args)),
        )


class _CountAllReduce:
    """Counts ``torch.distributed.all_reduce`` calls on one group while
    active."""

    def __init__(self, group):
        self.group, self.count, self._orig = group, 0, None

    def __enter__(self):
        self._orig = dist.all_reduce

        def counted(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
            if group is self.group:
                self.count += 1
            return self._orig(tensor, op=op, group=group, async_op=async_op)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self._orig


def dryrun_step(device) -> str:
    """The dry run on the ranks of the current group; returns (and rank 0
    prints) the ``dryrun_multichip OK`` line."""
    from ..ops.cuda import admm_kernel, ilqr_factory
    from ..ops.cuda.admm_kernel import admm_solve_cuda
    from ..solvers.linear_mpc import make_linear_mpc, session2_problem
    from .batch import racing_sweep
    from .mesh import all_reduce_sum, gather_rows, make_mesh, shard_rows
    from .podscale import weak_scaling
    from .tensor_parallel import admm_solve_tp

    device = resolve_device(device)
    n = dist.get_world_size()
    model_parallel = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(n, model_parallel=model_parallel, device=device)
    data_size = mesh.shape[0]
    launches = admm_kernel.LAUNCHES, ilqr_factory.LAUNCHES

    # tiny shapes: N=4 (m = 12 rows, divisible by the model axis), a batch
    # divisible by the data axis
    problem = session2_problem(N=4)
    ctrl = make_linear_mpc(problem, solver="admm", iters=60, dtype=torch.float32, device=device)
    system = problem.system(torch.float32, device)
    nu = ctrl.qp.nu
    B = 4 * data_size
    x_batch = torch.tensor([-5.0, 1.0], device=device).repeat(B, 1)
    warm_x = torch.zeros(B, ctrl.qp.n, device=device)
    warm_y = torch.zeros(B, ctrl.qp.m, device=device)

    # 1. the closed-loop step on the tensor-parallel ADMM, its model-axis
    # all_reduce counted
    q, l, u = ctrl.qp.qp_vectors(x_batch)
    with _CountAllReduce(mesh.get_group(MODEL_AXIS)) as counted:
        sol = admm_solve_tp(ctrl.op, q, l, u, warm_x, warm_y, mesh=mesh, iters=ctrl.iters)
    if counted.count != ctrl.iters:
        raise RuntimeError(f"{counted.count} model-axis all_reduces for {ctrl.iters} iterations")
    x_next = system(x_batch, sol.x[:, :nu])
    wx, wy = ctrl._shift_warm(sol.x, sol.y, axis=1)
    if x_next.shape != (B, 2) or wx.shape != warm_x.shape or wy.shape != warm_y.shape:
        raise RuntimeError("the tensor-parallel step returned wrong shapes")

    # 2. the success rate over the data axis: each data coordinate's share
    ok_local = shard_rows(mesh, sol.converged).float().sum()
    rate = all_reduce_sum(ok_local, mesh.get_group(DATA_AXIS)).item() / B

    # 3. the ADMM kernel on each rank's slice, gathered
    sol_k = admm_solve_cuda(ctrl.op, *(shard_rows(mesh, t) for t in (q, l, u)), iters=40,
                            tile=4)
    kernel_rate = gather_rows(mesh, sol_k.converged).float().mean().item()

    # 4. the racing tracker sharded over the data axis, the plant parameters
    # split alongside
    B_r = 2 * data_size
    _res, sum_r = racing_sweep(batch=B_r, steps=3, N=6, tile=max(2, B_r // data_size),
                               mesh=mesh, device=device)
    if device.type == "cuda" and (admm_kernel.LAUNCHES == launches[0]
                                  or ilqr_factory.LAUNCHES == launches[1]):
        raise RuntimeError("the dry run launched no ADMM or tracker kernel")

    # 5. the weak-scaling ladder's plumbing
    ws = weak_scaling(batch_per_device=8, steps=2, iters=40, tile=8, ladder=[1, n],
                      device=device)
    if ws["points"][-1]["devices"] != n:
        raise RuntimeError("the weak-scaling ladder lost a point")

    line = (
        f"dryrun_multichip OK: {n} devices, mesh {{'{DATA_AXIS}': {data_size}, "
        f"'{MODEL_AXIS}': {model_parallel}}}, batch {B}, success_rate={rate:.3f}, "
        f"tp_collective=verified, pallas_shardmap_success={kernel_rate:.3f}, "
        f"racing_shardmap_success={sum_r['success_rate']:.3f}, "
        f"weak_scaling_plumbing=ok({len(ws['points'])} points)"
    )
    if dist.get_rank() == 0:
        print(f"dryrun launches on rank 0: ADMM kernel {admm_kernel.LAUNCHES - launches[0]}, "
              f"tracker kernel {ilqr_factory.LAUNCHES - launches[1]}", flush=True)
        print(line, flush=True)
    return line


def dryrun_multichip(n_devices: int | None = None, device=None) -> None:
    """The dry run on ``n_devices`` spawned ranks (the GPU count when
    ``None``): NCCL ranks one a GPU on the card, gloo ranks for
    ``device="cpu"``."""
    device = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    run_ranks(dryrun_step, n_devices, args=(device.type,), device=device)


def record_checks(out_dir: str, inputs_path: str, device="cpu") -> None:
    """The scale-out layer's results on this rank, for a test to hold
    against the JAX package and the unsharded runs: written to
    ``out_dir/rank<r>.pt``. ``inputs_path`` holds the QP vectors
    ``tp_q, tp_l, tp_u`` (session-2, N=10, float64) and the starts
    ``pol_x0`` (16 x 2, float32)."""
    from .. import cli
    from ..solvers.linear_mpc import make_linear_mpc, session2_problem
    from ..solvers.qp import admm_solve
    from .batch import parking_sweep
    from .distributed import global_mesh, make_global_batch, process_batch_slice
    from .tensor_parallel import admm_solve_tp

    device = resolve_device(device)
    inp = torch.load(inputs_path)
    out = {}
    mesh = global_mesh(model_parallel=2, device=device)
    out["mesh_shape"] = tuple(mesh.shape)
    out["mesh_dims"] = tuple(mesh.mesh_dim_names)
    out["coordinate"] = tuple(mesh.get_coordinate())
    for key, call in (("refuse_model3", lambda: global_mesh(model_parallel=3, device=device)),
                      ("refuse_uneven", lambda: process_batch_slice(66))):
        try:
            call()
            out[key] = False
        except ValueError:
            out[key] = True
    out["slice_mesh"] = process_batch_slice(64, mesh)
    out["slice_world"] = process_batch_slice(64)
    full = torch.arange(32, dtype=torch.float32).reshape(16, 2)
    lo, hi = process_batch_slice(16, mesh)
    out["global_batch"] = make_global_batch(full[lo:hi], mesh).full_tensor().cpu()

    # the tensor-parallel ADMM: against the port's admm_solve at a fixed ρ,
    # and its model-axis collectives counted
    ctrl = make_linear_mpc(session2_problem(N=10), solver="admm", iters=200,
                           dtype=torch.float64, device=device)
    q, l, u = (inp[k].to(device) for k in ("tp_q", "tp_l", "tp_u"))
    sol_tp = admm_solve_tp(ctrl.op, q, l, u, mesh=mesh, iters=400)
    sol_ref = admm_solve(ctrl.op, q, l, u, iters=400, adapt_chunks=1)
    out["tp_x"], out["tp_converged"] = sol_tp.x.cpu(), sol_tp.converged.cpu()
    out["admm_x"] = sol_ref.x.cpu()
    with _CountAllReduce(mesh.get_group(MODEL_AXIS)) as counted:
        admm_solve_tp(ctrl.op, q, l, u, mesh=mesh, iters=10, polish=False)
    out["tp_all_reduces_10"] = counted.count

    # the kernel policy on the data axis against the unsharded one
    ctrl6 = make_linear_mpc(session2_problem(N=6), solver="admm", iters=400,
                            dtype=torch.float32, device=device)
    x0 = inp["pol_x0"].to(device)
    carry = ctrl6.initial_batch_carry(x0.shape[0], device=device)
    u_a, _, aux_a = ctrl6.batched_policy(tile=8)(x0, 0, carry)
    u_b, _, aux_b = ctrl6.batched_policy(tile=8, mesh=mesh)(x0, 0, carry)
    out["pol_u"], out["pol_ok"] = u_a.cpu(), aux_a["solver_success"].cpu()
    out["pol_mesh_u"], out["pol_mesh_ok"] = u_b.cpu(), aux_b["solver_success"].cpu()
    out["pol_iters"], out["pol_mesh_iters"] = aux_a["admm_iters"].cpu(), aux_b["admm_iters"].cpu()

    # a sharded parking sweep against the unsharded one
    small = dict(N=8, outer_iters=2, inner_iters=3, plant_substeps=4, device=device)
    res_s, sum_s = parking_sweep(8, 2, mesh=mesh, **small)
    res_u, sum_u = parking_sweep(8, 2, **small)
    out["park_states"], out["park_mesh_states"] = res_u.states.cpu(), res_s.states.cpu()
    out["park_ok"], out["park_mesh_ok"] = (res_u.logs["solver_success"].cpu(),
                                           res_s.logs["solver_success"].cpu())
    out["park_summary"], out["park_mesh_summary"] = sum_u, sum_s

    # the command line inside a multi-rank run: its sweep takes the mesh of
    # all ranks and rank 0 prints the summary
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(CLI_SWEEP + ["--device", device.type])
    out["cli_printed"] = printed.getvalue()

    out["dryrun"] = dryrun_step(device)
    torch.save(out, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = "cpu" if "--device" in args and args[args.index("--device") + 1] == "cpu" else None
    nums = [a for a in args if a.isdigit()]
    dryrun_multichip(int(nums[0]) if nums else None, device=dev)
