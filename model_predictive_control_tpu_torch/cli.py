"""Command-line entry point: ``python -m model_predictive_control_tpu_torch.cli``
(port of the JAX package's ``cli.py``).

Every subcommand of the JAX package's command line, with its arguments,
defaults and the keys of the JSON summary it prints last:

  session1             LQR horizon sweep + cost-to-go convergence
  session2 / session3  constrained / relaxed-tracking linear MPC closed loop
  session4             nonlinear parking MPC (``--variant main|sol``)
  sweep                perturbed-plant nonlinear parking sweep
  racesweep            batched lap-tracking sweep (kinematic or Pacejka tier)
  quadsweep            planar-quadrotor loiter sweep (the tracker kernel, nu=2)
  thrustersweep        thrust-cluster loiter sweep (the tracker kernel, nu=4)
  windsweep            offset-free racing under per-scenario crosswinds
  tune                 gradient-based MPC weight tuning (differentiable layer)
  estimate             output-feedback MPC on noisy measurements (KF)
  race                 lap tracking via NMPC (``--wind``: the crosswind demo)
  robust               nominal vs tube vs stochastic vs offset-free demo
  podscale             batched closed-loop throughput (``--scaling``: the
                       weak-scaling ladder over the ranks)

``--device`` (default ``cuda``) is where a command runs; the JAX package's
``--platform`` is taken too (``cpu``, or ``gpu`` for the card). Backends
take the port's names (``cuda``, ``twin``, ``torch``, ``factory``); the JAX
package's ``pallas`` is ``cuda``, its ``pallas-hand`` the parking kernel's
tracking mode, and its ``xla`` (the per-scenario route) is refused by the
sweeps, naming ``torch``, as they refuse it.

Launched on G devices, one process each (``torchrun --nproc-per-node=G -m
model_predictive_control_tpu_torch.cli <command>``; NCCL on the card, gloo
with ``--device cpu``), the sweeps and ``podscale`` split their scenario
batch over the mesh of all ranks (:func:`.parallel.distributed.global_mesh`),
as the JAX package's command line takes a mesh over all devices; rank 0
prints the summary, computed on the gathered batch.
"""

from __future__ import annotations

import argparse
import json

# the JAX package's backend names with a port counterpart of another name
BACKENDS = {"pallas": "cuda"}


def _add_device(p):
    p.add_argument(
        "--device", default="cuda",
        help="where the command runs: 'cuda' (the card, the default) or 'cpu'",
    )
    p.add_argument(
        "--platform", default=None,
        help="the JAX package's name of the device: 'cpu' or 'gpu' ('cuda')",
    )


def _add_common(p):
    p.add_argument("--outdir", default=None, help="write plots/metrics here")
    _add_device(p)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="model_predictive_control_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("session1", help="finite-horizon LQR experiments")
    p1.add_argument("--steps", type=int, default=30)
    _add_common(p1)

    for s in (2, 3):
        ps = sub.add_parser(f"session{s}", help=f"session-{s} linear MPC")
        ps.add_argument("--horizon", type=int, default=20)
        ps.add_argument("--steps", type=int, default=60)
        ps.add_argument("--solver", choices=("admm", "pdip"), default="admm")
        ps.add_argument("--iters", type=int, default=200)
        ps.add_argument(
            "--soft",
            action="store_true",
            help="slack-softened state constraints (QP feasible at every state)",
        )
        ps.add_argument(
            "--terminal-set",
            action="store_true",
            help="constrain x_N to the certified inner box of the invariant "
            "DARE ellipsoid (terminal cost + set: recursive feasibility); "
            "shrinks the feasible region, so pair with a nearer --x0",
        )
        ps.add_argument(
            "--x0", type=float, nargs=2, default=None,
            help="initial state (p, v); default (-100, 20)",
        )
        _add_common(ps)

    p4 = sub.add_parser("session4", help="nonlinear parking MPC")
    p4.add_argument("--variant", choices=("main", "sol"), default="main")
    p4.add_argument("--steps", type=int, default=None)
    p4.add_argument("--sqp-iters", type=int, default=15)
    p4.add_argument("--solver", choices=("sqp", "ilqr"), default="sqp")
    p4.add_argument("--animate", action="store_true")
    p4.add_argument(
        "--exercise", type=int, choices=(3, 4), default=None,
        help="run the open-loop exercise-3/4 driver instead of the closed loop",
    )
    _add_common(p4)

    pw = sub.add_parser(
        "sweep", help="nonlinear parking robustness sweep (perturbed plants)"
    )
    pw.add_argument("--batch", type=int, default=256)
    pw.add_argument("--steps", type=int, default=30)
    pw.add_argument("--horizon", type=int, default=30)
    pw.add_argument("--rel-scale", type=float, default=0.1)
    pw.add_argument("--controller-knows", action="store_true")
    pw.add_argument(
        "--solver", choices=("ilqr", "sqp"), default="ilqr",
        help="per-step optimizer; ilqr (AL-iLQR) is the throughput path",
    )
    pw.add_argument(
        "--backend", choices=("pallas", "factory", "xla", "cuda", "twin", "torch"),
        default="pallas",
        help="pallas (cuda) = the hand-written parking kernel; factory = the "
        "same OCP through the model-parametric tracker kernel; torch = the "
        "per-scenario route (the JAX package's xla); twin = the kernel's "
        "plain twin",
    )
    pw.add_argument("--sqp-iters", type=int, default=15)
    pw.add_argument("--checkpoint", default=None)
    pw.add_argument("--checkpoint-every", type=int, default=0)
    _add_common(pw)

    pr2 = sub.add_parser(
        "racesweep",
        help="batched lap-tracking sweep on the fused AL-iLQR kernel "
        "(perturbed plants x randomized starts, kinematic tier)",
    )
    pr2.add_argument("--batch", type=int, default=1024)
    pr2.add_argument("--steps", type=int, default=50)
    pr2.add_argument("--horizon", type=int, default=15)
    pr2.add_argument("--speed", type=float, default=0.35)
    pr2.add_argument("--rel-scale", type=float, default=0.1)
    pr2.add_argument(
        "--backend", choices=("pallas", "pallas-hand", "xla", "cuda", "twin", "torch"),
        default="pallas",
        help="pallas (cuda) = the model-parametric tracker kernel; "
        "pallas-hand = the parking kernel's tracking mode; torch = the "
        "per-scenario route (the JAX package's xla); twin = the kernel's "
        "plain twin",
    )
    pr2.add_argument(
        "--dynamic", action="store_true",
        help="6-state Pacejka tier at speed instead of the kinematic tier",
    )
    _add_common(pr2)

    pqs = sub.add_parser(
        "quadsweep",
        help="closed-loop planar-quadrotor loiter tracking on the "
        "model-parametric fused tracker under per-scenario mass/inertia/arm "
        "mismatch",
    )
    pqs.add_argument("--batch", type=int, default=2048)
    pqs.add_argument("--steps", type=int, default=50)
    pqs.add_argument("--rel-scale", type=float, default=0.1)
    _add_device(pqs)

    pts = sub.add_parser(
        "thrustersweep",
        help="closed-loop 3-D thrust-cluster loiter tracking, the nu=4 tier "
        "(unrolled-Cholesky Quu), under per-scenario mass/drag mismatch",
    )
    pts.add_argument("--batch", type=int, default=2048)
    pts.add_argument("--steps", type=int, default=50)
    pts.add_argument("--rel-scale", type=float, default=0.1)
    _add_device(pts)

    pws = sub.add_parser(
        "windsweep",
        help="batched offset-free racing under per-scenario crosswinds "
        "(EKF + disturbance-compensated tracking on the fused kernel)",
    )
    pws.add_argument("--batch", type=int, default=2048)
    pws.add_argument("--steps", type=int, default=50)
    pws.add_argument("--wind", type=float, default=0.004)
    pws.add_argument(
        "--nominal", action="store_true",
        help="ablation: run the uncompensated tracker under the same winds",
    )
    _add_common(pws)

    pt = sub.add_parser(
        "tune",
        help="gradient-tune MPC weights through the differentiable closed loop",
    )
    pt.add_argument("--horizon", type=int, default=6)
    pt.add_argument("--steps", type=int, default=16)
    pt.add_argument("--batch", type=int, default=8)
    pt.add_argument("--updates", type=int, default=15)
    pt.add_argument("--lr", type=float, default=0.3)
    pt.add_argument("--iters", type=int, default=400)
    pt.add_argument(
        "--nonlinear", action="store_true",
        help="tune the NONLINEAR parking tier's cost weights through the "
        "parameter-implicit AL-iLQR instead of the linear tier",
    )
    _add_common(pt)

    pe = sub.add_parser(
        "estimate", help="output-feedback MPC on noisy measurements (KF demo)"
    )
    pe.add_argument("--horizon", type=int, default=20)
    pe.add_argument("--steps", type=int, default=60)
    pe.add_argument("--meas-sigma", type=float, default=0.1)
    pe.add_argument("--seed", type=int, default=0)
    _add_common(pe)

    pr = sub.add_parser(
        "race", help="dynamic-bicycle lap tracking (Pacejka tier) via NMPC"
    )
    pr.add_argument("--steps", type=int, default=200)
    pr.add_argument("--horizon", type=int, default=15)
    pr.add_argument("--speed", type=float, default=1.2)
    pr.add_argument(
        "--wind", type=float, default=None,
        help="per-step lateral crosswind drift: run the offset-free "
        "(disturbance-compensated) vs nominal tracker comparison on the "
        "kinematic tier instead of the plain lap",
    )
    pr.add_argument(
        "--kinematic", action="store_true",
        help="use the kinematic tier (parking-grade model) instead",
    )
    _add_common(pr)

    pb = sub.add_parser(
        "robust",
        help="nominal vs tube/stochastic/offset-free demo (linear tiers "
        "+ nonlinear slope-parking offset-free NMPC)",
    )
    pb.add_argument("--batch", type=int, default=64)
    pb.add_argument("--steps", type=int, default=50)
    pb.add_argument("--seed", type=int, default=0)
    pb.add_argument(
        "--no-nonlinear", action="store_true",
        help="skip the nonlinear slope-parking section (section 4)",
    )
    pb.add_argument(
        "--nonlinear-steps", type=int, default=320,
        help="closed-loop steps for the slope-parking comparison",
    )
    _add_common(pb)

    pp = sub.add_parser("podscale", help="batched closed-loop throughput")
    pp.add_argument("--batch", type=int, default=4096)
    pp.add_argument("--steps", type=int, default=50)
    pp.add_argument("--horizon", type=int, default=20)
    pp.add_argument("--iters", type=int, default=100)
    pp.add_argument(
        "--scaling", action="store_true",
        help="weak-scaling ladder over the ranks (solves/s per device and the "
        "efficiency against one; where ranks share a device or run on the CPU the "
        "report is labelled non_performance)",
    )
    pp.add_argument(
        "--backend", choices=("pallas", "xla", "cuda", "twin"), default="pallas",
        help="pallas (cuda) = the fused ADMM kernel; xla = the per-scenario "
        "batched ADMM; twin = the kernel's plain twin",
    )
    _add_common(pp)

    args = parser.parse_args(argv)
    device = _device(args)
    import torch.distributed as dist

    from .parallel.distributed import global_mesh, initialize

    owned = not dist.is_initialized()  # a group this call starts, it ends
    multi = initialize(device=device)
    try:
        mesh = global_mesh(device=device) if multi else None
        summary = _run(args, device, mesh)
        if not multi or dist.get_rank() == 0:
            print(json.dumps(summary))
    finally:
        if multi and owned:
            dist.destroy_process_group()
    return 0


def _device(args):
    import torch

    name = args.device
    if getattr(args, "platform", None):
        name = {"gpu": "cuda"}.get(args.platform, args.platform)
    return torch.device(name)


def _backend(name: str) -> str:
    return BACKENDS.get(name, name)


def _timed(sweep_fn, batch: int, steps: int, kw: dict):
    """A sweep run twice, the second with a fresh generator (seed 1): the
    summary of the first with its wall time (``wall_s``), and the second's
    solves/s and wall time (``solves_per_s``, ``wall_steady_s``)."""
    import torch

    from .obs.metrics import Timer

    with Timer() as t:
        res, summary = sweep_fn(**kw)
        t.fence(res.states)
    summary["wall_s"] = round(t.elapsed, 3)
    with Timer() as t2:
        res2, _ = sweep_fn(generator=torch.Generator().manual_seed(1), **kw)
        t2.fence(res2.states)
    summary["solves_per_s"] = round(batch * steps / t2.elapsed, 1)
    summary["wall_steady_s"] = round(t2.elapsed, 3)
    return summary


def _run(args, device, mesh=None) -> dict:
    if args.cmd == "session1":
        from .experiments import session1

        return session1.run(outdir=args.outdir, steps=args.steps, device=device)
    if args.cmd in ("session2", "session3"):
        from .experiments import session23

        return session23.run(
            session=int(args.cmd[-1]), N=args.horizon, steps=args.steps, outdir=args.outdir,
            solver=args.solver, iters=args.iters, soft=args.soft,
            terminal_set=args.terminal_set,
            x0=tuple(args.x0) if args.x0 is not None else (-100.0, 20.0), device=device)
    if args.cmd == "session4":
        from .experiments import session4

        if args.exercise is not None:
            return session4.run_open_loop(exercise=args.exercise, outdir=args.outdir,
                                          sqp_iters=args.sqp_iters, device=device)
        return session4.run(variant=args.variant, steps=args.steps, outdir=args.outdir,
                            animate=args.animate, sqp_iters=args.sqp_iters, solver=args.solver,
                            device=device)
    if args.cmd == "tune":
        if args.nonlinear:
            import torch

            from .tuning import tune_parking_weights

            dt = torch.float64
            g = torch.Generator().manual_seed(0)
            x0s = (torch.tensor([0.6, -0.25, 0.0, 0.0], dtype=dt)
                   + 0.1 * torch.randn(args.batch, 4, generator=g, dtype=dt)).to(device)
            out = tune_parking_weights(x0s, steps=args.steps, true_Q=[10.0, 10.0, 0.1, 0.1],
                                       true_R=[0.1, 0.01], updates=args.updates,
                                       learning_rate=args.lr, dtype=dt)
            losses = [float(v) for v in out["losses"]]
            return {
                "tier": "nonlinear-parking",
                "loss_initial": round(losses[0], 4),
                "loss_final": round(losses[-1], 4),
                "improvement_pct": round(100.0 * (1.0 - losses[-1] / losses[0]), 1),
                "tuned_Q": [round(float(v), 4) for v in out["Q"]],
                "tuned_R": [round(float(v), 4) for v in out["R"]],
            }
        from .experiments import tuning as tuning_exp

        return tuning_exp.run(outdir=args.outdir, N=args.horizon, steps=args.steps,
                              batch=args.batch, updates=args.updates, learning_rate=args.lr,
                              iters=args.iters, device=device)
    if args.cmd == "estimate":
        from .experiments import estimation_demo

        return estimation_demo.run(outdir=args.outdir, N=args.horizon, steps=args.steps,
                                   meas_sigma=args.meas_sigma, seed=args.seed, device=device)
    if args.cmd == "robust":
        from .experiments import robust_demo

        _res, summary = robust_demo.run(batch=args.batch, steps=args.steps, seed=args.seed,
                                        outdir=args.outdir, nonlinear=not args.no_nonlinear,
                                        nonlinear_steps=args.nonlinear_steps, device=device)
        return summary
    if args.cmd == "race":
        from .experiments import racing

        if args.wind is not None:
            return racing.crosswind_comparison(steps=args.steps, N=args.horizon,
                                               speed=min(args.speed, 0.35), wind=args.wind,
                                               device=device)
        _res, summary = racing.run(steps=args.steps, N=args.horizon, dynamic=not args.kinematic,
                                   speed=args.speed, outdir=args.outdir, device=device)
        return summary
    if args.cmd == "racesweep":
        from .parallel.batch import racing_sweep, racing_sweep_dynamic

        if args.dynamic:
            # the dynamic tier has no hand-kernel mode: pallas-hand is its kernel
            be = "pallas" if args.backend == "pallas-hand" else args.backend
            kw = dict(batch=args.batch, steps=args.steps, N=args.horizon,
                      rel_scale=min(args.rel_scale, 0.05), backend=_backend(be), mesh=mesh,
                      device=device)
            return _timed(racing_sweep_dynamic, args.batch, args.steps, kw)
        kw = dict(batch=args.batch, steps=args.steps, N=args.horizon, speed=args.speed,
                  rel_scale=args.rel_scale, backend=_backend(args.backend), mesh=mesh,
                  device=device)
        return _timed(racing_sweep, args.batch, args.steps, kw)
    if args.cmd in ("quadsweep", "thrustersweep"):
        from .parallel.batch import quadrotor_sweep, thruster_sweep

        sweep = quadrotor_sweep if args.cmd == "quadsweep" else thruster_sweep
        kw = dict(batch=args.batch, steps=args.steps, rel_scale=args.rel_scale, mesh=mesh,
                  device=device)
        return _timed(sweep, args.batch, args.steps, kw)
    if args.cmd == "windsweep":
        from .parallel.batch import wind_sweep

        kw = dict(batch=args.batch, steps=args.steps, wind=args.wind,
                  compensate=not args.nominal, mesh=mesh, device=device)
        return _timed(wind_sweep, args.batch, args.steps, kw)
    if args.cmd == "sweep":
        import torch

        from .parallel.batch import parking_sweep

        kw = dict(batch=args.batch, steps=args.steps, N=args.horizon, rel_scale=args.rel_scale,
                  controller_knows=args.controller_knows, solver=args.solver,
                  backend=_backend(args.backend), sqp_iters=args.sqp_iters, mesh=mesh,
                  device=device)
        from .obs.metrics import Timer

        with Timer() as t:
            res, summary = parking_sweep(checkpoint_path=args.checkpoint,
                                         checkpoint_every=args.checkpoint_every, **kw)
            t.fence(res.states)
        summary["wall_s"] = round(t.elapsed, 3)
        summary["solves_per_s"] = round(args.batch * args.steps / t.elapsed, 1)
        # steady throughput: a second run with a fresh generator
        with Timer() as t2:
            res2, _ = parking_sweep(generator=torch.Generator().manual_seed(1), **kw)
            t2.fence(res2.states)
        summary["wall_s_steady"] = round(t2.elapsed, 3)
        summary["solves_per_s_steady"] = round(args.batch * args.steps / t2.elapsed, 1)
        return summary
    if args.cmd == "podscale":
        return _podscale(args, device, mesh)
    raise ValueError(f"unknown command {args.cmd}")


def _podscale(args, device, mesh=None) -> dict:
    """Batched closed-loop throughput of the session-2 MPC over the mesh's
    data axis (one device without a mesh): the JAX package's ``podscale`` at
    configurable scale; ``--scaling``: :func:`.parallel.podscale.weak_scaling`
    at ``--batch`` scenarios per rank."""
    import torch

    from .control.batch_loop import simulate_batch
    from .obs.metrics import Timer
    from .parallel.mesh import gather_rows, shard_rows
    from .parallel.podscale import headline_starts, weak_scaling
    from .solvers.linear_mpc import make_linear_mpc, session2_problem

    backend = _backend(args.backend)
    if args.scaling:
        return weak_scaling(batch_per_device=args.batch, steps=args.steps, horizon=args.horizon,
                            iters=args.iters, device=device)
    problem = session2_problem(N=args.horizon)
    ctrl = make_linear_mpc(problem, solver="admm", iters=args.iters, dtype=torch.float32,
                           device=device)
    system = problem.system(torch.float32, device)
    policy = ctrl.batched_policy(backend=backend)
    n_dev = 1 if mesh is None else mesh.shape[0]
    B = (args.batch // n_dev) * n_dev
    x0s = headline_starts(B, device=device)
    if mesh is not None:
        x0s = shard_rows(mesh, x0s)

    def run_batch(x0s):
        carry = ctrl.presolve_batch_carry(x0s, iters_mult=4, backend=backend)
        res = simulate_batch(x0s, system, args.steps, policy, carry, batched_dynamics=True)
        out = res.states[-1], res.logs["solver_success"]
        return out if mesh is None else (gather_rows(mesh, out[0]), gather_rows(mesh, out[1], 1))

    out = run_batch(x0s)  # warm-up: the kernel's build and first launch
    with Timer() as t:
        out = run_batch(x0s)
        t.fence(out)
    _, success = out
    return {
        "metric": "closed_loop_mpc_solves_per_s",
        "batch": B,
        "steps": args.steps,
        "devices": n_dev,
        "backend": args.backend,
        "solves_per_s": round(B * args.steps / t.elapsed, 1),
        "success_rate": round(success.float().mean().item(), 4),
        "wall_s": round(t.elapsed, 4),
    }


if __name__ == "__main__":
    raise SystemExit(main())
