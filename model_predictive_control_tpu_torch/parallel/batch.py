"""Scenario batching (port of ``parallel/batch.py``): the session-2
compaction key, the nonlinear obstacle-parking sweep on the fused AL-iLQR
kernel, the two lap-tracking sweeps (kinematic and Pacejka racing) on the
fused tracker kernel (the kinematic one also on the AL-iLQR kernel's
tracking mode), the planar-quadrotor and thrust-cluster loiter sweeps on the
fused tracker kernel, the crosswind and slope offset-free sweeps on the
AL-iLQR kernel's offset and input-reference modes, and the linear family's
sweeps on the ADMM kernel; each sweep runs randomized initial states ×
perturbed plants.

Every nonlinear sweep also has the per-scenario route (``backend="torch"``,
the JAX package's ``"xla"``): the batched AL-iLQR or SQP of
:mod:`..solvers.ilqr` / :mod:`..solvers.sqp` on each scenario's own problem,
in any dtype and for any perturbed field. A kernel request the kernel
cannot serve (another dtype than float32, a perturbed field it has no
operand for) raises a ``ValueError`` naming ``backend="torch"``, where the
JAX package falls back to its ``"xla"`` route without a word.

A sweep is a Python loop over closed-loop steps
(:func:`..control.batch_loop.simulate_batch`); each step is one kernel
launch for the whole batch, then one fine-RK4 plant step in plain torch.
Random draws come from an explicit ``torch.Generator`` made on the CPU, so a
seed gives the same scenarios on every device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..control.batch_loop import BatchSimResult, simulate_batch
from ..models.benchmarks import (
    NU_THRUSTER,
    QUADROTOR_PARAMS,
    THRUSTER_PARAMS,
    make_planar_quadrotor_ode_rows,
    make_thruster_ode_rows,
    thruster_directions,
)
from ..models.bicycle import NU, NX, NX_DYNAMIC, dynamic_bicycle_ode, kinematic_bicycle_ode
from ..models.parameters import VehicleParameters
from ..ops.cuda import ilqr_factory
from ..ops.cuda.ilqr_dyn_kernel import (
    al_ilqr_dyn_solve_cuda,
    al_ilqr_dyn_solve_twin,
    model_tuple,
)
from ..ops.cuda.ilqr_factory import fused_tracker_solve_cuda, fused_tracker_solve_twin
from ..ops.cuda.ilqr_kernel import (
    DEFAULT_TILE,
    al_ilqr_solve_cuda,
    al_ilqr_solve_twin,
    n_constraints,
    parking_geometry,
)
from ..ops.cuda.parking_factory import al_ilqr_parking_solve_factory, make_parking_ode_rows
from ..ops.integrators import euler, rk4, rk4_fine
from ..solvers.ilqr import ILQRProblem, al_ilqr_solve
from ..solvers.parking import (
    Q_MAIN,
    Q_SOL,
    QN_SCALE_MAIN,
    QN_SCALE_SOL,
    R_MAIN,
    make_parking_ilqr,
    make_parking_ocp,
    scenario_fields,
    with_fields,
)
from ..solvers.sqp import sqp_solve
from ..utils.device import resolve_device

# fields whose perturbation is physically meaningful for the kinematic model
DEFAULT_PERTURB_FIELDS = ("friction", "acceleration")
# per-scenario model fields the kernels take as operands; any other batched
# field takes the per-scenario route
KERNEL_FIELDS = {"acceleration", "friction"}
XLA_NAME = ("backend='xla' is the JAX package's name of the per-scenario route; "
            "here it is backend='torch'")


def _refuse_kernel(backend: str, dtype, exotic) -> None:
    """Raise where a kernel backend was asked for a dtype or a per-scenario
    model field the kernel cannot serve (the JAX package falls back to its
    per-scenario route there; the port makes the caller choose it)."""
    if dtype != torch.float32:
        raise ValueError(f"backend={backend!r} runs in float32 only; the per-scenario "
                         f"route backend='torch' takes {dtype}")
    if exotic:
        raise ValueError(f"backend={backend!r} has no operand for the per-scenario "
                         f"fields {sorted(exotic)}; the per-scenario route "
                         "backend='torch' takes them")


def boundary_compaction_key(p_max: float, x0s: torch.Tensor) -> torch.Tensor:
    """Static scenario-compaction sort key for the session-2 family:
    ``(p_max − p) − 3·max(v, 0)``. Small for boundary-activating (long
    iterating) scenarios, so a stable ``torch.argsort`` of it packs them into
    few kernel tiles and lets the per-tile early exit fire for the rest."""
    return (float(p_max) - x0s[:, 0]) - 3.0 * torch.clamp(x0s[:, 1], min=0.0)


def perturb_parameters(
    generator: torch.Generator,
    base: VehicleParameters,
    batch: int,
    rel_scale: float = 0.1,
    fields=DEFAULT_PERTURB_FIELDS,
    dtype=torch.float32,
    device=None,
) -> VehicleParameters:
    """Batched parameters: each named field drawn uniformly in
    ``base ± rel_scale·|base|`` per scenario, in field order from
    ``generator`` (a CPU generator) and moved to ``device`` (the card when
    ``None``); other fields stay floats."""
    device = resolve_device(device)
    updates = {}
    for name in fields:
        v = float(getattr(base, name))
        lo, hi = v - rel_scale * abs(v), v + rel_scale * abs(v)
        draw = torch.rand(batch, generator=generator, dtype=dtype)
        updates[name] = (lo + (hi - lo) * draw).to(device)
    return dataclasses.replace(base, **updates)


def random_initial_states(
    generator: torch.Generator,
    batch: int,
    center=(0.3, -0.1, 0.0, 0.0),
    spread=(0.2, 0.15, 0.3, 0.05),
    x_obs=None,
    clearance: float = 0.22,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """``(batch, 4)`` initial poses drawn uniformly in ``center ± spread``
    around the session-4 start. With an obstacle pose ``x_obs``, positions
    inside ``clearance`` of it are projected radially onto the clearance
    circle, so that every scenario starts collision-free whatever its
    heading (the JAX package's ``random_initial_states`` says why 0.22).
    Drawn on the CPU, returned on ``device`` (the card when ``None``)."""
    device = resolve_device(device)
    u = 2.0 * torch.rand(batch, 4, generator=generator, dtype=dtype) - 1.0
    x0 = torch.tensor(center, dtype=dtype) + u * torch.tensor(spread, dtype=dtype)
    if x_obs is not None:
        x0 = project_clear(x0, x_obs, clearance)
    return x0.to(device)


def project_clear(x0: torch.Tensor, x_obs, clearance: float) -> torch.Tensor:
    """``x0`` with every position closer than ``clearance`` to the obstacle
    position moved radially onto that circle (along +x where it coincides
    with the obstacle); other rows unchanged."""
    p_obs = torch.tensor([float(v) for v in x_obs][:2], dtype=x0.dtype, device=x0.device)
    d = x0[:, :2] - p_obs
    r = torch.linalg.vector_norm(d, dim=1, keepdim=True)
    plus_x = torch.tensor([1.0, 0.0], dtype=x0.dtype, device=x0.device)
    dir_ = torch.where(r > 1e-6, d / torch.clamp(r, min=1e-6), plus_x)
    p_fixed = torch.where(r < clearance, p_obs + dir_ * clearance, x0[:, :2])
    return torch.cat([p_fixed, x0[:, 2:]], dim=1)


def initial_warm_carry(batch: int, N: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(batch, N * NU, dtype=dtype, device=resolve_device(device))


def batched_plant(plant_params: VehicleParameters, ts: float, substeps: int = 16):
    """``(B, 4) × (B, 2) → (B, 4)`` plant: fine RK4 (the reference's
    ``odeint`` stand-in) with per-scenario parameter fields broadcast over
    the batch."""
    f = lambda x, u: kinematic_bicycle_ode(plant_params, x, u)
    return rk4_fine(f, ts, substeps=substeps)


def _per_scenario(value, batch: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=dtype, device=device).expand(batch).contiguous()


def batched_parking_policy(
    model_params: VehicleParameters,
    N: int,
    ts: float,
    x_obs=None,
    Q=Q_MAIN,
    R=R_MAIN,
    qn_scale: float = QN_SCALE_MAIN,
    sqp_iters: int = 15,
    qp_iters: int = 40,
    solver: str = "ilqr",
    outer_iters: int = 6,
    inner_iters: int = 15,
    mu_init: float = 10.0,
    backend: str = "cuda",
    tile: int = DEFAULT_TILE,
    group: int | None = None,
    mesh=None,
    dtype=torch.float32,
):
    """Batch-level receding-horizon nonlinear-MPC policy for
    :func:`simulate_batch`.

    ``model_params`` fields are floats (the nominal model) or ``(B,)``
    tensors (a per-scenario model). ``solver="ilqr"`` with ``backend="cuda"``
    makes every step one fused AL-iLQR solve of the whole batch (``"twin"``:
    the kernel's plain twin on any device); its carry is ``(u_warm (B,
    N·2), lam (B, N, nc))``, the multipliers shifted and decayed (``0.7``,
    zero where the solve did not converge), as in the JAX package.
    ``backend="factory"`` makes the same step one solve of the same OCP
    through the fused tracker kernel instead
    (:func:`..ops.cuda.parking_factory.al_ilqr_parking_solve_factory`: the
    clearances as user constraint rows with their exact curvature; its twin
    for CPU states), with the same carry in the tracker's row order.
    ``group`` is the kernel's threads per lane (``ilqr_kernel.GROUPS``,
    ``ilqr_factory.GROUPS``; the default when ``None``): it moves time,
    never numbers.

    The per-scenario route, the JAX package's vmapped solves: ``solver=
    "sqp"`` (the SQP of :func:`..solvers.parking.make_parking_ocp`; the
    backend concerns ``"ilqr"`` alone, as in the JAX package) or
    ``backend="torch"`` (the batched AL-iLQR on each scenario's
    :func:`..solvers.parking.make_parking_ilqr`). It is the only route for
    another dtype than float32 or a perturbed field other than acceleration
    and friction: the kernel backends raise ``ValueError`` for them. Its
    carry is ``u_warm``; its problems are built on the device of the first
    states it is given. Device meshes raise ``NotImplementedError``.
    """
    if solver not in ("ilqr", "sqp"):
        raise ValueError(f"unknown solver {solver!r}")
    if backend == "xla":
        raise ValueError(XLA_NAME)
    if backend not in ("cuda", "twin", "torch", "factory"):
        raise ValueError(f"unknown backend {backend!r}")
    if mesh is not None:
        raise NotImplementedError("device meshes are not ported yet: ROADMAP S7.1")
    if solver == "sqp" or backend == "torch":
        return _per_scenario_parking_policy(
            model_params, N, ts, x_obs, Q, R, qn_scale, sqp_iters, qp_iters, solver,
            outer_iters, inner_iters, dtype)
    _refuse_kernel(backend, dtype, model_params.batched_fields() - KERNEL_FIELDS)
    solve_fn = {"cuda": al_ilqr_solve_cuda, "twin": al_ilqr_solve_twin,
                "factory": al_ilqr_parking_solve_factory}[backend]
    n_circ = 0 if x_obs is None else 3
    nc = n_constraints(n_circ)
    geom, limits = parking_geometry(model_params, x_obs, n_circles=3)
    weights = (
        tuple(float(v) for v in Q),
        tuple(float(v) for v in R),
        float(qn_scale),
    )

    def policy(x_batch, t, carry):
        B = x_batch.shape[0]
        u_warm, lam_warm = carry
        accv = _per_scenario(model_params.acceleration, B, dtype, x_batch.device)
        fricv = _per_scenario(model_params.friction, B, dtype, x_batch.device)
        tile_eff = min(tile, math.ceil(B / 128) * 128)
        sol = solve_fn(
            x_batch, u_warm.reshape(B, N, NU), accv, fricv, lam_init=lam_warm,
            N=N, ts=float(ts), geom=geom, limits=limits, weights=weights,
            n_circles=n_circ, outer_iters=outer_iters, inner_iters=inner_iters,
            mu_init=mu_init, viol_tol=1e-4, tile=tile_eff, group=group,
        )
        u_next = torch.cat([sol.us[:, 1:], sol.us[:, -1:]], dim=1)
        # shifted, decayed multipliers, kept only where the solve converged
        # (undecayed or unmasked carry-over was measured worse than cold)
        lam_next = 0.7 * torch.where(
            sol.converged[:, None, None],
            torch.cat([sol.lam[:, 1:], sol.lam[:, -1:]], dim=1),
            0.0,
        )
        aux = {
            "solver_success": sol.converged,
            "kkt_res": sol.viol,
            "viol": sol.viol,
            "kernel_inner_iters": sol.inner_iters_executed,
        }
        return sol.us[:, 0], (u_next.reshape(B, N * NU), lam_next), aux

    policy.initial_carry = lambda batch, device=None: (
        initial_warm_carry(batch, N, dtype, device),
        torch.zeros(batch, N, nc, dtype=dtype, device=resolve_device(device)),
    )
    return policy


def _per_scenario_parking_policy(model_params, N, ts, x_obs, Q, R, qn_scale, sqp_iters,
                                 qp_iters, solver, outer_iters, inner_iters, dtype):
    """The per-scenario route of :func:`batched_parking_policy` (the JAX
    package's ``solve_one_sqp`` / ``solve_one_ilqr`` under ``vmap``)."""
    built = {}

    def problem(device):
        if device not in built:
            make = make_parking_ocp if solver == "sqp" else make_parking_ilqr
            built[device] = make(model_params, N=N, ts=ts, x_obs=x_obs, Q=Q, R=R,
                                 qn_scale=qn_scale, dtype=dtype, device=device)
        return built[device]

    def policy(x_batch, t, carry):
        B = x_batch.shape[0]
        if solver == "sqp":
            sol = sqp_solve(problem(x_batch.device), x_batch, u_init=carry, iters=sqp_iters,
                            qp_iters=qp_iters)
            u_next = torch.cat([sol.u[:, NU:], sol.u[:, -NU:]], dim=1)
            aux = {"solver_success": sol.converged, "kkt_res": sol.kkt_res, "viol": sol.viol}
            return sol.u[:, :NU], u_next, aux
        prob, cons, nc = problem(x_batch.device)
        # success at the engine-wide 1e-4 (float32 multipliers cannot
        # certify 1e-6 on rows of order one)
        sol = al_ilqr_solve(prob, cons, nc, x_batch, u_init=carry.reshape(B, N, NU),
                            outer_iters=outer_iters, inner_iters=inner_iters, viol_tol=1e-4)
        u_next = torch.cat([sol.us[:, 1:], sol.us[:, -1:]], dim=1).reshape(B, N * NU)
        aux = {"solver_success": sol.converged, "kkt_res": sol.viol, "viol": sol.viol}
        return sol.us[:, 0], u_next, aux

    policy.initial_carry = lambda batch, device=None: initial_warm_carry(batch, N, dtype, device)
    return policy


def parking_sweep(
    batch: int,
    steps: int,
    generator: torch.Generator | None = None,
    N: int = 30,
    ts: float = 0.08,
    x_obs=(0.25, 0.0, 0.0, 0.0),
    rel_scale: float = 0.1,
    perturb_fields=DEFAULT_PERTURB_FIELDS,
    controller_knows: bool = False,
    sqp_iters: int = 15,
    qp_iters: int = 40,
    solver: str = "ilqr",
    outer_iters: int = 6,
    inner_iters: int = 15,
    mu_init: float = 10.0,
    backend: str = "cuda",
    tile: int = DEFAULT_TILE,
    group: int | None = None,
    plant_substeps: int = 16,
    mesh=None,
    dtype=torch.float32,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    u_seed=None,
    device=None,
) -> tuple[BatchSimResult, dict]:
    """The robustness sweep: ``batch`` scenarios (randomized x0 × perturbed
    plant), closed-loop obstacle parking for ``steps`` steps on ``device``
    (the card when ``None``).

    ``generator`` (a CPU ``torch.Generator``, seed 0 when ``None``) draws
    the plant parameters, then the initial states. The controller predicts
    with the nominal model unless ``controller_knows``, when it gets each
    scenario's acceleration and friction. ``tile`` and ``group`` are the
    kernel's, ``solver`` and ``backend`` pick the route
    (:func:`batched_parking_policy`: ``"cuda"``, the hand-written parking
    kernel; ``"factory"``, the same OCP through the tracker kernel, whose
    contract configuration is ``inner_iters=14``). ``u_seed`` ``(B, N, 2)``: the step-0
    warm-start controls in place of zeros (the multipliers stay zero).
    ``checkpoint_every``/``checkpoint_path`` are not ported yet and raise
    ``NotImplementedError``.

    Returns ``(BatchSimResult, summary)`` with the JAX package's summary
    keys (``mean_inner_iters`` on the kernel route).
    """
    if checkpoint_every > 0 or checkpoint_path is not None:
        raise NotImplementedError("sweep checkpoints are not ported yet: ROADMAP S7.2")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    base = VehicleParameters()
    plant_params = perturb_parameters(
        generator, base, batch, rel_scale=rel_scale, fields=perturb_fields,
        dtype=dtype, device=device,
    )
    model_params = plant_params if controller_knows else base
    x0s = random_initial_states(generator, batch, x_obs=x_obs, dtype=dtype, device=device)
    policy = batched_parking_policy(
        model_params, N=N, ts=ts, x_obs=x_obs, sqp_iters=sqp_iters,
        qp_iters=qp_iters, solver=solver, outer_iters=outer_iters,
        inner_iters=inner_iters, mu_init=mu_init, backend=backend, tile=tile,
        group=group, mesh=mesh, dtype=dtype,
    )
    plant = batched_plant(plant_params, ts, substeps=plant_substeps)
    carry0 = policy.initial_carry(batch, device)
    if u_seed is not None:
        seed = torch.as_tensor(u_seed, dtype=dtype, device=device).reshape(batch, N * NU)
        carry0 = (seed, *carry0[1:]) if isinstance(carry0, tuple) else seed
    res = simulate_batch(x0s, plant, steps, policy, carry0, batched_dynamics=True)

    success = res.logs["solver_success"]
    dist = torch.linalg.vector_norm(res.states[-1][:, :2], dim=-1)
    summary = {
        "batch": int(batch),
        "steps": int(steps),
        "success_rate": success.float().mean().item(),
        # torch.median returns the lower middle value; jnp.median averages
        "median_final_dist": torch.quantile(dist, 0.5).item(),
        "parked_frac_5cm": (dist < 0.05).float().mean().item(),
        "controller_knows": bool(controller_knows),
        "rel_scale": float(rel_scale),
    }
    if "kernel_inner_iters" in res.logs:
        summary["mean_inner_iters"] = res.logs["kernel_inner_iters"].mean().item()
    return res, summary


# ---------------------------------------------------------------------------
# Racing: lap-tracking sweeps on the fused tracker kernel
# ---------------------------------------------------------------------------

# racing-sweep weights: the kinematic racing tier's (experiments/racing.py)
RACING_Q = (40.0, 40.0, 4.0, 1.0)
RACING_R = (0.5, 0.5)
RACING_QN_SCALE = 5.0


def _racing_route(backend: str, mesh, dtype, model_params, kinematic: bool) -> str:
    """Check a racing backend: a kernel backend raises ``ValueError`` for
    another dtype than float32 or a per-scenario controller model the kernel
    has no operand for (the kinematic tier takes acceleration and friction),
    which the per-scenario route ``"torch"`` takes; the kinematic tier also
    knows the parking kernel's tracking mode, ``"pallas-hand"``."""
    if backend == "xla":
        raise ValueError(XLA_NAME)
    known = ("cuda", "twin", "torch") + (("pallas-hand",) if kinematic else ())
    if backend not in known:
        raise ValueError(f"unknown backend {backend!r}")
    if mesh is not None:
        raise NotImplementedError("device meshes are not ported yet: ROADMAP S7.1")
    if backend != "torch":
        _refuse_kernel(backend, dtype,
                       model_params.batched_fields() - (KERNEL_FIELDS if kinematic else set()))
    return backend


def _window_tracking_problem(params, windows, model_step, Q, R, qn_scale, constraints, nc,
                             dtype):
    """The window-tracking AL-iLQR problem of the racing tiers' per-scenario
    route: ``(x − ref_t)ᵀQ(x − ref_t) + uᵀRu`` a stage, ``qn_scale · Q`` at
    the end, ``model_step(params, x, u)`` with each scenario's own fields of
    a per-scenario ``params``; ``windows`` ``(B, N + 1, nx)``. Returns
    ``(prob, constraints, nc)``."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=windows.device)
    Qd, Rd = t(Q), t(R)
    QNd = qn_scale * Qd
    N = windows.shape[1] - 1

    def stage_cost(x, u, p, s):
        e = x - s["ref"]
        return e @ (Qd * e) + u @ (Rd * u)

    def terminal_cost(x, p):
        e = x - p["ref_N"]
        return e @ (QNd * e)

    prob = ILQRProblem(
        dynamics=lambda x, u, p: model_step(with_fields(params, p), x, u),
        stage_cost=stage_cost, terminal_cost=terminal_cost, N=N, nx=windows.shape[-1], nu=NU,
        params={"ref_N": windows[:, N], **scenario_fields(params)},
        stages={"ref": windows[:, :N]},
    )
    return prob, constraints, nc


def make_tracking_ilqr_window(
    params: VehicleParameters,
    window: torch.Tensor,
    Q,
    R,
    qn_scale: float,
    x_lb,
    x_ub,
    ts: float,
    dtype=torch.float32,
):
    """Window-tracking iLQR problem with the constraint rows of the parking
    kernel's tracking mode (state box, input box, no obstacle): ``(prob,
    constraints, nc)``, the kernel's oracle and the per-scenario route of
    :func:`racing_sweep`. ``window`` is ``(B, N + 1, 4)`` (one window per
    scenario) or ``(N + 1, 4)`` (one scenario); the problem's tensors follow
    it."""
    window = torch.as_tensor(window, dtype=dtype)
    windows = window if window.ndim == 3 else window[None]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=windows.device)
    lb_x, ub_x = t(x_lb), t(x_ub)
    lb_u = t([float(params.min_drive), -float(params.max_steer)])
    ub_u = t([float(params.max_drive), float(params.max_steer)])
    step = lambda pp, x, u: euler(lambda xx, uu: kinematic_bicycle_ode(pp, xx, uu), ts)(x, u)
    return _window_tracking_problem(
        params, windows, step, Q, R, qn_scale,
        lambda x, u, p, s: torch.cat([x - ub_x, lb_x - x, u - ub_u, lb_u - u]),
        2 * NX + 2 * NU, dtype)


def _tracking_step(sol, x_batch, window, N, nu=NU):
    """The policy's output from a tracker solution: u0, the shifted warm
    start, and the logs (tracking error of the measured state's first two
    components against the window's first reference point)."""
    B = x_batch.shape[0]
    u_next = torch.cat([sol.us[:, 1:], sol.us[:, -1:]], dim=1)
    aux = {
        "solver_success": sol.converged,
        "viol": sol.viol,
        "tracking_error": torch.linalg.vector_norm(x_batch[:, :2] - window[0, :2], dim=-1),
    }
    if hasattr(sol, "inner_iters_executed"):
        aux["kernel_inner_iters"] = sol.inner_iters_executed
    return sol.us[:, 0], u_next.reshape(B, N * nu), aux


def _per_scenario_policy(ref, N, dtype, problem, outer_iters, inner_iters):
    """A racing policy on the per-scenario route: ``problem(windows (B, N+1,
    nx)) -> (prob, constraints, nc)`` solved by the batched AL-iLQR."""

    def policy(x_batch, t, carry):
        B = x_batch.shape[0]
        window = ref[t : t + N + 1]
        prob, cons, nc = problem(window[None].expand(B, N + 1, window.shape[-1]))
        sol = al_ilqr_solve(prob, cons, nc, x_batch, u_init=carry.reshape(B, N, NU),
                            outer_iters=outer_iters, inner_iters=inner_iters, viol_tol=1e-4)
        return _tracking_step(sol, x_batch, window, N)

    policy.initial_carry = lambda batch, device=None: initial_warm_carry(batch, N, dtype, device)
    return policy


def batched_racing_policy(
    ref: torch.Tensor,
    model_params: VehicleParameters | None = None,
    N: int = 15,
    ts: float = 0.05,
    Q=RACING_Q,
    R=RACING_R,
    qn_scale: float = RACING_QN_SCALE,
    outer_iters: int = 6,
    inner_iters: int = 15,
    backend: str = "cuda",
    tile: int = ilqr_factory.DEFAULT_TILE,
    group: int | None = None,
    mesh=None,
    dtype=torch.float32,
):
    """Batch-level kinematic lap-tracking policy for :func:`simulate_batch`
    (the JAX ``racing_sweep``'s ``make_policy``): every step is one fused
    tracker solve of the whole batch on the window ``ref[t : t + N + 1]``.

    The controller predicts with ``model_params`` (the nominal
    ``VehicleParameters()`` by default) through the row-form kinematic
    bicycle, one Euler substep per interval, with the per-scenario ``(acc,
    fric)`` parameter operand, an input box and a state box (the arena and
    the velocity limits; the unwrapped lap heading is boxed at ±100 so that
    it never binds). The carry is the solved controls shifted one stage.

    ``backend="cuda"`` launches the kernel for CUDA tensors (its plain twin
    for CPU tensors); ``"twin"`` runs the twin on any device. ``group`` is
    the kernel's threads per lane (``ilqr_factory.GROUPS``; the
    instantiation's default when ``None``): it moves time, never numbers.
    ``"pallas-hand"`` solves on the parking AL-iLQR kernel's tracking mode
    (``refs``; its group and tile, its twin for CPU tensors), the JAX
    package's A/B backend. ``"torch"`` is the per-scenario route (the batched
    AL-iLQR on :func:`make_tracking_ilqr_window`), the only one for another
    dtype or a per-scenario model other than acceleration and friction (the
    kernel backends raise ``ValueError`` for them). Device meshes raise
    ``NotImplementedError``.
    """
    base = model_params if model_params is not None else VehicleParameters()
    backend = _racing_route(backend, mesh, dtype, base, kinematic=True)
    x_lims = (
        (float(base.min_pos_x), float(base.min_pos_y), -100.0, float(base.min_vel)),
        (float(base.max_pos_x), float(base.max_pos_y), 100.0, float(base.max_vel)),
    )
    if backend == "torch":
        return _per_scenario_policy(ref, N, dtype, lambda w: make_tracking_ilqr_window(
            base, w, Q, R, qn_scale, x_lims[0], x_lims[1], ts, dtype=dtype), outer_iters,
            inner_iters)
    geom, _ = parking_geometry(base, None)
    u_lims = (
        (float(base.min_drive), -float(base.max_steer)),
        (float(base.max_drive), float(base.max_steer)),
    )
    weights = (tuple(float(v) for v in Q), tuple(float(v) for v in R), float(qn_scale))
    if backend == "pallas-hand":
        return _hand_tracking_policy(ref, base, N, ts, geom, x_lims + u_lims, weights,
                                     outer_iters, inner_iters, tile, group, dtype)
    solve_fn = fused_tracker_solve_cuda if backend == "cuda" else fused_tracker_solve_twin
    model = make_parking_ode_rows(float(geom[0]), float(geom[1]))

    def policy(x_batch, t, carry):
        B = x_batch.shape[0]
        window = ref[t : t + N + 1]
        params = torch.stack(
            [_per_scenario(base.acceleration, B, dtype, x_batch.device),
             _per_scenario(base.friction, B, dtype, x_batch.device)],
            dim=-1,
        )
        sol = solve_fn(
            x_batch, carry.reshape(B, N, NU), window[None].expand(B, N + 1, NX),
            ode_rows=model, nx=NX, nu=NU, N=N, ts=float(ts), substeps=1,
            integrator="euler", limits=u_lims, state_limits=x_lims, weights=weights,
            params=params, n_params=2, outer_iters=outer_iters,
            inner_iters=inner_iters, viol_tol=1e-4,
            tile=min(tile, math.ceil(B / 128) * 128), group=group,
        )
        return _tracking_step(sol, x_batch, window, N)

    policy.initial_carry = lambda batch, device=None: initial_warm_carry(batch, N, dtype, device)
    return policy


def _hand_tracking_policy(ref, base, N, ts, geom, limits, weights, outer_iters, inner_iters,
                          tile, group, dtype):
    """The kinematic lap-tracking policy on the parking kernel's tracking
    mode: the window broadcast to every lane as ``refs``."""

    def policy(x_batch, t, carry):
        B = x_batch.shape[0]
        window = ref[t : t + N + 1]
        sol = al_ilqr_solve_cuda(
            x_batch, carry.reshape(B, N, NU),
            _per_scenario(base.acceleration, B, dtype, x_batch.device),
            _per_scenario(base.friction, B, dtype, x_batch.device),
            window[None].expand(B, N + 1, NX).contiguous(),
            N=N, ts=float(ts), geom=geom, limits=limits, weights=weights, n_circles=0,
            outer_iters=outer_iters, inner_iters=inner_iters, viol_tol=1e-4,
            tile=min(tile, math.ceil(B / 128) * 128), group=group,
        )
        return _tracking_step(sol, x_batch, window, N)

    policy.initial_carry = lambda batch, device=None: initial_warm_carry(batch, N, dtype, device)
    return policy


def racing_sweep(
    batch: int,
    steps: int,
    generator: torch.Generator | None = None,
    N: int = 15,
    ts: float = 0.05,
    speed: float = 0.35,
    rel_scale: float = 0.1,
    perturb_fields=DEFAULT_PERTURB_FIELDS,
    Q=RACING_Q,
    R=RACING_R,
    qn_scale: float = RACING_QN_SCALE,
    outer_iters: int = 6,
    inner_iters: int = 15,
    backend: str = "cuda",
    tile: int = ilqr_factory.DEFAULT_TILE,
    group: int | None = None,
    plant_substeps: int = 8,
    mesh=None,
    dtype=torch.float32,
    device=None,
) -> tuple[BatchSimResult, dict]:
    """Kinematic lap-tracking sweep: ``batch`` scenarios (perturbed plant
    parameters × start poses scattered around the lap start) tracking the
    ellipse lap at ``speed`` for ``steps`` steps on ``device`` (the card when
    ``None``), each step one
    fused tracker solve (:func:`batched_racing_policy`).

    The controller predicts with the nominal Euler model; the plant
    integrates the perturbed parameters with ``plant_substeps``-RK4, the
    reference's mismatch methodology. ``generator`` (a CPU
    ``torch.Generator``, seed 0 when ``None``) draws the plant parameters,
    then the start-pose noise, in the JAX package's order.

    ``backend``: ``"cuda"`` / ``"twin"`` (the tracker kernel), ``"pallas-hand"``
    (the parking kernel's tracking mode), ``"torch"`` (the per-scenario
    route), as :func:`batched_racing_policy`.

    Returns ``(BatchSimResult, summary)`` with the JAX package's summary
    keys and, on a kernel, ``mean_inner_iters`` (executed inner iterations
    per solve).
    """
    from ..experiments.racing import ellipse_reference

    base = VehicleParameters()
    _racing_route(backend, mesh, dtype, base, kinematic=True)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    plant_params = perturb_parameters(
        generator, base, batch, rel_scale=rel_scale, fields=perturb_fields,
        dtype=dtype, device=device,
    )
    ref = ellipse_reference(
        steps + N + 1, speed=speed, ts=ts, dynamic=False, dtype=dtype, device="cpu"
    )
    # start poses scattered around the lap start
    noise = (2.0 * torch.rand(batch, NX, generator=generator, dtype=dtype) - 1.0) * torch.tensor(
        [0.08, 0.08, 0.15, 0.05], dtype=dtype
    )
    x0s = ref[0] + noise
    x0s[:, 3] = torch.clamp(x0s[:, 3], 0.0, float(base.max_vel))
    ref, x0s = ref.to(device), x0s.to(device)
    policy = batched_racing_policy(
        ref, base, N=N, ts=ts, Q=Q, R=R, qn_scale=qn_scale, outer_iters=outer_iters,
        inner_iters=inner_iters, backend=backend, tile=tile, group=group, mesh=mesh,
        dtype=dtype,
    )
    plant = batched_plant(plant_params, ts, substeps=plant_substeps)
    res = simulate_batch(x0s, plant, steps, policy, policy.initial_carry(batch, device),
                         batched_dynamics=True)

    tail = res.logs["tracking_error"][steps // 4 :]  # steady state after the catch-up
    summary = {
        "batch": int(batch),
        "steps": int(steps),
        "speed": float(speed),
        "success_rate": res.logs["solver_success"].float().mean().item(),
        "mean_tracking_error": tail.mean().item(),
        "p95_tracking_error": torch.quantile(tail.flatten(), 0.95).item(),
        "max_tracking_error": tail.max().item(),
        "rel_scale": float(rel_scale),
        "backend": backend,
    }
    if "kernel_inner_iters" in res.logs:
        summary["mean_inner_iters"] = res.logs["kernel_inner_iters"].mean().item()
    return res, summary


def batched_dynamic_plant(plant_params: VehicleParameters, ts: float, substeps: int = 16):
    """``(B, 6) × (B, 2) → (B, 6)`` Pacejka plant: fine RK4 with
    per-scenario parameter fields broadcast over the batch."""
    f = lambda x, u: dynamic_bicycle_ode(plant_params, x, u)
    return rk4_fine(f, ts, substeps=substeps)


def batched_racing_dynamic_policy(
    ref: torch.Tensor,
    model_params: VehicleParameters | None = None,
    N: int = 15,
    ts: float = 0.05,
    pred_substeps: int = 4,
    outer_iters: int = 3,
    inner_iters: int = 8,
    backend: str = "cuda",
    tile: int = ilqr_factory.DEFAULT_TILE,
    group: int | None = None,
    mesh=None,
    dtype=torch.float32,
):
    """Batch-level Pacejka lap-tracking policy for :func:`simulate_batch`
    (the JAX ``racing_sweep_dynamic``'s policy): every step is one fused
    tracker solve of the whole batch, RK4 with ``pred_substeps`` substeps on
    the nominal ``model_params``, the dynamic tier's weights and an input
    box. Backends as :func:`batched_racing_policy` (no ``"pallas-hand"``);
    only the per-scenario route (``"torch"``) takes another dtype or a
    per-scenario model."""
    from ..experiments.racing import Q_DYNAMIC, QN_SCALE, R_DYNAMIC

    base = model_params if model_params is not None else VehicleParameters()
    backend = _racing_route(backend, mesh, dtype, base, kinematic=False)
    u_lims = (
        (float(base.min_drive), -float(base.max_steer)),
        (float(base.max_drive), float(base.max_steer)),
    )
    if backend == "torch":
        return _per_scenario_policy(ref, N, dtype, lambda w: dynamic_window_problem(
            base, w, ts, pred_substeps, u_lims, dtype), outer_iters, inner_iters)
    solve_fn = al_ilqr_dyn_solve_cuda if backend == "cuda" else al_ilqr_dyn_solve_twin
    model = model_tuple(base)
    weights = (tuple(Q_DYNAMIC), tuple(R_DYNAMIC), float(QN_SCALE))

    def policy(x_batch, t, carry):
        B = x_batch.shape[0]
        window = ref[t : t + N + 1]
        sol = solve_fn(
            x_batch, carry.reshape(B, N, NU), window[None].expand(B, N + 1, NX_DYNAMIC),
            N=N, ts=float(ts), substeps=pred_substeps, model=model, limits=u_lims,
            weights=weights, outer_iters=outer_iters, inner_iters=inner_iters,
            viol_tol=1e-4, tile=min(tile, math.ceil(B / 128) * 128), group=group,
        )
        return _tracking_step(sol, x_batch, window, N)

    policy.initial_carry = lambda batch, device=None: initial_warm_carry(batch, N, dtype, device)
    return policy


def dynamic_window_problem(params, windows, ts, pred_substeps, u_lims, dtype=torch.float32):
    """The Pacejka window-tracking problem of the per-scenario route
    (``racing_sweep_dynamic``'s ``"xla"`` solve in the JAX package): RK4
    with ``pred_substeps`` substeps on ``params``, the dynamic tier's
    weights, the input box; ``windows`` ``(B, N + 1, 6)``."""
    from ..experiments.racing import Q_DYNAMIC, QN_SCALE, R_DYNAMIC

    t = lambda a: torch.as_tensor(a, dtype=dtype, device=windows.device)
    lb_u, ub_u = t(u_lims[0]), t(u_lims[1])
    step = lambda pp, x, u: rk4_fine(
        lambda xx, uu: dynamic_bicycle_ode(pp, xx, uu), ts, substeps=pred_substeps)(x, u)
    return _window_tracking_problem(
        params, windows, step, Q_DYNAMIC, R_DYNAMIC, QN_SCALE,
        lambda x, u, p, s: torch.cat([u - ub_u, lb_u - u]), 2 * NU, dtype)


def racing_sweep_dynamic(
    batch: int,
    steps: int,
    generator: torch.Generator | None = None,
    N: int = 15,
    ts: float = 0.05,
    speed: float = 1.2,
    rel_scale: float = 0.05,
    perturb_fields=("df", "dr", "friction"),
    outer_iters: int = 3,
    inner_iters: int = 8,
    plant_substeps: int = 16,
    pred_substeps: int = 4,
    backend: str = "cuda",
    tile: int = ilqr_factory.DEFAULT_TILE,
    group: int | None = None,
    mesh=None,
    dtype=torch.float32,
    device=None,
) -> tuple[BatchSimResult, dict]:
    """Dynamic-tier (6-state Pacejka) lap-tracking sweep at ``speed``
    beyond the kinematic cap: tire peak factors and friction perturbed per
    scenario while the controller keeps the nominal model (grip mismatch).
    ``friction`` never enters the Pacejka model, so perturbing it changes
    nothing; the JAX package draws it all the same, and so does this port.

    Prediction is RK4 with ``pred_substeps`` substeps, the plant RK4 with
    ``plant_substeps``. Draws as :func:`racing_sweep`. Returns
    ``(BatchSimResult, summary)`` with the JAX package's summary keys and,
    on the kernel, ``mean_inner_iters``.
    """
    from ..experiments.racing import ellipse_reference

    base = VehicleParameters()
    _racing_route(backend, mesh, dtype, base, kinematic=False)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    plant_params = perturb_parameters(
        generator, base, batch, rel_scale=rel_scale, fields=perturb_fields,
        dtype=dtype, device=device,
    )
    ref = ellipse_reference(
        steps + N + 1, speed=speed, ts=ts, dynamic=True, dtype=dtype, device="cpu"
    )
    noise = (2.0 * torch.rand(batch, NX_DYNAMIC, generator=generator, dtype=dtype) - 1.0) * (
        torch.tensor([0.05, 0.05, 0.1, 0.05, 0.01, 0.05], dtype=dtype)
    )
    x0s = (ref[0] + noise).to(device)
    ref = ref.to(device)
    policy = batched_racing_dynamic_policy(
        ref, base, N=N, ts=ts, pred_substeps=pred_substeps, outer_iters=outer_iters,
        inner_iters=inner_iters, backend=backend, tile=tile, group=group, mesh=mesh,
        dtype=dtype,
    )
    plant = batched_dynamic_plant(plant_params, ts, substeps=plant_substeps)
    res = simulate_batch(x0s, plant, steps, policy, policy.initial_carry(batch, device),
                         batched_dynamics=True)

    tail = res.logs["tracking_error"][steps // 4 :]
    summary = {
        "batch": int(batch),
        "steps": int(steps),
        "speed": float(speed),
        "model": "dynamic-pacejka",
        "success_rate": res.logs["solver_success"].float().mean().item(),
        "mean_tracking_error": tail.mean().item(),
        "p95_tracking_error": torch.quantile(tail.flatten(), 0.95).item(),
        "rel_scale": float(rel_scale),
        "backend": backend,
    }
    if "kernel_inner_iters" in res.logs:
        summary["mean_inner_iters"] = res.logs["kernel_inner_iters"].mean().item()
    return res, summary


# ---------------------------------------------------------------------------
# Offset-free tiers: crosswind racing and slope parking on the AL-iLQR
# kernel's offset and input-reference modes
# ---------------------------------------------------------------------------


def _window_solver(backend, base, N, ts, weights, outer_iters, inner_iters, tile, group,
                   dtype):
    """``solve(x, u_warm (B, N·2), refs, dist, urefs, problem)`` of the two
    offset-free sweeps: the parking kernel with all three operands (``"cuda"``,
    ``"twin"``; float32 only, else ``ValueError``), or the per-scenario route
    on ``problem()``'s ``(prob, constraints)`` (``"torch"``, any dtype). The kernel's state rows are boxed at ±100, so that
    only the input box binds, as in the per-scenario problems."""
    if backend == "xla":
        raise ValueError(XLA_NAME)
    if backend not in ("cuda", "twin", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "torch":
        _refuse_kernel(backend, dtype, set())
    geom, _ = parking_geometry(base, None)
    limits = ((-100.0,) * 4, (100.0,) * 4,
              (float(base.min_drive), -float(base.max_steer)),
              (float(base.max_drive), float(base.max_steer)))
    solve_fn = al_ilqr_solve_cuda if backend == "cuda" else al_ilqr_solve_twin

    def solve(x, u_warm, refs, dist, urefs, problem):
        B = x.shape[0]
        if backend == "torch":
            prob, cons = problem()
            return al_ilqr_solve(prob, cons, 2 * NU, x, u_init=u_warm.reshape(B, N, NU),
                                 outer_iters=outer_iters, inner_iters=inner_iters, viol_tol=1e-4)
        return solve_fn(
            x, u_warm.reshape(B, N, NU), _per_scenario(base.acceleration, B, x.dtype, x.device),
            _per_scenario(base.friction, B, x.dtype, x.device), refs.contiguous(),
            dist.contiguous(), urefs.contiguous(), N=N, ts=float(ts), geom=geom,
            limits=limits, weights=weights, n_circles=0, outer_iters=outer_iters,
            inner_iters=inner_iters, viol_tol=1e-4, tile=min(tile, math.ceil(B / 128) * 128),
            group=group,
        )

    return solve


def _loop_step(sol, B, N, aux):
    """The policy's u0, shifted warm start and logs from a window solve."""
    aux = {"solver_success": sol.converged, "viol": sol.viol, **aux}
    if hasattr(sol, "inner_iters_executed"):
        aux["kernel_inner_iters"] = sol.inner_iters_executed
    warm = torch.cat([sol.us[:, 1:], sol.us[:, -1:]], dim=1).reshape(B, N * NU)
    return sol.us[:, 0], warm, aux


def _ekf_carry0(ctrl, x0s):
    """``(ẑ (B, nx+nd), P (B, ·, ·), u_warm (B, N·2))`` from the starts."""
    B = x0s.shape[0]
    z0 = torch.cat([x0s, torch.zeros(B, ctrl.nd, dtype=x0s.dtype, device=x0s.device)], dim=1)
    P0 = ctrl.initial_P().to(x0s.device).expand(B, -1, -1).contiguous()
    return z0, P0, initial_warm_carry(B, ctrl.N, x0s.dtype, x0s.device)


def wind_scenarios(generator: torch.Generator, batch: int, ref0, wind: float = 0.004,
                   wind_rel_spread: float = 0.5, dtype=torch.float32):
    """Starts and persistent winds of :func:`wind_sweep`, on the CPU: a wind
    of random direction and magnitude ``wind · U[1 − spread, 1 + spread]``
    (a per-step position drift, ``(B, 4)`` with the speed and heading rows
    zero), then start poses scattered around ``ref0`` (speed kept in [0,
    0.5])."""
    ang = 2.0 * math.pi * torch.rand(batch, generator=generator, dtype=dtype)
    lo, hi = 1.0 - wind_rel_spread, 1.0 + wind_rel_spread
    mag = wind * (lo + (hi - lo) * torch.rand(batch, generator=generator, dtype=dtype))
    w_full = torch.zeros(batch, NX, dtype=dtype)
    w_full[:, 0], w_full[:, 1] = mag * torch.cos(ang), mag * torch.sin(ang)
    noise = (2.0 * torch.rand(batch, NX, generator=generator, dtype=dtype) - 1.0) * torch.tensor(
        [0.05, 0.05, 0.1, 0.03], dtype=dtype)
    x0s = torch.as_tensor(ref0, dtype=dtype).cpu() + noise
    x0s[:, 3] = torch.clamp(x0s[:, 3], 0.0, float(VehicleParameters().max_vel))
    return x0s, w_full


def wind_sweep(
    batch: int,
    steps: int,
    generator: torch.Generator | None = None,
    N: int = 15,
    ts: float = 0.05,
    speed: float = 0.35,
    wind: float = 0.004,
    wind_rel_spread: float = 0.5,
    compensate: bool = True,
    outer_iters: int = 3,
    inner_iters: int = 8,
    backend: str = "cuda",
    tile: int = DEFAULT_TILE,
    group: int | None = None,
    mesh=None,
    dtype=torch.float32,
    device=None,
    scenarios=None,
) -> tuple[BatchSimResult, dict]:
    """Offset-free racing under per-scenario crosswinds, on ``device`` (the
    card when ``None``): the output-feedback stack of
    :class:`..solvers.offset_free_nmpc.DisturbanceCompensatedTracking`
    batched. Per step: the augmented EKF's correction (``vmap``), the window
    re-projected and the input reference per scenario, the window solve on
    the parking kernel with ``refs``, ``dist = B_d d̂`` and ``urefs``, the
    EKF's prediction. ``compensate=False`` is the ablation: the plain
    tracking solve (zero offset and input reference) under the same winds.

    ``backend``: ``"cuda"`` (the kernel; its twin for CPU tensors),
    ``"twin"``, or ``"torch"`` (the per-scenario route on the controller's
    own window problems, any dtype). Scenarios from :func:`wind_scenarios`
    (``generator``, seed 0 when ``None``) or ``scenarios = (x0s (B, 4),
    w_full (B, 4))``. Returns ``(BatchSimResult, summary)`` with the JAX
    package's keys (and ``mean_inner_iters`` on the kernel)."""
    from ..experiments.racing import Q_KINEMATIC, QN_SCALE, R_KINEMATIC, ellipse_reference
    from ..solvers.offset_free_nmpc import DisturbanceCompensatedTracking

    if mesh is not None:
        raise NotImplementedError("device meshes are not ported yet: ROADMAP S7.1")
    device = resolve_device(device)
    base = VehicleParameters()
    weights = (tuple(Q_KINEMATIC), tuple(R_KINEMATIC), float(QN_SCALE))
    solve = _window_solver(backend, base, N, ts, weights, outer_iters, inner_iters, tile, group,
                           dtype)
    ref = ellipse_reference(steps + N + 1, speed=speed, ts=ts, dynamic=False, dtype=dtype,
                            device="cpu")
    if scenarios is None:
        generator = torch.Generator().manual_seed(0) if generator is None else generator
        scenarios = wind_scenarios(generator, batch, ref[0], wind, wind_rel_spread, dtype)
    x0s, w_full = (torch.as_tensor(a).to(dtype=dtype, device=device) for a in scenarios)
    ref = ref.to(device)
    ctrl = DisturbanceCompensatedTracking(
        euler(lambda x, u: kinematic_bicycle_ode(base, x, u), ts), nx=NX, nu=NU, N=N,
        Q=Q_KINEMATIC, R=R_KINEMATIC, QN=[QN_SCALE * q for q in Q_KINEMATIC],
        u_lb=[base.min_drive, -base.max_steer], u_ub=[base.max_drive, base.max_steer],
        ref_traj=ref, ts=ts, outer_iters=outer_iters, inner_iters=inner_iters, dtype=dtype,
        device=device,
    )
    correct_b = torch.func.vmap(ctrl._ekf_correct)
    predict_b = torch.func.vmap(ctrl._ekf_predict)

    def policy(y, t, carry):
        z_pred, P, u_warm = carry
        B = y.shape[0]
        window = ref[t : t + N + 1]
        if compensate:
            z, Pc = correct_b(z_pred, P, y)
            x_hat, d_hat = z[:, :NX], z[:, NX:]
            wins, urefs = ctrl.prepared_windows(window, d_hat)
        else:
            x_hat, d_hat = y, torch.zeros(B, ctrl.nd, dtype=dtype, device=y.device)
            wins = window[None].expand(B, N + 1, NX)
            urefs = torch.zeros(B, N, NU, dtype=dtype, device=y.device)
        sol = solve(x_hat, u_warm, wins, d_hat @ ctrl.Bd.T, urefs,
                    lambda: ctrl.window_problem(wins, d_hat, urefs))
        u0, warm, aux = _loop_step(sol, B, N, {
            "tracking_error": torch.linalg.vector_norm(y[:, :2] - window[0, :2], dim=-1),
            "d_hat": d_hat,
        })
        if compensate:
            z_pred, P = predict_b(z, Pc, u0)
        return u0, (z_pred, P, warm), aux

    plant_base = rk4(lambda x, u: kinematic_bicycle_ode(base, x, u), ts)
    res = simulate_batch(x0s, lambda x, u: plant_base(x, u) + w_full, steps, policy,
                         _ekf_carry0(ctrl, x0s), batched_dynamics=True)

    tail = res.logs["tracking_error"][-max(10, steps // 3):]
    d_last = res.logs["d_hat"][-1]
    summary = {
        "batch": int(batch),
        "steps": int(steps),
        "wind_per_step": float(wind),
        "compensate": bool(compensate),
        "success_rate": res.logs["solver_success"].float().mean().item(),
        "steady_tracking_error": tail.mean().item(),
        "p95_steady_tracking_error": torch.quantile(tail.flatten().double(), 0.95).item(),
        # the EKF's identification: position rows of the estimate vs the drift
        "wind_estimate_rms_error": (d_last[:, :2] - w_full[:, :2]).square().mean().sqrt().item(),
    }
    if "kernel_inner_iters" in res.logs:
        summary["mean_inner_iters"] = res.logs["kernel_inner_iters"].mean().item()
    return res, summary


def offset_free_scenarios(generator: torch.Generator, batch: int, slope_range=(0.15, 0.45),
                          friction_scale_range=(0.7, 0.9), dtype=torch.float32):
    """Starts, slopes and friction scales of :func:`offset_free_sweep`, on
    the CPU: a slope (a persistent deceleration) and a friction scale per
    scenario, then starts scattered around the reference's parking start
    ``(0.6, −0.25, 0, 0)``."""
    u = lambda lo_hi: lo_hi[0] + (lo_hi[1] - lo_hi[0]) * torch.rand(
        batch, generator=generator, dtype=dtype)
    slope, fscale = u(slope_range), u(friction_scale_range)
    noise = (2.0 * torch.rand(batch, NX, generator=generator, dtype=dtype) - 1.0) * torch.tensor(
        [0.1, 0.1, 0.2, 0.03], dtype=dtype)
    return torch.tensor([0.6, -0.25, 0.0, 0.0], dtype=dtype) + noise, slope, fscale


def offset_free_sweep(
    batch: int,
    steps: int,
    generator: torch.Generator | None = None,
    N: int = 12,
    ts: float = 0.05,
    slope_range=(0.15, 0.45),
    friction_scale_range=(0.7, 0.9),
    compensate: bool = True,
    outer_iters: int = 5,
    inner_iters: int = 10,
    backend: str = "cuda",
    tile: int = DEFAULT_TILE,
    group: int | None = None,
    plant_substeps: int = 16,
    dtype=torch.float32,
    device=None,
    scenarios=None,
) -> tuple[BatchSimResult, dict]:
    """Offset-free nonlinear parking under per-scenario slope and friction
    mismatch (the reference's exercise-5 loop), on ``device`` (the card when
    ``None``): :class:`..solvers.offset_free_nmpc.OffsetFreeNMPC` batched.
    Per step: the augmented EKF's correction, the damped-Newton target
    ``(x_s, u_s)`` per scenario, the solve on the parking kernel with ``refs
    = x_s`` on every stage, ``urefs = u_s`` and ``dist = B_d d̂``, the EKF's
    prediction. ``compensate=False`` forces ``d̂ = 0`` (the nominal
    ablation).

    ``backend`` as :func:`wind_sweep`. Scenarios from
    :func:`offset_free_scenarios` (``generator``, seed 0 when ``None``) or
    ``scenarios = (x0s (B, 4), slope (B,), friction_scale (B,))``. The plant
    is fine RK4 (``plant_substeps``) of the bicycle with the scenario's
    friction and the slope's deceleration. Returns ``(BatchSimResult,
    summary)`` with the JAX package's keys."""
    from ..solvers.offset_free_nmpc import OffsetFreeNMPC

    device = resolve_device(device)
    base = VehicleParameters()
    R_OF = (1.0, 0.01)
    solve = _window_solver(backend, base, N, ts, (tuple(Q_SOL), R_OF, float(QN_SCALE_SOL)),
                           outer_iters, inner_iters, tile, group, dtype)
    if scenarios is None:
        generator = torch.Generator().manual_seed(0) if generator is None else generator
        scenarios = offset_free_scenarios(generator, batch, slope_range, friction_scale_range,
                                          dtype)
    x0s, slope, fscale = (torch.as_tensor(a).to(dtype=dtype, device=device) for a in scenarios)
    ctrl = OffsetFreeNMPC(
        euler(lambda x, u: kinematic_bicycle_ode(base, x, u), ts), nx=NX, nu=NU, N=N,
        Q=Q_SOL, R=R_OF, QN=[QN_SCALE_SOL * q for q in Q_SOL],
        u_lb=[base.min_drive, -base.max_steer], u_ub=[base.max_drive, base.max_steer],
        r=[0.0, 0.0], outer_iters=outer_iters, inner_iters=inner_iters, dtype=dtype,
        device=device,
    )
    correct_b = torch.func.vmap(ctrl._ekf_correct)
    predict_b = torch.func.vmap(ctrl._ekf_predict)
    target_b = torch.func.vmap(lambda d, xg: ctrl.solve_target(d, x_guess=xg))

    def policy(y, t, carry):
        z_pred, P, u_warm = carry
        B = y.shape[0]
        z, Pc = correct_b(z_pred, P, y)
        x_hat, d_hat = z[:, :NX], z[:, NX:]
        if not compensate:
            d_hat = torch.zeros_like(d_hat)
        x_s, u_s, t_res = target_b(d_hat, x_hat)
        sol = solve(x_hat, u_warm, x_s[:, None].expand(B, N + 1, NX), d_hat @ ctrl.Bd.T,
                    u_s[:, None].expand(B, N, NU),
                    lambda: ctrl.shifted_problem(d_hat, x_s, u_s))
        u0, warm, aux = _loop_step(sol, B, N, {
            "d_hat": d_hat, "target_residual": t_res,
            "dist_to_target": torch.linalg.vector_norm(y[:, :2], dim=-1),
        })
        z_next, P_next = predict_b(z, Pc, u0)
        return u0, (z_next, P_next, warm), aux

    plant_params = dataclasses.replace(base, friction=base.friction * fscale)
    drift = torch.zeros(x0s.shape[0], NX, dtype=dtype, device=device)
    drift[:, 3] = -slope
    plant = rk4_fine(lambda x, u: kinematic_bicycle_ode(plant_params, x, u) + drift, ts,
                     substeps=plant_substeps)
    res = simulate_batch(x0s, plant, steps, policy, _ekf_carry0(ctrl, x0s), batched_dynamics=True)

    final_dist = torch.linalg.vector_norm(res.states[-1][:, :2], dim=-1)
    d_last = res.logs["d_hat"][-1]
    summary = {
        "batch": int(batch),
        "steps": int(steps),
        "compensate": bool(compensate),
        "success_rate": res.logs["solver_success"].float().mean().item(),
        "median_final_dist": torch.quantile(final_dist, 0.5).item(),
        "p95_final_dist": torch.quantile(final_dist, 0.95).item(),
        "d_hat_rms_error": (d_last[:, 3] + slope * ts).square().mean().sqrt().item(),
    }
    if "kernel_inner_iters" in res.logs:
        summary["mean_inner_iters"] = res.logs["kernel_inner_iters"].mean().item()
    return res, summary


# ---------------------------------------------------------------------------
# The robust, stochastic and output-feedback tiers of the session-2 problem,
# on the fused ADMM kernel
# ---------------------------------------------------------------------------


def _uniform(generator, shape, lo, hi, dtype=torch.float64):
    return lo + (hi - lo) * torch.rand(shape, generator=generator, dtype=dtype)


def tube_scenarios(generator: torch.Generator, batch: int, steps: int, problem, tube, w_half):
    """Starts and corner disturbances of :func:`tube_sweep`, on the CPU.

    Feasible starts: ``v`` capped below the tightened v-box and ``p`` far
    enough from the wall that the worst-case braking (``u_min`` tightened,
    the disturbance pushing forward every step) still stops before it. Each
    step's disturbance is a corner of the box, ``±w_half``."""
    zm, um = tube.z_margin.double().cpu(), tube.u_margin.double().cpu()
    v_hi = min(15.0, float(problem.v_max - zm[1] - 1.0))
    u_eff = abs(float(problem.u_min)) - float(um[0]) - float(w_half[1]) / problem.Ts
    v = _uniform(generator, (batch,), -15.0, v_hi)
    vp = torch.clamp(v, min=0.0)
    stop_dist = vp**2 / (2.0 * max(u_eff, 1.0))
    p_hi = float(problem.p_max - zm[0]) - 2.0 - stop_dist - vp * problem.Ts
    p = -140.0 + torch.rand(batch, generator=generator, dtype=torch.float64) * (p_hi + 140.0)
    signs = 2.0 * torch.randint(0, 2, (steps, batch, 2), generator=generator) - 1.0
    w = signs * torch.as_tensor(w_half, dtype=torch.float64)
    return torch.stack([p, v], dim=1), w


def _sorted(problem, x0s, w, dtype, device):
    """The scenarios in the compaction order (the disturbances follow their
    lanes), as ``dtype`` on ``device``."""
    x0s = x0s.to(dtype=dtype, device=device)
    w = w.to(dtype=dtype, device=device)
    order = torch.argsort(boundary_compaction_key(problem.p_max, x0s), stable=True)
    return x0s[order], w[:, order]


def tube_sweep(
    batch: int,
    steps: int,
    generator: torch.Generator | None = None,
    N: int = 20,
    w_half=(0.0, 0.45),
    iters: int = 100,
    tile: int = DEFAULT_TILE,
    backend: str = "cuda",
    rho: float = 0.1,
    polish: bool = False,
    mesh=None,
    dtype=torch.float32,
    device=None,
    scenarios=None,
) -> tuple[BatchSimResult, dict]:
    """Batched rigid-tube robust MPC of the session-2 braking wall at N=20
    under adversarial corner disturbances, on ``device`` (the card when
    ``None``): the nominal tightened solve through the fused ADMM kernel
    (``backend="cuda"``; ``"twin"`` and ``"xla"`` as
    :meth:`..solvers.linear_mpc.LinearMPC.batched_policy`), the tube
    correction two batched products.

    The scenarios come from :func:`tube_scenarios` with ``generator`` (a CPU
    generator, seed 0 when ``None``), or from ``scenarios = (x0s (B, 2),
    w (steps, B, 2))``. They are sorted once by
    :func:`boundary_compaction_key`, the disturbances following their lanes;
    a 4× adaptive presolve warms step 0; the steps run with ρ fixed
    (``max_rho_moves=0``) and ``polish``. Returns ``(BatchSimResult,
    summary)`` with the JAX package's keys."""
    from ..solvers.linear_mpc import session2_problem
    from ..solvers.tube import make_tube_mpc
    from ..utils.precision import set_solver_precision

    if mesh is not None:
        raise NotImplementedError("mesh sharding is not ported yet: ROADMAP S7.1")
    set_solver_precision()
    device = resolve_device(device)
    problem = session2_problem(N=N)
    tube = make_tube_mpc(problem, w_half, iters=iters, dtype=dtype, rho=rho, device=device)
    system = problem.system(dtype, device)
    if scenarios is None:
        generator = torch.Generator().manual_seed(0) if generator is None else generator
        scenarios = tube_scenarios(generator, batch, steps, problem, tube, w_half)
    x0s, w = _sorted(problem, *scenarios, dtype, device)
    policy = tube.batched_policy(backend=backend, tile=tile, max_rho_moves=0, polish=polish)
    inner_warm = tube.inner.presolve_batch_carry(x0s, iters_mult=4, backend=backend, tile=tile)
    res = simulate_batch(x0s, system, steps, policy, (x0s, inner_warm), batched_dynamics=True,
                         disturbances=w)

    x_lo = torch.tensor([problem.p_min, problem.v_min], dtype=dtype, device=device)
    x_hi = torch.tensor([problem.p_max, problem.v_max], dtype=dtype, device=device)
    viol = ((res.states > x_hi + 1e-4) | (res.states < x_lo - 1e-4)).any(dim=2).any(dim=0)
    summary = {
        "batch": int(batch),
        "steps": int(steps),
        "success_rate": res.logs["solver_success"].float().mean().item(),
        "tube_ok_rate": res.logs["tube_ok"].float().mean().item(),
        "original_box_violation_frac": viol.float().mean().item(),
        "backend": backend,
    }
    return res, summary


def stochastic_scenarios(generator: torch.Generator, batch: int, steps: int, sigma_v: float):
    """Starts and noise of :func:`stochastic_sweep`, on the CPU: ``p`` in
    [−130, −70], ``v`` in [10, 20] (the cruise toward the v_max bound),
    Gaussian velocity noise of deviation ``sigma_v``."""
    p = _uniform(generator, (batch,), -130.0, -70.0)
    v = _uniform(generator, (batch,), 10.0, 20.0)
    w = torch.zeros(steps, batch, 2, dtype=torch.float64)
    w[:, :, 1] = sigma_v * torch.randn(steps, batch, generator=generator, dtype=torch.float64)
    return torch.stack([p, v], dim=1), w


def stochastic_sweep(
    batch: int,
    steps: int,
    generator: torch.Generator | None = None,
    N: int = 20,
    sigma_v: float = 0.12,
    eps: float = 0.1,
    iters: int = 200,
    tile: int = DEFAULT_TILE,
    backend: str = "cuda",
    rho: float = 0.01,
    polish: bool = False,
    dtype=torch.float32,
    device=None,
    scenarios=None,
) -> tuple[BatchSimResult, dict]:
    """Batched chance-constrained MPC under Gaussian velocity noise on the
    v_max-riding cruise, on ``device`` (the card when ``None``): a
    Monte-Carlo check of the ε-level on the fused ADMM kernel. Reports the
    violation rate among the near-limit steps (``v > v_max − 3σ``), which the
    chance constraint holds at or below ``eps``.

    Scenarios from :func:`stochastic_scenarios` (``generator``, seed 0 when
    ``None``) or ``scenarios = (x0s, w)``; sorted by the compaction key, a 4×
    presolve, ρ fixed and ``polish`` on the steps, as :func:`tube_sweep`."""
    from ..solvers.linear_mpc import session2_problem
    from ..solvers.stochastic import make_stochastic_mpc
    from ..utils.precision import set_solver_precision

    set_solver_precision()
    device = resolve_device(device)
    problem = session2_problem(N=N)
    ctrl = make_stochastic_mpc(problem, [[0.0, 0.0], [0.0, sigma_v**2]], eps=eps, iters=iters,
                               dtype=dtype, rho=rho, device=device)
    system = problem.system(dtype, device)
    if scenarios is None:
        generator = torch.Generator().manual_seed(0) if generator is None else generator
        scenarios = stochastic_scenarios(generator, batch, steps, sigma_v)
    x0s, w = _sorted(problem, *scenarios, dtype, device)
    policy = ctrl.batched_policy(backend=backend, tile=tile, max_rho_moves=0, polish=polish)
    inner_warm = ctrl.inner.presolve_batch_carry(x0s, iters_mult=4, backend=backend, tile=tile)
    res = simulate_batch(x0s, system, steps, policy, inner_warm, batched_dynamics=True,
                         disturbances=w)

    v = res.states[1:, :, 1]
    near = v > problem.v_max - 3.0 * sigma_v
    viol = v > problem.v_max
    n_near = max(near.sum().item(), 1.0)
    summary = {
        "batch": int(batch),
        "steps": int(steps),
        "eps": float(eps),
        "success_rate": res.logs["solver_success"].float().mean().item(),
        "near_limit_violation_rate": viol.sum().item() / n_near,
        "backend": backend,
    }
    return res, summary


def mhe_loop_scenarios(generator: torch.Generator, batch: int, steps: int, M: int, ts: float,
                       process_sigma: float, meas_sigma: float):
    """Starts, process noise and measurement noise of :func:`mhe_loop_sweep`,
    on the CPU. The starts keep the backward-consistent warm-up history
    inside the MHE's box and leave room to brake before the wall."""
    v0 = _uniform(generator, (batch,), -10.0, 20.0)
    hist = float(M * ts)
    p_lo = -145.0 + hist * torch.clamp(v0, min=0.0)
    p_hi = torch.clamp(-5.0 - hist * torch.clamp(-v0, min=0.0), max=-30.0)
    p0 = p_lo + torch.rand(batch, generator=generator, dtype=torch.float64) * (p_hi - p_lo)
    ws = process_sigma * torch.randn(steps, batch, 2, generator=generator, dtype=torch.float64)
    vs = meas_sigma * torch.randn(steps, batch, 1, generator=generator, dtype=torch.float64)
    return torch.stack([p0, v0], dim=1), ws, vs


def mhe_loop_sweep(
    batch: int,
    steps: int,
    generator: torch.Generator | None = None,
    N: int = 20,
    M: int = 10,
    meas_sigma: float = 0.1,
    process_sigma: float = 0.02,
    mpc_iters: int = 200,
    mpc_rho: float = 0.02,
    mhe_iters: int = 100,
    tile: int = DEFAULT_TILE,
    backend: str = "cuda",
    dtype=torch.float32,
    device=None,
    scenarios=None,
) -> tuple[BatchSimResult, dict]:
    """Batched MHE-in-the-loop output feedback: the session-2 braking loop
    closed on noisy position measurements, on ``device`` (the card when
    ``None``), both halves on the fused ADMM kernel each step: the bounded
    linear-MHE windows (:meth:`..estimation.MHE.solve_batch`, the physical
    box, warm-started window to window; n + m = 44) and the slack-softened
    session-2 MPC (n + m = 200 at N = 20, the kernel's wide mode).
    ``backend="twin"`` runs both on the twin.

    Scenarios from :func:`mhe_loop_scenarios` (``generator``, seed 0 when
    ``None``) or ``scenarios = (x0s, ws (steps, B, 2), vs (steps, B, 1))``.
    The window buffers start from a backward-consistent constant-velocity
    history, the MPC from a 4× presolve."""
    from ..estimation import make_mhe
    from ..models.linear import LinearSystem
    from ..solvers.linear_mpc import make_linear_mpc, session2_problem
    from ..utils.precision import set_solver_precision

    set_solver_precision()
    device = resolve_device(device)
    problem = session2_problem(N=N)
    system = problem.system(dtype, device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    C = t([[1.0, 0.0]])  # position-only measurement
    eye2 = torch.eye(2, dtype=dtype, device=device)
    # the MHE's hard box is the physical envelope, 5 m / 5 m/s over the
    # operating box: the soft MPC may exceed the operating box transiently
    mhe = make_mhe(
        LinearSystem(A=system.A, B=system.B, C=C), process_sigma**2 * eye2,
        t([[meas_sigma**2]]), P0=0.1 * eye2, M=M,
        x_min=t([problem.p_min - 5.0, problem.v_min - 5.0]),
        x_max=t([problem.p_max + 5.0, problem.v_max + 5.0]), iters=mhe_iters,
    )
    ctrl = make_linear_mpc(problem, iters=mpc_iters, dtype=dtype, device=device,
                           soft_state=True, slack_weight=1e4, rho=mpc_rho)
    mpc_policy = ctrl.batched_policy(backend=backend, tile=tile)
    if scenarios is None:
        generator = torch.Generator().manual_seed(0) if generator is None else generator
        scenarios = mhe_loop_scenarios(generator, batch, steps, M, problem.Ts, process_sigma,
                                       meas_sigma)
    x0s, ws, vs = (a.to(dtype=dtype, device=device) for a in scenarios)
    A, B = system.A, system.B

    def policy(x_batch, step, carry):
        ys_buf, us_buf, xbar, mpc_carry, mhe_warm = carry
        y = x_batch @ C.T + vs[step]
        ys_buf = torch.cat([ys_buf[:, 1:], y[:, None]], dim=1)
        x_t, X, w, sol = mhe.solve_batch(xbar, us_buf, ys_buf, backend=backend, tile=tile,
                                         warm=mhe_warm)
        u, mpc_carry, mpc_aux = mpc_policy(x_t, step, mpc_carry)
        # frozen-arrival recursion (mhe_trajectory's), batched
        xbar_next = X[:, 0] @ A.T + u @ B.T + w[:, 0]
        us_buf = torch.cat([us_buf[:, 1:], u[:, None]], dim=1)
        aux = {
            "solver_success": mpc_aux["solver_success"],
            "mhe_converged": sol.converged,
            "state_estimate": x_t,
        }
        return u, (ys_buf, us_buf, xbar_next, mpc_carry, (sol.x, sol.y)), aux

    # warm-up buffers: a constant-velocity history that ends at x0, with zero
    # input and zero noise, which the model represents exactly
    offs = (M - torch.arange(M + 1, dtype=dtype, device=device)) * problem.Ts
    ys_buf0 = (x0s[:, 0:1] - offs[None, :] * x0s[:, 1:2])[:, :, None]
    us_buf0 = torch.zeros(batch, M, 1, dtype=dtype, device=device)
    # the arrival mean is that of the window's head (its oldest state)
    xbar0 = torch.stack([x0s[:, 0] - M * problem.Ts * x0s[:, 1], x0s[:, 1]], dim=1)
    mhe_warm0 = (torch.zeros(batch, mhe.op.P.shape[0], dtype=dtype, device=device),
                 torch.zeros(batch, mhe.op.A_c.shape[0], dtype=dtype, device=device))
    mpc_warm0 = ctrl.presolve_batch_carry(x0s, iters_mult=4, backend=backend, tile=tile)
    carry0 = (ys_buf0, us_buf0, xbar0, mpc_warm0, mhe_warm0)
    res = simulate_batch(x0s, system, steps, policy, carry0, batched_dynamics=True,
                         disturbances=ws)

    # the step-t window end estimates the pre-step state (the one measured)
    tail = (res.logs["state_estimate"] - res.states[:-1])[M + 2:]
    summary = {
        "batch": int(batch),
        "steps": int(steps),
        "M": int(M),
        "success_rate": res.logs["solver_success"].float().mean().item(),
        "mhe_converged_rate": res.logs["mhe_converged"].float().mean().item(),
        "est_rmse_pos": tail[..., 0].square().mean().sqrt().item(),
        "est_rmse_vel": tail[..., 1].square().mean().sqrt().item(),
        # the mean of the two middle values for an even count, as jnp.median
        "median_final_pos": torch.quantile(res.states[-1][:, 0].abs(), 0.5).item(),
    }
    return res, summary


# ---------------------------------------------------------------------------
# the benchmark models' loiter sweeps (planar quadrotor, thrust cluster) on
# the fused tracker kernel
# ---------------------------------------------------------------------------

QUADROTOR_WEIGHTS = ((5.0, 5.0, 1.0, 0.5, 0.5, 0.1), (0.02, 0.02), 10.0)
QUADROTOR_TILT = 0.5  # the tilt state box |θ| ≤ 0.5; the other states are boxed at ±50
THRUSTER_WEIGHTS = ((5.0, 5.0, 5.0, 0.5, 0.5, 0.5), (0.02,) * 4, 10.0)
THRUSTER_U_MAX = 6.0


def loiter_reference(n: int, radius: float = 1.0, period: float = 12.0, ts: float = 0.1,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """``(n, 6)`` loiter circle of ``radius`` flown in ``period`` seconds,
    sampled every ``ts``: ``(p₁, p₂, 0, v₁, v₂, 0)`` with ``p₁ = r sin ωt``,
    ``p₂ = r (1 − cos ωt)`` (the quadrotor's (x, z), the thrust cluster's
    (x, y)), as the JAX sweeps build it. Computed on the CPU, returned on
    ``device`` (the card when ``None``)."""
    t = torch.arange(n, dtype=dtype) * ts
    om = 2.0 * math.pi / period
    zero = torch.zeros_like(t)
    ref = torch.stack([
        radius * torch.sin(om * t), radius * (1.0 - torch.cos(om * t)), zero,
        radius * om * torch.cos(om * t), radius * om * torch.sin(om * t), zero,
    ], dim=-1)
    return ref.to(resolve_device(device))


def batched_quadrotor_plant(plant_params, ts: float, substeps: int = 8):
    """``(B, 6) × (B, 2) → (B, 6)`` planar-quadrotor plant: fine RK4 with each
    scenario's ``(mass, inertia, arm)`` ``(B,)`` each (the JAX
    ``quadrotor_sweep``'s per-scenario plant, on the batch)."""
    m, inr, arm = plant_params
    grav = QUADROTOR_PARAMS[3]

    def ode(x, u):
        s, c = torch.sin(x[:, 2]), torch.cos(x[:, 2])
        thrust = u[:, 0] + u[:, 1]
        return torch.stack([
            x[:, 3], x[:, 4], x[:, 5],
            -thrust * s / m, thrust * c / m - grav, (u[:, 0] - u[:, 1]) * arm / inr,
        ], dim=-1)

    return rk4_fine(ode, ts, substeps=substeps)


def batched_thruster_plant(plant_params, ts: float, substeps: int = 8):
    """``(B, 6) × (B, 4) → (B, 6)`` thrust-cluster plant: fine RK4 with each
    scenario's ``(mass, c₁, c₂)`` ``(B,)`` each (the JAX ``thruster_sweep``'s
    per-scenario plant, on the batch)."""
    m, c1, c2 = (p[:, None] for p in plant_params)
    grav = THRUSTER_PARAMS[1]
    dirs = torch.tensor(thruster_directions(THRUSTER_PARAMS[4]), dtype=m.dtype, device=m.device)
    gvec = torch.tensor([0.0, 0.0, grav], dtype=m.dtype, device=m.device)

    def ode(x, u):
        v = x[:, 3:]
        sp = torch.sqrt((v * v).sum(dim=-1, keepdim=True) + 1e-9)
        f = (u @ dirs) / m - gvec
        return torch.cat([v, f - c1 * v - c2 * sp * v], dim=-1)

    return rk4_fine(ode, ts, substeps=substeps)


def _loiter_policy(ref, model, N, ts, pred_substeps, limits, state_limits, weights,
                   outer_iters, inner_iters, backend, tile, group, hover, dtype):
    """A loiter tracking policy: every step one fused tracker solve of the
    whole batch on the window ``ref[t : t + N + 1]``, RK4 prediction with the
    nominal model, the solved controls shifted one stage as the carry."""
    if backend == "xla":
        raise ValueError("backend='xla' is the JAX package's name; the loiter sweeps run on "
                         "the tracker kernel, backend='cuda' (or its twin, 'twin')")
    if backend not in ("cuda", "twin"):
        raise ValueError(f"unknown backend {backend!r}")
    if dtype != torch.float32:
        raise ValueError(f"backend={backend!r} runs in float32 only")
    solve_fn = fused_tracker_solve_cuda if backend == "cuda" else fused_tracker_solve_twin
    nx, nu = model.nx, model.nu

    def policy(x_batch, t, carry):
        B = x_batch.shape[0]
        window = ref[t : t + N + 1]
        sol = solve_fn(
            x_batch, carry.reshape(B, N, nu), window[None].expand(B, N + 1, nx),
            ode_rows=model, nx=nx, nu=nu, N=N, ts=float(ts), substeps=pred_substeps,
            limits=limits, state_limits=state_limits, weights=weights,
            outer_iters=outer_iters, inner_iters=inner_iters, viol_tol=1e-4,
            tile=min(tile, math.ceil(B / 128) * 128), group=group,
        )
        return _tracking_step(sol, x_batch, window, N, nu)

    policy.initial_carry = lambda batch, device=None: torch.full(
        (batch, N * nu), hover, dtype=dtype, device=resolve_device(device))
    return policy


def batched_quadrotor_policy(ref: torch.Tensor, N: int = 10, ts: float = 0.1,
                             pred_substeps: int = 2, outer_iters: int = 4,
                             inner_iters: int = 10, backend: str = "cuda",
                             tile: int = ilqr_factory.DEFAULT_TILE, group: int | None = None,
                             dtype=torch.float32):
    """Batch-level planar-quadrotor loiter policy (the JAX ``quadrotor_sweep``'s
    policy): the nominal model (:func:`..models.benchmarks.
    make_planar_quadrotor_ode_rows`), thrusts boxed in ``[0, 1.5 m g]``, the
    tilt boxed at ±0.5, RK4 × ``pred_substeps`` prediction. ``backend="cuda"``
    launches the kernel for CUDA tensors (its twin for CPU tensors);
    ``"twin"`` runs the twin on any device. ``initial_carry`` is hover."""
    m0, _, _, grav = QUADROTOR_PARAMS
    u_max = 1.5 * m0 * grav
    big = 50.0
    return _loiter_policy(
        ref, make_planar_quadrotor_ode_rows(QUADROTOR_PARAMS), N, ts, pred_substeps,
        ((0.0, 0.0), (float(u_max), float(u_max))),
        ((-big, -big, -QUADROTOR_TILT, -big, -big, -big),
         (big, big, QUADROTOR_TILT, big, big, big)),
        QUADROTOR_WEIGHTS, outer_iters, inner_iters, backend, tile, group, 0.5 * m0 * grav,
        dtype)


def batched_thruster_policy(ref: torch.Tensor, N: int = 10, ts: float = 0.1,
                            pred_substeps: int = 2, outer_iters: int = 4,
                            inner_iters: int = 10, backend: str = "cuda",
                            tile: int = ilqr_factory.DEFAULT_TILE, group: int | None = None,
                            dtype=torch.float32):
    """Batch-level thrust-cluster loiter policy (the JAX ``thruster_sweep``'s
    policy): the nominal model (:func:`..models.benchmarks.
    make_thruster_ode_rows`, nu = 4), thrusts boxed in ``[0, 6]``, no state
    box, RK4 × ``pred_substeps`` prediction; backends as
    :func:`batched_quadrotor_policy`. ``initial_carry`` is the four
    symmetric thrusts that cancel gravity."""
    m0, grav, _, _, cone = THRUSTER_PARAMS
    return _loiter_policy(
        ref, make_thruster_ode_rows(THRUSTER_PARAMS), N, ts, pred_substeps,
        ((0.0,) * NU_THRUSTER, (THRUSTER_U_MAX,) * NU_THRUSTER), None, THRUSTER_WEIGHTS,
        outer_iters, inner_iters, backend, tile, group, m0 * grav / (4.0 * math.cos(cone)), dtype)


def _loiter_sweep(model_name, make_policy, make_plant, noise_scale, nominal, batch, steps,
                  generator, N, ts, radius, period, rel_scale, outer_iters, inner_iters,
                  plant_substeps, pred_substeps, backend, tile, group, mesh, dtype, device):
    """One loiter sweep: the draws (on the CPU, in the JAX package's order:
    plant factors ``1 + rel_scale·U[−1, 1]`` ``(batch, 3)``, then start states
    ``ref[0] + U[−1, 1]·noise_scale``), the reference, policy and plant, the
    closed loop and its summary."""
    if mesh is not None:
        raise NotImplementedError("device meshes are not ported yet: ROADMAP S7.1")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    ref = loiter_reference(steps + N + 1, radius, period, ts, dtype=dtype, device="cpu")
    uniform = lambda *shape: 2.0 * torch.rand(*shape, generator=generator, dtype=dtype) - 1.0
    factors = 1.0 + rel_scale * uniform(batch, 3)
    x0s = ref[0] + uniform(batch, 6) * torch.tensor(noise_scale, dtype=dtype)
    plant_params = tuple((v * factors[:, i]).to(device) for i, v in enumerate(nominal))
    policy = make_policy(ref.to(device), N=N, ts=ts, pred_substeps=pred_substeps,
                         outer_iters=outer_iters, inner_iters=inner_iters, backend=backend,
                         tile=tile, group=group, dtype=dtype)
    plant = make_plant(plant_params, ts, substeps=plant_substeps)
    res = simulate_batch(x0s.to(device), plant, steps, policy, policy.initial_carry(batch, device),
                         batched_dynamics=True)

    tail = res.logs["tracking_error"][steps // 4 :]
    summary = {
        "batch": int(batch),
        "steps": int(steps),
        "model": model_name,
        "success_rate": res.logs["solver_success"].float().mean().item(),
        "mean_tracking_error": tail.mean().item(),
        "p95_tracking_error": torch.quantile(tail.flatten(), 0.95).item(),
        "rel_scale": float(rel_scale),
        "mean_inner_iters": res.logs["kernel_inner_iters"].mean().item(),
    }
    return res, summary


def quadrotor_sweep(
    batch: int,
    steps: int,
    generator: torch.Generator | None = None,
    N: int = 10,
    ts: float = 0.1,
    radius: float = 1.0,
    period: float = 12.0,
    rel_scale: float = 0.1,
    outer_iters: int = 4,
    inner_iters: int = 10,
    plant_substeps: int = 8,
    pred_substeps: int = 2,
    backend: str = "cuda",
    tile: int = ilqr_factory.DEFAULT_TILE,
    group: int | None = None,
    mesh=None,
    dtype=torch.float32,
    device=None,
) -> tuple[BatchSimResult, dict]:
    """Closed-loop planar-quadrotor loiter tracking on the fused tracker
    kernel (the JAX package's ``quadrotor_sweep``): ``batch`` scenarios enter
    the loiter circle (:func:`loiter_reference`) from perturbed hovers at its
    start, each plant's mass, inertia and arm scaled by ``1 ± rel_scale``
    while the controller keeps the nominal model; thrusts in ``[0, 1.5 m g]``,
    the tilt boxed at ±0.5 (:func:`batched_quadrotor_policy`); the plant is
    fine RK4 with ``plant_substeps`` (:func:`batched_quadrotor_plant`).

    ``generator`` (a CPU ``torch.Generator``, seed 0 when ``None``) draws the
    plant factors, then the start noise, in the JAX package's order.
    ``tile`` is the kernel's lanes per CTA (the port's default, not the JAX
    package's TPU tile of 512); ``group`` its threads per lane. Returns
    ``(BatchSimResult, summary)`` with the JAX package's summary keys and
    ``mean_inner_iters`` (executed inner iterations per solve)."""
    return _loiter_sweep(
        "planar-quadrotor", batched_quadrotor_policy, batched_quadrotor_plant,
        [0.15, 0.15, 0.1, 0.1, 0.1, 0.1], QUADROTOR_PARAMS[:3], batch, steps, generator, N, ts,
        radius, period, rel_scale, outer_iters, inner_iters, plant_substeps, pred_substeps,
        backend, tile, group, mesh, dtype, device)


def thruster_sweep(
    batch: int,
    steps: int,
    generator: torch.Generator | None = None,
    N: int = 10,
    ts: float = 0.1,
    radius: float = 1.0,
    period: float = 12.0,
    rel_scale: float = 0.1,
    outer_iters: int = 4,
    inner_iters: int = 10,
    plant_substeps: int = 8,
    pred_substeps: int = 2,
    backend: str = "cuda",
    tile: int = ilqr_factory.DEFAULT_TILE,
    group: int | None = None,
    mesh=None,
    dtype=torch.float32,
    device=None,
) -> tuple[BatchSimResult, dict]:
    """Closed-loop 3-D thrust-cluster loiter tracking, the ``nu = 4`` tier
    (the JAX package's ``thruster_sweep``): a lateral loiter circle at
    constant height (:func:`loiter_reference`) entered from perturbed
    offsets, each plant's mass and drags ``(c₁, c₂)`` scaled by ``1 ±
    rel_scale`` while the controller keeps the nominal model; thrusts in
    ``[0, 6]`` (:func:`batched_thruster_policy`); the plant is fine RK4 with
    ``plant_substeps`` (:func:`batched_thruster_plant`). Draws, ``tile``,
    ``group`` and the summary as :func:`quadrotor_sweep`."""
    m0, _, c1_0, c2_0, _ = THRUSTER_PARAMS
    return _loiter_sweep(
        "thrust-cluster-nu4", batched_thruster_policy, batched_thruster_plant,
        [0.15, 0.15, 0.15, 0.1, 0.1, 0.1], (m0, c1_0, c2_0), batch, steps, generator, N, ts,
        radius, period, rel_scale, outer_iters, inner_iters, plant_substeps, pred_substeps,
        backend, tile, group, mesh, dtype, device)
