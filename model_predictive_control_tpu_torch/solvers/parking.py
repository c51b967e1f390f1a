"""Session-4 parking OCP: nonlinear MPC for the kinematic bicycle with an
optional covering-circle obstacle (port of ``solvers/parking.py``).

Reference semantics (``session_4/main.py:41-113``, ``session4_sol.py:
132-217``): forward-Euler (or RK4) prediction of the bicycle; cost
``Σ_{i<N} (xᵢᵀQxᵢ + uᵢᵀRuᵢ) + x_NᵀQ_N x_N``; the state box on stages 1..N
and, with an obstacle, the 9 pairwise covering-circle clearances; the input
box. Two forms of the same OCP: :func:`make_parking_ocp` for the SQP
(single shooting, residual and constraint stack of the stacked inputs) and
:func:`make_parking_ilqr` for the AL-iLQR (stagewise rows ``c ≤ 0``).

``params`` may carry per-scenario fields (``(B,)`` tensors, as
:func:`..parallel.batch.perturb_parameters` makes them): the problem's
``params`` then holds them, and every function reads its scenario's values.
"""

from __future__ import annotations

import dataclasses

import torch

from ..control.simulate import Policy
from ..models.bicycle import NU, NX, kinematic_bicycle_ode
from ..models.parameters import VehicleParameters
from ..ops.integrators import euler, rk4
from ..utils.device import resolve_device
from ..utils.geometry import cover_circle_offsets, pairwise_sq_distances, transform_circles
from .ilqr import ILQRProblem, al_ilqr_solve
from .sqp import ShootingOCP, SQPSolution, sqp_solve

# main.py:72-74 of the reference
Q_MAIN = (1.0, 6.0, 0.2, 0.05)
R_MAIN = (1.0, 0.01)
QN_SCALE_MAIN = 100.0
# session4_sol.py:166-169
Q_SOL = (1.0, 3.0, 0.1, 0.01)
QN_SCALE_SOL = 10.0
# template.py:136 (the RK4-prediction template variant)
QN_SCALE_TEMPLATE = 5.0

_X_LO = ("min_pos_x", "min_pos_y", "min_heading", "min_vel")
_X_HI = ("max_pos_x", "max_pos_y", "max_heading", "max_vel")
_FIELDS = {f.name for f in dataclasses.fields(VehicleParameters)}


def scenario_fields(params: VehicleParameters) -> dict:
    """The per-scenario fields of ``params``: ``{name: (B,) tensor}``."""
    return {name: getattr(params, name) for name in sorted(params.batched_fields())}


def with_fields(params: VehicleParameters, p: dict) -> VehicleParameters:
    """``params`` with the fields in ``p`` (one scenario's values) put in;
    other keys of ``p`` are ignored."""
    p = {k: v for k, v in p.items() if k in _FIELDS}
    return dataclasses.replace(params, **p) if p else params


def _t(v, dtype, device) -> torch.Tensor:
    """A float, a tuple or a tensor as a tensor of ``dtype`` on ``device``; a
    tensor keeps its autograd graph (the tuning layer's ``exp(theta["logQ"])``
    weights)."""
    if torch.is_tensor(v):
        return v.to(dtype=dtype, device=device)
    return torch.tensor(v, dtype=dtype, device=device)


def _vec(values, dtype, device) -> torch.Tensor:
    """Floats and tensors stacked along a last axis (broadcast)."""
    return torch.stack(torch.broadcast_tensors(*(_t(v, dtype, device) for v in values)), dim=-1)


def _weight_device(Q, device) -> torch.device:
    """Where a problem builds its tensors: ``device``, or the weights' own
    device when ``Q`` is a tensor and ``device`` is ``None``."""
    return Q.device if device is None and torch.is_tensor(Q) else resolve_device(device)


def _prediction_step(params, ts, integrator: str):
    ode = lambda x, u: kinematic_bicycle_ode(params, x, u)
    if integrator == "euler":
        return euler(ode, ts)
    if integrator == "rk4":
        return rk4(ode, ts)
    raise ValueError(f"unknown integrator {integrator!r} (euler|rk4)")


def _obstacle(params, x_obs, n_circles, dtype, device):
    """Body offsets, the clearance ``(r + r_p)²`` and the obstacle's circle
    centres (float32 offsets, as in the JAX package)."""
    if torch.is_tensor(params.length):
        # a per-scenario length: the centres in the working dtype, as JAX
        # promotes them under vmap (float32 offsets only for a float length)
        d = params.length / (2 * n_circles)
        k = torch.arange(n_circles, dtype=dtype, device=device)
        cx = (2.0 * k + 1.0) * d - params.length / 2.0
        offsets = torch.stack([cx, torch.zeros_like(cx)], dim=1)
        r_circ = (d**2 + (params.width**2) / 4.0) ** 0.5
    else:
        offsets, r_circ = cover_circle_offsets(params.length, params.width, n_circles,
                                               device=device)
        offsets = offsets.to(dtype)
    obs = transform_circles(torch.tensor([float(v) for v in x_obs], dtype=dtype, device=device),
                            offsets)
    return offsets, _t((r_circ + r_circ) ** 2, dtype, device), obs


def _clearance(params, n_circles, dtype, device) -> torch.Tensor:
    """``(r + r_p)²`` of every scenario: ``()`` or ``(B,)``."""
    d = params.length / (2 * n_circles)
    return _t((2.0 * (d**2 + (params.width**2) / 4.0) ** 0.5) ** 2, dtype, device)


def make_parking_ocp(
    params: VehicleParameters,
    N: int,
    ts: float,
    x_obs=None,
    Q: tuple = Q_MAIN,
    R: tuple = R_MAIN,
    qn_scale: float = QN_SCALE_MAIN,
    n_circles: int = 3,
    dtype=torch.float32,
    integrator: str = "euler",
    device=None,
) -> ShootingOCP:
    """The single-shooting parking OCP as residual and constraint functions
    of one scenario's stacked inputs, on ``device`` (the card when
    ``None``). The state box's bounds come from ``params`` (shared, or per
    scenario where ``params`` perturbs them)."""
    device = _weight_device(Q, device)
    Qd, Rd = _t(Q, dtype, device), _t(R, dtype, device)
    sqQ, sqQN, sqR = torch.sqrt(Qd), torch.sqrt(qn_scale * Qd), torch.sqrt(Rd)
    fields = scenario_fields(params)

    def rollout_states(u_flat, x0, p):
        step = _prediction_step(with_fields(params, p), ts, integrator)
        u_seq = u_flat.reshape(N, NU)
        xs, x = [], x0
        for t in range(N):
            x = step(x, u_seq[t])
            xs.append(x)
        return torch.stack(xs)  # x_1 .. x_N

    def residual(u_flat, x0, p):
        """cost = ‖r‖²: stage √Q x_k (k = 0..N-1), terminal √Q_N x_N, √R u_k."""
        xs = rollout_states(u_flat, x0, p)
        stage_x = torch.cat([x0[None], xs[:-1]], dim=0)
        return torch.cat([(stage_x * sqQ).reshape(-1), xs[-1] * sqQN,
                          (u_flat.reshape(N, NU) * sqR).reshape(-1)])

    n_colli = n_circles * n_circles if x_obs is not None else 0

    def constraints(u_flat, x0, p):
        xs = rollout_states(u_flat, x0, p)
        parts = [xs.reshape(-1)]
        if n_colli:
            pr = with_fields(params, p)
            offsets, _, obs = _obstacle(pr, x_obs, n_circles, dtype, device)
            veh = transform_circles(xs, offsets)  # (N, n_c, 2)
            parts.append(torch.stack([pairwise_sq_distances(veh[t], obs) for t in range(N)])
                         .reshape(-1))
        return torch.cat(parts)

    # bounds from params: (m,) shared, (B, m) where params perturbs them
    tiled = lambda values: (lambda b: b.repeat(*([1] * (b.ndim - 1)), N))(
        _vec(values, dtype, device))
    l_c = tiled([getattr(params, n) for n in _X_LO])
    u_c = tiled([getattr(params, n) for n in _X_HI])
    if n_colli:
        r2 = _clearance(params, n_circles, dtype, device)
        r2 = r2[..., None].expand(*r2.shape, N * n_colli)
        lead = torch.broadcast_shapes(l_c.shape[:-1], r2.shape[:-1])
        wide = lambda a: a.expand(*lead, a.shape[-1])
        l_c = torch.cat([wide(l_c), wide(r2)], dim=-1)
        u_c = torch.cat([wide(u_c), torch.full_like(wide(r2), float("inf"))], dim=-1)
    l_u = tiled([params.min_drive, -params.max_steer])
    u_u = tiled([params.max_drive, params.max_steer])
    return ShootingOCP(
        residual=residual, constraints=constraints, l_c=l_c, u_c=u_c, l_u=l_u, u_u=u_u,
        n_controls=N * NU, horizon=N, nu=NU, params=fields or None,
    )


def make_parking_ilqr(
    params: VehicleParameters,
    N: int,
    ts: float,
    x_obs=None,
    Q: tuple = Q_MAIN,
    R: tuple = R_MAIN,
    qn_scale: float = QN_SCALE_MAIN,
    n_circles: int = 3,
    dtype=torch.float32,
    integrator: str = "euler",
    device=None,
):
    """The parking OCP in iLQR form: ``(ILQRProblem, constraints, nc)`` on
    ``device`` (the card when ``None``, ``Q``'s device when ``Q`` is a
    tensor; tensor weights keep their graph). Same model, cost and constraints
    as :func:`make_parking_ocp`, as stagewise rows ``c(x, u, p, s) ≤ 0``:
    state box (8), input box (4) and, with an obstacle, ``(r + r_p)² −
    ‖c_v − c_o‖²`` (``n_circles²``)."""
    device = _weight_device(Q, device)
    Qd, Rd = _t(Q, dtype, device), _t(R, dtype, device)
    QNd = qn_scale * Qd
    n_colli = n_circles * n_circles if x_obs is not None else 0
    fields = scenario_fields(params)
    # the box rows' bounds (ub_x, lb_x, ub_u, lb_u) and the obstacle's
    # geometry: constants, or per-scenario data where params perturbs them
    box = lambda pr: _vec([*(getattr(pr, n) for n in _X_HI), *(getattr(pr, n) for n in _X_LO),
                           pr.max_drive, pr.max_steer, pr.min_drive, -pr.max_steer], dtype, device)
    data = dict(fields)
    box_const = box(params)
    if box_const.ndim > 1:
        data["box"] = box_const
    geo_batched = bool({"length", "width"} & fields.keys())
    geo_const = _obstacle(params, x_obs, n_circles, dtype, device) if n_colli and not geo_batched \
        else None

    def dynamics(x, u, p):
        return _prediction_step(with_fields(params, p), ts, integrator)(x, u)

    def constraints(x, u, p, s):
        L = p["box"] if "box" in p else box_const
        rows = [x - L[:NX], L[NX:2 * NX] - x, u - L[2 * NX:2 * NX + NU], L[2 * NX + NU:] - u]
        if n_colli:
            offsets, r2, obs = geo_const or _obstacle(with_fields(params, p), x_obs, n_circles,
                                                      dtype, device)
            rows.append(r2 - pairwise_sq_distances(transform_circles(x, offsets), obs))
        return torch.cat(rows)

    prob = ILQRProblem(
        dynamics=dynamics,
        stage_cost=lambda x, u, p, s: x @ (Qd * x) + u @ (Rd * u),
        terminal_cost=lambda x, p: x @ (QNd * x),
        N=N, nx=NX, nu=NU, params=data or None,
    )
    return prob, constraints, 2 * NX + 2 * NU + n_colli


def _batched(x: torch.Tensor):
    """``x`` with a scenario axis, and whether it had one."""
    return (x, True) if x.ndim == 2 else (x[None], False)


def _unbatch(tree, batched: bool):
    if batched:
        return tree
    return type(tree)(**{f.name: getattr(tree, f.name)[0] for f in dataclasses.fields(tree)})


class NonlinearMPC:
    """Receding-horizon nonlinear MPC over the parking OCP (the reference's
    ``MPCController.__call__`` pattern, main.py:121-129) with a warm-started
    SQP. ``solve`` and the policy take one state ``(nx,)`` or a batch ``(B,
    nx)``."""

    def __init__(self, ocp: ShootingOCP, sqp_iters: int = 20, qp_iters: int = 30):
        self.ocp = ocp
        self.sqp_iters = sqp_iters
        self.qp_iters = qp_iters

    def solve(self, x0: torch.Tensor, u_init=None) -> SQPSolution:
        x, batched = _batched(x0)
        if u_init is not None and not batched:
            u_init = u_init[None]
        sol = sqp_solve(self.ocp, x, u_init=u_init, iters=self.sqp_iters, qp_iters=self.qp_iters)
        return _unbatch(sol, batched)

    def policy(self) -> Policy:
        N, nu = self.ocp.horizon, self.ocp.nu

        def policy_fn(x, t, carry):
            u_init = carry if not isinstance(carry, tuple) else None
            sol = self.solve(x, u_init=u_init)
            u_traj = sol.u.reshape(*sol.u.shape[:-1], N, nu)
            u_warm = torch.cat([sol.u[..., nu:], sol.u[..., -nu:]], dim=-1)  # shifted one stage
            aux = {
                "solver_success": sol.converged,
                "input_prediction": u_traj,
                "kkt_res": sol.kkt_res,
                "viol": sol.viol,
            }
            return u_traj[..., 0, :], u_warm, aux

        return policy_fn

    def initial_carry(self, dtype=torch.float32, device=None):
        return torch.zeros(self.ocp.n_controls, dtype=dtype, device=resolve_device(device))


class ILQRMPC:
    """Receding-horizon nonlinear MPC over the AL-iLQR (the
    :class:`NonlinearMPC` contract, O(N) Riccati sweeps per inner iteration
    instead of a condensed QP). Warm start: the previous controls shifted
    one stage. ``solve`` and the policy take ``(nx,)`` or ``(B, nx)``."""

    def __init__(self, prob, constraints, n_constraints: int, outer_iters: int = 6,
                 inner_iters: int = 15):
        self.prob = prob
        self.constraints = constraints
        self.n_constraints = n_constraints
        self.outer_iters = outer_iters
        self.inner_iters = inner_iters

    def solve(self, x0: torch.Tensor, u_init=None):
        x, batched = _batched(x0)
        if u_init is not None and not batched:
            u_init = u_init[None]
        sol = al_ilqr_solve(self.prob, self.constraints, self.n_constraints, x, u_init=u_init,
                            outer_iters=self.outer_iters, inner_iters=self.inner_iters)
        return _unbatch(sol, batched)

    def policy(self) -> Policy:
        def policy_fn(x, t, carry):
            u_init = carry if not isinstance(carry, tuple) else None
            sol = self.solve(x, u_init=u_init)
            u_warm = torch.cat([sol.us[..., 1:, :], sol.us[..., -1:, :]], dim=-2)
            aux = {
                "solver_success": sol.converged,
                "input_prediction": sol.us,
                "viol": sol.viol,
            }
            return sol.us[..., 0, :], u_warm, aux

        return policy_fn

    def initial_carry(self, dtype=torch.float32, device=None):
        return torch.zeros(self.prob.N, self.prob.nu, dtype=dtype, device=resolve_device(device))
