"""Float64 oracle for the session-4 parking NLP (port of
``oracle/parking_oracle.py``).

The stand-in for CasADi + IPOPT (``session_4/main.py:39``): scipy's SLSQP,
an SQP with its own line search, QP subproblem solver and convergence path,
solving the same single-shooting OCP. Values and derivatives come from the
port's OCP functions in float64 on the CPU: the cost's gradient by
``torch.autograd.grad``, the constraints' Jacobian by reverse mode,
vectorized over its rows (``torch.autograd.functional.jacobian``; forward
mode, as the JAX package's ``jacfwd``, takes ~4x as long in eager torch).
The model is shared, as the reference shares its CasADi expressions
between solvers; the solver path is independent. The oracle checks its own
feasibility and SLSQP's exit before it returns.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import minimize
from torch.autograd.functional import jacobian

from ._native_build import c64


def _last(fn):
    """``fn`` of a float64 vector, its last result kept: SLSQP asks both
    constraint blocks for the values and the Jacobian at one point."""
    memo = {}

    def cached(u):
        key = np.asarray(u, dtype=np.float64).tobytes()
        if key not in memo:
            memo.clear()
            memo[key] = fn(u)
        return memo[key]

    return cached


def solve_parking_nlp(ocp, x0, u_init=None, ftol=1e-12, maxiter=500):
    """Solve min ‖r(u)‖² s.t. l_c ≤ c(u) ≤ u_c, l_u ≤ u ≤ u_u with SLSQP.

    ``ocp``: a ``ShootingOCP`` of the nominal parameters built with
    ``dtype=torch.float64`` on the CPU; ``x0`` one start ``(nx,)``. Returns
    ``(u, info)``: the float64 stacked inputs and ``cost``, ``viol``,
    ``nit``.
    """
    if ocp.params is not None:
        raise ValueError("the oracle solves one scenario: build the OCP without "
                         "per-scenario parameters")
    n = ocp.n_controls
    x0_t = torch.as_tensor(c64(x0))
    p = {}  # the parameter slice sqp_solve passes an OCP without one
    l_c, u_c, l_u, u_u = map(c64, (ocp.l_c, ocp.u_c, ocp.l_u, ocp.u_u))
    as_t = lambda u: torch.as_tensor(np.asarray(u, dtype=np.float64))

    def cost_t(u):
        r = ocp.residual(u, x0_t, p)
        return (r * r).sum()

    def con_t(u):
        return ocp.constraints(u, x0_t, p)

    def grad_t(u):
        u = u.requires_grad_(True)
        return torch.autograd.grad(cost_t(u), u)[0]

    cost = lambda u: float(cost_t(as_t(u)))
    jac = lambda u: grad_t(as_t(u)).numpy()
    c_np = _last(lambda u: con_t(as_t(u)).numpy())
    J_np = _last(lambda u: jacobian(con_t, as_t(u), vectorize=True).numpy())

    fin_l = np.isfinite(l_c)
    fin_u = np.isfinite(u_c)
    cons = [
        {
            "type": "ineq",
            "fun": lambda u: (c_np(u) - l_c)[fin_l],
            "jac": lambda u: J_np(u)[fin_l],
        },
        {
            "type": "ineq",
            "fun": lambda u: (u_c - c_np(u))[fin_u],
            "jac": lambda u: -J_np(u)[fin_u],
        },
    ]
    out = minimize(
        cost,
        np.zeros(n) if u_init is None else c64(u_init),
        jac=jac,
        constraints=cons,
        bounds=list(zip(l_u, u_u)),
        method="SLSQP",
        options={"maxiter": maxiter, "ftol": ftol},
    )
    u = out.x

    # self-check: feasibility (KKT stationarity is checked loosely: SLSQP's
    # own convergence plus feasibility suffices for a trajectory-level oracle)
    c = c_np(u)
    viol = 0.0
    if fin_l.any():
        viol = max(viol, float(np.max(l_c[fin_l] - c[fin_l])))
    if fin_u.any():
        viol = max(viol, float(np.max(c[fin_u] - u_c[fin_u])))
    if not viol < 1e-7:
        raise RuntimeError(f"parking oracle infeasible by {viol:.2e}")
    if not (out.success or out.status == 9):
        raise RuntimeError(f"SLSQP failed: {out.message}")
    return u, {"cost": cost(u), "viol": viol, "nit": out.nit}
