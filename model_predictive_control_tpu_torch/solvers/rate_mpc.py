"""Rate-limited linear MPC: input slew bounds and Δu smoothing (port of
``solvers/rate_mpc.py``).

With ``Δu_k = u_k − u_{k−1}`` and ``u_{−1} = u_prev`` (the input applied last
step), hard rate bounds append ``N·nu`` rows ``D ū ∈ [l_Δ + E u_prev,
u_Δ + E u_prev]`` to the constraint stack (``D`` the block first difference,
``E`` the first block) and the smoothing ``Σ Δu_kᵀ λ Δu_k`` folds into the
Hessian with a ``u_prev`` cross term. Everything stays affine in
``(x0, u_prev)``, so one operator serves every step and the batch rides the
fused ADMM kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.condensed import CondensedQP, build_condensed_qp
from ..ops.cuda.admm_kernel import DEFAULT_TILE
from ..utils.device import resolve_device
from .linear_mpc import _TILED, _roll, _squeeze, as_box_problem
from .qp import QPOperator, admm_solve, qp_setup


@dataclasses.dataclass(frozen=True)
class RateCondensedQP:
    """Condensed QP with the rate channel; per-solve data ``(x0, u_prev)``."""

    base: CondensedQP
    D: torch.Tensor  # (N nu, N nu) first-difference map
    q_uprev: torch.Tensor  # (n, nu): q += q_uprev @ u_prev
    du_lb: torch.Tensor  # (N nu,) rate bounds before the shift
    du_ub: torch.Tensor
    P: torch.Tensor  # (n, n) Hessian with the smoothing
    A_c: torch.Tensor  # (m + N nu, n) [I; Γ; D]

    @property
    def N(self) -> int:
        return self.base.N

    @property
    def nu(self) -> int:
        return self.base.nu

    @property
    def nx(self) -> int:
        return self.base.nx

    def qp_vectors(self, x0: torch.Tensor, u_prev: torch.Tensor):
        """``(q, l, u)`` for the rows [inputs; states; rates], batched over
        the leading axes of ``x0 (..., nx)`` and ``u_prev (..., nu)``."""
        q, l, u = self.base.qp_vectors(x0)
        q = q + u_prev @ self.q_uprev.T
        nu = self.nu
        pad = torch.zeros(*u_prev.shape[:-1], self.du_lb.shape[0] - nu, dtype=u_prev.dtype,
                          device=u_prev.device)
        shift = torch.cat([u_prev, pad], dim=-1)  # Δu_0 = u_0 − u_prev
        return q, torch.cat([l, self.du_lb + shift], -1), torch.cat([u, self.du_ub + shift], -1)


def build_rate_condensed_qp(A, B, Q, R, QN, N, u_min, u_max, x_min, x_max, du_min=None,
                            du_max=None, du_weight=None, x_ref=None) -> RateCondensedQP:
    """:func:`..ops.condensed.build_condensed_qp` with the rate channel:
    ``du_min`` / ``du_max`` ``(nu,)`` slew bounds (``None``: unbounded),
    ``du_weight`` a ``(nu, nu)`` smoothing weight (``None``: none)."""
    base = build_condensed_qp(A, B, Q, R, QN, N, u_min, u_max, x_min, x_max, x_ref=x_ref)
    nu = B.shape[1]
    dtype, device = B.dtype, B.device
    n = N * nu
    D = torch.eye(n, dtype=dtype, device=device) - torch.diag(
        torch.ones(n - nu, dtype=dtype, device=device), -nu)
    E = torch.zeros(n, nu, dtype=dtype, device=device)
    E[:nu] = torch.eye(nu, dtype=dtype, device=device)
    P = base.P
    q_uprev = torch.zeros(n, nu, dtype=dtype, device=device)
    if du_weight is not None:
        Lbar = torch.kron(torch.eye(N, dtype=dtype, device=device),
                          torch.as_tensor(du_weight, dtype=dtype, device=device))
        P = P + 2.0 * D.T @ Lbar @ D
        P = 0.5 * (P + P.T)
        q_uprev = -2.0 * D.T @ (Lbar @ E)
    inf = torch.full((nu,), float("inf"), dtype=dtype, device=device)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    du_lb = (-inf if du_min is None else t(du_min)).repeat(N)
    du_ub = (inf if du_max is None else t(du_max)).repeat(N)
    return RateCondensedQP(base=base, D=D, q_uprev=q_uprev, du_lb=du_lb, du_ub=du_ub, P=P,
                           A_c=torch.cat([base.A_c, D], dim=0))


@dataclasses.dataclass(frozen=True)
class RateLimitedMPC:
    """Receding-horizon MPC over the rate-extended QP. Carry
    ``(x_warm, y_warm, u_prev)``."""

    qp: RateCondensedQP
    op: QPOperator
    iters: int = 200

    @property
    def N(self) -> int:
        return self.qp.N

    def solve(self, x0, u_prev, warm=None):
        q, l, u = self.qp.qp_vectors(x0[None], u_prev[None])
        w = None if warm is None else (warm[0][None], warm[1][None])
        sol = _squeeze(admm_solve(self.op, q, l, u, iters=self.iters, warm=w))
        return sol.x.reshape(self.N, self.qp.nu), sol

    def _shift_warm(self, x, y, axis: int = 0):
        """Shift the warm start one stage per constraint block: the duals
        stack [inputs (N·nu) | states (N·nx) | rates (N·nu)]."""
        nu, nx, N = self.qp.nu, self.qp.nx, self.qp.N
        blocks = torch.split(y, (N * nu, N * nx, N * nu), dim=axis)
        y_w = torch.cat([_roll(b, d, False, axis) for b, d in zip(blocks, (nu, nx, nu))], dim=axis)
        return _roll(x, nu, True, axis), y_w

    def policy(self):
        def policy_fn(x, t, carry):
            x_warm, y_warm, u_prev = carry
            u_traj, sol = self.solve(x, u_prev, warm=(x_warm, y_warm))
            x_w, y_w = self._shift_warm(sol.x, sol.y)
            u0 = u_traj[0]
            aux = {"solver_success": sol.converged, "input_prediction": u_traj,
                   "du": u0 - u_prev}
            return u0, (x_w, y_w, u0), aux

        return policy_fn

    def initial_carry(self, u_prev=None, dtype=torch.float32, device=None):
        device = resolve_device(device)
        n, m = self.qp.P.shape[0], self.qp.A_c.shape[0]
        u_prev = torch.zeros(self.qp.nu) if u_prev is None else u_prev
        return (torch.zeros(n, dtype=dtype, device=device),
                torch.zeros(m, dtype=dtype, device=device),
                torch.as_tensor(u_prev, dtype=dtype, device=device))

    def batched_policy(self, backend: str = "cuda", tile: int = DEFAULT_TILE,
                       max_rho_moves: int | None = None):
        """Batch-level policy for :func:`..control.batch_loop.simulate_batch`
        with :meth:`policy`'s carry and a leading batch axis: the fused
        kernel (``"cuda"``; its twin on CPU tensors), the twin (``"twin"``)
        or the per-scenario :func:`..solvers.qp.admm_solve` (``"xla"``)."""
        if backend not in _TILED and backend != "xla":
            raise ValueError(f"unknown backend {backend!r}")
        nu = self.qp.nu

        def policy_fn(x, t, carry):
            x_warm, y_warm, u_prev = carry
            q, l, u = self.qp.qp_vectors(x, u_prev)
            if backend == "xla":
                sol = admm_solve(self.op, q, l, u, iters=self.iters, warm=(x_warm, y_warm))
            else:
                sol = _TILED[backend](self.op, q, l, u, x_warm, y_warm, iters=self.iters,
                                      tile=tile, max_rho_moves=max_rho_moves)
            u0 = sol.x[:, :nu]
            x_w, y_w = self._shift_warm(sol.x, sol.y, axis=1)
            return u0, (x_w, y_w, u0), {"solver_success": sol.converged, "du": u0 - u_prev}

        return policy_fn

    def initial_batch_carry(self, batch: int, u_prev=None, dtype=torch.float32, device=None):
        device = resolve_device(device)
        n, m = self.qp.P.shape[0], self.qp.A_c.shape[0]
        u_prev = torch.zeros(batch, self.qp.nu) if u_prev is None else u_prev
        return (torch.zeros(batch, n, dtype=dtype, device=device),
                torch.zeros(batch, m, dtype=dtype, device=device),
                torch.as_tensor(u_prev, dtype=dtype, device=device))


def make_rate_limited_mpc(problem, du_max: float, du_weight: float | None = None,
                          iters: int = 300, dtype=torch.float32, rho: float = 0.1,
                          device=None) -> RateLimitedMPC:
    """Session-2/3 ``Problem`` data or any ``BoxProblem``, a symmetric slew
    bound ``|Δu| ≤ du_max`` per step and an optional scalar smoothing
    weight, on ``device`` (the card when ``None``)."""
    device = resolve_device(device)
    box = as_box_problem(problem)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    nu = box.B.shape[1]
    Q = t(box.Q)
    eye = torch.eye(nu, dtype=dtype, device=device)
    qp = build_rate_condensed_qp(
        t(box.A), t(box.B), Q, t(box.R), Q, box.N, u_min=t(box.u_min), u_max=t(box.u_max),
        x_min=t(box.x_min), x_max=t(box.x_max), du_min=-du_max * torch.ones(nu, dtype=dtype,
        device=device), du_max=du_max * torch.ones(nu, dtype=dtype, device=device),
        du_weight=None if du_weight is None else du_weight * eye,
    )
    return RateLimitedMPC(qp=qp, op=qp_setup(qp.P, qp.A_c, rho=rho), iters=iters)
