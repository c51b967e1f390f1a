"""Tensor-parallel ADMM over the model axis (port of
``parallel/tensor_parallel.py``).

The row-parallel pattern of transformer tensor parallelism, applied to the
ADMM operator, written per rank with its collective by hand:

- the constraint rows of ``A_s`` and the iterates ``z, y`` (and the bounds
  ``l, u``) are split over the ``model`` group of the mesh;
- the primal ``x`` is replicated across the model group;
- per iteration ``w = σx − q + A_sᵀ(ρz − y)`` takes ONE ``all_reduce`` over
  the model group (each rank adds ``A_shᵀ(ρz − y)_sh``); ``x̃ = M⁻¹w`` is
  computed on every rank alike; ``z̃ = A_sh x̃`` and the clip and dual update
  stay local.

ρ is fixed at the operator's initial level (no ladder moves), which keeps
the per-rank program at one collective an iteration. The polish needs the
full row space: it runs on the gathered result, as do the residuals. The
iterations run eagerly: a CUDA graph cannot hold a gloo collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..solvers.qp import QPOperator, QPSolution, _converged, _polish, _unscaled_residuals
from ..utils.precision import set_solver_precision
from .mesh import DATA_AXIS, MODEL_AXIS, _coordinate, _on_backend, all_gather_cat


def admm_solve_tp(
    op: QPOperator,
    q: torch.Tensor,  # (B, n)
    l: torch.Tensor,  # (B, m)
    u: torch.Tensor,  # (B, m)
    warm_x: torch.Tensor | None = None,
    warm_y: torch.Tensor | None = None,
    *,
    mesh,
    iters: int = 100,
    alpha: float = 1.6,
    eps_abs: float | None = None,
    polish: bool = True,
) -> QPSolution:
    """Batched ADMM with the scenario batch split over ``data`` and the
    constraint rows over ``model``: the solution of ``admm_solve`` at a
    fixed ρ (``adapt_chunks=1``), to float tolerance.

    Every rank passes the global ``(q, l, u)`` (and warm start) and gets the
    global solution back. Requires ``B % mesh.shape[0] == 0`` and ``m %
    mesh.shape[1] == 0``."""
    set_solver_precision()
    dtype = op.P.dtype
    B, n = q.shape
    m = op.A_c.shape[0]
    n_data, n_model = mesh.shape
    if m % n_model != 0:
        raise ValueError(f"m={m} not divisible by model axis {n_model}")
    if B % n_data != 0:
        raise ValueError(f"B={B} not divisible by data axis {n_data}")
    if eps_abs is None:
        eps_abs = 1e-6 if dtype == torch.float64 else 1e-4

    # equilibrated-space data (the scaling of admm_solve)
    q_s = op.c * op.D * q
    l_s = op.E * l
    u_s = op.E * u
    x0 = torch.zeros(B, n, dtype=dtype, device=q.device) if warm_x is None else warm_x / op.D
    y0 = (torch.zeros(B, m, dtype=dtype, device=q.device) if warm_y is None
          else op.c * warm_y / op.E)
    rho = op.rho_levels[op.rho_init_idx]
    Minv = op.Minv_stack[op.rho_init_idx]
    sigma = op.sigma

    # this rank's block: batch rows by its data coordinate, constraint rows
    # by its model coordinate
    d, k = _coordinate(mesh)
    b_sh, m_sh = B // n_data, m // n_model
    rows, cols = slice(d * b_sh, (d + 1) * b_sh), slice(k * m_sh, (k + 1) * m_sh)
    q_b, x = q_s[rows], x0[rows]
    y, l_b, u_b = y0[rows, cols], l_s[rows, cols], u_s[rows, cols]
    A_sh = op.A_s[cols]
    model_group = mesh.get_group(MODEL_AXIS)

    z = torch.clamp(x @ A_sh.T, l_b, u_b)
    for _ in range(iters):
        # row-parallel A_sᵀ(ρz − y): the local contribution, ONE all_reduce
        w_part = _on_backend((rho * z - y) @ A_sh, model_group).contiguous()
        dist.all_reduce(w_part, group=model_group)
        w = sigma * x - q_b + w_part.to(x.device)
        x_t = w @ Minv.T  # the same on every rank of the model group
        z_t = x_t @ A_sh.T  # local rows, no traffic
        x_n = alpha * x_t + (1.0 - alpha) * x
        z_pre = alpha * z_t + (1.0 - alpha) * z + y / rho
        z_n = torch.clamp(z_pre, l_b, u_b)
        y = y + rho * (alpha * z_t + (1.0 - alpha) * z - z_n)
        x, z = x_n, z_n

    # the full rows, then the full batch, on every rank
    data_group = mesh.get_group(DATA_AXIS)
    z = all_gather_cat(all_gather_cat(z, model_group, 1), data_group, 0)
    y = all_gather_cat(all_gather_cat(y, model_group, 1), data_group, 0)
    x = all_gather_cat(x, data_group, 0)

    # unscale, then the optional polish on full rows
    x = op.D * x
    y = y * op.E / op.c
    z = z / op.E
    if polish:
        x, y, z = _polish(op, q, l, u, x, y, z)
    rp, rd = _unscaled_residuals(op, x, y, z, q)
    return QPSolution(x=x, z=z, y=y, prim_res=rp, dual_res=rd,
                      converged=_converged(rp, rd, q, eps_abs))
