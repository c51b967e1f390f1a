"""Batched box-constrained QP: operator setup, the per-scenario ADMM path and
the Mehrotra interior point (port of ``solvers/qp.py``).

Problem form (OSQP convention): ``min ½ xᵀPx + qᵀx  s.t.  l ≤ A_c x ≤ u``.
The operator (Ruiz scaling, ρ-ladder KKT inverses, polish operators) is built
once per QP family; ``(q, l, u)`` vary per scenario. Every solver here takes a
leading batch axis: ``q`` is ``(B, n)``, ``l`` and ``u`` are ``(B, m)``.
The interior point and the polish read ``P`` and ``A_c`` alone, so they also
take a :class:`QPMatrices`, which may hold one QP per scenario (the SQP's
subproblems).
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from ..utils.precision import set_solver_precision


@dataclasses.dataclass(frozen=True)
class QPOperator:
    """Scenario-independent precomputation for a QP family ``(P, A_c)``."""

    P: torch.Tensor  # (n, n) original
    A_c: torch.Tensor  # (m, n) original
    P_s: torch.Tensor  # scaled: c * D P D
    A_s: torch.Tensor  # scaled: E A D
    D: torch.Tensor  # (n,) variable scaling
    E: torch.Tensor  # (m,) constraint scaling
    c: torch.Tensor  # () cost scaling
    rho_levels: torch.Tensor  # (R,) ρ ladder (scaled space)
    rho_init_idx: int  # starting level
    sigma: torch.Tensor  # () ADMM regularization
    Minv_stack: torch.Tensor  # (R, n, n) inv(P_s + σI + ρ_r A_sᵀA_s)
    Pinv_s: torch.Tensor  # (n, n) inv(P_s)
    S: torch.Tensor  # (m, m) A_s inv(P_s) A_sᵀ


@dataclasses.dataclass(frozen=True)
class QPMatrices:
    """The bare QP matrices for :func:`pdip_solve`, shared or one QP per
    scenario: ``P`` ``(n, n)`` or ``(B, n, n)``, ``A_c`` ``(m, n)`` or
    ``(B, m, n)``."""

    P: torch.Tensor
    A_c: torch.Tensor


@dataclasses.dataclass(frozen=True)
class QPSolution:
    x: torch.Tensor  # (B, n) primal
    z: torch.Tensor  # (B, m) constraint values (projected)
    y: torch.Tensor  # (B, m) duals
    prim_res: torch.Tensor  # (B,) ‖A_c x − z‖∞ (unscaled)
    dual_res: torch.Tensor  # (B,) ‖Px + q + A_cᵀy‖∞ (unscaled)
    converged: torch.Tensor  # (B,) bool
    iters: torch.Tensor | None = None  # (B,) ADMM iterations executed (tiled kernel solves)


def ruiz_equilibrate(
    P: torch.Tensor, A_c: torch.Tensor, iters: int = 10
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Modified Ruiz equilibration of the stacked KKT matrix; returns (D, E, c)."""
    D = torch.ones(P.shape[0], dtype=P.dtype, device=P.device)
    E = torch.ones(A_c.shape[0], dtype=P.dtype, device=P.device)
    P_s, A_s = P, A_c
    for _ in range(iters):
        col_x = torch.maximum(P_s.abs().amax(dim=0), A_s.abs().amax(dim=0))
        col_z = A_s.abs().amax(dim=1)
        # identically-zero rows/columns keep scale 1
        dx = torch.where(col_x > 1e-10, 1.0 / torch.sqrt(col_x), 1.0)
        dz = torch.where(col_z > 1e-10, 1.0 / torch.sqrt(col_z), 1.0)
        P_s = dx[:, None] * P_s * dx[None, :]
        A_s = dz[:, None] * A_s * dx[None, :]
        D, E = D * dx, E * dz
    mean_col = P_s.abs().amax(dim=0).mean()
    c = 1.0 / torch.clamp(mean_col, min=1e-8)
    return D, E, c


def qp_setup(
    P: torch.Tensor,
    A_c: torch.Tensor,
    rho: float = 0.1,
    sigma: float = 1e-6,
    n_rho_levels: int = 7,
    rho_ladder_step: float = 10.0,
    equilibrate: bool = True,
    setup_admm: bool = True,
) -> QPOperator:
    """Scalings, the geometric ρ ladder and one reduced-KKT inverse per level,
    computed in ``P``'s dtype on ``P``'s device. ``equilibrate=False`` keeps
    unit scalings (D, E, c = 1); ``setup_admm=False`` builds an interior-point
    operator without the ladder's inverses: ``Minv_stack`` is ``(0, n, n)``,
    so an ADMM solve on it fails loudly, and ``Pinv_s`` and ``S`` are zero."""
    set_solver_precision()
    dtype, device = P.dtype, P.device
    n, m = P.shape[0], A_c.shape[0]
    if equilibrate:
        D, E, c = ruiz_equilibrate(P, A_c)
    else:
        D = torch.ones(n, dtype=dtype, device=device)
        E = torch.ones(m, dtype=dtype, device=device)
        c = torch.tensor(1.0, dtype=dtype, device=device)
    P_s = c * (D[:, None] * P * D[None, :])
    A_s = E[:, None] * A_c * D[None, :]

    half = (n_rho_levels - 1) // 2
    exps = torch.arange(-half, n_rho_levels - half, dtype=dtype, device=device)
    rho_levels = rho * rho_ladder_step**exps
    sigma_ = torch.tensor(sigma, dtype=dtype, device=device)
    if setup_admm:
        I = torch.eye(n, dtype=dtype, device=device)
        AtA = A_s.T @ A_s
        Minv_stack = torch.linalg.inv(
            P_s + sigma_ * I + rho_levels[:, None, None] * AtA
        )
        Pinv_s = torch.linalg.inv(P_s + 1e-9 * I)
        S = A_s @ Pinv_s @ A_s.T
    else:
        Minv_stack = P.new_zeros((0, n, n))
        Pinv_s = torch.zeros_like(P)
        S = P.new_zeros((m, m))
    return QPOperator(
        P=P,
        A_c=A_c,
        P_s=P_s,
        A_s=A_s,
        D=D,
        E=E,
        c=c,
        rho_levels=rho_levels,
        rho_init_idx=half,
        sigma=sigma_,
        Minv_stack=Minv_stack,
        Pinv_s=Pinv_s,
        S=S,
    )


def _mv(M, x):
    """``M x`` row by row: ``M`` shared ``(r, c)`` or per scenario ``(B, r, c)``."""
    return x @ M.T if M.ndim == 2 else (M @ x[..., None])[..., 0]


def _mtv(M, y):
    """``Mᵀ y`` row by row, ``M`` as in :func:`_mv`."""
    return y @ M if M.ndim == 2 else (M.transpose(-1, -2) @ y[..., None])[..., 0]


def _unscaled_residuals(op: QPOperator, x, y, z, q):
    """Per-scenario ∞-norm primal and dual residuals of ``(B, ·)`` iterates."""
    rp = (_mv(op.A_c, x) - z).abs().amax(dim=-1)
    rd = (_mv(op.P, x) + q + _mtv(op.A_c, y)).abs().amax(dim=-1)
    return rp, rd


def _converged(rp, rd, q, eps_abs):
    scale = 1.0 + q.abs().amax(dim=-1)
    return (rp < eps_abs * scale) & (rd < eps_abs * scale)


def _admm_iterations(x, z, y, Minv, rho, q_s, l_s, u_s, A_s, sigma, *, alpha: float, k: int):
    """``k`` ADMM iterations in the scaled space at a fixed ρ per scenario
    (``Minv`` ``(B, n, n)`` and ``rho`` ``(B, 1)`` its level's)."""
    for _ in range(k):
        w = sigma * x - q_s + (rho * z - y) @ A_s
        x_t = torch.einsum("bij,bj->bi", Minv, w)
        z_t = x_t @ A_s.T
        x_n = alpha * x_t + (1.0 - alpha) * x
        z_rel = alpha * z_t + (1.0 - alpha) * z
        z_n = torch.clamp(z_rel + y / rho, l_s, u_s)
        y = y + rho * (z_rel - z_n)
        x, z = x_n, z_n
    return x, z, y


# CUDA graphs of :func:`_admm_iterations`, by operand shapes, dtypes,
# device, alpha and k, least recently used first
_ITERATION_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_ITERATION_GRAPHS_MAX = 8


def _graphed_iterations(*operands, alpha: float, k: int):
    """:func:`_admm_iterations` on CUDA tensors as one replay of a CUDA
    graph, captured at the first call for these shapes and kept: the
    operands are copied into the graph's own buffers, the replay runs the
    same kernels in the same order, and ``(x, z, y)`` come back as new
    tensors."""
    device = operands[0].device
    key = (tuple((t.shape, t.dtype) for t in operands), device, alpha, k)
    entry = _ITERATION_GRAPHS.pop(key, None)
    if entry is None:
        static = [t.clone() for t in operands]
        # one iteration off the capture first: the BLAS handles start there
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            _admm_iterations(*static, alpha=alpha, k=1)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for buf, out in zip(static, _admm_iterations(*static, alpha=alpha, k=k)):
                buf.copy_(out)
        entry = (graph, static)
    else:
        for buf, t in zip(entry[1], operands):
            buf.copy_(t)
    _ITERATION_GRAPHS[key] = entry
    if len(_ITERATION_GRAPHS) > _ITERATION_GRAPHS_MAX:
        _ITERATION_GRAPHS.popitem(last=False)
    entry[0].replay()
    return tuple(buf.clone() for buf in entry[1][:3])


def admm_solve(
    op: QPOperator,
    q: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    iters: int = 100,
    alpha: float = 1.6,
    eps_abs: float | None = None,
    polish: bool = True,
    polish_reg: float = 1e-9,
    warm: tuple[torch.Tensor, torch.Tensor] | None = None,
    adapt_chunks: int = 5,
) -> QPSolution:
    """OSQP-style ADMM on a batch, with per-scenario ρ-ladder adaptation
    between ``adapt_chunks`` chunks and an optional active-set polish.

    ``warm`` is an unscaled ``(x (B, n), y (B, m))`` pair.
    """
    set_solver_precision()
    dtype = op.P.dtype
    B, n = q.shape
    m = op.A_c.shape[0]
    if eps_abs is None:
        eps_abs = 1e-6 if dtype == torch.float64 else 1e-4

    q_s = op.c * op.D * q
    l_s = op.E * l
    u_s = op.E * u
    if warm is None:
        x = torch.zeros(B, n, dtype=dtype, device=q.device)
        y = torch.zeros(B, m, dtype=dtype, device=q.device)
    else:
        x = warm[0] / op.D
        y = op.c * warm[1] / op.E
    z = torch.clamp(x @ op.A_s.T, l_s, u_s)

    idx = torch.full((B,), op.rho_init_idx, dtype=torch.long, device=q.device)
    chunk = max(1, iters // max(1, adapt_chunks))
    log_levels = torch.log(op.rho_levels)
    # without autograd, a CUDA chunk is one replay of a captured graph: the
    # eager loop is bound by its ~20 small launches an iteration
    iterate = (_graphed_iterations if q.is_cuda and not torch.is_grad_enabled()
               and not torch.cuda.is_current_stream_capturing() else _admm_iterations)
    for _ in range(max(1, adapt_chunks)):
        Minv = op.Minv_stack[idx]  # (B, n, n)
        rho = op.rho_levels[idx][:, None]  # (B, 1)
        x, z, y = iterate(x, z, y, Minv, rho, q_s, l_s, u_s, op.A_s, op.sigma, alpha=alpha,
                          k=chunk)

        # OSQP §5.2 adaptive ρ per scenario, snapped to the ladder, with 5x
        # hysteresis and no move once converged
        Ax = x @ op.A_s.T
        Px = x @ op.P_s.T
        Aty = y @ op.A_s
        amax = lambda a: a.abs().amax(dim=-1)
        rp = amax(Ax - z)
        rd = amax(Px + q_s + Aty)
        rp_rel = rp / torch.clamp(torch.maximum(amax(Ax), amax(z)), min=1e-10)
        rd_rel = rd / torch.maximum(
            torch.maximum(amax(Px), amax(Aty)), torch.clamp(amax(q_s), min=1e-10)
        )
        rho_now = rho[:, 0]
        target = rho_now * torch.sqrt(rp_rel / torch.clamp(rd_rel, min=1e-16))
        cand = torch.argmin(
            (log_levels - torch.log(torch.clamp(target, min=1e-12))[:, None]).abs(),
            dim=1,
        )
        scale_s = 1.0 + amax(q_s)
        conv = (rp < eps_abs * scale_s) & (rd < eps_abs * scale_s)
        move = (target > 5.0 * rho_now) | (5.0 * target < rho_now)
        idx = torch.where(move & ~conv, cand, idx)

    x = op.D * x
    y = y * op.E / op.c
    z = z / op.E
    if polish:
        x, y, z = _polish(op, q, l, u, x, y, z, reg=polish_reg)

    rp, rd = _unscaled_residuals(op, x, y, z, q)
    return QPSolution(
        x=x, z=z, y=y, prim_res=rp, dual_res=rd,
        converged=_converged(rp, rd, q, eps_abs),
    )


def _polish(op: QPOperator | QPMatrices, q, l, u, x, y, z, reg: float = 1e-9,
            lower_active=None, upper_active=None):
    """Active-set polish (OSQP §5.2) on a batch: read the active set off the
    duals (or take the given masks), solve the equality-constrained KKT
    system, keep the result per scenario only where it is finite, keeps valid
    dual signs and improves the residuals."""
    dtype = op.P.dtype
    B, n = x.shape
    m = op.A_c.shape[-2]
    lower = y < -1e-12 if lower_active is None else lower_active
    upper = y > 1e-12 if upper_active is None else upper_active
    d = (lower | upper).to(dtype)
    b = torch.where(lower, l, u)
    b = torch.where(torch.isfinite(b), b, torch.zeros_like(b))

    # K = [[P, A_cᵀ·diag(d)], [diag(d)·A_c, −(I − diag(d)) − reg·diag(d)]]
    K = torch.zeros(B, n + m, n + m, dtype=dtype, device=x.device)
    K[:, :n, :n] = op.P
    K[:, :n, n:] = op.A_c.transpose(-1, -2) * d[:, None, :]
    K[:, n:, :n] = d[:, :, None] * op.A_c
    K[:, n:, n:] = torch.diag_embed(-(1.0 - d) - reg * d)
    rhs = torch.cat([-q, d * b], dim=1)
    # solve_ex: a singular active-set system yields non-finite values that
    # the finite test below rejects, instead of raising for the whole batch
    sol = torch.linalg.solve_ex(K, rhs).result
    # one step of iterative refinement on the same system
    r = rhs - torch.einsum("bij,bj->bi", K, sol)
    sol = sol + torch.linalg.solve_ex(K, r).result
    x_p = sol[:, :n]
    y_p = sol[:, n:] * d
    z_p = torch.clamp(_mv(op.A_c, x_p), l, u)

    sign_tol = 1e-10
    sign_ok = (
        torch.where(lower, y_p <= sign_tol, True)
        & torch.where(upper, y_p >= -sign_tol, True)
    ).all(dim=1)
    rp0, rd0 = _unscaled_residuals(op, x, y, z, q)
    rp1, rd1 = _unscaled_residuals(op, x_p, y_p, z_p, q)
    finite = torch.isfinite(sol).all(dim=1)
    better = (finite & sign_ok & (torch.maximum(rp1, rd1) < torch.maximum(rp0, rd0)))[
        :, None
    ]
    return (
        torch.where(better, x_p, x),
        torch.where(better, y_p, y),
        torch.where(better, z_p, z),
    )


_BIG = 1e20


def pdip_solve(
    op: QPOperator | QPMatrices,
    q: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    iters: int = 25,
    eps_abs: float | None = None,
    polish: bool = True,
) -> QPSolution:
    """Mehrotra predictor-corrector primal-dual interior point on a batch:
    ``min ½xᵀPx + qᵀx s.t. Gx ≤ h`` with ``G = [A_c; −A_c]``,
    ``h = [u; −l]``. Infinite bounds are masked out; a fixed iteration
    count, each scenario's iterate frozen once converged, then the active-set
    polish with the active set read off ``λ > s``. ``op`` is a
    :class:`QPOperator` or a :class:`QPMatrices` (one QP per scenario
    allowed): only ``P`` and ``A_c`` are read."""
    set_solver_precision()
    dtype = op.P.dtype
    P, A_c = op.P, op.A_c
    Bn, n = q.shape
    m_r = A_c.shape[-2]
    if eps_abs is None:
        eps_abs = 1e-8 if dtype == torch.float64 else 1e-4

    G = torch.cat([A_c, -A_c], dim=-2)
    h = torch.cat([u, -l], dim=1)
    finite = torch.isfinite(h)
    h_safe = torch.where(finite, h, torch.full_like(h, _BIG))
    mask = finite.to(dtype)
    count = torch.clamp(mask.sum(dim=1), min=1.0)
    eye = torch.eye(n, dtype=dtype, device=q.device)

    x = torch.linalg.solve(P + 1e-8 * eye, -q.T).T if P.ndim == 2 else \
        torch.linalg.solve(P + 1e-8 * eye, -q)
    s = torch.clamp(h_safe - _mv(G, x), 1.0, _BIG)
    lam = mask * (1.0 / s) + (1.0 - mask) * 1e-12

    def newton_dx(W, r_d, r_g, r_s, s, lam):
        # (P + Gᵀ W G) Δx = −r_d − Gᵀ((λ∘r_g − r_s)/s), masked rows zeroed
        KKT = P + (torch.einsum("ki,bk,kj->bij", G, W, G) if G.ndim == 2 else
                   torch.einsum("bki,bk,bkj->bij", G, W, G))
        rhs = -r_d - _mtv(G, mask * (lam * r_g - r_s) / s)
        return torch.linalg.solve_ex(KKT, rhs).result

    def step_len(v, dv):
        ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0), _BIG)
        ratio = torch.where(mask > 0, ratio, _BIG)
        return torch.clamp(0.99 * ratio.amin(dim=1), max=1.0)

    eps_machine = torch.finfo(dtype).eps
    scale = 1.0 + q.abs().amax(dim=1)
    mu_freeze = 50.0 * eps_machine * scale
    rd_freeze = 1e3 * eps_machine * scale
    col = lambda a: a[:, None]
    for _ in range(iters):
        r_d = _mv(P, x) + q + _mtv(G, mask * lam)
        r_g = mask * (_mv(G, x) + s - h_safe)
        mu = (mask * s * lam).sum(dim=1) / count
        frozen = (mu < mu_freeze) & (r_d.abs().amax(dim=1) < rd_freeze)
        W = mask * lam / s

        r_s_aff = s * lam
        dx_aff = newton_dx(W, r_d, r_g, r_s_aff, s, lam)
        ds_aff = -r_g - _mv(G, dx_aff) * mask
        dlam_aff = mask * (-r_s_aff - lam * ds_aff) / s
        a_aff = torch.minimum(step_len(s, ds_aff), step_len(lam, dlam_aff))
        mu_aff = (mask * (s + col(a_aff) * ds_aff) * (lam + col(a_aff) * dlam_aff)).sum(dim=1) / count
        sig = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3

        r_s = s * lam + ds_aff * dlam_aff - col(sig * mu)
        dx = newton_dx(W, r_d, r_g, r_s, s, lam)
        ds = -r_g - _mv(G, dx) * mask
        dlam = mask * (-r_s - lam * ds) / s

        a = col(torch.minimum(step_len(s, ds), step_len(lam, dlam)))
        x_n = x + a * dx
        s_n = torch.where(mask > 0, s + a * ds, s)
        lam_n = torch.where(mask > 0, lam + a * dlam, lam)
        ok = col(~frozen & torch.isfinite(x_n).all(dim=1) & torch.isfinite(s_n).all(dim=1)
                 & torch.isfinite(lam_n).all(dim=1))
        x = torch.where(ok, x_n, x)
        s = torch.where(ok, s_n, s)
        lam = torch.where(ok, lam_n, lam)

    lam_m = mask * lam
    y = lam_m[:, :m_r] - lam_m[:, m_r:]
    z = torch.clamp(_mv(A_c, x), l, u)
    if polish:
        upper_active = (mask[:, :m_r] > 0) & (lam[:, :m_r] > s[:, :m_r])
        lower_active = (mask[:, m_r:] > 0) & (lam[:, m_r:] > s[:, m_r:])
        x, y, z = _polish(op, q, l, u, x, y, z, lower_active=lower_active,
                          upper_active=upper_active)
    rp, rd = _unscaled_residuals(op, x, y, z, q)
    return QPSolution(
        x=x, z=z, y=y, prim_res=rp, dual_res=rd,
        converged=_converged(rp, rd, q, eps_abs),
    )
