"""Plain reference of the linear-MPC family: the condensed box-QP worked out
again from the configuration, an exact solve of it, the plant, and the
readings that decide ``correct``.

Imports torch and numpy only: nothing of the program. The problem data come
from the configuration file (the course's session-2 problem): ``x = (p, v)``,
``x⁺ = A x + B u`` with ``A = [[1, Ts], [0, 1]]``, ``B = [[0], [Ts]]``, the
cost ``Σ_{k=1..N-1} x_kᵀ Q x_k + x_Nᵀ P x_N + Σ_{k=0..N-1} u_kᵀ R u_k``
(``terminal`` ``"Q"``: ``P = Q``; ``"dare"``: the Riccati fixed point),
boxes on ``u_0..u_{N-1}`` and on ``x_1..x_N``. A ``chance`` block (noise
variances ``sigma_w``, level ``eps``) tightens the boxes stage by stage as
a chance-constrained MPC by variance propagation does: with the LQR gain
``K``, ``Σ_0 = 0``, ``Σ_{k+1} = (A + BK) Σ_k (A + BK)ᵀ + Σ_w``, the state
box of ``x_{k+1}`` by ``β·√diag Σ_{k+1}`` and the input box of ``u_k`` by
``β·√diag(K Σ_k Kᵀ)``, ``β = Φ⁻¹(1 − eps)``.

The solve is a batched Mehrotra predictor-corrector interior point on
``min ½ zᵀHz + fᵀz  s.t.  Gz ≤ h`` (the box rows written as one-sided
inequalities), a fixed number of iterations. In float64 it is the judge: its
KKT residuals certify each solution. The same code with every matrix
product's operands rounded to TF32 (10 mantissa bits, float32 accumulation:
the precision of the H100's tensor cores when TF32 is allowed, emulated so
that it is the same on the CPU) and put in the program's place is the
control, which has to come out not correct.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np
import torch

IPM_ITERS = 40
# a judge's solution counts as certified below these residuals (relative to
# 1 + the largest |f| or |h|)
CERTIFY = 1e-7


def tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` (float32) rounded to TF32's 10 mantissa bits, nearest, ties away."""
    i = a.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul(lowp: bool):
    if not lowp:
        return torch.matmul
    return lambda a, b: torch.matmul(tf32(a), tf32(b))


def dare(A, B, Q, R, iters: int = 100_000, tol: float = 1e-13):
    """The discrete algebraic Riccati equation's fixed point and the LQR gain
    ``K`` (``u = K x``), by the plain Riccati iteration in float64."""
    P = Q.copy()
    for _ in range(iters):
        K = -np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        P_next = Q + A.T @ P @ (A + B @ K)
        P_next = 0.5 * (P_next + P_next.T)
        if np.max(np.abs(P_next - P)) < tol * (1.0 + np.max(np.abs(P_next))):
            P = P_next
            break
        P = P_next
    return P, -np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)


def chance_margins(A, B, K, sigma_w, N: int, eps: float):
    """Per-stage tightenings ``(state (N, nx), input (N, nu))``: row k of the
    state margins applies to ``x_{k+1}``, row k of the input margins to
    ``u_k``."""
    beta = NormalDist().inv_cdf(1.0 - eps)
    AK = A + B @ K
    Sigma = np.zeros_like(A)
    state_m, input_m = np.zeros((N, A.shape[0])), np.zeros((N, B.shape[1]))
    for k in range(N):
        input_m[k] = beta * np.sqrt(np.maximum(np.diag(K @ Sigma @ K.T), 0.0))
        Sigma = AK @ Sigma @ AK.T + np.diag(sigma_w)
        state_m[k] = beta * np.sqrt(np.maximum(np.diag(Sigma), 0.0))
    return state_m, input_m


class Problem:
    """The condensed QP of one configuration, on ``device`` in ``dtype``:
    ``H``, the linear term ``f = F x0``, ``G`` and ``h(x0)``."""

    def __init__(self, cfg: dict, dtype=torch.float64, device="cpu"):
        p = cfg["problem"]
        ts, N = float(p["Ts"]), int(p["N"])
        A = np.array([[1.0, ts], [0.0, 1.0]])
        B = np.array([[0.0], [ts]])
        nx, nu = B.shape
        Q, R = np.diag(p["Q"]), np.diag(p["R"])
        Phi = np.zeros((N * nx, nx))
        Gam = np.zeros((N * nx, N * nu))
        for k in range(N):
            Phi[k * nx:(k + 1) * nx] = np.linalg.matrix_power(A, k + 1)
            for j in range(k + 1):
                Gam[k * nx:(k + 1) * nx, j * nu:(j + 1) * nu] = np.linalg.matrix_power(A, k - j) @ B
        P, K = dare(A, B, Q, R)
        terminal = p.get("terminal", "Q")
        if terminal not in ("Q", "dare"):
            raise ValueError(f"unknown terminal {terminal!r}")
        Qb = np.kron(np.eye(N), Q)
        if terminal == "dare":
            Qb[-nx:, -nx:] = P
        Rb = np.kron(np.eye(N), R)
        state_m, input_m = np.zeros((N, nx)), np.zeros((N, nu))
        if "chance" in p:
            state_m, input_m = chance_margins(A, B, K, np.asarray(p["chance"]["sigma_w"], float),
                                              N, float(p["chance"]["eps"]))
        n = N * nu
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
        self.nx, self.nu, self.N, self.n = nx, nu, N, n
        self.A, self.B = t(A), t(B)
        self.H = t(Gam.T @ Qb @ Gam + Rb)
        self.F = t(Gam.T @ Qb @ Phi)
        self.Phi = t(Phi)
        eye = np.eye(n)
        self.G = t(np.concatenate([eye, -eye, Gam, -Gam]))
        x_max, x_min = np.array([p["p_max"], p["v_max"]]), np.array([p["p_min"], p["v_min"]])
        self.h_const = t(np.concatenate([
            p["u_max"] - input_m.reshape(-1), -(p["u_min"] + input_m.reshape(-1)),
            (x_max - state_m).reshape(-1), -(x_min + state_m).reshape(-1),
        ]))
        self.state_rows = slice(2 * n, 2 * n + 2 * N * nx)

    def vectors(self, x0: torch.Tensor, mm=torch.matmul):
        """``(f, h)`` of the QPs at states ``x0 (B, nx)``."""
        f = mm(x0, self.F.T)
        shift = mm(x0, self.Phi.T)
        h = self.h_const.expand(x0.shape[0], -1).clone()
        Nn = shift.shape[1]
        lo = self.state_rows.start
        h[:, lo:lo + Nn] -= shift
        h[:, lo + Nn:lo + 2 * Nn] += shift
        return f, h


def ipm(H, f, G, h, iters: int = IPM_ITERS, lowp: bool = False):
    """Batched Mehrotra interior point for ``min ½ zᵀHz + fᵀz, Gz ≤ h``.
    Returns ``z`` and the certificate ``(dual residual, primal violation,
    largest complementarity product)``, each per problem. ``lowp``: every
    matrix product on TF32-rounded operands."""
    mm = _matmul(lowp)
    Bn, n = f.shape
    GT = G.T.contiguous()
    z = torch.zeros(Bn, n, dtype=f.dtype, device=f.device)
    s = torch.clamp(h, min=1.0)
    lam = torch.ones_like(h)
    big = torch.full_like(h, 1e30)
    for _ in range(iters):
        rd = mm(z, H) + f + mm(lam, G)
        rp = mm(z, GT) + s - h
        mu = (s * lam).mean(1, keepdim=True)
        W = lam / s
        K = H + mm(GT[None] * W[:, None, :], G)
        L, info = torch.linalg.cholesky_ex(K)

        def direction(rc):
            rhs = -rd - mm(W * rp - rc / s, G)
            dz = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            Gdz = mm(dz, GT)
            return dz, -rp - Gdz, W * (Gdz + rp) - rc / s

        def longest(ds, dl):
            a = torch.minimum(torch.where(ds < 0, -s / ds, big).amin(1, keepdim=True),
                              torch.where(dl < 0, -lam / dl, big).amin(1, keepdim=True))
            return torch.clamp(a, max=1.0)

        dz, ds, dl = direction(s * lam)
        a = longest(ds, dl)
        sigma = (((s + a * ds) * (lam + a * dl)).mean(1, keepdim=True) / mu) ** 3
        dz, ds, dl = direction(s * lam + ds * dl - sigma * mu)
        a = 0.99 * longest(ds, dl)
        go = (info == 0)[:, None] & (mu > 1e-15) & torch.isfinite(dz).all(1, keepdim=True)
        z = torch.where(go, z + a * dz, z)
        s = torch.where(go, s + a * ds, s)
        lam = torch.where(go, lam + a * dl, lam)
    rd = (z @ H + f + lam @ G).abs().amax(1)
    viol = torch.clamp(z @ GT - h, min=0.0).amax(1)
    comp = (torch.clamp(h - z @ GT, min=0.0) * lam).amax(1)
    return z, rd, viol, comp


class ControlLoop:
    """The reference put in the program's place, in TF32: each step the
    interior point above on TF32 products, then the plant on TF32 products.
    ``step(x, w)`` returns ``(u, x_next)``."""

    def __init__(self, cfg: dict, device):
        self.prob = Problem(cfg, torch.float32, device)
        self.mm = _matmul(True)

    def step(self, x, w=None):
        f, h = self.prob.vectors(x, self.mm)
        z = ipm(self.prob.H, f, self.prob.G, h, lowp=True)[0]
        u = z[:, : self.prob.nu]
        x_next = self.mm(x, self.prob.A.T) + self.mm(u, self.prob.B.T)
        return u, (x_next if w is None else x_next + w)


def judge(cfg: dict, sample: dict, device, block: int = 32768) -> dict:
    """The readings of ``S`` answers, each a measured state ``x (S, nx)``,
    the input the program applied ``u (S, nu)``, the disturbance ``w (S,
    nx)`` (or ``None``) and the next state ``xn (S, nx)`` (``sample``'s
    keys):

    - ``u_gap``: the largest distance of an applied input from the exact
      optimum's first input at the same measured state, over every answer,
      whether or not the program reported its solve converged (QPs the judge
      cannot certify, an infeasible one, are counted as ``unjudged``);
    - ``plant_gap``: the largest distance of a next state from the plant's
      ``A x + B u + w``, over ``1 + |x|``.

    Computed in float64, the interior point in blocks of ``block`` solves."""
    d = torch.float64
    prob = Problem(cfg, d, device)
    xs, xn, us = (sample[k].to(device, d) for k in ("x", "xn", "u"))
    pred = xs @ prob.A.T + us @ prob.B.T
    if sample["w"] is not None:
        pred = pred + sample["w"].to(device, d)
    plant_gap = ((xn - pred).abs().amax(1) / (1.0 + xs.abs().amax(1))).max().item()
    gaps, unjudged = [], 0
    for lo in range(0, xs.shape[0], block):
        f, h = prob.vectors(xs[lo:lo + block])
        z, rd, viol, comp = ipm(prob.H, f, prob.G, h)
        scale = 1.0 + torch.maximum(f.abs().amax(1), h.abs().amax(1))
        cert = (rd < CERTIFY * scale) & (viol < CERTIFY * scale) & (comp < CERTIFY * scale)
        gap = (us[lo:lo + block] - z[:, : prob.nu]).abs().amax(1)
        gaps.append(gap[cert])
        unjudged += int((~cert).sum())
    gap = torch.cat(gaps)
    return {
        "u_gap": gap.max().item() if gap.numel() else float("nan"),
        "plant_gap": plant_gap,
        "judged": int(gap.numel()),
        "unjudged": unjudged,
    }
