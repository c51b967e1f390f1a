"""Float64 oracle for box/two-sided-inequality QPs (port of
``oracle/qp_oracle.py``).

The stand-in for IPOPT (the reference's native solver,
``session_4/main.py:39``) as the trusted ground truth: scipy SLSQP finds the
active set; an exact equality-KKT solve on that active set refines to ~1e-10
KKT residuals when it validates (right dual signs, still feasible), and an
adaptive interior point takes over where SLSQP fails. The oracle checks its
own KKT certificate before it returns, so a wrong oracle fails loudly rather
than blessing a wrong solver. Inputs may be tensors on any device.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize

from ._native_build import c64


def _kkt_residuals(P, q, A, l, u, x, y):
    Ax = A @ x
    stat = np.max(np.abs(P @ x + q + A.T @ y))
    viol_u = np.where(np.isfinite(u), Ax - u, -np.inf)
    viol_l = np.where(np.isfinite(l), l - Ax, -np.inf)
    prim = max(np.max(viol_u), np.max(viol_l), 0.0)
    return stat, prim


def _pdip_np(P, q, A, l, u, max_iter=200, tol=1e-11):
    """Adaptive float64 Mehrotra PDIP fallback (runs until the certificate holds).

    Written in plain numpy with Python control flow — the oracle is allowed to
    branch; only the device solvers must be branch-free.
    """
    n = P.shape[0]
    G = np.vstack([A, -A])
    h = np.concatenate([u, -l])
    keep = np.isfinite(h)
    G, h = G[keep], h[keep]
    m = G.shape[0]
    if m == 0:
        return np.linalg.solve(P, -q), np.zeros(A.shape[0])

    x = np.linalg.solve(P + 1e-10 * np.eye(n), -q)
    s = np.clip(h - G @ x, 1.0, None)
    lam = 1.0 / s
    for _ in range(max_iter):
        r_d = P @ x + q + G.T @ lam
        r_g = G @ x + s - h
        mu = s @ lam / m
        if max(np.abs(r_d).max(), np.abs(r_g).max(), mu) < tol:
            break
        W = lam / s

        def solve_newton(r_s):
            KKT = P + (G.T * W) @ G
            rhs = -r_d - G.T @ ((lam * r_g - r_s) / s)
            dx = np.linalg.solve(KKT, rhs)
            ds = -r_g - G @ dx
            dlam = (-r_s - lam * ds) / s
            return dx, ds, dlam

        def alpha(v, dv):
            neg = dv < 0
            return min(1.0, 0.99 * np.min(-v[neg] / dv[neg])) if neg.any() else 1.0

        dx_a, ds_a, dl_a = solve_newton(s * lam)
        a_aff = min(alpha(s, ds_a), alpha(lam, dl_a))
        mu_aff = (s + a_aff * ds_a) @ (lam + a_aff * dl_a) / m
        sig = (mu_aff / mu) ** 3
        dx, ds, dlam = solve_newton(s * lam + ds_a * dl_a - sig * mu)
        a = min(alpha(s, ds), alpha(lam, dlam))
        x, s, lam = x + a * dx, s + a * ds, lam + a * dlam

    lam_full = np.zeros(2 * A.shape[0])
    lam_full[keep] = lam
    y = lam_full[: A.shape[0]] - lam_full[A.shape[0] :]
    return x, y


def solve_qp_np(P, q, A, l, u, x0=None, assert_tol: float = 1e-6):
    """min ½xᵀPx + qᵀx s.t. l ≤ Ax ≤ u (entries of l/u may be ±inf).

    Returns (x, y) with the two-sided dual convention y_i > 0 ⇔ upper bound active.
    """
    P = c64(P)
    q = c64(q)
    A = c64(A)
    l = c64(l)
    u = c64(u)
    n = P.shape[0]
    finite_l = np.isfinite(l)
    finite_u = np.isfinite(u)

    cons = []
    if finite_u.any():
        Au, uu = A[finite_u], u[finite_u]
        cons.append(
            {"type": "ineq", "fun": lambda x: uu - Au @ x, "jac": lambda x: -Au}
        )
    if finite_l.any():
        Al, ll = A[finite_l], l[finite_l]
        cons.append(
            {"type": "ineq", "fun": lambda x: Al @ x - ll, "jac": lambda x: Al}
        )

    res = minimize(
        lambda x: 0.5 * x @ P @ x + q @ x,
        np.zeros(n) if x0 is None else c64(x0),
        jac=lambda x: P @ x + q,
        constraints=cons,
        method="SLSQP",
        options={"maxiter": 1000, "ftol": 1e-14},
    )
    x = res.x

    # finite-safe activity tolerance
    l0 = np.where(finite_l, l, 0.0)
    u0 = np.where(finite_u, u, 0.0)
    act_tol = 1e-5 * (1.0 + np.abs(l0) + np.abs(u0) + np.abs(A @ x))

    def detect_active(x):
        Ax = A @ x
        low = finite_l & (Ax <= l + act_tol)
        up = finite_u & (Ax >= u - act_tol)
        return low, up

    def dual_from_active(x, low, up):
        act = low | up
        y = np.zeros(A.shape[0])
        if act.any():
            nu, *_ = np.linalg.lstsq(A[act].T, -(P @ x + q), rcond=None)
            y[act] = nu
        return y

    low, up = detect_active(x)
    y = dual_from_active(x, low, up)
    best = (x, y)
    best_res = max(_kkt_residuals(P, q, A, l, u, x, y))

    # equality-KKT refinement on the detected active set (validated accept)
    act = low | up
    if act.any():
        A_act = A[act]
        b = np.where(low, l, u)[act]
        k = A_act.shape[0]
        K = np.block([[P, A_act.T], [A_act, np.zeros((k, k))]])
        rhs = np.concatenate([-q, b])
        try:
            sol = np.linalg.solve(K, rhs)
        except np.linalg.LinAlgError:
            sol, *_ = np.linalg.lstsq(K, rhs, rcond=None)
        x_r = sol[:n]
        y_r = np.zeros(A.shape[0])
        y_r[act] = sol[n:]
        # dual sign convention: lower-active ⇒ y ≤ 0, upper-active ⇒ y ≥ 0
        signs_ok = np.all(y_r[low & ~up] <= 1e-8) and np.all(
            y_r[up & ~low] >= -1e-8
        )
        res_r = max(_kkt_residuals(P, q, A, l, u, x_r, y_r))
        if signs_ok and res_r < best_res:
            best, best_res = (x_r, y_r), res_r

    x, y = best

    def certificate(x, y):
        """Full KKT certificate: stationarity, feasibility, dual signs,
        complementarity — sufficient for optimality of a convex QP."""
        stat, prim = _kkt_residuals(P, q, A, l, u, x, y)
        Ax = A @ x
        gap_u = np.where(finite_u, u - Ax, np.inf)
        gap_l = np.where(finite_l, Ax - l, np.inf)
        comp = np.max(
            np.maximum(np.maximum(y, 0.0) * np.minimum(gap_u, 1e6),
                       np.maximum(-y, 0.0) * np.minimum(gap_l, 1e6))
        ) if A.shape[0] else 0.0
        sign_bad = np.any((~finite_u) & (y > 1e-9)) or np.any(
            (~finite_l) & (y < -1e-9)
        )
        return max(stat, prim, comp) if not sign_bad else np.inf

    if certificate(x, y) >= assert_tol:
        # SLSQP path failed (badly scaled QP) — adaptive PDIP fallback.
        x, y = _pdip_np(P, q, A, l, u)

    cert = certificate(x, y)
    if not cert < assert_tol:
        raise RuntimeError(f"oracle KKT certificate {cert:.2e}")
    return x, y
