"""Float64 numpy/scipy oracle for the LQR layer (port of
``oracle/lqr_oracle.py``; never on the card).

An independent re-implementation of the reference's recursion semantics
(``session_1/session1_sol.py:44-65``) and scipy's LAPACK DARE
(``session_1/FHC.py:97``): the ground truth for the port's Riccati recursion
and its SDA DARE solver. Inputs may be tensors on any device.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from ._native_build import c64


def riccati_recursion_np(A, B, Q, R, Pf, N):
    """Backward recursion in float64; returns (P, K) stacks in stage order."""
    A, B, Q, R, Pf = (c64(m) for m in (A, B, Q, R, Pf))
    P = [Pf]
    K = []
    for _ in range(N):
        Kk = -np.linalg.solve(R + B.T @ P[-1] @ B, B.T @ P[-1] @ A)
        K.append(Kk)
        P.append(Q + A.T @ P[-1] @ (A + B @ Kk))
    return np.stack(P[::-1]), np.stack(K[::-1])


def dare_np(A, B, Q, R):
    """LAPACK DARE (the reference's infinite-horizon path, FHC.py:97)."""
    return scipy.linalg.solve_discrete_are(
        c64(A),
        c64(B),
        c64(Q),
        c64(R),
    )


def lqr_gain_np(A, B, R, P):
    A, B, R, P = (c64(m) for m in (A, B, R, P))
    return -np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)


def simulate_np(x0, f, policy, steps):
    """Reference rollout loop with instability flag (session1_sol.py:68-91)."""
    x = [c64(x0)]
    unstable = False
    for t in range(steps):
        u = policy(x[-1], t)
        x.append(c64(f(x[-1], u)))
        if np.linalg.norm(x[-1]) > 100:
            unstable = True
    return np.stack(x), unstable
