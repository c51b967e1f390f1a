"""Float64 oracle for the condensed linear-MPC loop (port of
``oracle/mpc_oracle.py``).

An independent numpy construction of the prediction matrices and the
condensed QP (plain Python loops, another code shape than the port's
``ops/condensed.py``) and a receding-horizon closed loop on the
SLSQP-based QP oracle: the stand-in for the reference's session-2/3 solver
scripts, giving the golden u-trajectories of the 1e-4 gate. Inputs may be
tensors on any device.
"""

from __future__ import annotations

import numpy as np

from ._native_build import c64
from .qp_oracle import solve_qp_np


def prediction_matrices_np(A, B, N):
    A = c64(A)
    B = c64(B)
    nx, nu = B.shape
    Phi = np.zeros((N * nx, nx))
    Gamma = np.zeros((N * nx, N * nu))
    Ak = np.eye(nx)
    for k in range(N):
        Ak = A @ Ak  # A^{k+1}
        Phi[k * nx : (k + 1) * nx] = Ak
    for k in range(N):
        for j in range(k + 1):
            Gamma[k * nx : (k + 1) * nx, j * nu : (j + 1) * nu] = (
                np.linalg.matrix_power(A, k - j) @ B
            )
    return Phi, Gamma


def condensed_qp_np(A, B, Q, R, QN, N, x_ref=None):
    nx, nu = c64(B).shape
    Q, R, QN = c64(Q), c64(R), c64(QN)
    Phi, Gamma = prediction_matrices_np(A, B, N)
    Qbar = np.zeros((N * nx, N * nx))
    for k in range(N - 1):
        Qbar[k * nx : (k + 1) * nx, k * nx : (k + 1) * nx] = Q
    Qbar[(N - 1) * nx :, (N - 1) * nx :] = QN
    Rbar = np.kron(np.eye(N), R)
    P = 2.0 * (Gamma.T @ Qbar @ Gamma + Rbar)
    q_x0 = 2.0 * Gamma.T @ Qbar @ Phi
    if x_ref is None:
        q_const = np.zeros(N * nu)
    else:
        x_ref = c64(x_ref)
        if x_ref.ndim == 1:
            x_ref = np.tile(x_ref[None], (N, 1))
        q_const = -2.0 * Gamma.T @ Qbar @ x_ref.reshape(N * nx)
    return P, q_x0, q_const, Phi, Gamma


def closed_loop_mpc_np(problem_dict, x0, steps, x_ref=None):
    """Receding-horizon closed loop in float64 with the SLSQP oracle per step.

    ``problem_dict``: {A, B, Q, R, QN, N, u_min, u_max, x_min, x_max}.
    Returns dict with states (steps+1, nx), inputs (steps, nu), success list,
    predictions (steps, N, nx).
    """
    A = c64(problem_dict["A"])
    B = c64(problem_dict["B"])
    N = problem_dict["N"]
    nx, nu = B.shape
    P, q_x0, q_const, Phi, Gamma = condensed_qp_np(
        A,
        B,
        c64(problem_dict["Q"]),
        c64(problem_dict["R"]),
        c64(problem_dict["QN"]),
        N,
        x_ref=x_ref,
    )
    A_c = np.vstack([np.eye(N * nu), Gamma])
    u_lb = np.tile(c64(problem_dict["u_min"]), N)
    u_ub = np.tile(c64(problem_dict["u_max"]), N)
    x_lb = np.tile(c64(problem_dict["x_min"]), N)
    x_ub = np.tile(c64(problem_dict["x_max"]), N)

    x = c64(x0)
    states = [x]
    inputs = []
    success = []
    predictions = []
    u_prev = None
    for _ in range(steps):
        q = q_x0 @ x + q_const
        shift = Phi @ x
        l = np.concatenate([u_lb, x_lb - shift])
        u = np.concatenate([u_ub, x_ub - shift])
        z, _ = solve_qp_np(P, q, A_c, l, u, x0=u_prev)
        u_traj = z.reshape(N, nu)
        predictions.append((shift + Gamma @ z).reshape(N, nx))
        inputs.append(u_traj[0])
        success.append(True)
        x = A @ x + B @ u_traj[0]
        states.append(x)
        u_prev = np.concatenate([z[nu:], z[-nu:]])
    return {
        "states": np.stack(states),
        "inputs": np.stack(inputs),
        "success": success,
        "predictions": np.stack(predictions),
    }
