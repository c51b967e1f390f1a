"""ctypes binding for the native C++ box-QP oracle (port of
``oracle/native_qp.py``; source ``csrc/oracle/qp_oracle.cpp``).

A float64 dense ADMM with an active-set polish and a KKT certificate,
compiled at first use with g++ and loaded through ctypes: an oracle
independent of the port's solvers and kernels (another algorithm, another
precision), and a CPU solves/s baseline. The inputs may be numpy arrays or
tensors on any device; the results are float64 numpy arrays and Python
scalars. The library is built into ``build/native/`` at first use (about a
second).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ._native_build import c64 as _c64, load_native_lib, ptr as _ptr

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = load_native_lib("libqp_oracle.so", ("qp_oracle.cpp",))
    d = ctypes.POINTER(ctypes.c_double)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.admm_box_qp_family.restype = ctypes.c_int
    lib.admm_box_qp_family.argtypes = [
        d, d, ctypes.c_int, ctypes.c_int,  # P, A, n, m
        d, d, d, ctypes.c_int,  # Q, L, U, batch
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, d, d, u8,
    ]
    lib.qp_kkt_residual.restype = ctypes.c_double
    lib.qp_kkt_residual.argtypes = [
        d, d, d, d, d, ctypes.c_int, ctypes.c_int, d, d
    ]
    _lib = lib
    return lib


def solve_qp_family_native(
    P, A, Q, L, U,
    rho: float = 1.0,
    sigma: float = 1e-6,
    iters: int = 4000,
    eps_abs: float = 1e-9,
    polish: bool = True,
):
    """Solve ``batch`` box QPs sharing (P, A): ``min ½xᵀPx + qᵀx, l ≤ Ax ≤ u``.

    ``Q``: (batch, n), ``L``/``U``: (batch, m). Returns ``(X, Y, converged)``.
    """
    lib = _load()
    P, A = _c64(P), _c64(A)
    Q, L, U = _c64(Q), _c64(L), _c64(U)
    batch, n = Q.shape
    m = L.shape[1]
    if not (P.shape == (n, n) and A.shape == (m, n) and U.shape == (batch, m)):
        raise ValueError(f"shapes do not match: P {P.shape}, A {A.shape}, Q {Q.shape}, "
                         f"L {L.shape}, U {U.shape}")
    X = np.empty((batch, n), dtype=np.float64)
    Y = np.empty((batch, m), dtype=np.float64)
    conv = np.empty(batch, dtype=np.uint8)
    status = lib.admm_box_qp_family(
        _ptr(P), _ptr(A), n, m, _ptr(Q), _ptr(L), _ptr(U), batch,
        rho, sigma, iters, eps_abs, int(polish),
        _ptr(X), _ptr(Y),
        conv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if status != 0:
        raise RuntimeError("native QP setup failed (KKT matrix not SPD)")
    return X, Y, conv.astype(bool)


def solve_qp_native(P, q, A, l, u, **kw):
    """Single-instance wrapper; returns ``(x, y, converged)``."""
    X, Y, conv = solve_qp_family_native(
        P, A, _c64(q)[None], _c64(l)[None], _c64(u)[None], **kw
    )
    return X[0], Y[0], bool(conv[0])


def kkt_residual_native(P, q, A, l, u, x, y) -> float:
    """KKT residual (max of stationarity and primal violation) from the C side."""
    lib = _load()
    P, q, A, l, u, x, y = map(_c64, (P, q, A, l, u, x, y))
    n, m = P.shape[0], A.shape[0]
    if not (P.shape == (n, n) and A.shape == (m, n) and q.shape == x.shape == (n,)
            and l.shape == u.shape == y.shape == (m,)):
        raise ValueError("shapes do not match: P (n, n), A (m, n), q and x (n,), l, u and "
                         "y (m,)")
    return float(
        lib.qp_kkt_residual(
            _ptr(P), _ptr(q), _ptr(A), _ptr(l), _ptr(u), n, m, _ptr(x), _ptr(y)
        )
    )
