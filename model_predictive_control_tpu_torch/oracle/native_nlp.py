"""ctypes binding for the native C++ parking-NLP oracle (port of
``oracle/native_nlp.py``; source ``csrc/oracle/nlp_oracle.cpp``).

A float64 dual-number-AD Gauss-Newton SQP for the session-4 parking OCP,
its QP subproblems on the native ADMM + polish box-QP of
``csrc/oracle/qp_oracle.cpp``, compiled at first use with g++ and loaded
through ctypes; and a native receding-horizon closed loop (the reference's
exercise-5 loop). It checks the port's SQP and parking solvers independently
of scipy and of torch.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ._native_build import c64 as _c64, load_native_lib, ptr as _ptr

_SOURCES = ("nlp_oracle.cpp", "qp_oracle.cpp")

_lib = None

# VehicleParams packing order (native/nlp_oracle.cpp struct declaration)
_PARAM_FIELDS = (
    "axis_front", "axis_rear", "friction", "acceleration",
    "length", "width",
    "min_pos_x", "max_pos_x", "min_pos_y", "max_pos_y",
    "min_heading", "max_heading", "min_vel", "max_vel",
    "min_drive", "max_drive", "max_steer",
)


def pack_params(params) -> np.ndarray:
    """Pack a ``VehicleParameters`` (or anything with the same attributes,
    floats or 0-d tensors) to float64."""
    return np.asarray(
        [float(getattr(params, f)) for f in _PARAM_FIELDS], dtype=np.float64
    )


def _check_sizes(x0, x_obs, Q, R) -> None:
    """The C side reads 4 states, 4 obstacle states, 4 + 2 weights."""
    if not (x0.size == x_obs.size == Q.size == 4 and R.size == 2):
        raise ValueError("x0, x_obs and Q take 4 entries, R 2")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = load_native_lib("libnlp_oracle.so", _SOURCES)
    d = ctypes.POINTER(ctypes.c_double)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.parking_sqp_solve.restype = ctypes.c_int
    lib.parking_sqp_solve.argtypes = [
        d, ctypes.c_int, ctypes.c_double, ctypes.c_int,  # vp, N, ts, integrator
        d, d, ctypes.c_double,  # Q, R, qn_scale
        d, d, ctypes.c_int, ctypes.c_int,  # x0, x_obs, has_obs, n_circles
        d, ctypes.c_int, ctypes.c_int, ctypes.c_double,  # u_init, iters, qp, tol
        d, d, d, d, ip,  # u_out, cost, kkt, viol, iters_out
    ]
    lib.parking_mpc_closed_loop.restype = ctypes.c_int
    lib.parking_mpc_closed_loop.argtypes = [
        d, d, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        d, d, ctypes.c_double,
        d, d, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        d, d, u8,
    ]
    _lib = lib
    return lib


def solve_parking_native(
    params,
    N: int,
    ts: float,
    x0,
    x_obs=None,
    Q=(1.0, 6.0, 0.2, 0.05),
    R=(1.0, 0.01),
    qn_scale: float = 100.0,
    n_circles: int = 3,
    integrator: str = "euler",
    u_init=None,
    max_iters: int = 200,
    qp_iters: int = 20000,
    tol: float = 1e-7,
):
    """Solve the session-4 parking NLP natively; returns ``(u, info)``.

    ``u``: (N*2,) stacked controls. ``info``: cost/kkt/viol/iters/converged.
    """
    lib = _load()
    vp = pack_params(params)
    x0 = _c64(x0)
    has_obs = x_obs is not None
    xo = _c64(x_obs) if has_obs else np.zeros(4)
    Qd, Rd = _c64(Q), _c64(R)
    _check_sizes(x0, xo, Qd, Rd)
    n = N * 2
    if u_init is not None:
        u_init = _c64(u_init).reshape(-1)
        if u_init.shape != (n,):
            raise ValueError(f"u_init has {u_init.shape[0]} entries, not N * 2 = {n}")
    u_out = np.empty(n, dtype=np.float64)
    cost = ctypes.c_double()
    kkt = ctypes.c_double()
    viol = ctypes.c_double()
    iters = ctypes.c_int()
    status = lib.parking_sqp_solve(
        _ptr(vp), N, ts, {"euler": 0, "rk4": 1}[integrator],
        _ptr(Qd), _ptr(Rd), qn_scale,
        _ptr(x0), _ptr(xo), int(has_obs), n_circles,
        _ptr(u_init) if u_init is not None else None,
        max_iters, qp_iters, tol,
        _ptr(u_out), ctypes.byref(cost), ctypes.byref(kkt), ctypes.byref(viol),
        ctypes.byref(iters),
    )
    if status == 1:
        raise RuntimeError("native NLP: QP subproblem setup failed")
    info = {
        "cost": cost.value,
        "kkt_res": kkt.value,
        "viol": viol.value,
        "iters": iters.value,
        "converged": status == 0,
    }
    return u_out, info


def closed_loop_parking_native(
    params,
    N: int,
    ts: float,
    x0,
    steps: int,
    x_obs=None,
    params_plant=None,
    Q=(1.0, 6.0, 0.2, 0.05),
    R=(1.0, 0.01),
    qn_scale: float = 100.0,
    n_circles: int = 3,
    integrator: str = "euler",
    plant_substeps: int = 16,
    max_iters: int = 100,
    qp_iters: int = 8000,
    tol: float = 1e-6,
):
    """Native receding-horizon closed loop (exercise-5 semantics).

    Returns ``(states (steps+1, 4), inputs (steps, 2), success (steps,) bool)``.
    ``params_plant`` defaults to ``params`` (no mismatch); pass a perturbed set for
    the friction×0.8 experiment (``session4_sol.py:410-411``).
    """
    lib = _load()
    vp = pack_params(params)
    vpp = pack_params(params_plant if params_plant is not None else params)
    x0 = _c64(x0)
    has_obs = x_obs is not None
    xo = _c64(x_obs) if has_obs else np.zeros(4)
    Qd, Rd = _c64(Q), _c64(R)
    _check_sizes(x0, xo, Qd, Rd)
    states = np.empty((steps + 1, 4), dtype=np.float64)
    inputs = np.empty((steps, 2), dtype=np.float64)
    success = np.empty(steps, dtype=np.uint8)
    lib.parking_mpc_closed_loop(
        _ptr(vp), _ptr(vpp), N, ts, {"euler": 0, "rk4": 1}[integrator],
        _ptr(Qd), _ptr(Rd), qn_scale,
        _ptr(x0), _ptr(xo), int(has_obs), n_circles,
        steps, plant_substeps, max_iters, qp_iters, tol,
        _ptr(states), _ptr(inputs),
        success.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return states, inputs, success.astype(bool)
