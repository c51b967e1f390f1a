"""Float64 oracles: the port's own ground truth (port of ``oracle/``).

The reference validates against trusted external solvers (scipy DARE and
odeint, IPOPT); the port's equivalents live here, independent of its solvers
and kernels: numpy Riccati, DARE and prediction-matrix constructions, a
scipy-based parking NLP solve, a certified Python box-QP oracle, and native
C++ oracles (``csrc/oracle/qp_oracle.cpp``: ADMM with an active-set polish
and a KKT certificate; ``nlp_oracle.cpp``: a Gauss-Newton SQP for parking)
loaded through ctypes. Every function takes numpy arrays or tensors on any
device, computes in float64 on the CPU and returns float64 numpy arrays and
Python scalars. ``chip_smoke.py`` holds the card's solutions to them.
"""

from .lqr_oracle import dare_np, lqr_gain_np, riccati_recursion_np, simulate_np
from .mpc_oracle import (
    closed_loop_mpc_np,
    condensed_qp_np,
    prediction_matrices_np,
)
from .parking_oracle import solve_parking_nlp
from .qp_oracle import solve_qp_np
from .native_qp import (
    kkt_residual_native,
    solve_qp_family_native,
    solve_qp_native,
)

__all__ = [
    "dare_np",
    "lqr_gain_np",
    "riccati_recursion_np",
    "simulate_np",
    "closed_loop_mpc_np",
    "condensed_qp_np",
    "prediction_matrices_np",
    "solve_parking_nlp",
    "solve_qp_np",
    "kkt_residual_native",
    "solve_qp_family_native",
    "solve_qp_native",
]
