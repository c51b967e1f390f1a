"""model_predictive_control_tpu_torch — the PyTorch and CUDA port of
``model_predictive_control_tpu``.

The closed-loop linear-MPC main path: session-2 problem data, condensed
box-QP, the fused ADMM kernel written in CUDA for Hopper (``csrc/``) with its
plain-PyTorch twin, and the batched closed loop. Imports ``torch`` only.
"""

from .control.batch_loop import BatchSimResult, simulate_batch
from .parallel.batch import boundary_compaction_key
from .solvers.linear_mpc import make_linear_mpc, session2_problem

__all__ = [
    "BatchSimResult",
    "boundary_compaction_key",
    "make_linear_mpc",
    "session2_problem",
    "simulate_batch",
]
