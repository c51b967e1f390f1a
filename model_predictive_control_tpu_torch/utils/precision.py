"""FP32 matmul policy for solver-grade linear algebra.

Counterpart of ``model_predictive_control_tpu/utils/precision.py``. On the GPU a
float32 matmul may run in TF32 (about three decimal digits) when the global
switches allow it. Solver math must not: the reference measured single-pass
low-precision iteration products collapsing closed-loop success to 0.44
against 0.98 (``ops/pallas/admm_kernel.py:45-48`` of the JAX package). The
solver entry points call :func:`set_solver_precision` before they compute.
"""

from __future__ import annotations

import torch


def set_solver_precision() -> None:
    """Pin every float32 matmul and convolution to full FP32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
