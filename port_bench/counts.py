"""The yardstick's arithmetic, frozen here so that a later change to the
program cannot move it: the H100's published peaks and the FP32 operations
and bytes an algorithm needs for the iterations it executed.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): 67 TFLOP/s in FP32
outside the tensor cores (the kernels are scalar FP32 code), 3.35 TB/s of
HBM3. A card set below its 700 W limit runs under them: every share is
printed beside the card's power limit.
"""

from __future__ import annotations

FP32_PEAK = 67e12  # FLOP/s
HBM_PEAK = 3.35e12  # B/s


def admm_flops(n: int, m: int, iters: float, checks: float, solves: int) -> float:
    """FP32 operations of the fused ADMM (K1) on the condensed box-QP with
    ``n`` variables and ``m`` rows, ``K = n + m``, for ``iters`` executed
    scenario-iterations, ``checks`` executed chunk ends and ``solves``
    scenarios:

    - an iteration: the product ``[x | ρz − y]·W``, ``2K²``, and about 12
      operations on each of the ``K`` columns (relaxation, projection, dual
      update);
    - a chunk: the chunk's ``q·Wq``, ``2nK``, and its exit check, the
      residual products ``Ax``, ``Px``, ``Aᵀy`` (``4mn + 2n²``) and about 10
      operations a column for the scaled norms and the ρ estimate;
    - a solve: the first ``z = Ax``, ``2mn``.

    The CG polish of a presolve is not counted (its executed iterations are
    not reported), so a share with a polish in it reads low, never high."""
    K = n + m
    return (iters * (2 * K * K + 12 * K)
            + checks * (2 * n * K + 4 * m * n + 2 * n * n + 10 * K)
            + solves * 2 * m * n)


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the chip could take: the larger of the operations
    over the FP32 peak and the bytes over the HBM peak, and which bounds."""
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_PEAK
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
