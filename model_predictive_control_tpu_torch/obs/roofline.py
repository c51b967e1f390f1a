"""Roofline accounting for the fused kernels (port of ``obs/roofline.py``).

Turns each fused kernel's *algorithmic* work into FLOPs per solve and
device-memory bytes per solve, so that a measured throughput can be read as
achieved GFLOP/s and as a share of the card's peak. The counts are analytic,
from the algorithm's structure (cited below), and equal the JAX package's at
the same arguments: the work is the same whatever implements it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet), the card the port runs
on; a card set below its 700 W limit runs under them:

- FP32 outside the tensor cores: 67 TFLOP/s. The port's kernels are scalar
  FP32 code on the CUDA cores (no tensor core), so FP32 is the bound;
- HBM3: 3.35 TB/s.
"""

from __future__ import annotations

from dataclasses import dataclass

# --- NVIDIA H100 SXM peaks -----------------------------------------------------
FP32_PEAK = 67e12  # FLOP/s, outside the tensor cores
HBM_BW_PEAK = 3.35e12  # B/s


@dataclass(frozen=True)
class KernelRoofline:
    """Work model of one fused-kernel solve and its achieved/peak ratios."""

    name: str
    flops_per_solve: float  # algorithmic useful FP32 FLOPs (full budget)
    flops_main_loop: float  # the fixed-iteration core only (no checks or polish)
    hbm_bytes_per_solve: float
    notes: str = ""

    @property
    def bound(self) -> str:
        """``"FP32"`` or ``"HBM"``: the peak that caps the solves/s."""
        return ("FP32" if self.flops_per_solve / FP32_PEAK >= self.hbm_bytes_per_solve / HBM_BW_PEAK
                else "HBM")

    def achieved(self, solves_per_s: float) -> dict:
        """Achieved rates at a measured throughput: the useful FLOP rate
        against the FP32 peak, the byte rate against the HBM peak, and the
        throughput against the roofline ceiling (the smaller of the two
        peaks' solves/s)."""
        flop_rate = self.flops_per_solve * solves_per_s
        hbm_rate = self.hbm_bytes_per_solve * solves_per_s
        ceiling = min(FP32_PEAK / self.flops_per_solve, HBM_BW_PEAK / self.hbm_bytes_per_solve)
        return {
            "flops_per_solve": round(self.flops_per_solve),
            "achieved_gflops": round(flop_rate / 1e9, 1),
            "frac_of_peak": round(flop_rate / FP32_PEAK, 4),
            "roofline_ceiling_solves_per_s": round(ceiling, 1),
            "frac_of_ceiling": round(solves_per_s / ceiling, 4),
            "hbm_gb_per_s": round(hbm_rate / 1e9, 2),
            "frac_of_hbm_peak": round(hbm_rate / HBM_BW_PEAK, 5),
            "bound": self.bound,
        }


def admm_kernel_roofline(
    n: int = 20,
    m: int = 60,
    iters: int = 100,
    chunks: int = 2,
    probe_iters: int = 32,
    cg_iters: int = 40,
) -> KernelRoofline:
    """Work model of the fused ADMM solve (``csrc/admm_kernel.cu``) per
    scenario.

    - main loop: per iteration one affine map of the ``n + m`` iterate
      (``(x, z, y) → G·(x, z, y) + g``), 2(n+m)² FLOPs;
    - per-solve setup: the q-term (2·n·(n+m)) and the warm-start projection
      (2·m·n);
    - per exit check (the probe chunk and each chunk): residuals need
      ``A x``, ``Aᵀ y``, ``P x``, ≈ 2(2nm + n²);
    - CG polish (full budget; the early exit usually stops sooner): per CG
      iteration one application of ``P + ρAᵀA`` ≈ 2(n² + 2nm) and ~6n of
      vector work;
    - device memory: read (q, l, u, warm x, warm y), write (x, z, y), FP32.
      The iterations never touch it.
    """
    nm = n + m
    main = iters * 2 * nm * nm
    setup = 2 * n * nm + 2 * m * n
    n_checks = (1 if probe_iters else 0) + chunks
    checks = n_checks * 2 * (2 * n * m + n * n)
    polish = cg_iters * (2 * (n * n + 2 * n * m) + 6 * n)
    hbm = 4 * ((n + 2 * m) + (n + m) + (n + 2 * m))
    return KernelRoofline(
        name="fused_admm",
        flops_per_solve=float(main + setup + checks + polish),
        flops_main_loop=float(main),
        hbm_bytes_per_solve=float(hbm),
        notes="early exits make the full-budget count an upper bound on delivered work",
    )


def al_ilqr_dyn_kernel_roofline(
    N: int = 15,
    nx: int = 6,
    nu: int = 2,
    substeps: int = 4,
    outer_iters: int = 3,
    inner_iters: int = 8,
    ls_alphas: int = 7,
) -> KernelRoofline:
    """Work model of the 6-state Pacejka tracking solve (the fused tracker,
    ``csrc/ilqr_factory.cu``'s ``PacejkaRows``) per scenario.

    Per inner iteration, per stage:
    - the Jacobian by forward-mode tangents: ``substeps × 4`` ODE evaluations
      at ~90 FLOPs each, ×3 for the tangent arithmetic, ×8 directions;
    - the 6×6 backward algebra ≈ 1.1k multiply-adds = 2.2k FLOPs;
    - the line search: ``ls_alphas`` rollouts of ``substeps × 4`` ODE
      evaluations (~90 FLOPs) and the cost rows (~50).
    Device memory: read (x0, u0, refs), write (us, xs, viol, conv).
    """
    ode = 90
    jac_stage = 3 * 8 * substeps * 4 * ode
    backward_stage = jac_stage + 2200
    ls_stage = ls_alphas * (substeps * 4 * ode + 50)
    inner_iter = N * (backward_stage + ls_stage)
    outer_extra = N * (20 * (2 * nu))
    useful = outer_iters * (inner_iters * inner_iter + outer_extra)
    hbm = 4 * (nx + N * nu + (N + 1) * nx + N * nu + (N + 1) * nx + 2)
    return KernelRoofline(
        name="fused_al_ilqr_dyn",
        flops_per_solve=float(useful),
        flops_main_loop=float(outer_iters * inner_iters * inner_iter),
        hbm_bytes_per_solve=float(hbm),
        notes="analytic count +-40% (the tangent pass is estimated, not hand-counted)",
    )


def al_ilqr_kernel_roofline(
    N: int = 30,
    nx: int = 4,
    nu: int = 2,
    n_pairs: int = 9,
    outer_iters: int = 6,
    inner_iters: int = 15,
    ls_alphas: int = 7,
) -> KernelRoofline:
    """Work model of the fused AL-iLQR parking solve (``csrc/ilqr_kernel.cu``)
    per scenario.

    Per inner iteration, per stage:
    - backward pass: dynamics Jacobian rows (~60), the constraint derivative
      rows, dominated by the collision pairs (~60 FLOPs a pair: distance rows,
      Gauss-Newton outer products, exact curvature), the quadratic expansion
      of the 4×4 / 2×4 / 2×2 blocks (~450 multiply-adds), the gain solve ~40;
    - forward line search: ``ls_alphas`` candidate rollouts, dynamics (~60)
      and stage-cost rows (~30 + 8 a pair) each.
    Outer loop: the multiplier update and violation sweep ≈ one constraint
    pass. Device memory: read (x0, u0, params), write (us, xs, viol, conv).
    """
    per_pair = 60
    backward_stage = 60 + per_pair * n_pairs + 450 + 40
    ls_stage = ls_alphas * (60 + 30 + 8 * n_pairs)
    inner_iter = N * (backward_stage + ls_stage)
    outer_extra = N * (20 * (2 * nx + 2 * nu + n_pairs))
    useful = outer_iters * (inner_iters * inner_iter + outer_extra)
    hbm = 4 * (nx + N * nu + 2 + N * nu + (N + 1) * nx + 2)
    return KernelRoofline(
        name="fused_al_ilqr",
        flops_per_solve=float(useful),
        flops_main_loop=float(outer_iters * inner_iters * inner_iter),
        hbm_bytes_per_solve=float(hbm),
        notes="analytic count from the algorithm's row operations, +-30%",
    )
