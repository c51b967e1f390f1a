"""The tracker twin at the wide input widths against the JAX package's
``fused_tracker_solve`` in interpret mode, at the same tile, on inputs made
with numpy from a seed: the omnidirectional base in regulation (nu = 3, the
unrolled Cholesky on a dense 3 × 3 Quu), the same with a per-scenario mass
(``n_params = 1``), and the thrust cluster in regulation (nu = 4, redundant
thrusters: Quu positive definite only through R). Gates as in
``test_torch_benchmark_models.py``: converged masks and executed inner
iterations equal; ``us`` and ``xs`` within 1e-5 after one inner iteration,
within 5e-3 at a 3 × 5 budget.
"""

import pytest

from test_torch_benchmark_models import BUDGET, ONE_ITERATION, check_against_jax


@pytest.mark.parametrize("budget", [ONE_ITERATION, BUDGET], ids=["one_iteration", "budget"])
@pytest.mark.parametrize("case", ["omnibase_regulation", "omnibase_param_mass",
                                  "thruster_regulation"])
def test_twin_matches_pallas_tracker(case, budget):
    check_against_jax(case, budget)
