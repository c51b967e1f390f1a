"""model_predictive_control_tpu_torch — the PyTorch and CUDA port of
``model_predictive_control_tpu``.

Five paths so far, each on a kernel written in CUDA for Hopper (``csrc/``)
with its plain-PyTorch twin:

- the closed-loop linear MPC (session-2 problem data, condensed box-QP, the
  fused ADMM kernel, the batched closed loop);
- the nonlinear obstacle-parking sweep (kinematic bicycle, fine-RK4 plant,
  the fused AL-iLQR kernel);
- the kinematic lap-tracking sweep (``racing_sweep``) and the 6-state
  Pacejka lap-tracking sweep (``racing_sweep_dynamic``), both on the
  model-parametric fused tracker kernel;
- the long-horizon closed-loop linear MPC (``make_stagewise_mpc``): the
  stagewise Riccati interior-point solver, batched in plain torch and as the
  fused stagewise-IP kernel.

Entry points that take ``device`` run on the card unless the caller passes
``device="cpu"``. Imports ``torch`` only.
"""

from .control.batch_loop import BatchSimResult, simulate_batch
from .models.parameters import VehicleParameters
from .parallel.batch import (
    batched_parking_policy,
    batched_plant,
    boundary_compaction_key,
    parking_sweep,
    racing_sweep,
    racing_sweep_dynamic,
)
from .solvers.linear_mpc import make_linear_mpc, session2_problem
from .solvers.riccati_ip import make_stagewise_mpc, stagewise_ip_solve

__all__ = [
    "BatchSimResult",
    "VehicleParameters",
    "batched_parking_policy",
    "batched_plant",
    "boundary_compaction_key",
    "make_linear_mpc",
    "make_stagewise_mpc",
    "parking_sweep",
    "racing_sweep",
    "racing_sweep_dynamic",
    "session2_problem",
    "simulate_batch",
    "stagewise_ip_solve",
]
