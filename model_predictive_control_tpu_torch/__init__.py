"""model_predictive_control_tpu_torch — the PyTorch and CUDA port of
``model_predictive_control_tpu``.

Eight paths so far, each on a kernel written in CUDA for Hopper (``csrc/``)
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
  fused stagewise-IP kernel;
- the rest of the linear ADMM family on the fused ADMM kernel: the DARE
  terminal cost, the terminal set, soft state boxes and reference tracking
  of ``make_linear_mpc``; the tube (``tube_sweep``), stochastic
  (``stochastic_sweep``), offset-free and rate-limited controllers; the
  Kalman filter, MHE and the MHE-in-the-loop sweep (``mhe_loop_sweep``,
  whose soft-state MPC takes the kernel's wide mode). Session-1 LQR and the
  single-scenario ``simulate`` come with them;
- the benchmark models of the model-parametric tracker (cart-pole,
  planar quadrotor, omnidirectional base, thrust cluster: ``nu`` from 1 to
  4, in regulation or tracking) and their loiter sweeps (``quadrotor_sweep``,
  ``thruster_sweep``) on the fused tracker kernel;
- the per-scenario nonlinear solvers, batched over scenarios in plain torch
  with ``torch.func`` derivatives: iLQR and AL-iLQR (``ilqr_solve``,
  ``al_ilqr_solve``), the SQP (``sqp_solve``), the parking OCPs and their
  controllers, the tracking NMPC (``TrackingNMPC``, ``make_racing_mpc``) and
  the offset-free NMPC (``OffsetFreeNMPC``, ``DisturbanceCompensatedTracking``);
  the crosswind (``wind_sweep``) and slope (``offset_free_sweep``) loops on
  the AL-iLQR kernel's offset and input-reference modes;
- the obstacle-parking OCP through the model-parametric tracker kernel
  (``al_ilqr_parking_solve_factory``, ``parking_sweep(backend="factory")``:
  the clearances as user constraint rows with their exact curvature, the
  multipliers warm-started), and the nonlinear moving-horizon estimator
  (``NonlinearMHE``: Gauss-Newton windows with a box-QP step, and its
  bounded windows batched on the tracker kernel's additive mode).

Entry points that take ``device`` run on the card unless the caller passes
``device="cpu"``. Imports ``torch`` only.
"""

from .control.batch_loop import BatchSimResult, simulate_batch
from .control.simulate import SimResult, open_loop_policy, policy_from_law, rollout, simulate
from .estimation_nl import (
    NonlinearMHE,
    initial_mhe_feedback_carry,
    mhe_output_feedback_policy,
)
from .estimation import (
    ExtendedKalmanFilter,
    KalmanFilter,
    MHE,
    kalman_filter_trajectory,
    kalman_gain,
    make_mhe,
    mhe_trajectory,
    output_feedback_policy,
)
from .models.bicycle import make_kinematic_ode_rows
from .models.benchmarks import (
    make_cartpole_ode_rows,
    make_omnibase_ode_rows,
    make_omnibase_param_ode_rows,
    make_planar_quadrotor_ode_rows,
    make_thruster_ode_rows,
)
from .models.linear import LinearSystem
from .models.parameters import VehicleParameters
from .ops.cuda.parking_factory import al_ilqr_parking_solve_factory, make_clearance_rows
from .ops.riccati import dare_residual, dare_sda, lqr_gain, riccati_recursion
from .experiments.racing import make_racing_mpc
from .parallel.batch import (
    batched_parking_policy,
    batched_plant,
    boundary_compaction_key,
    make_tracking_ilqr_window,
    mhe_loop_sweep,
    offset_free_sweep,
    parking_sweep,
    quadrotor_sweep,
    racing_sweep,
    racing_sweep_dynamic,
    stochastic_sweep,
    thruster_sweep,
    tube_sweep,
    wind_sweep,
)
from .solvers.linear_mpc import (
    BoxProblem,
    make_box_mpc,
    make_linear_mpc,
    session2_problem,
    session3_problem,
)
from .solvers.lqr import (
    cost_to_go,
    lqr_terminal_set,
    prediction_policy,
    receding_horizon_policy,
    solve_finite_horizon,
    solve_infinite_horizon,
)
from .solvers.ilqr import ALILQRSolution, ILQRProblem, ILQRSolution, al_ilqr_solve, ilqr_solve
from .solvers.nmpc_tracking import TrackingNMPC
from .solvers.offset_free import make_offset_free_mpc
from .solvers.offset_free_nmpc import DisturbanceCompensatedTracking, OffsetFreeNMPC
from .solvers.parking import ILQRMPC, NonlinearMPC, make_parking_ilqr, make_parking_ocp
from .solvers.qp import admm_solve, pdip_solve, qp_setup
from .solvers.rate_mpc import make_rate_limited_mpc
from .solvers.riccati_ip import make_stagewise_mpc, stagewise_ip_solve
from .solvers.sqp import ShootingOCP, SQPSolution, sqp_solve
from .solvers.stochastic import make_stochastic_mpc
from .solvers.tube import make_tube_mpc

__all__ = [
    "ALILQRSolution",
    "BatchSimResult",
    "BoxProblem",
    "DisturbanceCompensatedTracking",
    "ExtendedKalmanFilter",
    "ILQRMPC",
    "ILQRProblem",
    "ILQRSolution",
    "KalmanFilter",
    "LinearSystem",
    "MHE",
    "NonlinearMHE",
    "NonlinearMPC",
    "OffsetFreeNMPC",
    "SQPSolution",
    "ShootingOCP",
    "SimResult",
    "TrackingNMPC",
    "VehicleParameters",
    "admm_solve",
    "al_ilqr_parking_solve_factory",
    "al_ilqr_solve",
    "batched_parking_policy",
    "batched_plant",
    "boundary_compaction_key",
    "cost_to_go",
    "dare_residual",
    "dare_sda",
    "ilqr_solve",
    "initial_mhe_feedback_carry",
    "kalman_filter_trajectory",
    "kalman_gain",
    "lqr_gain",
    "lqr_terminal_set",
    "make_box_mpc",
    "make_cartpole_ode_rows",
    "make_clearance_rows",
    "make_kinematic_ode_rows",
    "make_linear_mpc",
    "make_mhe",
    "make_offset_free_mpc",
    "make_omnibase_ode_rows",
    "make_omnibase_param_ode_rows",
    "make_parking_ilqr",
    "make_parking_ocp",
    "make_planar_quadrotor_ode_rows",
    "make_racing_mpc",
    "make_rate_limited_mpc",
    "make_stagewise_mpc",
    "make_stochastic_mpc",
    "make_thruster_ode_rows",
    "make_tracking_ilqr_window",
    "make_tube_mpc",
    "mhe_loop_sweep",
    "mhe_output_feedback_policy",
    "mhe_trajectory",
    "offset_free_sweep",
    "open_loop_policy",
    "output_feedback_policy",
    "parking_sweep",
    "pdip_solve",
    "policy_from_law",
    "prediction_policy",
    "qp_setup",
    "quadrotor_sweep",
    "racing_sweep",
    "racing_sweep_dynamic",
    "receding_horizon_policy",
    "riccati_recursion",
    "rollout",
    "session2_problem",
    "session3_problem",
    "simulate",
    "simulate_batch",
    "solve_finite_horizon",
    "solve_infinite_horizon",
    "sqp_solve",
    "stagewise_ip_solve",
    "stochastic_sweep",
    "thruster_sweep",
    "tube_sweep",
    "wind_sweep",
]
