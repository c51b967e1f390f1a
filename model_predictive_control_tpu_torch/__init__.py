"""model_predictive_control_tpu_torch — the PyTorch and CUDA port of
``model_predictive_control_tpu``.

Nine paths so far, each on a kernel written in CUDA for Hopper (``csrc/``)
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
  whose soft-state MPC takes the kernel's panel mode). Session-1 LQR and the
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
  bounded windows batched on the tracker kernel's additive mode);
- the differentiable layer: the box-QP, the stagewise interior point and the
  AL-iLQR differentiated at their KKT points (``make_implicit_qp_solver``,
  ``stagewise_ip_solve_implicit``, ``make_implicit_al_ilqr_solver``,
  ``make_implicit_al_ilqr_param_solver``), the differentiable linear-MPC
  policy, and weight tuning against a true closed-loop cost
  (``tune_mpc_weights``; ``tune_parking_weights``, whose fused forward solves
  every scenario in one launch of the tracker kernel with per-lane weights);
  and the O(log N) parallel-in-horizon rollouts, Riccati recursion and LQ
  solve (``lqt_solve_parallel``, ``stagewise_ip_solve(parallel=True)``).

The top level binds every name the JAX package's binds to the port's
counterpart (``fused_tracker_solve`` is ``fused_tracker_solve_cuda``: the
kernel on CUDA tensors, its twin on CPU ones); ``oracle`` holds the float64
oracles (numpy, scipy and native C++) the card's answers are held to.
``tests/test_torch_public_api.py`` checks the surface against the JAX
package's.

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
    ekf_output_feedback_policy,
    ekf_trajectory,
    initial_ekf_carry,
    initial_output_feedback_carry,
    kalman_filter_trajectory,
    kalman_gain,
    make_mhe,
    mhe_trajectory,
    output_feedback_policy,
)
from .models.bicycle import (
    DynamicBicycle,
    KinematicBicycle,
    dynamic_bicycle_ode,
    kinematic_bicycle_ode,
    make_kinematic_ode_rows,
)
from .models.benchmarks import (
    make_cartpole_ode_rows,
    make_omnibase_ode_rows,
    make_omnibase_param_ode_rows,
    make_planar_quadrotor_ode_rows,
    make_thruster_ode_rows,
)
from .models.linear import (
    LinearSystem,
    double_integrator_continuous,
    double_integrator_discrete,
    session2_dynamics,
)
from .models.parameters import VehicleParameters
from .ops.condensed import (
    CondensedQP,
    SoftCondensedQP,
    build_condensed_qp,
    prediction_matrices,
    soften_condensed_qp,
)
from .ops.cuda.ilqr_factory import (
    BatchedTrackerSolution,
    make_fused_tracker,
    rowform_to_vector,
    step_jacobian_pattern,
)
from .ops.cuda.ilqr_factory import fused_tracker_solve_cuda as fused_tracker_solve
from .ops.cuda.parking_factory import al_ilqr_parking_solve_factory, make_clearance_rows
from .ops.integrators import euler, get_integrator, heun, rk4, rk4_fine
from .ops.parallel_horizon import (
    affine_rollout_parallel,
    lqt_solve_parallel,
    riccati_recursion_parallel,
    rollout_parallel,
)
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
    LinearMPC,
    Problem,
    as_box_problem,
    make_box_mpc,
    make_linear_mpc,
    session2_problem,
    session3_problem,
)
from .solvers.lqr import (
    LQRSolution,
    cost_to_go,
    lqr_terminal_set,
    prediction_policy,
    receding_horizon_policy,
    solve_finite_horizon,
    solve_infinite_horizon,
)
from .solvers.implicit import (
    admm_solve_implicit,
    implicit_qp_solver,
    make_implicit_al_ilqr_param_solver,
    make_implicit_al_ilqr_solver,
    make_implicit_qp_solver,
    make_implicit_stagewise_solver,
    pdip_solve_implicit,
    stagewise_ip_solve_implicit,
)
from .solvers.ilqr import ALILQRSolution, ILQRProblem, ILQRSolution, al_ilqr_solve, ilqr_solve
from .solvers.nmpc_tracking import TrackingNMPC
from .solvers.offset_free import OffsetFreeMPC, make_offset_free_mpc
from .solvers.offset_free_nmpc import DisturbanceCompensatedTracking, OffsetFreeNMPC
from .solvers.parking import ILQRMPC, NonlinearMPC, make_parking_ilqr, make_parking_ocp
from .solvers.qp import QPOperator, QPSolution, admm_solve, pdip_solve, qp_setup
from .solvers.rate_mpc import (
    RateCondensedQP,
    RateLimitedMPC,
    build_rate_condensed_qp,
    make_rate_limited_mpc,
)
from .solvers.riccati_ip import (
    StagewiseIPResult,
    StagewiseMPC,
    make_stagewise_mpc,
    stagewise_ip_solve,
)
from .solvers.sqp import ShootingOCP, SQPSolution, sqp_solve
from .solvers.stochastic import StochasticMPC, gaussian_stage_margins, make_stochastic_mpc
from .solvers.tube import TubeMPC, make_tube_mpc, mrpi_box_margins
from .tuning import (
    TuneResult,
    make_closed_loop_cost,
    make_fused_parking_forward,
    make_parking_closed_loop_cost,
    theta_to_weights,
    tune_mpc_weights,
    tune_parking_weights,
)

__all__ = [
    "ALILQRSolution",
    "BatchSimResult",
    "BatchedTrackerSolution",
    "BoxProblem",
    "CondensedQP",
    "DisturbanceCompensatedTracking",
    "DynamicBicycle",
    "ExtendedKalmanFilter",
    "ILQRMPC",
    "ILQRProblem",
    "ILQRSolution",
    "KalmanFilter",
    "KinematicBicycle",
    "LQRSolution",
    "LinearMPC",
    "LinearSystem",
    "MHE",
    "NonlinearMHE",
    "NonlinearMPC",
    "OffsetFreeMPC",
    "OffsetFreeNMPC",
    "Problem",
    "QPOperator",
    "QPSolution",
    "RateCondensedQP",
    "RateLimitedMPC",
    "SQPSolution",
    "ShootingOCP",
    "SimResult",
    "SoftCondensedQP",
    "StagewiseIPResult",
    "StagewiseMPC",
    "StochasticMPC",
    "TrackingNMPC",
    "TubeMPC",
    "TuneResult",
    "VehicleParameters",
    "admm_solve",
    "admm_solve_implicit",
    "affine_rollout_parallel",
    "al_ilqr_parking_solve_factory",
    "al_ilqr_solve",
    "as_box_problem",
    "batched_parking_policy",
    "batched_plant",
    "boundary_compaction_key",
    "build_condensed_qp",
    "build_rate_condensed_qp",
    "cost_to_go",
    "dare_residual",
    "dare_sda",
    "double_integrator_continuous",
    "double_integrator_discrete",
    "dynamic_bicycle_ode",
    "ekf_output_feedback_policy",
    "ekf_trajectory",
    "euler",
    "fused_tracker_solve",
    "gaussian_stage_margins",
    "get_integrator",
    "heun",
    "ilqr_solve",
    "implicit_qp_solver",
    "initial_ekf_carry",
    "initial_mhe_feedback_carry",
    "initial_output_feedback_carry",
    "kalman_filter_trajectory",
    "kalman_gain",
    "kinematic_bicycle_ode",
    "lqr_gain",
    "lqr_terminal_set",
    "lqt_solve_parallel",
    "make_box_mpc",
    "make_cartpole_ode_rows",
    "make_clearance_rows",
    "make_closed_loop_cost",
    "make_fused_parking_forward",
    "make_fused_tracker",
    "make_implicit_al_ilqr_param_solver",
    "make_implicit_al_ilqr_solver",
    "make_implicit_qp_solver",
    "make_implicit_stagewise_solver",
    "make_kinematic_ode_rows",
    "make_linear_mpc",
    "make_mhe",
    "make_offset_free_mpc",
    "make_omnibase_ode_rows",
    "make_omnibase_param_ode_rows",
    "make_parking_closed_loop_cost",
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
    "mrpi_box_margins",
    "offset_free_sweep",
    "open_loop_policy",
    "output_feedback_policy",
    "parking_sweep",
    "pdip_solve",
    "pdip_solve_implicit",
    "policy_from_law",
    "prediction_matrices",
    "prediction_policy",
    "qp_setup",
    "quadrotor_sweep",
    "racing_sweep",
    "racing_sweep_dynamic",
    "receding_horizon_policy",
    "riccati_recursion",
    "riccati_recursion_parallel",
    "rk4",
    "rk4_fine",
    "rollout",
    "rollout_parallel",
    "rowform_to_vector",
    "session2_dynamics",
    "session2_problem",
    "session3_problem",
    "simulate",
    "simulate_batch",
    "soften_condensed_qp",
    "solve_finite_horizon",
    "solve_infinite_horizon",
    "sqp_solve",
    "stagewise_ip_solve",
    "stagewise_ip_solve_implicit",
    "step_jacobian_pattern",
    "stochastic_sweep",
    "theta_to_weights",
    "thruster_sweep",
    "tube_sweep",
    "tune_mpc_weights",
    "tune_parking_weights",
    "wind_sweep",
]

__version__ = "0.1.0"
