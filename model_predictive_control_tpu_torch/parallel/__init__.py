"""Scale-out layer: device meshes, scenario-batch sharding, the
tensor-parallel ADMM, multi-process runs, weak scaling, and the
parameter-perturbation sweeps (port of the JAX package's ``parallel/``)."""

from .batch import (
    batched_parking_policy,
    batched_plant,
    initial_warm_carry,
    parking_sweep,
    perturb_parameters,
    quadrotor_sweep,
    racing_sweep,
    racing_sweep_dynamic,
    random_initial_states,
    thruster_sweep,
)
from .distributed import (
    global_mesh,
    initialize,
    make_global_batch,
    process_batch_slice,
    scaling_efficiency,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_constraint_sharding,
    batch_sharding,
    make_mesh,
    replicated,
)
from .tensor_parallel import admm_solve_tp

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_constraint_sharding",
    "batch_sharding",
    "make_mesh",
    "replicated",
    "admm_solve_tp",
    "global_mesh",
    "initialize",
    "make_global_batch",
    "process_batch_slice",
    "scaling_efficiency",
    "batched_parking_policy",
    "batched_plant",
    "initial_warm_carry",
    "parking_sweep",
    "perturb_parameters",
    "quadrotor_sweep",
    "racing_sweep",
    "racing_sweep_dynamic",
    "random_initial_states",
    "thruster_sweep",
]
