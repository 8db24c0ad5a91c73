"""Gradient-based trajectory optimization framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
EpicOne1/grad_traj_optimization (IROS-2017 "Gradient-Based Online Safe
Trajectory Generation for Quadrotor Flight in Complex Environments"):

  * dense 3-D occupancy grid -> Euclidean distance transform (fields.sdf)
  * closed-form minimum-snap QP seeding of piecewise-quintic trajectories
    (core.qp)
  * penalty-gradient trajectory refinement with analytic gradients
    (opt.penalty, opt.descent)
  * front-end path search seeding and dynamic-obstacle prediction (search.*)
  * batched (vmap) and sharded (mesh/pjit) solving of thousands of
    scenarios per device (solve, parallel.*)

Unlike the reference (single-threaded C++/Eigen/NLopt/ROS), everything here
is a pure function over pytrees: one jitted ``solve`` maps a ``Scenario``
batch to a ``Solution`` batch, scaled with ``vmap`` on a device and
``jax.sharding`` across a mesh.
"""

from grad_traj_optimization_tpu.config import (
    MapConfig,
    OptimizerConfig,
    OPTI_NODE_CONFIG,
    TEXT_INPUT_CONFIG,
)
from grad_traj_optimization_tpu.solver import (
    Scenario,
    Solution,
    crop_scenarios,
    make_scenario,
    solve,
    solve_batch,
)

__version__ = "0.1.0"

from grad_traj_optimization_tpu.pipeline import PlanBatchResult, plan_batch

__all__ = [
    "MapConfig",
    "PlanBatchResult",
    "plan_batch",
    "OptimizerConfig",
    "OPTI_NODE_CONFIG",
    "TEXT_INPUT_CONFIG",
    "Scenario",
    "Solution",
    "crop_scenarios",
    "make_scenario",
    "solve",
    "solve_batch",
]
