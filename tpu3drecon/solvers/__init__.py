"""Solver layer: LM engines (dense, implicit-Schur flat, scatter-free grid)."""

from tpu3drecon.solvers.ba_grid import ba_solve_grid, make_grid_ba_solver
from tpu3drecon.solvers.bundle_adjust import (
    BAConfig,
    BAState,
    ba_solve,
    make_ba_solver,
    reprojection_rmse,
)
from tpu3drecon.solvers.intrinsics_refine import refine_intrinsics
from tpu3drecon.solvers.lm_core import LMConfig, LMState, lm_solve, lm_solve_batched
from tpu3drecon.solvers.pose_refine import (
    PoseRefiner,
    pose_params_pack,
    pose_params_unpack,
    refine_poses,
)
