"""Pose graph, bundle adjustment and sequence registration (one device;
the JAX package's sharded solvers are not ported)."""
from image_matching_tpu_torch.slam.bundle_adjustment import (
    BAProblem,
    apply_similarity,
    ba_residuals,
    bundle_adjust,
    bundle_adjust_robust,
    invert_similarity,
    solve_landmarks,
    tracks_to_ba_problem,
)
from image_matching_tpu_torch.slam.pose_graph import (
    PoseGraph,
    absolute_trajectory_error,
    compose_similarity,
    matrix_to_similarity_params,
    optimize_pose_graph,
    similarity_params_to_matrix,
)

__all__ = [
    "PoseGraph",
    "similarity_params_to_matrix",
    "matrix_to_similarity_params",
    "compose_similarity",
    "optimize_pose_graph",
    "absolute_trajectory_error",
    "BAProblem",
    "apply_similarity",
    "invert_similarity",
    "bundle_adjust",
    "bundle_adjust_robust",
    "solve_landmarks",
    "ba_residuals",
    "tracks_to_ba_problem",
]
