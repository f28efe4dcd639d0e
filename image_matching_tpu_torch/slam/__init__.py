"""Pose graph, bundle adjustment (each also with its edges or observations
sharded over a mesh axis) and sequence registration."""
from image_matching_tpu_torch.slam.bundle_adjustment import (
    BAProblem,
    apply_similarity,
    ba_residuals,
    bundle_adjust,
    bundle_adjust_robust,
    invert_similarity,
    make_sharded_bundle_adjuster,
    solve_landmarks,
    tracks_to_ba_problem,
)
from image_matching_tpu_torch.slam.pose_graph import (
    PoseGraph,
    absolute_trajectory_error,
    compose_similarity,
    make_sharded_pose_graph_solver,
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
    "make_sharded_pose_graph_solver",
    "absolute_trajectory_error",
    "BAProblem",
    "apply_similarity",
    "invert_similarity",
    "bundle_adjust",
    "bundle_adjust_robust",
    "make_sharded_bundle_adjuster",
    "solve_landmarks",
    "ba_residuals",
    "tracks_to_ba_problem",
]
