"""Sequence registration: frames -> pose graph -> a globally consistent
trajectory — the counterpart of `image_matching_tpu/slam/sequence.py`.

A sequence is registered pairwise along consecutive and stride-K
loop-closure edges; every pairwise similarity becomes a pose-graph edge
weighted by the square root of its inlier count, and
`optimize_pose_graph` solves the trajectory; point tracks can then refine
it by robust bundle adjustment.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from image_matching_tpu_torch.device import resolve_device
from image_matching_tpu_torch.slam.bundle_adjustment import bundle_adjust_robust, tracks_to_ba_problem
from image_matching_tpu_torch.slam.pose_graph import PoseGraph, matrix_to_similarity_params, optimize_pose_graph


def sequence_edges(n_frames: int, strides: Sequence[int] = (1, 4)) -> List[Tuple[int, int]]:
    """Edge list: consecutive plus longer-stride loop closures."""
    edges = []
    for s in strides:
        edges.extend((i, i + s) for i in range(0, n_frames - s))
    return edges


def register_sequence(
    register_fn: Callable,  # (frame_i, frame_j, gen, indices) -> RegistrationResult, batched (1, H, W, 1)
    frames: Sequence[np.ndarray],  # (H, W, 1) float arrays
    gen: Optional[torch.Generator] = None,
    strides: Sequence[int] = (1, 4),
    min_inliers: int = 8,
    indices: Optional[Sequence[torch.Tensor]] = None,
    device=None,
) -> PoseGraph:
    """Register the edge list pairwise into a PoseGraph on the device of
    `gen` (or `device`; CUDA by default). The edges draw their RANSAC
    samples from `gen` in edge order, or take `indices[e]` (1, M, k) for
    edge e. Edge weight = sqrt(inliers) for a valid fit with at least
    `min_inliers` inliers, else 0 (the solver ignores it). One host read
    an edge."""
    dev = gen.device if gen is not None else resolve_device(device)
    n = len(frames)
    src, dst, rel, weight = [], [], [], []
    for e, (i, j) in enumerate(sequence_edges(n, strides)):
        fi = torch.as_tensor(np.asarray(frames[i], np.float32), device=dev)[None]
        fj = torch.as_tensor(np.asarray(frames[j], np.float32), device=dev)[None]
        res = register_fn(fi, fj, gen, None if indices is None else indices[e])
        fit = res.fit
        # T_ij maps frame i -> frame j coordinates
        summary = torch.cat([fit.valid[0].reshape(1).float(), fit.num_inliers[0].reshape(1).float(),
                             matrix_to_similarity_params(fit.matrix[0]).float()]).cpu().numpy()
        valid, n_inl = bool(summary[0]), int(summary[1])
        src.append(i)
        dst.append(j)
        rel.append(summary[2:])
        weight.append(np.sqrt(float(n_inl)) if valid and n_inl >= min_inliers else 0.0)
    return PoseGraph(src=torch.tensor(src, dtype=torch.int64, device=dev),
                     dst=torch.tensor(dst, dtype=torch.int64, device=dev),
                     rel=torch.from_numpy(np.stack(rel).astype(np.float32)).to(dev),
                     weight=torch.tensor(weight, dtype=torch.float32, device=dev), num_frames=n)


def solve_trajectory(graph: PoseGraph, iters: int = 200):
    """(N, 4) world-from-frame similarity params (frame 0 = identity)."""
    return optimize_pose_graph(graph, iters=iters)


def refine_trajectory_with_tracks(tracks, trajectory, num_frames: int, iters: int = 300, min_track_length: int = 2):
    """Bundle-adjust a pose-graph trajectory against point tracks
    (`models/tracker.get_tracks` output): each track becomes a world
    landmark and poses and landmarks are re-optimised jointly with IRLS
    weights, since descriptor-only tracks carry outright mismatches.
    Returns (poses, landmarks) on the trajectory's device."""
    tracks = [t for t in tracks if len(t[1]) >= min_track_length]
    if not tracks:
        return trajectory, torch.zeros((1, 2), device=trajectory.device)
    n_obs = sum(len(t[1]) for t in tracks)
    capacity = -(-n_obs // 8) * 8
    problem = tracks_to_ba_problem(tracks, num_frames, capacity, device=trajectory.device)
    z, p, _ = bundle_adjust_robust(problem, init=trajectory, iters=iters)
    return z, p
