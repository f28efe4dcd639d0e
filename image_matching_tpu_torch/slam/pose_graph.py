"""Pose-graph optimisation over 2D similarities — the counterpart of
`image_matching_tpu/slam/pose_graph.py` (its one-device solver).

Each frame i carries a similarity S_i, params z_i = (a, b, tx, ty) and
matrix [[a, -b, tx], [b, a, ty]], mapping frame-i pixels into a common
world frame. An edge (i -> j) measures T_ij and asks S_i = S_j o T_ij.
Similarities compose linearly in these params, so the residual
z_i - L(T_ij) z_j is linear and the whole trajectory is one sparse
weighted least-squares problem: conjugate gradients (`slam/cg.py`) on the
normal equations, one matvec two gathers and two scatter-adds
(`index_add_`) over the edge list. Frame 0 is anchored by a strong prior.
Products are elementwise sums, so no TF32 product enters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from image_matching_tpu_torch.ops.ransac import fit_similarity_lsq
from image_matching_tpu_torch.slam.cg import cg


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Edge list (fixed capacity, masked): src, dst (E,) int frame indices;
    rel (E, 4) params of T_ij (frame src -> frame dst); weight (E,) float
    (0 = padding)."""

    src: torch.Tensor
    dst: torch.Tensor
    rel: torch.Tensor
    weight: torch.Tensor
    num_frames: int = 0


def similarity_params_to_matrix(z):
    """(..., 4) (a, b, tx, ty) -> (..., 2, 3)."""
    a, b, tx, ty = z.unbind(-1)
    return torch.stack([torch.stack([a, -b, tx], -1), torch.stack([b, a, ty], -1)], -2)


def matrix_to_similarity_params(m):
    """(..., 2, 3) -> (..., 4); assumes a proper similarity matrix."""
    return torch.stack([m[..., 0, 0], m[..., 1, 0], m[..., 0, 2], m[..., 1, 2]], -1)


def compose_similarity(z2, z1):
    """Params of S2 o S1 (S1 first): rotation and scale multiply as complex
    numbers, translation t = R2 t1 + t2."""
    a2, b2, t2x, t2y = z2.unbind(-1)
    a1, b1, t1x, t1y = z1.unbind(-1)
    return torch.stack([a2 * a1 - b2 * b1, a2 * b1 + b2 * a1, a2 * t1x - b2 * t1y + t2x,
                        b2 * t1x + a2 * t1y + t2y], -1)


def _edge_operator(rel):
    """(E, 4, 4) linear map L with (S_j o T_ij) params = L(T_ij) @ z_j."""
    a1, b1, t1x, t1y = rel.unbind(-1)
    z, o = torch.zeros_like(a1), torch.ones_like(a1)
    return torch.stack([torch.stack([a1, -b1, z, z], -1), torch.stack([b1, a1, z, z], -1),
                        torch.stack([t1x, -t1y, o, z], -1), torch.stack([t1y, t1x, z, o], -1)], -2)


def _normal_matvec(z, graph: PoseGraph, l_op, anchor_weight: float):
    """A^T W A z for the stacked edge system plus the anchor prior on frame 0."""
    w = graph.weight[:, None]
    r = (z[graph.src] - (l_op * z[graph.dst][:, None, :]).sum(-1)) * w
    out = torch.zeros_like(z).index_add_(0, graph.src, r * w)
    out = out.index_add_(0, graph.dst, -(l_op * (r * w)[:, :, None]).sum(1))
    return out + torch.cat([anchor_weight * z[:1], torch.zeros_like(z[1:])])


def _jacobi_diag(graph: PoseGraph, l_op, num_frames: int, anchor_weight: float):
    """diag(A^T W^2 A): w^2 at source blocks, w^2 colnorm(L)^2 at dest blocks."""
    w2 = (graph.weight ** 2)[:, None]
    diag = torch.zeros((num_frames, 4), device=l_op.device)
    diag = diag.index_add_(0, graph.src, w2 * torch.ones((1, 4), device=l_op.device))
    diag = diag.index_add_(0, graph.dst, w2 * (l_op ** 2).sum(1))
    diag[0] += anchor_weight
    return diag.clamp_min(1e-8)


def optimize_pose_graph(graph: PoseGraph, init: Optional[torch.Tensor] = None, iters: int = 100,
                        anchor_weight: float = 10.0):
    """(N, 4) similarity params by CG on the normal equations, on the
    graph's device. Frame 0 is anchored to the identity (or to init[0]).
    The system is linear, so this is exact global optimisation; init only
    seeds CG."""
    n = graph.num_frames
    dev = graph.rel.device
    z0 = init if init is not None else torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(n, 1)
    l_op = _edge_operator(graph.rel)
    rhs = torch.zeros((n, 4), device=dev)
    rhs[0] += anchor_weight * z0[0]
    diag = _jacobi_diag(graph, l_op, n, anchor_weight)
    return cg(lambda v: _normal_matvec(v, graph, l_op, anchor_weight), rhs, x0=z0, maxiter=iters, tol=1e-10,
              M=lambda v: v / diag)


def absolute_trajectory_error(est, gt, align: bool = True):
    """ATE over frame translations: mean ||t_est - t_gt|| after an optional
    similarity alignment of the estimate to the ground truth."""
    te, tg = est[:, 2:4], gt[:, 2:4]
    if align:
        mat = fit_similarity_lsq(te, tg, torch.ones(te.shape[0], device=te.device))
        te = (te[:, None, :] * mat[:, :2]).sum(-1) + mat[:, 2]
    return torch.linalg.vector_norm(te - tg, dim=-1).mean()
