"""Pose-graph optimisation over 2D similarities — the counterpart of
`image_matching_tpu/slam/pose_graph.py`: the one-device solver and the
solver with the edges sharded over a mesh axis.

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
from image_matching_tpu_torch.parallel.collectives import all_reduce
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


def _edge_matvec(z, graph: PoseGraph, l_op):
    """The edges' part of A^T W A z: two gathers and two scatter-adds."""
    w = graph.weight[:, None]
    r = (z[graph.src] - (l_op * z[graph.dst][:, None, :]).sum(-1)) * w
    out = torch.zeros_like(z).index_add_(0, graph.src, r * w)
    return out.index_add_(0, graph.dst, -(l_op * (r * w)[:, :, None]).sum(1))


def _anchored(out, z, anchor_weight: float):
    """`out` plus the anchor prior's anchor_weight * z on frame 0."""
    return out + torch.cat([anchor_weight * z[:1], torch.zeros_like(z[1:])])


def _normal_matvec(z, graph: PoseGraph, l_op, anchor_weight: float):
    """A^T W A z for the stacked edge system plus the anchor prior on frame 0."""
    return _anchored(_edge_matvec(z, graph, l_op), z, anchor_weight)


def _edge_diag(graph: PoseGraph, l_op, num_frames: int):
    """The edges' part of diag(A^T W^2 A): w^2 at source blocks, w^2 colnorm(L)^2 at dest blocks."""
    w2 = (graph.weight ** 2)[:, None]
    diag = torch.zeros((num_frames, 4), dtype=l_op.dtype, device=l_op.device)
    diag = diag.index_add_(0, graph.src, w2 * torch.ones((1, 4), dtype=l_op.dtype, device=l_op.device))
    return diag.index_add_(0, graph.dst, w2 * (l_op ** 2).sum(1))


def _solve(graph: PoseGraph, z0, iters: int, anchor_weight: float, reduce=lambda t: t):
    """CG on the normal equations from z0, frame 0 anchored to z0[0].
    `reduce` sums the edges' parts over the ranks that share the edges
    (the sharded solver's all_reduce)."""
    n = graph.num_frames
    l_op = _edge_operator(graph.rel)
    rhs = torch.zeros((n, 4), dtype=z0.dtype, device=z0.device)
    rhs[0] += anchor_weight * z0[0]
    diag = reduce(_edge_diag(graph, l_op, n))
    diag[0] += anchor_weight
    diag = diag.clamp_min(1e-8)
    return cg(lambda v: _anchored(reduce(_edge_matvec(v, graph, l_op)), v, anchor_weight), rhs, x0=z0,
              maxiter=iters, tol=1e-10, M=lambda v: v / diag)


def _identity_poses(n: int, device):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(n, 1)


def optimize_pose_graph(graph: PoseGraph, init: Optional[torch.Tensor] = None, iters: int = 100,
                        anchor_weight: float = 10.0):
    """(N, 4) similarity params by CG on the normal equations, on the
    graph's device. Frame 0 is anchored to the identity (or to init[0]).
    The system is linear, so this is exact global optimisation; init only
    seeds CG."""
    z0 = init if init is not None else _identity_poses(graph.num_frames, graph.rel.device)
    return _solve(graph, z0, iters, anchor_weight)


def make_sharded_pose_graph_solver(mesh, num_frames: int, iters: int = 100, axis_name: str = "data",
                                   anchor_weight: float = 10.0):
    """The pose-graph solver with the edges sharded over `axis_name` of a
    `parallel/mesh.Mesh`: `solve(src, dst, rel, weight, z0)` takes this
    rank's edges (padding edges of weight 0 add nothing) and the
    replicated init, and returns the replicated (N, 4) solution. Each CG
    matvec and the Jacobi diagonal sum the ranks' partial scatters with an
    all_reduce; the reduced vectors are the same on every rank, so the
    CG's done mask stays in step."""
    axis = mesh.axis(axis_name)

    def solve(src, dst, rel, weight, z0):
        graph = PoseGraph(src, dst, rel, weight, num_frames)
        return _solve(graph, z0, iters, anchor_weight, reduce=lambda t: all_reduce(t, axis))

    return solve


def absolute_trajectory_error(est, gt, align: bool = True):
    """ATE over frame translations: mean ||t_est - t_gt|| after an optional
    similarity alignment of the estimate to the ground truth."""
    te, tg = est[:, 2:4], gt[:, 2:4]
    if align:
        mat = fit_similarity_lsq(te, tg, torch.ones(te.shape[0], device=te.device))
        te = (te[:, None, :] * mat[:, :2]).sum(-1) + mat[:, 2]
    return torch.linalg.vector_norm(te - tg, dim=-1).mean()
