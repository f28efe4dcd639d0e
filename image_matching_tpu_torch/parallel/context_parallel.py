"""Context-parallel SuperGlue: the keypoint axis sharded over a mesh axis,
end to end — the counterpart of
`image_matching_tpu/parallel/context_parallel.py`. Each rank owns N/P
keypoints of both images:

  keypoint encoder    local (pointwise)
  GNN self / cross    ring attention (`parallel/ring_attention.py`)
  score rows          local rows x all-gathered columns (N·D values)
  Sinkhorn            row-sharded (`parallel/sharded_sinkhorn.py`)
  match extraction    local row argmax, column argmax reduced over ranks

Evaluation only (the batch norms' running statistics), in f32 as in the
JAX package. The JAX package rebuilds the forward from raw parameter
dicts; here the port's own `SuperGlue` modules run it (`encode`, the GNN
with the ring as its attention, `final_proj`, `bin_score`), so a rank
computes what the unsharded model computes for its keypoints
(`tests/test_torch_context_parallel.py` guards that every parameter and
statistic is read).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from image_matching_tpu_torch.models.common import dense
from image_matching_tpu_torch.parallel.collectives import all_gather, all_reduce
from image_matching_tpu_torch.parallel.mesh import Mesh
from image_matching_tpu_torch.parallel.ring_attention import ring_attention_local
from image_matching_tpu_torch.parallel.sharded_sinkhorn import sharded_log_sinkhorn_local
from image_matching_tpu_torch.structs import Keypoints

BIG_NEG = -1e9


def _gathered(x, axis):
    """The whole keypoint axis of x (B, N_local, ...): every rank's block in
    axis order, (B, P * N_local, ...)."""
    g = all_gather(x, axis)  # (P, B, N_local, ...)
    return g.transpose(0, 1).reshape(x.shape[0], -1, *x.shape[2:])


def context_parallel_superglue_local(module, kpts0: Keypoints, kpts1: Keypoints, image_shape0: Tuple[int, int],
                                     image_shape1: Tuple[int, int], gnn_layers: int, sinkhorn_iterations: int,
                                     match_threshold: float, axis):
    """This rank's part of the SuperGlue forward of `module` (a port
    `SuperGlue`), on its (B, N_local, ...) shards of both keypoint sets.
    Returns this rank's slices (B, N_local) of matches0, matches1,
    matching_scores0, matching_scores1."""
    if len(module.gnn.names) != gnn_layers:
        raise ValueError(f"gnn_layers={gnn_layers}, the model has {len(module.gnn.names)}")
    dt = torch.float32
    mask0, mask1 = kpts0.mask, kpts1.mask
    desc0 = module.encode(kpts0, image_shape0, dt)
    desc1 = module.encode(kpts1, image_shape1, dt)

    def ring(q, k, v, key_mask, heads, logits_dtype):
        return ring_attention_local(q, k, v, key_mask, axis, heads)

    desc0, desc1 = module.gnn(desc0, desc1, mask0, mask1, dt, "float32", attend=ring)
    mdesc0 = dense(desc0, module.final_proj, dt)  # (B, N0_local, D)
    mdesc1 = dense(desc1, module.final_proj, dt)

    # score rows are local; the columns need every rank's mdesc1 (N·D values)
    mdesc1_full = _gathered(mdesc1, axis)
    mask1_full = _gathered(mask1, axis)
    scores = mdesc0 @ mdesc1_full.transpose(1, 2) / math.sqrt(module.descriptor_dim)

    # the dustbin-augmented coupling, rows sharded: the dustbin row lives on
    # rank 0 and every other rank carries a dead row, so all hold N_local + 1
    b, nl, nf = scores.shape
    me = axis.index
    alpha = module.bin_score.float().reshape(())
    neg = torch.tensor(BIG_NEG, dtype=torch.float32, device=scores.device)
    pair_valid = mask0[:, :, None] & mask1_full[:, None, :]
    z_rows = torch.cat([torch.where(pair_valid, scores, neg), torch.where(mask0, alpha, neg)[..., None]], -1)
    bin_row = torch.cat([torch.where(mask1_full, alpha, neg), alpha.expand(b, 1)], -1)  # (B, nf + 1)

    ms, ns = all_reduce(torch.stack([mask0.sum(-1).float(), mask1.sum(-1).float()]), axis).unbind(0)
    norm = -torch.log(ms + ns)  # (B,)
    log_mu_rows = torch.where(mask0, norm[:, None], neg)
    log_mu_bin = torch.log(ns.clamp_min(1e-12)) + norm
    log_nu = torch.cat([torch.where(mask1_full, norm[:, None], neg),
                        (torch.log(ms.clamp_min(1e-12)) + norm)[:, None]], -1)
    last_row = bin_row if me == 0 else torch.full_like(bin_row, BIG_NEG)
    z_local = torch.cat([z_rows, last_row[:, None, :]], 1)
    log_mu_local = torch.cat([log_mu_rows, (log_mu_bin if me == 0 else torch.full_like(log_mu_bin, BIG_NEG))[:, None]],
                             -1)
    z = sharded_log_sinkhorn_local(z_local, log_mu_local, log_nu, sinkhorn_iterations, axis) - norm[:, None, None]

    # extraction: the rows see every column; a column's best row is reduced over the ranks
    inner = z[:, :nl, :nf]
    inner = torch.where(mask0[:, :, None], inner, neg)
    inner = torch.where(mask1_full[:, None, :], inner, neg)
    max0, indices0 = inner.max(-1).values, inner.argmax(-1)  # (B, nl): global column ids, first of ties
    col_best = inner.amax(1)  # (B, nf)
    col_best_row = inner.argmax(1) + me * nl
    best = all_reduce(col_best, axis, "max")
    # ties go to the lowest global row id
    cand = torch.where(col_best >= best, col_best_row, torch.full_like(col_best_row, 2 ** 30))
    indices1 = all_reduce(cand, axis, "min")  # (B, nf): global row ids

    row_ids = torch.arange(nl, device=z.device) + me * nl
    mutual0 = torch.gather(indices1, 1, indices0) == row_ids
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    mscores0 = torch.where(mutual0, torch.exp(max0), zero)
    valid0 = mutual0 & (mscores0 > match_threshold) & mask0

    # the column side's mutual check reads every rank's rows: one gather of
    # indices0 (exact in f32 below 2^24), valid0 and mscores0
    rows_full = _gathered(torch.stack([indices0.float(), valid0.float(), mscores0], -1), axis)
    indices0_full, valid0_full, mscores0_full = rows_full.unbind(-1)
    safe1 = indices1.clamp(0, nf - 1)
    mutual1 = torch.gather(indices0_full, 1, safe1).long() == torch.arange(nf, device=z.device)
    mscores1 = torch.where(mutual1, torch.gather(mscores0_full, 1, safe1), zero)
    valid1 = mutual1 & (torch.gather(valid0_full, 1, safe1) > 0) & mask1_full

    minus1 = torch.tensor(-1, dtype=indices0.dtype, device=z.device)
    matches0 = torch.where(valid0, indices0, minus1).int()
    matches1 = torch.where(valid1, indices1, minus1).int()
    mine = slice(me * nl, (me + 1) * nl)  # this rank's columns of the column-side outputs
    return matches0, matches1[:, mine], mscores0, mscores1[:, mine]


def make_context_parallel_superglue(mesh: Mesh, gnn_layers: int = 18, sinkhorn_iterations: int = 30,
                                    match_threshold: float = 0.2, axis_name: str = "context"):
    """`f(module, kpts0, kpts1, shape0, shape1)` on this rank's shards of
    both keypoint sets (the K axis split over `axis_name`, equal blocks in
    axis order); returns this rank's (B, K / P) slices of matches0,
    matches1, matching_scores0, matching_scores1. Evaluation mode."""
    axis = mesh.axis(axis_name)

    @torch.no_grad()
    def run(module, kpts0: Keypoints, kpts1: Keypoints, shape0, shape1):
        return context_parallel_superglue_local(module, kpts0, kpts1, shape0, shape1, gnn_layers,
                                                sinkhorn_iterations, match_threshold, axis)

    return run


__all__ = ["context_parallel_superglue_local", "make_context_parallel_superglue"]
