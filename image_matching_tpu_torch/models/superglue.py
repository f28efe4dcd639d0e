"""SuperGlue attentional graph matcher — the counterpart of
`image_matching_tpu/models/superglue.py`.

Keypoint normalisation, MLP keypoint encoder, alternating self/cross
4-head attention layers (fused QKV or KV projections, the merge
projection folded into the message MLP), final projection, scores / sqrt(D),
dustbin Sinkhorn and mutual-max extraction, all on fixed-K masked sets.

Attention goes through `ops/attention.py` (the CUDA kernel on the card,
at every key count) and Sinkhorn through `ops/sinkhorn.py` (the CUDA
kernels on the card). The JAX package's `attention_impl`,
`sinkhorn_impl` and `stack_sides` choose among TPU implementations and
layouts of the same function, so the port has none of them; its
`logits_dtype` only matters to the plain CPU attention (see
`ops/attention.py`).

`forward(..., train=True)` is the JAX package's training path: masked
batch statistics in every MLP (running statistics updated at each of the
two calls per layer, as flax does when one module is applied twice),
`merge` applied after attention instead of folded into the MLP,
attention through `ops/attention.AttentionFunction` (forward with LSE,
then the dK/dV and dQ kernels on the card) and the differentiable
Sinkhorn loop.

The sharded forwards of `parallel/` reuse these modules: the
context-parallel one runs `encode`, the GNN with ring attention as its
`attend` and its own sharded Sinkhorn; the pipelined one runs `encode`,
each stage's `names` of the GNN and `assign`; tensor parallelism
(`parallel/sharding.py`) marks the attention and the GNN's MLPs with the
model axis (`tp`), whose forwards then run Megatron's collectives.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from image_matching_tpu_torch.device import resolve_device
from image_matching_tpu_torch.models.common import SeqMLP, dense, init_weights
from image_matching_tpu_torch.ops.attention import attention
from image_matching_tpu_torch.ops.sinkhorn import (
    extract_matches_from_transport,
    log_optimal_transport,
)
from image_matching_tpu_torch.parallel.collectives import from_model_axis, to_model_axis
from image_matching_tpu_torch.structs import Keypoints, MatchResult


def normalize_keypoints(xy, height: int, width: int):
    """Centre and scale keypoints by 0.7 * max(H, W)."""
    size = torch.tensor([width, height], dtype=xy.dtype, device=xy.device)
    return (xy - size / 2.0) / (size.max() * 0.7)


class MultiHeadedAttention(nn.Module):
    """4-head attention over packed heads. `tp`: the model axis when
    `parallel/sharding.apply_param_sharding` has split the projections
    over it (this rank's heads; None unsharded)."""

    tp = None

    def __init__(self, num_heads: int, dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.proj_q = nn.Linear(dim, dim)
        self.proj_k = nn.Linear(dim, dim)
        self.proj_v = nn.Linear(dim, dim)
        self.merge = nn.Linear(dim, dim)

    def project(self, query, source, dtype):
        """q, k, v: one fused projection for Q, K, V when `source is query`
        (self layers), Q plus a fused K/V projection otherwise; q/k/v stay
        views of the fused result, which the kernel reads by row stride."""
        d = self.proj_q.weight.shape[0]  # D, or this rank's D / P under tensor parallelism
        w = lambda lin: lin.weight.t()
        if source is query:
            kernel = torch.cat([w(self.proj_q), w(self.proj_k), w(self.proj_v)], 1).to(dtype)
            bias = torch.cat([self.proj_q.bias, self.proj_k.bias, self.proj_v.bias]).to(dtype)
            qkv = query.to(dtype) @ kernel + bias
            return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        q = dense(query, self.proj_q, dtype)
        kernel = torch.cat([w(self.proj_k), w(self.proj_v)], 1).to(dtype)
        bias = torch.cat([self.proj_k.bias, self.proj_v.bias]).to(dtype)
        kv = source.to(dtype) @ kernel + bias
        return q, kv[..., :d], kv[..., d:]

    def forward(self, query, source, source_mask, dtype, logits_dtype, train: bool = False, attend=None):
        """The attention output before `merge` (the JAX package's
        `return_premerge=True`, its inference form): the caller folds
        `merge` into its next matmul. With `train`, or under tensor
        parallelism, after `merge`. `attend(q, k, v, mask, heads,
        logits_dtype)` computes the heads (None: `ops.attention.attention`,
        looked up at the call; the context-parallel forward passes its
        ring). Under tensor parallelism
        this rank's heads are a column-parallel Q/K/V and `merge` is
        row-parallel: its partial products are summed over the model axis,
        then its bias is added."""
        tp = self.tp
        if tp is not None:
            same = source is query
            query = to_model_axis(query, tp)
            source = query if same else to_model_axis(source, tp)
        q, k, v = self.project(query, source, dtype)
        heads = self.num_heads // (tp.size if tp is not None else 1)
        out = (attention if attend is None else attend)(q, k, v, source_mask, heads, logits_dtype)
        if tp is not None:
            partial = out.to(dtype) @ self.merge.weight.t().to(dtype)
            return from_model_axis(partial, tp) + self.merge.bias.to(dtype)
        return dense(out, self.merge, dtype) if train else out


class AttentionalPropagation(nn.Module):
    """Attention + MLP([2D, 2D, D]) residual message; at inference the
    merge projection is folded into the MLP's first kernel (not under
    tensor parallelism, where `merge` ends in the model axis's sum)."""

    def __init__(self, dim: int, num_heads: int = 4):
        super().__init__()
        self.attn = MultiHeadedAttention(num_heads, dim)
        self.mlp = SeqMLP([dim * 2, dim * 2, dim])

    def forward(self, x, source, x_mask, source_mask, dtype, logits_dtype, train: bool = False, attend=None):
        message = self.attn(x, source, source_mask, dtype, logits_dtype, train, attend)
        if train or self.attn.tp is not None:
            return self.mlp(x, dtype, x2=message, mask=x_mask, train=train)
        return self.mlp(x, dtype, x2=message, x2_fold=self.attn.merge)


class AttentionalGNN(nn.Module):
    """Alternating self/cross layers; each layer's weights serve both
    directions, run as two calls per layer."""

    def __init__(self, dim: int, layer_names):
        super().__init__()
        self.names = [f"layer_{i}_{name}" for i, name in enumerate(layer_names)]
        for name in self.names:
            setattr(self, name, AttentionalPropagation(dim))

    def forward(self, desc0, desc1, mask0, mask1, dtype, logits_dtype, train: bool = False, names=None,
                attend=None):
        """`names`: the layers to run, in order (all by default; a pipeline
        stage runs its own); `attend`: as `MultiHeadedAttention.forward`'s."""
        for name in self.names if names is None else names:
            layer = getattr(self, name)
            if name.endswith("cross"):
                src0, sm0, src1, sm1 = desc1, mask1, desc0, mask0
            else:
                src0, sm0, src1, sm1 = desc0, mask0, desc1, mask1
            delta0 = layer(desc0, src0, mask0, sm0, dtype, logits_dtype, train, attend)
            delta1 = layer(desc1, src1, mask1, sm1, dtype, logits_dtype, train, attend)
            desc0, desc1 = desc0 + delta0, desc1 + delta1
        return desc0, desc1


class SuperGlue(nn.Module):
    """Feature matching GNN with optimal-transport assignment. Defaults
    follow the reference's (`logits_dtype` f32, as in the JAX SuperGlue)."""

    def __init__(self, descriptor_dim: int = 256, keypoint_encoder=(32, 64, 128, 256),
                 gnn_layers: int = 18, sinkhorn_iterations: int = 100,
                 match_threshold: float = 0.2, compute_dtype: str = "float32",
                 logits_dtype: str = "float32", device=None, seed: int = 0):
        super().__init__()
        d = descriptor_dim
        self.descriptor_dim = d
        self.sinkhorn_iterations = sinkhorn_iterations
        self.match_threshold = match_threshold
        self.dtype = getattr(torch, compute_dtype)
        self.logits_dtype = logits_dtype
        self.kenc = SeqMLP([3, *keypoint_encoder, d])
        names = ["self" if i % 2 == 0 else "cross" for i in range(gnn_layers)]
        self.gnn = AttentionalGNN(d, names)
        self.final_proj = nn.Linear(d, d)
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        init_weights(self, seed)
        self.to(resolve_device(device))

    def encode(self, kpts: Keypoints, image_shape, dtype, train: bool = False):
        """The descriptors plus the keypoint encoder's message."""
        n = normalize_keypoints(kpts.xy, *image_shape)
        enc = torch.cat([n, kpts.score[..., None]], -1).to(dtype)
        return kpts.desc.to(dtype) + self.kenc(enc, dtype, mask=kpts.mask, train=train)

    def assign(self, desc0, desc1, mask0, mask1, dtype, iters: int, match_threshold: float,
               train: bool = False) -> dict:
        """Final projection, scores / sqrt(D), dustbin Sinkhorn of `iters`
        iterations and mutual-max extraction at `match_threshold`."""
        mdesc0 = dense(desc0, self.final_proj, dtype)
        mdesc1 = dense(desc1, self.final_proj, dtype)
        # f32 products of the compute-dtype values (TF32 must be off)
        scores = mdesc0.float() @ mdesc1.float().transpose(1, 2) / math.sqrt(self.descriptor_dim)
        z = log_optimal_transport(scores, self.bin_score, iters, mask0=mask0, mask1=mask1, train=train)
        matches0, matches1, mscores0, mscores1 = extract_matches_from_transport(
            z, match_threshold, mask0=mask0, mask1=mask1)
        return {
            "matches0": matches0,
            "matches1": matches1,
            "matching_scores0": mscores0,
            "matching_scores1": mscores1,
            "log_coupling": z,
        }

    def forward(self, kpts0: Keypoints, kpts1: Keypoints, image_shape0, image_shape1,
                train: bool = False) -> dict:
        """`train`: the training path (batch statistics, differentiable
        attention and Sinkhorn); otherwise inference."""
        dt = self.dtype
        desc0 = self.encode(kpts0, image_shape0, dt, train)
        desc1 = self.encode(kpts1, image_shape1, dt, train)
        desc0, desc1 = self.gnn(desc0, desc1, kpts0.mask, kpts1.mask, dt, self.logits_dtype, train)
        return self.assign(desc0, desc1, kpts0.mask, kpts1.mask, dt, self.sinkhorn_iterations,
                           self.match_threshold, train)


def match_result_from_outputs(outputs: dict) -> MatchResult:
    return MatchResult(matches0=outputs["matches0"], matches1=outputs["matches1"],
                       scores0=outputs["matching_scores0"], scores1=outputs["matching_scores1"])
