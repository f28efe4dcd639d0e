"""Tensor parallelism of the SuperGlue GNN over a `model` mesh axis — the
counterpart of `image_matching_tpu/parallel/sharding.py`.

Megatron's split: the Q/K/V projections are column-parallel (a split of
the heads: the JAX package's heads are contiguous column blocks, so a
contiguous split gives each rank whole heads only where the axis divides
the head count), the attention's `merge` row-parallel, each GNN MLP's
first layer column-parallel and its second row-parallel; everything else
is replicated. The JAX package only places the kernels and GSPMD inserts
the collectives; here `apply_param_sharding` keeps this rank's slices and
marks the attention and MLP modules with the axis, whose forwards then
run Megatron's pair of collectives (`parallel/collectives.py`): at a
column-parallel layer's input the identity whose gradient is summed over
the axis, at a row-parallel layer's output the sum over the axis. So each
replicated parameter gets its whole gradient on every rank, and the data
axis's `sync_gradients` sums over the data axis alone.

`nn.Linear.weight` is (out, in), the transpose of flax's kernel (in, out):
JAX's P(None, "model") (a split of the output columns) is a split of the
torch weight's dim 0, and P("model", None) of its dim 1. A hand-split
layer also needs what GSPMD does for the replicated vectors that JAX
leaves unsplit: a column-parallel layer's bias, and the batch norm after
the MLP's first layer (scale, bias and running statistics), are sliced
with its output columns. A row-parallel layer's bias is added once, after
the sum.
"""
from __future__ import annotations

import re
from typing import NamedTuple, Optional

import torch

from image_matching_tpu_torch.parallel.collectives import all_gather
from image_matching_tpu_torch.parallel.mesh import Axis, Mesh

# state_dict keys -> the torch dim split over the model axis
_RULES = (
    (re.compile(r".*\.attn\.proj_[qkv]\.(weight|bias)"), 0),  # column-parallel: the heads
    (re.compile(r".*\.attn\.merge\.weight"), 1),  # row-parallel
    (re.compile(r"gnn\..*\.mlp\.Dense_0\.(weight|bias)"), 0),  # column-parallel
    (re.compile(r"gnn\..*\.mlp\.MaskedBatchNorm1d_0\.(weight|bias|running_mean|running_var)"), 0),
    (re.compile(r"gnn\..*\.mlp\.Dense_1\.weight"), 1),  # row-parallel
)


class ParamSharding(NamedTuple):
    """How one parameter or buffer lies on the mesh: split along torch dim
    `dim` over `axis`, or replicated (`dim` None)."""

    dim: Optional[int]
    axis: Optional[Axis]


def _dim_for(name: str) -> Optional[int]:
    for pattern, dim in _RULES:
        if pattern.fullmatch(name):
            return dim
    return None


def superglue_param_sharding(module: torch.nn.Module, mesh: Mesh, model_axis: str = "model") -> dict:
    """{state_dict key: ParamSharding} of a SuperGlue for tensor-parallel
    placement over `model_axis`; all replicated where the mesh has no such
    axis or it has one rank. Raises a ValueError where the axis does not
    divide the attention's heads."""
    axis = next((a for a in mesh.axes if a.name == model_axis), None)
    if axis is None or axis.size == 1:
        return {k: ParamSharding(None, None) for k in module.state_dict()}
    heads = {m.num_heads for m in module.modules() if hasattr(m, "num_heads")}
    if any(h % axis.size for h in heads):
        raise ValueError(f"a model axis of {axis.size} does not split {sorted(heads)} heads into whole heads")
    out = {}
    for k in module.state_dict():
        dim = _dim_for(k)
        out[k] = ParamSharding(dim, axis if dim is not None else None)
    return out


@torch.no_grad()
def apply_param_sharding(module: torch.nn.Module, shardings: dict) -> torch.nn.Module:
    """Keep this rank's slice of every split parameter and buffer of
    `module` (in place, the same Parameter objects: call it before making
    the optimizer) and mark its attention and GNN MLP modules with the
    model axis. Returns the module."""
    state = dict(module.named_parameters())
    state.update(module.named_buffers())
    axis = None
    for name, spec in shardings.items():
        if spec.dim is None:
            continue
        axis = spec.axis
        t = state[name]
        t.data = t.data[(slice(None),) * spec.dim + (axis.shard(t.shape[spec.dim]),)].clone()
    if axis is None:
        return module
    for name, sub in module.named_modules():
        if name.endswith(".attn") or (name.startswith("gnn.") and name.endswith(".mlp")):
            sub.tp = axis
    return module


def gather_param(t, spec: ParamSharding):
    """The whole of a parameter or buffer that `spec` split: its slices
    from every rank of the axis, joined (the tensor itself if replicated)."""
    if spec.dim is None:
        return t
    return torch.cat(all_gather(t, spec.axis).unbind(0), dim=spec.dim)


__all__ = ["ParamSharding", "superglue_param_sharding", "apply_param_sharding", "gather_param"]
