"""Collectives over one axis of a mesh (`parallel/mesh.Axis`) — what XLA
inserts into the JAX package's `shard_map` bodies, called here by hand:

  psum / pmax / pmin    `all_reduce`          (dist.all_reduce, SUM / MAX / MIN)
  tiled all_gather      `all_gather`          (dist.all_gather, stacked on a new dim 0)
  ppermute to i + 1     `ring_pass`           (dist.batch_isend_irecv)
  stage handoff         `send` / `recv`       (dist.isend / dist.recv)

and Megatron's two tensor-parallel functions, `to_model_axis` (identity
forward, all_reduce backward) and `from_model_axis` (all_reduce forward,
identity backward). Each returns its input where the axis has no group (one
rank). Gloo reads and writes a tensor's memory as host memory, so on a gloo
group a CUDA tensor is copied to the host for the exchange and back; that
lets several gloo ranks share one card, which is for correctness, not
speed.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _staged(t, axis) -> bool:
    """True where `t` goes through host memory for a collective on `axis`."""
    return t.is_cuda and dist.get_backend(axis.group) == "gloo"


def all_reduce(x, axis, op: str = "sum"):
    """A new tensor: `x` reduced by `op` ("sum", "max", "min") over the axis."""
    if axis.group is None:
        return x
    staged = _staged(x, axis)
    y = x.detach().to("cpu" if staged else x.device, copy=True)
    dist.all_reduce(y, op=_OPS[op], group=axis.group)
    return y.to(x.device) if staged else y


def all_gather(x, axis):
    """(axis size, *x.shape): every rank's `x`, in axis order."""
    if axis.group is None:
        return x[None]
    staged = _staged(x, axis)
    src = x.detach().to("cpu" if staged else x.device).contiguous()
    if src.dtype == torch.bool:  # gloo gathers no bool: its bytes as uint8
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.stack(parts).to(x.device).view(x.dtype)


def broadcast(x, axis, src_index: int):
    """A new tensor: `x` of the rank at `src_index` of the axis, on every rank."""
    if axis.group is None:
        return x
    staged = _staged(x, axis)
    y = x.detach().to("cpu" if staged else x.device, copy=True).contiguous()
    dist.broadcast(y, src=axis.ranks[src_index], group=axis.group)
    return y.to(x.device) if staged else y


def ring_pass(tensors, axis):
    """Send each tensor to the next rank of the axis's ring ((i + 1) mod P)
    and return the previous rank's, in one batch of point-to-point ops."""
    if axis.group is None:
        return list(tensors)
    nxt = axis.ranks[(axis.index + 1) % axis.size]
    prv = axis.ranks[(axis.index - 1) % axis.size]
    staged = _staged(tensors[0], axis)
    sends = [t.detach().to("cpu" if staged else t.device).contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, nxt, axis.group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, prv, axis.group) for t in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


def send(x, axis, dst_index: int):
    """Start sending `x` to the rank at `dst_index` of the axis; returns
    (work, buffer): wait on the work, keeping the buffer alive till then."""
    buf = x.detach().to("cpu" if _staged(x, axis) else x.device).contiguous()
    return dist.isend(buf, axis.ranks[dst_index], group=axis.group), buf


def recv(like, axis, src_index: int):
    """A tensor shaped as `like`, received from the rank at `src_index`."""
    buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if _staged(like, axis) else like.device)
    dist.recv(buf, axis.ranks[src_index], group=axis.group)
    return buf.to(like.device)


class _ToModelAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.axis), None


class _FromModelAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def to_model_axis(x, axis):
    """Megatron's f, at the input of a column-parallel layer: `x` itself,
    whose gradient is summed over the model axis (each rank's columns give
    a part of it)."""
    return x if axis.group is None else _ToModelAxis.apply(x, axis)


def from_model_axis(x, axis):
    """Megatron's g, at the output of a row-parallel layer: the sum of the
    ranks' partial products, whose gradient each rank takes as it is."""
    return x if axis.group is None else _FromModelAxis.apply(x, axis)
