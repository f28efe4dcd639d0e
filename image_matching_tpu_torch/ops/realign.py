"""Parity realign fused with the 2x2 max pool of the s2d backbone:
U (B, H+1, >= W+1, 4C) -> direct (B, H, W, C),

    out[b, i, j, c] = max(U[b, i, j, c],       U[b, i, j+1, C + c],
                          U[b, i+1, j, 2C + c], U[b, i+1, j+1, 3C + c]).

The counterpart of `image_matching_tpu/ops/pallas/realign.py`
(`maxpool_realign_pallas`, `maxpool_realign`, `pool_from_raw`). On a
CUDA tensor `maxpool_realign` launches `csrc/realign.cu`; on a CPU
tensor it runs the plain version,
`ops/s2d_conv.maxpool2x2_s2d_from_raw`. The two agree exactly: a max
rounds nothing, and both give NaN where any of the four taps is NaN
(`torch.maximum`'s rule).

The kernel reads U by its real row pitch, so a U widened by
`conv3x3_s2d_raw(..., extra_cols)` works with `out_w` set to the true
width; it needs no aligned width and no row blocking.

Like the TPU wrapper, it is differentiable by recomputation: under grad
it goes through `MaxpoolRealignFunction`, whose backward runs autograd
of the plain version (the TPU kernel has no backward kernel either).
`pool_from_raw` is the models' call site; where the JAX package keeps it
on the XLA formulation, the port's runs the kernel on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from image_matching_tpu_torch.ops import _build
from image_matching_tpu_torch.ops.s2d_conv import maxpool2x2_s2d_from_raw


def maxpool_realign(u, out_w: Optional[int] = None):
    """U (B, H+1, >= W+1, 4C) -> (B, H, W, C); `out_w` is W for a padded U."""
    if torch.is_grad_enabled() and u.requires_grad:
        return MaxpoolRealignFunction.apply(u, out_w)
    return _forward(u, out_w)


def pool_from_raw(u, out_w: Optional[int] = None):
    """The realigning pool as the models call it."""
    return maxpool_realign(u, out_w)


def _forward(u, out_w):
    if u.device.type == "cpu":
        return maxpool2x2_s2d_from_raw(u, out_w)
    return _maxpool_realign_cuda(u, out_w)


class MaxpoolRealignFunction(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU). Backward:
    autograd of the plain version on the saved U."""

    @staticmethod
    def forward(ctx, u, out_w):
        ctx.save_for_backward(u)
        ctx.out_w = out_w
        return _forward(u, out_w)

    @staticmethod
    def backward(ctx, grad):
        u = ctx.saved_tensors[0].detach().requires_grad_()
        with torch.enable_grad():
            (du,) = torch.autograd.grad(maxpool2x2_s2d_from_raw(u, ctx.out_w), u, grad)
        return du, None


def _maxpool_realign_cuda(u, out_w):
    if u.device.type != "cuda":
        raise ValueError(f"maxpool_realign: unsupported device {u.device}")
    if u.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"maxpool_realign: dtype {u.dtype} not in (bfloat16, float32)")
    if u.dim() != 4 or not u.is_contiguous() or u.data_ptr() % 16:
        raise ValueError(f"maxpool_realign: need a contiguous, 16-byte aligned (B, H+1, W+1, 4C) U, got {tuple(u.shape)}")
    b, h1, w1, c4 = u.shape
    h, c = h1 - 1, c4 // 4
    w = w1 - 1 if out_w is None else out_w
    vec = 16 // u.element_size()  # channels per 16-byte load
    if c4 % 4 or c % vec:
        raise ValueError(f"maxpool_realign: C = {c4} / 4 is not a multiple of {vec}")
    if b < 1 or h < 1 or not 1 <= w <= w1 - 1:
        raise ValueError(f"maxpool_realign: no (B, H, W) = ({b}, {h}, {w}) output in a U of {tuple(u.shape)}")
    if u.numel() >= 2 ** 31:
        raise ValueError("maxpool_realign: U too large for 32-bit element indexing")
    out = torch.empty((b, h, w, c), dtype=u.dtype, device=u.device)
    lib = _build.library("realign")
    fn = lib.maxpool_realign_bf16 if u.dtype == torch.bfloat16 else lib.maxpool_realign_f32
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(
        fn(_build.ptr(u.detach()), _build.ptr(out), b, h, w, w1, c, _build.stream_ptr(u.device)),
        "realign",
    )
    _build.LAUNCHES["realign"] += 1
    return out
