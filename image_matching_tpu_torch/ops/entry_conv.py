"""Fused image entry conv: relu(conv3x3_same(img, w) * scale + shift).

The counterpart of `image_matching_tpu/ops/pallas/entry_h.py`
(`entry_h_fused`): the first ConvBNReLU of SuperPointBN with the conv
bias and inference BatchNorm folded into one per-channel f32 affine.
It has two outputs:

  * `entry_conv`, the direct layout, returned as an NCHW-shaped tensor in
    `torch.channels_last` memory so the next `F.conv2d` reads it as is
    (the plain backbone);
  * `entry_conv_h`, the H-only space-to-depth layout (B, H/2, W, 2 * 64)
    that the TPU kernel writes, for the H-only backbone
    (`models/common.S2DConvBNReLUH`). It equals
    `space_to_depth_h` of the direct output, bit for bit on the card.

(The TPU's other entry kernel, `ops/pallas/entry_conv.py`, the conv fused
with 2x2 space-to-depth that starts every level of the 2x2 s2d backbone,
has its counterpart in `ops/s2d_entry.py`.)

On a CUDA tensor both launch `csrc/entry_conv.cu` (counted as
"entry_conv" and "entry_conv_h"); on a CPU tensor they run
`entry_conv_plain` / `entry_conv_h_plain`. Both round the image and the
taps to the compute dtype and accumulate in f32, so they differ only in
the order of the nine products and in one final rounding. The JAX
kernel takes its affine tiled over the two parity groups (2 * 64,); the
port takes the (64,) pair and applies it to both.

Like the TPU kernel (`entry_h.py`, inference-only), the CUDA kernel has
no backward: its wrapper raises under grad when an input requires grad,
so the frozen detector of the trainer runs it under `torch.no_grad()`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from image_matching_tpu_torch.ops import _build
from image_matching_tpu_torch.ops.s2d_conv import space_to_depth_h

CHANNELS = 64
MAX_PIXELS = 2 ** 31 // CHANNELS  # the kernel indexes its output's elements in 32 bits


def fold_bn(conv_bias, bn_scale, bn_bias, mean, var, eps: float = 1e-5):
    """Conv bias + inference BatchNorm as one affine, computed in f32 as
    `models/common.py` of the JAX package does: inv = g * rsqrt(var + eps),
    shift = (bias - mu) * inv + beta."""
    inv = bn_scale.float() * torch.rsqrt(var.float() + eps)
    return inv, (conv_bias.float() - mean.float()) * inv + bn_bias.float()


def entry_conv_plain(img, w, scale, shift):
    """img (B, H, W) in the compute dtype; w (3, 3, 1, co) f32 taps;
    scale, shift (co,) f32. Returns (B, co, H, W) channels_last."""
    dtype = img.dtype
    wt = w.to(dtype).float().permute(3, 2, 0, 1)  # (co, 1, 3, 3)
    acc = F.conv2d(img.float()[:, None], wt, padding=1)
    y = torch.relu(acc * scale[:, None, None] + shift[:, None, None])
    return y.to(dtype).contiguous(memory_format=torch.channels_last)


def entry_conv_h_plain(img, w, scale, shift):
    """As `entry_conv_plain`, in the H-only space-to-depth layout:
    (B, H/2, W, 2 * co), contiguous, for an even H."""
    return space_to_depth_h(entry_conv_plain(img, w, scale, shift).permute(0, 2, 3, 1))


def entry_conv(img, w, scale, shift):
    """Dispatch on the tensor's device: the CUDA kernel on the card, the
    plain version on the CPU."""
    if img.device.type == "cpu":
        return entry_conv_plain(img, w, scale, shift)
    return _entry_conv_cuda(img, w, scale, shift, h_layout=False).permute(0, 3, 1, 2)


def entry_conv_h(img, w, scale, shift):
    """`entry_conv` with the H-only space-to-depth output, (B, H/2, W, 2 * 64)."""
    if img.device.type == "cpu":
        return entry_conv_h_plain(img, w, scale, shift)
    return _entry_conv_cuda(img, w, scale, shift, h_layout=True)


def _entry_conv_cuda(img, w, scale, shift, h_layout: bool):
    name = "entry_conv_h" if h_layout else "entry_conv"
    if torch.is_grad_enabled() and any(t.requires_grad for t in (img, w, scale, shift)):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; run it under torch.no_grad()")
    if img.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {img.device}")
    if img.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: image dtype {img.dtype} not in (bfloat16, float32)")
    if img.dim() != 3 or not img.is_contiguous():
        raise ValueError(f"{name}: need a contiguous (B, H, W) image, got {tuple(img.shape)}")
    if tuple(w.shape) != (3, 3, 1, CHANNELS):
        raise ValueError(f"{name}: kernel shape {tuple(w.shape)} != (3, 3, 1, {CHANNELS})")
    for arg, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (CHANNELS,) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be ({CHANNELS},) float32")
        if t.device != img.device:
            raise ValueError(f"{name}: {arg} on {t.device}, image on {img.device}")
    b, h, wd = img.shape
    if h_layout and h % 2:
        raise ValueError(f"{name}: the H-only layout needs an even height, got {h}")
    if b * h * wd >= MAX_PIXELS:
        raise ValueError(f"{name}: image too large for 32-bit pixel indexing")
    taps = w.to(img.device, img.dtype).float().reshape(9, CHANNELS).contiguous()
    scale, shift = scale.contiguous(), shift.contiguous()
    shape = (b, h // 2, wd, 2 * CHANNELS) if h_layout else (b, h, wd, CHANNELS)
    out = torch.empty(shape, dtype=img.dtype, device=img.device)
    lib = _build.library("entry_conv")
    fn = getattr(lib, f"{name}_{'bf16' if img.dtype == torch.bfloat16 else 'f32'}")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(
        fn(_build.ptr(img), _build.ptr(taps), _build.ptr(scale), _build.ptr(shift),
           _build.ptr(out), b, h, wd, _build.stream_ptr(img.device)),
        name,
    )
    _build.LAUNCHES[name] += 1
    return out
