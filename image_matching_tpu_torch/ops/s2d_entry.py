"""The s2d entry conv: a SAME 3x3 conv fused with space-to-depth,
direct (B, H, W, ci) x (3, 3, ci, co) -> aligned (B, H/2, W/2, 4co).

The counterpart of `image_matching_tpu/ops/pallas/entry_conv.py`
(`entry_conv_pallas`, `entry_conv`): every level of the 2x2 s2d backbone
starts with it. (`ops/entry_conv.py` is the counterpart of the other TPU
entry kernel, `ops/pallas/entry_h.py`: the image conv with the folded
affine, which the plain backbone starts with.)

On a CUDA tensor `s2d_entry_conv` launches `csrc/s2d_entry_conv.cu`; on
a CPU tensor it runs the plain version, `ops/s2d_conv.conv3x3_s2d_entry`.
In bf16 with co a multiple of 64 the kernel runs on tensor cores: wgmma
for ci in `WG_CHANNELS`, mma.sync with the 9 taps padded to 16 for the
1-channel image; f32 and every other width run its SIMT kernels (plain
f32 FMAs: a register-tiled implicit GEMM, and for the 1-channel image a
thread per pixel). `s2d_entry_route` names the C entry a call takes.
Both multiply the inputs as they are in their type, sum in f32 and round
once to the input type, so they differ in summation order and by that in
at most one step of the type. There is no bias and no epilogue: the
model adds the bias to the rounded result, as the JAX package does.

Like the TPU wrapper, it is differentiable by recomputation: under grad
it goes through `S2DEntryConvFunction`, whose backward runs autograd of
the plain version (the TPU kernel has no backward kernel either).
"""
from __future__ import annotations

import ctypes

import torch

from image_matching_tpu_torch.ops import _build
from image_matching_tpu_torch.ops.s2d_conv import conv3x3_s2d_entry

# input widths the wgmma kernel is built for (one instantiation each)
WG_CHANNELS = (16, 32, 64, 128)


def s2d_entry_conv(x, w):
    """x (B, H, W, ci), w (3, 3, ci, co), one dtype -> (B, H/2, W/2, 4co)
    with channels (py, px, co). Equal to space_to_depth(conv3x3(x, w))."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return S2DEntryConvFunction.apply(x, w)
    return _forward(x, w)


def _forward(x, w):
    if x.device.type == "cpu":
        return conv3x3_s2d_entry(x, w)
    return _s2d_entry_conv_cuda(x, w)


class S2DEntryConvFunction(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU). Backward:
    autograd of the plain version on the saved inputs."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, grad):
        x, w = (t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad))
        wanted = [t for t in (x, w) if t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(conv3x3_s2d_entry(x, w), wanted, grad))
        return tuple(next(grads) if t.requires_grad else None for t in (x, w))


def _s2d_entry_conv_cuda(x, w):
    if x.device.type != "cuda":
        raise ValueError(f"s2d_entry_conv: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"s2d_entry_conv: dtype {x.dtype} not in (bfloat16, float32)")
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"s2d_entry_conv: kernel is {w.dtype} on {w.device}, input {x.dtype} on {x.device}")
    if x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"s2d_entry_conv: need a contiguous, 16-byte aligned (B, H, W, ci) input, got {tuple(x.shape)}")
    b, h, wd, ci = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"s2d_entry_conv: kernel shape {tuple(w.shape)} != (3, 3, {ci}, co)")
    co = w.shape[3]
    if h % 2 or wd % 2 or b * h * wd == 0:
        raise ValueError(f"s2d_entry_conv: H and W must be even and non-zero, got {h} x {wd}")
    if co % 8:
        raise ValueError(f"s2d_entry_conv: co = {co} is not a multiple of 8")
    if b * h * wd * max(ci, co) >= 2 ** 31:
        raise ValueError("s2d_entry_conv: tensor too large for 32-bit element indexing")
    x, w = x.detach(), w.detach()
    out = torch.empty((b, h // 2, wd // 2, 4 * co), dtype=x.dtype, device=x.device)
    lib = _build.library("s2d_entry_conv")
    symbol = s2d_entry_route(x.dtype, ci, co)
    args = [_build.ptr(x), None, _build.ptr(out), b, h, wd]
    if symbol == "s2d_entry_conv_bf16_wg":
        # implicit GEMM on wgmma; w as it is: ((ky, kx, ci), co) bf16
        fn, weights = _entry(lib, symbol, 5), _aligned(w.reshape(9 * ci, co))
        args += [ci, co]
    elif symbol == "s2d_entry_conv_bf16_image":
        # the image conv on tensor cores, K = 9 taps padded to 16: (9, co) bf16
        fn, weights = _entry(lib, symbol, 4), _aligned(w.reshape(9, co))
        args += [co]
    else:
        # SIMT: ((ky, kx, ci), co) f32, staged 16 bytes at a time
        fn, weights = _entry(lib, symbol, 5), _aligned(w.float().reshape(9 * ci, co))
        args += [ci, co]
    args[1] = _build.ptr(weights)
    _build.check(fn(*args, _build.stream_ptr(x.device)), "s2d_entry_conv")
    _build.LAUNCHES["s2d_entry_conv"] += 1
    return out


def s2d_entry_route(dtype, ci: int, co: int) -> str:
    """The C entry of `csrc/s2d_entry_conv.cu` that takes an input of
    `dtype` with ci channels to co: bf16 with co a multiple of 64 on tensor
    cores (wgmma at ci in `WG_CHANNELS`, the image kernel at ci = 1), all
    else SIMT (`s2d_entry_ffma`; at ci = 1 with 256 threads a multiple of
    co / 8, `s2d_entry_simt_image`)."""
    if dtype == torch.bfloat16 and co % 64 == 0 and ci in WG_CHANNELS:
        return "s2d_entry_conv_bf16_wg"
    if dtype == torch.bfloat16 and co % 64 == 0 and ci == 1:
        return "s2d_entry_conv_bf16_image"
    return "s2d_entry_conv_bf16_simt" if dtype == torch.bfloat16 else "s2d_entry_conv_f32_simt"


def _entry(lib, symbol, ints):
    """A launcher of the library, its signature (x, w, out, `ints` ints,
    stream) set."""
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t):
    """t contiguous and starting on 16 bytes, copied only where it is not:
    the kernels copy weights 16 bytes at a time."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
