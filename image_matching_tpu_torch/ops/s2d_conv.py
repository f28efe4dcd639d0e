"""3x3 convolutions resident in the 2x2 space-to-depth ("s2d") layout —
the counterpart of `image_matching_tpu/ops/s2d_conv.py:33-222`.

A stride-1 SAME 3x3 conv on (H, W, C) equals four 2x2 convs on the
space-to-depth tensor (H/2, W/2, 4C), one per output-pixel parity
(py, px): full-resolution tap row u = py + ky - 1 decomposes as
u = 2a + dy, so parity (py, px) reads the 2x2 decimated window at offset
(py - 1, px - 1) over channels (dy, dx, ci). Channel layouts are
(dy, dx, ci) for inputs and (py, px, co) for outputs, row-major, as in
`space_to_depth`.

The layout is a device for a 128-lane matrix unit. On an H100 the 2x2
kernel of `conv3x3_s2d_raw` is 9/16 dense, so the card does 16/9 of the
useful multiply-adds there; the port's default backbone is the plain one
(`models/matching.MatchingConfig`). This module exists so that the port
covers the JAX package's configurations and outputs the same values.

Tensors are NHWC and contiguous, as in the JAX package. Representations:

  direct  : ordinary (B, H, W, C) feature map
  aligned : (B, H/2, W/2, 4C) s2d layout (== `space_to_depth`)
  U       : (B, H/2+1, W/2+1, 4C) unaligned conv output; parity group
            (py, px) holds its aligned value for index (i, j) at
            U[i+py, j+px]. Realignment is left to the consumer.

`conv3x3_s2d_entry` and `maxpool2x2_s2d_from_raw` are the plain versions
of the two CUDA kernels (`ops/s2d_entry.py`, `ops/realign.py`). The
in-level 2x2 conv (`conv3x3_s2d_raw`) is a library convolution, as it is
an XLA convolution in the JAX package.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_ZERO_TAP = 9  # index of the all-zero tap appended to the nine real ones


def space_to_depth(x):
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel layout (dy, dx, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x):
    """(B, H/2, W/2, 4C) with (dy, dx, c) channels -> (B, H, W, C)."""
    b, hh, wh, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, hh, wh, 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh * 2, wh * 2, c)


@functools.lru_cache(maxsize=None)
def _s2d_tap_table() -> np.ndarray:
    """tap[py, px, r, s, dy, dx]: which of the nine 3x3 taps (ky * 3 + kx)
    the 2x2 s2d kernel of output parity (py, px) holds at window position
    (r, s), input parity (dy, dx); `_ZERO_TAP` where it holds none.

    Full-resolution tap u = py + ky - 1 = 2a + dy with a in {py - 1, py},
    dy in {0, 1}; kernel row r = a + 1 - py in {0, 1} (same for columns)."""
    tap = np.full((2, 2, 2, 2, 2, 2), _ZERO_TAP, np.int64)
    for py in range(2):
        for px in range(2):
            for ky in range(3):
                u = py + ky - 1
                a, dy = u >> 1, u & 1
                r = a + 1 - py
                for kx in range(3):
                    v = px + kx - 1
                    b_, dx = v >> 1, v & 1
                    s = b_ + 1 - px
                    tap[py, px, r, s, dy, dx] = ky * 3 + kx
    return tap


@functools.lru_cache(maxsize=None)
def _entry_tap_table() -> np.ndarray:
    """tap[py, px, a, b]: the 3x3 tap that output parity (py, px) takes at
    position (a, b) of the 4x4 stride-2 window anchored at row 2i - 1,
    column 2j - 1: full-resolution offset u = py + ky - 1 sits at window
    row u + 1."""
    tap = np.full((2, 2, 4, 4), _ZERO_TAP, np.int64)
    for py in range(2):
        for px in range(2):
            for ky in range(3):
                for kx in range(3):
                    tap[py, px, py + ky, px + kx] = ky * 3 + kx
    return tap


@functools.lru_cache(maxsize=None)
def _tap_index(table_fn, device):
    """A tap table, flat, on `device`: copied there once. Made outside
    inference mode, so that a call under autograd can use it later."""
    with torch.inference_mode(False):
        return torch.from_numpy(table_fn().reshape(-1)).to(device)


def _gather_taps(w, table_fn, select=()):
    """w (3, 3, ci, co) -> w10[table]: (*table.shape, ci, co), where w10 is
    the nine taps and one zero tap, and table is `table_fn()[select]`. One
    gather instead of nine slice assignments per parity."""
    ci, co = w.shape[2], w.shape[3]
    w10 = torch.cat([w.reshape(9, ci, co), w.new_zeros(1, ci, co)], 0)
    shape = table_fn().shape
    taps = w10.index_select(0, _tap_index(table_fn, w.device)).reshape(*shape, ci, co)
    return taps[select]


def s2d_kernel(w, py: int, px: int):
    """(3, 3, ci, co) -> the (2, 2, 4ci, co) kernel of output parity
    (py, px) in s2d space."""
    ci, co = w.shape[2], w.shape[3]
    return _gather_taps(w, _s2d_tap_table, (py, px)).reshape(2, 2, 4 * ci, co)


def s2d_kernel_all(w):
    """(3, 3, ci, co) -> (2, 2, 4ci, 4co): all four parity kernels stacked
    along output channels in (py, px, co) order."""
    ci, co = w.shape[2], w.shape[3]
    k = _gather_taps(w, _s2d_tap_table)  # (py, px, r, s, dy, dx, ci, co)
    return k.permute(2, 3, 4, 5, 6, 0, 1, 7).reshape(2, 2, 4 * ci, 4 * co)


def entry_kernel(w):
    """(3, 3, ci, co) -> (4, 4, ci, 4co): kernel of the stride-2 conv that
    computes conv3x3-then-s2d straight from a direct-layout input (pad
    ((1, 2), (1, 2)), stride 2)."""
    ci, co = w.shape[2], w.shape[3]
    k = _gather_taps(w, _entry_tap_table)  # (py, px, a, b, ci, co)
    return k.permute(2, 3, 4, 0, 1, 5).reshape(4, 4, ci, 4 * co)


def _conv_nhwc(x, k_hwio, stride: int = 1, padding=0):
    """A library convolution on NHWC tensors with an HWIO kernel. The NCHW
    views it hands to `F.conv2d` are channels_last, so nothing is copied."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k_hwio.permute(3, 2, 0, 1), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3_s2d(x_s2d, w):
    """SAME 3x3 stride-1 conv computed in s2d space as one 2x2 conv, then
    each parity group sliced back into alignment. x_s2d (B, H/2, W/2, 4ci),
    w (3, 3, ci, co) -> (B, H/2, W/2, 4co), equal to
    space_to_depth(conv3x3(depth_to_space(x_s2d), w))."""
    return realign(conv3x3_s2d_raw(x_s2d, w))


def maxpool2x2_s2d(x_s2d):
    """2x2 / stride-2 max pool of an aligned s2d map: the max over the four
    parity channel groups."""
    b, hh, wh, c4 = x_s2d.shape
    return x_s2d.reshape(b, hh, wh, 4, c4 // 4).amax(dim=3)


def conv3x3_s2d_entry(x, w):
    """SAME 3x3 conv fused with space_to_depth: direct (B, H, W, ci) in,
    aligned (B, H/2, W/2, 4co) out, as one stride-2 4x4 conv. Equal to
    space_to_depth(conv3x3(x, w)). No bias.

    The plain version of `ops/s2d_entry.s2d_entry_conv`: products of the
    inputs as they are in their type, summed in f32, rounded once to the
    input type."""
    xf = F.pad(x.float(), (0, 0, 1, 2, 1, 2))
    return _conv_nhwc(xf, entry_kernel(w).float(), stride=2).to(x.dtype)


def conv3x3_s2d_raw(x_s2d, w, extra_cols: int = 0):
    """SAME 3x3 conv in s2d space, returning the unaligned conv output U
    (B, H/2+1, W/2+1+extra_cols, 4co): the single 2x2 conv without the
    realignment copy. `extra_cols` widens U with junk columns computed over
    extra right padding (the TPU realign kernel wants an 8-aligned width;
    the CUDA kernel does not, but takes such a U); consumers are then told
    the true width through their `out_w`."""
    if extra_cols:
        x_s2d = F.pad(x_s2d, (0, 0, 0, extra_cols))
    return _conv_nhwc(x_s2d, s2d_kernel_all(w), padding=1)


def _parity_slices(u, hh: int, wh: int):
    c = u.shape[3] // 4
    return [u[:, py:py + hh, px:px + wh, (py * 2 + px) * c:(py * 2 + px + 1) * c]
            for py in range(2) for px in range(2)]


def realign(u):
    """U (B, H/2+1, W/2+1, 4C) -> aligned (B, H/2, W/2, 4C)."""
    return torch.cat(_parity_slices(u, u.shape[1] - 1, u.shape[2] - 1), dim=-1)


def maxpool2x2_s2d_from_raw(u, out_w: int | None = None):
    """2x2 / stride-2 max pool fused with the realignment: U in, direct
    (B, H/2, W/2, C) out. `out_w` overrides the width for a U widened by
    `conv3x3_s2d_raw`'s `extra_cols`. A NaN in any of the four taps gives
    NaN (`torch.maximum`).

    The plain version of `ops/realign.maxpool_realign`."""
    wh = out_w if out_w is not None else u.shape[2] - 1
    g = _parity_slices(u, u.shape[1] - 1, wh)
    return torch.maximum(torch.maximum(g[0], g[1]), torch.maximum(g[2], g[3]))


def mm1x1_s2d(x, w, bias=None):
    """1x1 conv in s2d layout (aligned or U: parity-wise, so alignment does
    not matter): (..., 4ci) @ (ci, co) -> (..., 4co)."""
    *lead, _ = x.shape
    ci, co = w.shape
    y = x.reshape(*lead, 4, ci) @ w
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, 4 * co)
