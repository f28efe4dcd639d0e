"""3x3 convolutions resident in the space-to-depth ("s2d") layouts —
the counterpart of `image_matching_tpu/ops/s2d_conv.py`: the 2x2 layout
(`:33-222`) and the H-only (2, 1) layout (`:240-408`, at the end of this
module).

A stride-1 SAME 3x3 conv on (H, W, C) equals four 2x2 convs on the
space-to-depth tensor (H/2, W/2, 4C), one per output-pixel parity
(py, px): full-resolution tap row u = py + ky - 1 decomposes as
u = 2a + dy, so parity (py, px) reads the 2x2 decimated window at offset
(py - 1, px - 1) over channels (dy, dx, ci). Channel layouts are
(dy, dx, ci) for inputs and (py, px, co) for outputs, row-major, as in
`space_to_depth`.

The layouts are devices for a 128-lane matrix unit. On an H100 the 2x2
kernel of `conv3x3_s2d_raw` is 9/16 dense, so the card does 16/9 of the
useful multiply-adds there (the H-only kernel: 4/3); the port's default
backbone is the plain one (`models/matching.MatchingConfig`). This module
exists so that the port covers the JAX package's configurations and
outputs the same values.

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


def _conv_nhwc(x, k_hwio, stride=1, padding=0):
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


# ---------------------------------------------------------------------------
# The H-only (2, 1) layout: rows are split by parity, columns stay dense, so
# the in-level kernel (2, 3, 2ci, 2co) is 3/4 dense (4/3 of the useful
# multiply-adds, against 16/9 for the 2x2 layout). Representations:
#
#   direct   : (B, H, W, C)
#   alignedH : (B, H/2, W, 2C), channels (dy, c) (== `space_to_depth_h`)
#   Uh       : (B, H/2+1, W, 2C) unaligned conv output; parity group py
#              holds its aligned row i at Uh[i + py]
#
# These are XLA ops in the JAX package and stay plain PyTorch here; the one
# kernel of the layout is the image entry conv (`ops/entry_conv.entry_conv_h`).
# ---------------------------------------------------------------------------


def space_to_depth_h(x):
    """(B, H, W, C) -> (B, H/2, W, 2C), channel layout (dy, c)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w, c).permute(0, 1, 3, 2, 4).reshape(b, h // 2, w, 2 * c)


def depth_to_space_h(x):
    """(B, H/2, W, 2C) with (dy, c) channels -> (B, H, W, C)."""
    b, hh, w, c2 = x.shape
    c = c2 // 2
    return x.reshape(b, hh, w, 2, c).permute(0, 1, 3, 2, 4).reshape(b, hh * 2, w, c)


def s2dh_kernel(w, py: int):
    """(3, 3, ci, co) -> the (2, 3, 2ci, co) kernel of output row parity py
    in H-s2d space: full-resolution tap row u = py + ky - 1 = 2a + dy,
    kernel row r = a + 1 - py in {0, 1}; columns stay dense."""
    ci, co = w.shape[2], w.shape[3]
    out = w.new_zeros(2, 3, 2 * ci, co)
    for ky in range(3):
        u = py + ky - 1
        a, dy = u >> 1, u & 1
        out[a + 1 - py, :, dy * ci:(dy + 1) * ci] = w[ky]
    return out


def s2dh_kernel_all(w):
    """(3, 3, ci, co) -> (2, 3, 2ci, 2co): both row-parity kernels stacked
    along output channels in (py, co) order."""
    return torch.cat([s2dh_kernel(w, 0), s2dh_kernel(w, 1)], dim=-1)


def entry_kernel_h(w):
    """(3, 3, ci, co) -> (4, 3, ci, 2co): kernel of the stride-(2, 1) conv
    that computes conv3x3-then-`space_to_depth_h` straight from a direct
    input. Row parity py takes full-resolution rows u = py + ky - 1 at
    kernel row u + 1 of a 4-row window anchored at row 2i - 1 (pad
    ((1, 2), (1, 1)), row stride 2)."""
    ci, co = w.shape[2], w.shape[3]
    out = w.new_zeros(4, 3, ci, 2 * co)
    for py in range(2):
        for ky in range(3):
            out[py + ky, :, :, py * co:(py + 1) * co] = w[ky]
    return out


def conv3x3_s2dh_entry(x, w):
    """SAME 3x3 conv fused with `space_to_depth_h`: direct (B, H, W, ci) in,
    alignedH (B, H/2, W, 2co) out, as one stride-(2, 1) 4x3 conv in the
    inputs' type. Equal to space_to_depth_h(conv3x3(x, w)). No bias. The JAX
    package phrases ci = 1 as a matmul over 12 tap channels (`_entry_h_mm`,
    for its matrix unit); it is the same function, and here the same conv."""
    return _conv_nhwc(F.pad(x, (0, 0, 1, 1, 1, 2)), entry_kernel_h(w), stride=(2, 1))


def conv3x3_s2dh_raw(x_h, w):
    """SAME 3x3 stride-1 conv in H-s2d space: alignedH (B, H/2, W, 2ci) in,
    unaligned Uh (B, H/2+1, W, 2co) out. Parity group py aligns at row
    offset py (`realign_h` and the pool shift rows only)."""
    return _conv_nhwc(x_h, s2dh_kernel_all(w), padding=1)


def realign_h(u):
    """Uh (B, H/2+1, W, 2C) -> alignedH (B, H/2, W, 2C): two row-shifted
    halves. (The JAX package phrases it as a select, to dodge a TPU
    miscompile of this concatenation; the values are the same.)"""
    hh, c = u.shape[1] - 1, u.shape[3] // 2
    return torch.cat([u[:, :hh, :, :c], u[:, 1:, :, c:]], dim=-1)


def maxpool2x2_s2dh_from_raw(u):
    """2x2 / stride-2 max pool fused with the realignment: Uh in, direct
    (B, H/2, W/2, C) out. Rows reduce across the two parity groups, columns
    pairwise (an odd last column is dropped, as by a VALID window). A NaN
    in any tap gives NaN (`torch.maximum`)."""
    hh, w, c = u.shape[1] - 1, u.shape[2], u.shape[3] // 2
    y = torch.maximum(u[:, :hh, :, :c], u[:, 1:, :, c:])
    return torch.maximum(y[:, :, 0:w - 1:2], y[:, :, 1:w:2])


def mm1x1_s2dh(x, w, bias=None):
    """1x1 conv in H-s2d layout (alignedH or Uh): (..., 2ci) @ (ci, co) ->
    (..., 2co)."""
    *lead, _ = x.shape
    ci, co = w.shape
    y = x.reshape(*lead, 2, ci) @ w
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, 2 * co)
