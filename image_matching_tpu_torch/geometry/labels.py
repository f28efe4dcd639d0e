"""Detector-label plumbing — the counterpart of
`image_matching_tpu/geometry/labels.py`: space <-> depth, dustbin labels,
point scattering and splatting, and the homographic-adaptation heatmap
aggregation. NHWC, fixed shapes, like the JAX package.
"""
from __future__ import annotations

import torch

from image_matching_tpu_torch.geometry.warp import warp_image


def space_to_depth(x, block: int = 8):
    """(B, H, W, C) -> (B, H/b, W/b, C*b*b), channels in (C, by, bx) order,
    the pixel-unshuffle the detector head expects."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // block, w // block, c * block * block)


def depth_to_space(x, block: int = 8):
    """(B, Hc, Wc, C*b*b) with channels in (C, by, bx) order -> (B, H, W, C)."""
    b, hc, wc, cbb = x.shape
    c = cbb // (block * block)
    x = x.reshape(b, hc, wc, c, block, block).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, hc * block, wc * block, c)


def labels_2d_to_3d(labels, cell_size: int = 8, add_dustbin: bool = True):
    """Keypoint map (B, H, W, 1) -> per-cell distribution (B, Hc, Wc, 65):
    space-to-depth, a dustbin channel of 1 - occupancy that is floored to
    0 where it is under 1 (so only empty cells keep it), then each cell
    divided by its sum."""
    cells = space_to_depth(labels, cell_size)
    if not add_dustbin:
        return cells
    occupancy = cells.sum(dim=-1, keepdim=True)
    dustbin = torch.where(occupancy >= 1.0, 0.0, 1.0 - occupancy)
    dustbin = torch.where(dustbin < 1.0, 0.0, dustbin)
    cells = torch.cat([cells, dustbin], dim=-1)
    return cells / cells.sum(dim=-1, keepdim=True).clamp_min(1e-12)


def flatten_detection(semi, cell_size: int = 8, dtype=torch.bfloat16):
    """Detector logits (B, Hc, Wc, 65) -> heatmap (B, H, W, 1): softmax
    in f32 over the 65 channels, dustbin dropped, stored in `dtype`,
    pixel-shuffled up. bf16 by default, as the JAX package's inference
    detect path stores it; the export and the training metrics ask for
    f32, the JAX function's default on f32 logits."""
    dense = torch.softmax(semi.float(), dim=-1)
    nodust = dense[..., :-1].to(dtype)
    return depth_to_space(nodust, cell_size)


def _pixel_index(ix, iy, height: int, width: int):
    """Flat indices of integer pixels, clipped into the image (the caller
    writes a value of 0 for the pixels it clipped)."""
    return iy.clamp(0, height - 1) * width + ix.clamp(0, width - 1)


def scatter_points(xy, mask, height: int, width: int):
    """Masked points (B, K, 2) -> (B, H, W) binary maps at the rounded
    (half to even) pixels. Invalid or outside points land clipped with a
    value of 0 under a max, so they change nothing."""
    ix = torch.round(xy[..., 0]).long()
    iy = torch.round(xy[..., 1]).long()
    ok = mask & (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
    flat = torch.zeros(xy.shape[0], height * width, dtype=torch.float32, device=xy.device)
    flat.scatter_reduce_(1, _pixel_index(ix, iy, height, width), ok.float(), reduce="amax")
    return flat.reshape(-1, height, width)


def splat_points_bilinear(xy, mask, height: int, width: int):
    """Masked subpixel points (B, K, 2) -> (B, H, W) soft maps: each point
    adds its four bilinear weights to its neighbours, the sums clipped to
    [0, 1]. (On the card the adds are atomics, so f32 sums vary by order.)"""
    x, y = xy[..., 0], xy[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    flat = torch.zeros(xy.shape[0], height * width, dtype=torch.float32, device=xy.device)
    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)), (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        ix, iy = x0 + dx, y0 + dy
        ok = mask & (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
        flat.scatter_add_(1, _pixel_index(ix, iy, height, width), torch.where(ok, w, 0.0))
    return flat.reshape(-1, height, width).clamp(0.0, 1.0)


def combine_heatmaps(heatmaps, inv_homographies, masks):
    """Homographic-adaptation aggregation: each view's heatmap (..., N, H,
    W, 1) times its validity mask (same shape), warped back to the original
    frame by `inv_homographies` (..., N, 3, 3) (bilinear), summed over the
    N views and divided by the sum of the warped-back masks (floored at
    1e-6). Returns (..., H, W, 1); leading dims are independent images."""
    *lead, n, h, w, c = heatmaps.shape
    hs = inv_homographies.reshape(-1, 3, 3)
    back = warp_image((heatmaps * masks).reshape(-1, h, w, c), hs).reshape(*lead, n, h, w, c)
    masks_back = warp_image(masks.reshape(-1, h, w, c), hs).reshape(*lead, n, h, w, c)
    return back.sum(dim=-4) / masks_back.sum(dim=-4).clamp_min(1e-6)
