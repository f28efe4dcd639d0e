"""Image warping by a homography and valid masks — the counterpart of
`image_matching_tpu/geometry/warp.py`: inverse warping by a bilinear or
nearest gather in pixel coordinates (zero outside the image), and the
mask of destination pixels whose source lies inside, eroded by a disk.
NHWC, like the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from image_matching_tpu_torch.geometry.homography import warp_points
from image_matching_tpu_torch.ops.sampling import bilinear_sample


def nearest_sample(img, coords_xy):
    """img (B, H, W, C); coords_xy (B, K, 2) float pixel (x, y) -> (B, K, C)
    at the rounded (half to even) pixels, zero outside the image."""
    b, h, w, c = img.shape
    ix = torch.round(coords_xy[..., 0]).long()
    iy = torch.round(coords_xy[..., 1]).long()
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    vals = torch.gather(img.reshape(b, h * w, c), 1, idx[..., None].expand(-1, -1, c))
    return vals * valid[..., None].to(img.dtype)


def _source_grid(h_inv, height: int, width: int):
    """(B, H*W, 2) source pixel of every destination pixel, row-major."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=h_inv.device),
                            torch.arange(width, dtype=torch.float32, device=h_inv.device), indexing="ij")
    grid = torch.stack([xs, ys], dim=-1).reshape(1, height * width, 2).expand(h_inv.shape[0], -1, -1)
    return warp_points(grid, h_inv)


def warp_image(img, h_inv, mode: str = "bilinear"):
    """img (B, H, W, C), h_inv (B, 3, 3) or (3, 3) destination -> source
    homography in pixels: out(p) = img(h_inv @ p), zero where a tap falls
    outside; `mode` "bilinear" or "nearest". To warp an image *by* H, pass
    inv(H)."""
    b, h, w, c = img.shape
    if h_inv.dim() == 2:
        h_inv = h_inv.expand(b, 3, 3)
    sample = {"bilinear": bilinear_sample, "nearest": nearest_sample}[mode]
    return sample(img, _source_grid(h_inv, h, w)).reshape(b, h, w, c)


def disk_kernel(radius: int, device=None):
    """(2r, 2r) disk structuring element: taps whose distance from the
    centre ((2r - 1) / 2, (2r - 1) / 2) is at most r."""
    r = radius
    ys, xs = torch.meshgrid(torch.arange(2 * r, device=device), torch.arange(2 * r, device=device), indexing="ij")
    c = (2 * r - 1) / 2.0
    return (((ys - c) ** 2 + (xs - c) ** 2) <= r * r).float()


def erode_mask(mask, radius: int):
    """Binary erosion of (..., H, W) masks in {0, 1} by `disk_kernel`: a
    pixel survives where every tap of the kernel is 1, outside the image
    counting as 0. XLA's SAME padding of the even kernel: r - 1 before, r
    after."""
    if radius <= 0:
        return mask
    k = disk_kernel(radius, mask.device)
    m = mask.float().reshape(-1, 1, *mask.shape[-2:])
    m = F.pad(m, (radius - 1, radius, radius - 1, radius))
    out = F.conv2d(m, k[None, None])
    return (out[:, 0] >= k.sum() - 0.5).to(mask.dtype).reshape(mask.shape)


def compute_valid_mask(h_inv, height: int, width: int, erosion_radius: int = 0):
    """(B, H, W) f32 mask in {0, 1} of destination pixels whose source
    h_inv @ p rounds to a pixel inside the image (a nearest warp of a ones
    image), eroded by `erosion_radius`. h_inv (B, 3, 3) or (3, 3)."""
    hb = h_inv if h_inv.dim() == 3 else h_inv[None]
    src = torch.round(_source_grid(hb, height, width))
    x, y = src[..., 0], src[..., 1]
    inb = (x >= 0) & (x <= width - 1) & (y >= 0) & (y <= height - 1)
    mask = erode_mask(inb.float().reshape(-1, height, width), erosion_radius)
    return mask if h_inv.dim() == 3 else mask[0]
