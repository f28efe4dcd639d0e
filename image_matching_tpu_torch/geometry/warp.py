"""Image warping by a homography — the counterpart of `warp_image` in
`image_matching_tpu/geometry/warp.py` (bilinear, inverse warping, zero
outside the image). NHWC, like the JAX package."""
from __future__ import annotations

import torch

from image_matching_tpu_torch.geometry.homography import warp_points
from image_matching_tpu_torch.ops.sampling import bilinear_sample


def warp_image(img, h_inv):
    """img (B, H, W, C), h_inv (B, 3, 3) or (3, 3) destination -> source
    homography in pixels: out(p) = img(h_inv @ p), bilinear, zero where a
    tap falls outside. To warp an image *by* H, pass inv(H)."""
    b, h, w, c = img.shape
    if h_inv.dim() == 2:
        h_inv = h_inv.expand(b, 3, 3)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device), indexing="ij")
    grid = torch.stack([xs, ys], dim=-1).reshape(1, h * w, 2).expand(b, h * w, 2)
    src = warp_points(grid, h_inv)
    return bilinear_sample(img, src).reshape(b, h, w, c)
