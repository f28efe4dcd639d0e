"""Bilinear descriptor sampling at keypoints — the counterpart of
`image_matching_tpu/ops/sampling.py` (`sample_descriptors`) and
`geometry/warp.py` (`bilinear_sample`)."""
from __future__ import annotations

import torch


def bilinear_sample(img, coords_xy):
    """img (B, H, W, C); coords_xy (B, K, 2) float pixel (x, y) ->
    (B, K, C). Taps outside the image read zero."""
    b, h, w, c = img.shape
    x = coords_xy[..., 0].float()
    y = coords_xy[..., 1].float()
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    wx = (x - x0.float())[..., None]
    wy = (y - y0.float())[..., None]
    flat = img.reshape(b, h * w, c)

    def tap(ix, iy):
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals * valid[..., None].to(img.dtype)

    v00, v01 = tap(x0, y0), tap(x0 + 1, y0)
    v10, v11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def sample_descriptors(xy, desc_map, cell: int = 8):
    """xy (B, K, 2) full-resolution (x, y); desc_map (B, Hc, Wc, D) ->
    (B, K, D) unit-norm descriptors, with the reference's coordinate
    normalisation n = (p - s/2 + 0.5) / (s*size - s/2 - 0.5) * 2 - 1 and
    align_corners=True sampling."""
    _, hc, wc, _ = desc_map.shape
    s = float(cell)
    size = torch.tensor([wc, hc], dtype=torch.float32, device=xy.device)
    n = (xy - s / 2 + 0.5) / (size * s - s / 2 - 0.5) * 2.0 - 1.0
    pc = (n + 1.0) / 2.0 * (size - 1.0)
    desc = bilinear_sample(desc_map, pc)
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    return desc / norm.clamp_min(1e-12)
