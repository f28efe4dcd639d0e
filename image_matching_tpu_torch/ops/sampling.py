"""Bilinear descriptor sampling at keypoints, patch extraction and the
soft-argmax subpixel refinement — the counterpart of
`image_matching_tpu/ops/sampling.py` (`sample_descriptors`,
`describe_keypoints`, `extract_patches`, `soft_argmax_2d`, `refine_keypoints_subpixel`) and
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


def describe_keypoints(kpts, desc_map, cell: int = 8):
    """`kpts` (a `Keypoints`) with its descriptors sampled from desc_map
    (B, Hc, Wc, D) by `sample_descriptors`, invalid slots zeroed."""
    desc = sample_descriptors(kpts.xy, desc_map, cell)
    return kpts.replace(desc=desc * kpts.mask[..., None].to(desc.dtype))


def extract_patches(image, xy, patch_size: int = 5):
    """Gather patch_size x patch_size patches centred at the rounded
    keypoints. image (B, H, W) or (B, H, W, 1); xy (B, K, 2) ->
    (B, K, P, P) f32. Taps outside the image read 0."""
    if image.dim() == 4:
        image = image[..., 0]
    r = patch_size // 2
    steps = torch.arange(-r, patch_size - r, dtype=torch.float32, device=xy.device)
    dy, dx = torch.meshgrid(steps, steps, indexing="ij")
    offsets = torch.stack([dx, dy], dim=-1).reshape(-1, 2)
    coords = (torch.round(xy)[:, :, None, :] + offsets).reshape(xy.shape[0], -1, 2)  # (B, K*P*P, 2)
    patches = bilinear_sample(image[..., None].float(), coords)[..., 0]
    return patches.reshape(xy.shape[0], xy.shape[1], patch_size, patch_size)


def soft_argmax_2d(patches):
    """Spatial soft-argmax over (..., P, P) patches -> (..., 2) expected
    (x, y) in patch coordinates [0, P-1]."""
    *lead, ph, pw = patches.shape
    prob = torch.softmax(patches.reshape(*lead, ph * pw), dim=-1).reshape(*lead, ph, pw)
    ys = torch.arange(ph, dtype=patches.dtype, device=patches.device)
    xs = torch.arange(pw, dtype=patches.dtype, device=patches.device)
    ey = (prob * ys[:, None]).sum(dim=(-2, -1))
    ex = (prob * xs[None, :]).sum(dim=(-2, -1))
    return torch.stack([ex, ey], dim=-1)


def refine_keypoints_subpixel(heatmap, xy, patch_size: int = 5):
    """Subpixel refinement: the soft-argmax of the log of the heatmap patch
    around each keypoint (with the reference's 1e-6 floor), as an offset
    from the patch centre added to the rounded keypoint."""
    patches = extract_patches(heatmap, xy, patch_size)
    sub = soft_argmax_2d(torch.log(patches + 1e-6))
    return torch.round(xy) + (sub - (patch_size - 1) / 2.0)
