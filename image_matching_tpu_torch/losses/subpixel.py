"""Subpixel refinement losses — the counterpart of
`image_matching_tpu/losses/subpixel.py`: at fixed-K masked keypoints, the
L2 distance between the true subpixel residual and either the soft-argmax
of a heatmap patch around the point or a predicted 2-channel residual map,
averaged over the valid points."""
from __future__ import annotations

import torch

from image_matching_tpu_torch.ops.sampling import extract_patches, soft_argmax_2d


def _masked_mean(err, mask):
    w = mask.float()
    return (err * w).sum() / w.sum().clamp_min(1.0)


def subpixel_loss(xy, residuals, mask, pred_heatmap, patch_size: int = 7):
    """xy (B, K, 2) integer keypoints; residuals (B, K, 2) true offsets;
    mask (B, K); pred_heatmap (B, H, W, 1). The offset is the soft-argmax of
    the log patch (floored at 1e-6) from the patch centre."""
    patches = extract_patches(pred_heatmap, xy, patch_size)
    dxdy = soft_argmax_2d(torch.log(patches.clamp_min(1e-6))) - (patch_size - 1) / 2.0
    return _masked_mean(torch.linalg.vector_norm(residuals - dxdy, dim=-1), mask)


def subpixel_loss_no_argmax(xy, residuals, mask, pred_residual_map):
    """As `subpixel_loss`, with the offsets read from pred_residual_map
    (B, H, W, 2) at the rounded keypoints (clipped into the map)."""
    b, h, w, _ = pred_residual_map.shape
    ix = torch.round(xy[..., 0]).long().clamp(0, w - 1)
    iy = torch.round(xy[..., 1]).long().clamp(0, h - 1)
    pred = pred_residual_map[torch.arange(b, device=xy.device)[:, None], iy, ix]
    return _masked_mean(torch.linalg.vector_norm(residuals - pred, dim=-1), mask)
