"""SuperGlue's ground-truth assignment and NLL loss — the counterpart of
`image_matching_tpu/losses/superglue_loss.py`."""
from __future__ import annotations

import torch

from image_matching_tpu_torch.parallel.mesh import all_sum


def make_gt_matches(xy0_warped_to1, xy1, mask0, mask1, dist_thresh: float = 3.0):
    """Mutual nearest neighbours of the warped keypoints of set 0 and the
    keypoints of set 1, closer than `dist_thresh` px, are matches; every
    other valid keypoint goes to the dustbin.

    xy0_warped_to1 (B, K0, 2), xy1 (B, K1, 2), masks (B, K0) / (B, K1).
    Returns gt0 (B, K0) int32 in [0, K1] (K1 = dustbin) and gt1 (B, K1)
    int32 in [0, K0] (K0 = dustbin)."""
    k0, k1 = xy0_warped_to1.shape[-2], xy1.shape[-2]
    d2 = ((xy0_warped_to1[:, :, None, :] - xy1[:, None, :, :]) ** 2).sum(-1)
    valid = mask0[:, :, None] & mask1[:, None, :]
    d2 = torch.where(valid, d2, torch.full((), 1e12, dtype=d2.dtype, device=d2.device))
    best1 = d2.argmin(dim=-1)  # (B, K0); the first minimum, as jnp.argmin
    best0 = d2.argmin(dim=-2)  # (B, K1)
    dmin = d2.amin(dim=-1)
    arange0 = torch.arange(k0, device=d2.device)
    mutual = torch.gather(best0, 1, best1) == arange0
    is_match0 = mutual & (dmin < dist_thresh ** 2) & mask0

    dustbin1 = torch.full_like(best1, k1)
    gt0 = torch.where(is_match0, best1, dustbin1)
    # invert onto set 1: matched targets are unique; the rest land on the
    # extra column K1, which is dropped
    gt1 = torch.full((best1.shape[0], k1 + 1), k0, dtype=torch.int64, device=d2.device)
    gt1.scatter_(1, gt0, torch.where(is_match0, arange0.expand_as(best1), torch.full_like(best1, k0)))
    return gt0.int(), gt1[:, :k1].int()


def superglue_nll_loss(log_coupling, gt0, gt1, mask0, mask1):
    """Mean -log P over the ground-truth pairs: (i, gt0[i]) for every valid
    keypoint i of set 0, matched or dustbin-assigned, and (dustbin, j) for
    every valid keypoint j of set 1 left unmatched. Under a data mesh, this
    rank's share of the global batch's mean: the count is global."""
    m, n = log_coupling.shape[1] - 1, log_coupling.shape[2] - 1
    z0 = torch.gather(log_coupling[:, :m, :], 2, gt0.long()[..., None])[..., 0]
    loss0 = -z0 * mask0.float()
    unmatched1 = (gt1 == m) & mask1
    loss1 = -log_coupling[:, m, :n] * unmatched1.float()
    count = all_sum((mask0.sum() + unmatched1.sum()).float()).clamp_min(1.0)
    return (loss0.sum() + loss1.sum()) / count
