"""Heatmap -> fixed-K keypoints — the counterpart of
`image_matching_tpu/ops/detect.py` (`detect_keypoints`): NMS, border
mask, then either the exact 4x4 tiled top-k or a flat top-k."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from image_matching_tpu_torch.ops.nms import simple_nms
from image_matching_tpu_torch.structs import Keypoints


def detect_keypoints(heatmap, max_keypoints: int, threshold: float = 0.005,
                     nms_radius: int = 4, border: int = 4):
    """heatmap (B, H, W) or (B, H, W, 1) -> Keypoints with xy (B, K, 2)
    f32 as (x, y), score (B, K) f32 (0 where masked) and mask (B, K)."""
    if heatmap.dim() == 4:
        heatmap = heatmap[..., 0]
    b, h, w = heatmap.shape
    scores = simple_nms(heatmap, nms_radius)

    ys = torch.arange(h, device=scores.device)[:, None]
    xs = torch.arange(w, device=scores.device)[None, :]
    border_ok = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    scores = torch.where(border_ok[None], scores, torch.zeros((), dtype=scores.dtype, device=scores.device))

    n_tiles = (-(-h // 4)) * (-(-w // 4))
    if nms_radius >= 3 and max_keypoints <= n_tiles:
        # radius-r NMS leaves non-tied survivors more than r apart, so a
        # 4x4 tile holds at most one: reduce tiles, then sort the tiles
        top_scores, yy, xx = _tiled_topk(scores, max_keypoints, tile=4)
    else:
        flat = scores.reshape(b, h * w)
        k = min(max_keypoints, h * w)
        top_scores, top_idx = torch.topk(flat, k, dim=-1)
        if k < max_keypoints:
            top_scores = F.pad(top_scores, (0, max_keypoints - k))
            top_idx = F.pad(top_idx, (0, max_keypoints - k))
        yy, xx = top_idx // w, top_idx % w
    xy = torch.stack([xx.float(), yy.float()], dim=-1)
    mask = top_scores > threshold
    score = torch.where(mask, top_scores, torch.zeros((), dtype=top_scores.dtype, device=scores.device))
    return Keypoints(xy=xy, score=score.float(), mask=mask)


def _tiled_topk(scores, k: int, tile: int = 4):
    """Top-k over (B, H, W) with at most one positive per tile x tile
    block. Each tile reports its max and the smallest linear index that
    attains it; a stable descending sort over the tiles keeps equal
    scores in tile order, as the JAX package's stable `lax.sort` does."""
    b, h, w = scores.shape
    ph, pw = -h % tile, -w % tile
    if ph or pw:
        scores = F.pad(scores, (0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    th, tw = hp // tile, wp // tile
    tiles = scores.reshape(b, th, tile, tw, tile).permute(0, 1, 3, 2, 4).reshape(b, th * tw, tile * tile)
    tmax, pos = tiles.max(dim=-1)  # first (row-major) position of the max
    ty = torch.arange(th, device=scores.device)[:, None] * tile + pos.reshape(b, th, tw) // tile
    tx = torch.arange(tw, device=scores.device)[None, :] * tile + pos.reshape(b, th, tw) % tile
    lin = (ty * wp + tx).reshape(b, th * tw)
    top_scores, order = torch.sort(tmax, dim=-1, descending=True, stable=True)
    sel = torch.gather(lin, 1, order[:, :k])
    return top_scores[:, :k], sel // wp, sel % wp
