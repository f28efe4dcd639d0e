"""Max-pool non-maximum suppression on dense heatmaps — the counterpart
of `image_matching_tpu/ops/nms.py` (the reference's `simple_nms`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2d(x, window: int):
    """Same-padded max pool over the two trailing dims of (B, H, W),
    separable: rows, then columns (padding never wins: it is -inf)."""
    pad = window // 2
    y = F.max_pool2d(x[:, None], (1, window), stride=1, padding=(0, pad))
    return F.max_pool2d(y, (window, 1), stride=1, padding=(pad, 0))[:, 0]


ITERATIONS = 2


def simple_nms(scores, radius: int):
    """Keep pixels that are the max of their (2r+1)^2 neighbourhood,
    iterating twice to re-admit maxima suppressed only by suppressed
    pixels. scores: (B, H, W) >= 0."""
    if radius <= 0:
        return scores
    window = radius * 2 + 1
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    max_mask = scores == max_pool_2d(scores, window)
    for _ in range(ITERATIONS):
        supp_mask = max_pool_2d(max_mask.to(scores.dtype), window) > 0
        supp_scores = torch.where(supp_mask, zero, scores)
        new_max_mask = supp_scores == max_pool_2d(supp_scores, window)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zero)
