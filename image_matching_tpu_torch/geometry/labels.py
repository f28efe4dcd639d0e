"""Detector-label plumbing — the counterpart of the inference part of
`image_matching_tpu/geometry/labels.py` (`depth_to_space`,
`flatten_detection`). NHWC, like the JAX package."""
from __future__ import annotations

import torch


def depth_to_space(x, block: int = 8):
    """(B, Hc, Wc, C*b*b) with channels in (C, by, bx) order -> (B, H, W, C)."""
    b, hc, wc, cbb = x.shape
    c = cbb // (block * block)
    x = x.reshape(b, hc, wc, c, block, block).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, hc * block, wc * block, c)


def flatten_detection(semi, cell_size: int = 8):
    """Detector logits (B, Hc, Wc, 65) -> heatmap (B, H, W, 1): softmax
    in f32 over the 65 channels, dustbin dropped, stored in bf16 (as the
    JAX package's inference detect path stores it), pixel-shuffled up."""
    dense = torch.softmax(semi.float(), dim=-1)
    nodust = dense[..., :-1].to(torch.bfloat16)
    return depth_to_space(nodust, cell_size)
