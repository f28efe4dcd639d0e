"""Top-k in `jax.lax.top_k`'s order: descending, and among equal values
the lower index first. `torch.topk` on CUDA gives no order among ties,
and FAST scores of 8-bit images, or the two orientations of one SIFT
keypoint, tie often."""
from __future__ import annotations

import torch


def topk_lower_index_first(x, k: int):
    """(values, indices) of the k largest entries along the last dim of
    float `x`, ordered as `lax.top_k` orders them. Each entry becomes one
    int64 key, its value's order-preserving int32 image in the high half
    and its reversed index in the low half, so every key is distinct and
    one `torch.topk` gives the order on any device. As in XLA's total
    order, -0.0 ranks below 0.0."""
    x = x.float()
    bits = x.contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # monotone in the float value
    n = x.shape[-1]
    rev = (1 << 32) - 1 - torch.arange(n, dtype=torch.int64, device=x.device)
    key = ordered.to(torch.int64) * (1 << 32) + rev
    idx = torch.topk(key, k, dim=-1).indices
    return torch.gather(x, -1, idx), idx
