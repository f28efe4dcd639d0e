"""Matching metrics of training — the counterpart of
`matching_precision_recall` in `image_matching_tpu/train/metrics.py`."""
from __future__ import annotations


def matching_precision_recall(matches0, gt0, mask0, n1: int) -> dict:
    """Match-level precision and recall against a ground-truth assignment
    whose dustbin index is `n1`, with the reference's 1e-6 smoothing."""
    pred = matches0 >= 0
    gt_match = (gt0 < n1) & mask0
    correct = (pred & gt_match & (matches0 == gt0)).sum().float()
    return {
        "match_precision": correct / ((pred & mask0).sum().float() + 1e-6),
        "match_recall": correct / (gt_match.sum().float() + 1e-6),
    }
