"""Training metrics — the counterpart of `image_matching_tpu/train/metrics.py`:
binary precision / recall, the detector's against its labels after NMS,
and SuperGlue's match-level precision / recall. Under a data mesh
(`parallel.use_mesh`) the counts are the global batch's."""
from __future__ import annotations

import torch

from image_matching_tpu_torch.geometry.labels import flatten_detection
from image_matching_tpu_torch.ops.nms import simple_nms
from image_matching_tpu_torch.parallel.mesh import all_sum


def precision_recall(pred, labels) -> dict:
    """Binary precision and recall with the reference's 1e-6 smoothing."""
    pred, labels = pred.float(), labels.float()
    tp, n_pred, n_labels = all_sum(torch.stack([(pred * labels).sum(), pred.sum(), labels.sum()])).unbind(0)
    return {"precision": tp / (n_pred + 1e-6), "recall": tp / (n_labels + 1e-6)}


def detector_precision_recall(semi, labels_2d, detection_threshold: float = 0.015, nms_radius: int = 4) -> dict:
    """The f32 heatmap of semi (B, Hc, Wc, 65) after NMS, thresholded,
    against the labels (B, H, W, 1) above 0.5, as the trainers log."""
    heat = flatten_detection(semi, dtype=torch.float32)[..., 0]
    pred = simple_nms(heat, nms_radius) > detection_threshold
    return precision_recall(pred, labels_2d[..., 0] > 0.5)


def matching_precision_recall(matches0, gt0, mask0, n1: int) -> dict:
    """Match-level precision and recall against a ground-truth assignment
    whose dustbin index is `n1`, with the reference's 1e-6 smoothing."""
    pred = matches0 >= 0
    gt_match = (gt0 < n1) & mask0
    correct, n_pred, n_gt = all_sum(torch.stack([(pred & gt_match & (matches0 == gt0)).sum(), (pred & mask0).sum(),
                                                 gt_match.sum()]).float()).unbind(0)
    return {"match_precision": correct / (n_pred + 1e-6), "match_recall": correct / (n_gt + 1e-6)}
