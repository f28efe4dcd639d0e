"""SuperPoint's detector loss — the counterpart of
`image_matching_tpu/losses/detector.py`: a BCE between the per-cell
softmax of the logits and the dustbin labels, over the valid cells."""
from __future__ import annotations

import torch

from image_matching_tpu_torch.geometry.labels import labels_2d_to_3d, space_to_depth
from image_matching_tpu_torch.parallel.mesh import all_sum


def cell_mask_from_2d(mask_2d, cell_size: int = 8):
    """(B, H, W, 1) pixel validity -> (B, Hc, Wc) cell validity: a cell is
    valid where every pixel of it is (the product over the cell)."""
    return space_to_depth(mask_2d, cell_size).prod(dim=-1)


def detector_loss(semi, labels_2d, valid_mask_2d, cell_size: int = 8):
    """semi (B, Hc, Wc, 65) logits; labels_2d (B, H, W, 1) binary or soft
    keypoint map; valid_mask_2d (B, H, W, 1). The BCE of each of the 65
    channels (probabilities clipped to [1e-7, 1 - 1e-7]) summed over the
    channels, then averaged over the valid cells. Returns a scalar (under a
    data mesh, this rank's share of the global batch's: the count of valid
    cells is global)."""
    t = labels_2d_to_3d(labels_2d, cell_size).float()
    mask = cell_mask_from_2d(valid_mask_2d, cell_size)
    p = torch.softmax(semi.float(), dim=-1).clamp(1e-7, 1.0 - 1e-7)
    per_cell = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).sum(dim=-1)
    return (per_cell * mask).sum() / (all_sum(mask.sum()) + 1e-10)
