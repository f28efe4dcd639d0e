"""SuperPoint's sparse contrastive descriptor loss — the counterpart of
`image_matching_tpu/losses/descriptor.py`, batched, with fixed shapes.

Per image: every cell of image 0 is warped into image 1's cell grid and
rounded; `num_matches` slots are chosen among the warps that land inside
(a random-priority top-k when the grid has at least that many cells,
else a choice with replacement); positives pay max(0, 1 - <d_a, d_b>),
averaged over the valid slots; each slot also meets `num_non_matches`
random cells of image 1, moved away (a N(0, 10) step, at least 0.5) where
they lie within one cell of the true match in x or y, wrapped around the
grid, and those pay max(0, <d_a, d_n> - 0.2), summed and divided by the
count of positive terms plus one. total = lamda_d * match + non-match,
averaged over the batch.

The random numbers come in a `DescriptorDraws` (`draw_descriptor_loss`,
from a `torch.Generator`), which the loss applies. The negatives'
similarities are read from one (B, M, Hc*Wc) product of the chosen
descriptors with image 1's map, not from a (B, M, num_non_matches, D)
gather: 38 MB at 240x320, batch 8 and 1000 slots, against 410 MB (D = 128).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from image_matching_tpu_torch.geometry.homography import warp_points
from image_matching_tpu_torch.parallel.mesh import global_count


class DescriptorDraws(NamedTuple):
    """The random numbers of one loss of a batch of B images with M slots
    and NN negatives a slot, over N = Hc * Wc cells."""
    select: torch.Tensor  # (B, N) uniform priorities if M <= N, else (B, M, N) Gumbel noise
    negatives: torch.Tensor  # (B, M, NN, 2) int64 cells (x in [0, Wc), y in [0, Hc))
    sign: torch.Tensor  # (B, M, NN) uniform: the step's sign, floor(2u) - 0.5
    magnitude: torch.Tensor  # (B, M, NN) standard normal: the step is 10 * this + the sign


def draw_descriptor_loss(gen: torch.Generator, batch: int, hc: int, wc: int, num_matches: int = 1000,
                         num_non_matches: int = 100) -> DescriptorDraws:
    """Every random number of one loss, from `gen` on its device."""
    dev, n = gen.device, hc * wc
    shape = (batch, num_matches, num_non_matches)
    if num_matches <= n:
        select = torch.rand((batch, n), generator=gen, device=dev)
    else:  # categorical with replacement, by Gumbel-max
        u = torch.rand((batch, num_matches, n), generator=gen, device=dev).clamp_min(torch.finfo(torch.float32).tiny)
        select = -torch.log(-torch.log(u))
    negatives = torch.stack([torch.randint(0, wc, shape, generator=gen, device=dev),
                             torch.randint(0, hc, shape, generator=gen, device=dev)], dim=-1)
    return DescriptorDraws(select, negatives, torch.rand(shape, generator=gen, device=dev),
                           torch.randn(shape, generator=gen, device=dev))


def homography_to_cell_frame(h, cell_size: int = 8):
    """Pixel homographies (..., 3, 3) -> cell-grid ones: S H S^-1 with
    S = diag(1/s, 1/s, 1)."""
    s = float(cell_size)
    scale = torch.tensor([1 / s, 1 / s, 1.0], dtype=h.dtype, device=h.device)
    return scale[:, None] * h / scale[None, :]


def _cell_index(uv, wc: int, n: int):
    """Flat cell index y * Wc + x of integer-valued (x, y), clipped to the map."""
    return (uv[..., 1].long() * wc + uv[..., 0].long()).clamp(0, n - 1)


def _gather_cells(desc, idx):
    """desc (B, N, D), idx (B, M) -> (B, M, D)."""
    return torch.gather(desc, 1, idx[..., None].expand(-1, -1, desc.shape[-1]))


def sparse_descriptor_loss(draws: DescriptorDraws, desc0, desc1, homographies, lamda_d: float = 1.0,
                           margin_pos: float = 1.0, margin_neg: float = 0.2, cell_size: int = 8):
    """desc0, desc1 (B, Hc, Wc, D) unit-norm coarse maps of an image and
    its warp; homographies (B, 3, 3) pixel homographies image -> warp.
    Returns the batch means (total, positive, negative); under a data mesh,
    this rank's share of the global batch's means (the per-image
    normalisers stay per image)."""
    b, hc, wc, d = desc0.shape
    n = hc * wc
    m = draws.negatives.shape[1]
    ys, xs = torch.meshgrid(torch.arange(hc, device=desc0.device), torch.arange(wc, device=desc0.device),
                            indexing="ij")
    uv_a = torch.stack([xs, ys], dim=-1).reshape(n, 2).float()
    uv_b = torch.round(warp_points(uv_a.expand(b, n, 2), homography_to_cell_frame(homographies, cell_size)))
    inb = (uv_b[..., 0] >= 0) & (uv_b[..., 0] <= wc - 1) & (uv_b[..., 1] >= 0) & (uv_b[..., 1] <= hc - 1)

    if draws.select.dim() == 2:  # random-priority top-k among the warps inside
        sel = torch.topk(torch.where(inb, draws.select, -1.0), m, dim=-1).indices
    else:  # categorical with replacement over the warps inside (over all cells if none is)
        logits = torch.where(inb | ~inb.any(dim=-1, keepdim=True), 0.0, -math.inf)
        sel = (draws.select + logits[:, None, :]).argmax(dim=-1)
    uv_b_m = torch.gather(uv_b, 1, sel[..., None].expand(-1, -1, 2))
    w = torch.gather(inb, 1, sel).float()

    flat0, flat1 = desc0.reshape(b, n, d).float(), desc1.reshape(b, n, d).float()
    da = _gather_cells(flat0, sel)  # the cell of slot i is cell sel[i] of image 0
    db = _gather_cells(flat1, _cell_index(uv_b_m, wc, n))
    pos_sim = (da * db).sum(dim=-1)
    match_loss = ((margin_pos - pos_sim).clamp_min(0.0) * w).sum(dim=-1) / w.sum(dim=-1).clamp_min(1.0)

    neg = draws.negatives.float()
    diff = (neg - uv_b_m[:, :, None, :]).abs()
    too_close = (diff[..., 0] < 1.0) | (diff[..., 1] < 1.0)
    step = draws.magnitude * 10.0 + (torch.floor(draws.sign * 2.0) - 0.5)
    neg = neg + torch.where(too_close, step, 0.0)[..., None]  # the same step in x and y
    wrapped = []
    for axis, upper in ((0, wc - 1.0), (1, hc - 1.0)):
        v = neg[..., axis]
        v = torch.where(v > upper, v - upper, v)
        v = torch.where(v < 0.0, v + upper, v)
        wrapped.append(torch.floor(v).clamp(0.0, upper))
    neg_idx = _cell_index(torch.stack(wrapped, dim=-1), wc, n)  # (B, M, NN)
    sim = torch.bmm(da, flat1.transpose(1, 2))  # (B, M, N)
    neg_sim = torch.gather(sim, 2, neg_idx)
    neg_hinge = (neg_sim - margin_neg).clamp_min(0.0) * w[..., None]
    non_match_loss = neg_hinge.sum(dim=(1, 2)) / ((neg_hinge > 0).sum(dim=(1, 2)) + 1.0)

    pos = lamda_d * match_loss
    n = global_count(b)
    return (pos + non_match_loss).sum() / n, pos.sum() / n, non_match_loss.sum() / n
