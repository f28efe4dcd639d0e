"""SuperPoint training and evaluation steps — the counterpart of
`image_matching_tpu/train/superpoint_trainer.py`: forward passes on the
image and its warped view (the second sees the batch statistics the first
moved, as JAX chains `new_model_state`), the detector loss on each with its
valid mask, the sparse descriptor loss between the two coarse maps through
the pair's homography, total = det + det_warp + lambda_loss * desc, then an
Adam update, skipped when the loss is not finite.

The non-finite guard reads `isfinite(loss)` back to the host once a step
(`is_finite`) and, on a bad batch, skips the update and restores the
running statistics that the two forward passes moved, so the parameters,
Adam's moments and count, the step and the statistics all stay as they
were, as JAX's `tree_map(where(ok, new, old))` leaves them.

Under a data mesh (`parallel.use_mesh`), a step on a rank's shard of the
global batch is that shard's part of the global step: the loss's draws
are made for the global batch and sliced, the batch norms' statistics and
the losses' normalisers are global, the metrics are summed over the
ranks (so they are the global batch's), the gradients are summed, and the
guard reads the global loss.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from image_matching_tpu_torch.losses.descriptor import DescriptorDraws, draw_descriptor_loss, sparse_descriptor_loss
from image_matching_tpu_torch.losses.detector import detector_loss
from image_matching_tpu_torch.parallel.mesh import all_sum_dict, global_count, local_shard, sync_gradients
from image_matching_tpu_torch.train.state import TrainState


class SuperPointLossConfig(NamedTuple):
    """The JAX package's defaults (the reference's training config)."""

    lambda_loss: float = 1.0
    num_matching_attempts: int = 1000
    num_masked_non_matches_per_match: int = 100
    lamda_d: float = 1.0
    margin_neg: float = 0.2
    cell_size: int = 8


def draw_superpoint_loss(gen: torch.Generator, batch: dict, cfg: SuperPointLossConfig) -> DescriptorDraws:
    """The loss's random numbers (the descriptor loss's) for `batch`."""
    b, h, w, _ = batch["image"].shape
    return local_shard(draw_descriptor_loss(gen, global_count(b), h // cfg.cell_size, w // cfg.cell_size,
                                            cfg.num_matching_attempts, cfg.num_masked_non_matches_per_match))


def superpoint_loss_fn(model, batch: dict, draws: DescriptorDraws, cfg: SuperPointLossConfig = SuperPointLossConfig(),
                       train: bool = True):
    """batch: image, labels_2d, valid_mask, warped_image, warped_labels,
    warped_valid_mask (B, H, W, 1) and homographies (B, 3, 3) image ->
    warped view. Returns (total loss, metrics)."""
    out = model(batch["image"], train=train)
    out_warp = model(batch["warped_image"], train=train)
    loss_det = detector_loss(out["semi"], batch["labels_2d"], batch["valid_mask"], cfg.cell_size)
    loss_det_warp = detector_loss(out_warp["semi"], batch["warped_labels"], batch["warped_valid_mask"], cfg.cell_size)
    loss_desc, pos, neg = sparse_descriptor_loss(draws, out["desc_map"], out_warp["desc_map"], batch["homographies"],
                                                 lamda_d=cfg.lamda_d, margin_neg=cfg.margin_neg,
                                                 cell_size=cfg.cell_size)
    total = loss_det + loss_det_warp + cfg.lambda_loss * loss_desc
    metrics = {"loss": total, "loss_det": loss_det, "loss_det_warp": loss_det_warp, "loss_desc": loss_desc,
               "positive_dist": pos, "negative_dist": neg}
    return total, metrics


def is_finite(loss) -> bool:
    """The guard's one host read-back a step."""
    return bool(torch.isfinite(loss))


def train_on_batch(state: TrainState, batch: dict, draws: DescriptorDraws,
                   cfg: SuperPointLossConfig = SuperPointLossConfig()) -> dict:
    """One update of `state.module` on a training batch with the loss's
    draws. Returns the metrics (device scalars) and `skipped_nonfinite`."""
    model = state.module
    stats = [buf.clone() for buf in model.buffers()]
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = superpoint_loss_fn(model, batch, draws, cfg, train=True)
    loss.backward()
    metrics = all_sum_dict({k: v.detach() for k, v in metrics.items()})
    ok = is_finite(metrics["loss"])
    if ok:
        sync_gradients(model.parameters())
        state.apply_gradients()
    else:
        with torch.no_grad():
            for buf, old in zip(model.buffers(), stats):
                buf.copy_(old)
    metrics["skipped_nonfinite"] = int(not ok)
    return metrics


def make_superpoint_train_step(model, cfg: SuperPointLossConfig = SuperPointLossConfig()):
    """`step(state, batch, gen) -> metrics`: one update of `model`, which
    `state` must hold, with the loss's draws from `gen`."""

    def step(state: TrainState, batch: dict, gen: torch.Generator) -> dict:
        if state.module is not model:
            raise ValueError("train step: the state holds another module than this step's SuperPoint")
        return train_on_batch(state, batch, draw_superpoint_loss(gen, batch, cfg), cfg)

    return step


def make_superpoint_eval_step(model, cfg: SuperPointLossConfig = SuperPointLossConfig()):
    """`step(state, batch, gen) -> metrics`: the loss's metrics in
    inference (running statistics, no grad; the image conv is the fused
    entry conv), with the loss's draws from `gen`."""

    @torch.no_grad()
    def step(state: TrainState, batch: dict, gen: torch.Generator) -> dict:
        if state.module is not model:
            raise ValueError("eval step: the state holds another module than this step's SuperPoint")
        return all_sum_dict(superpoint_loss_fn(model, batch, draw_superpoint_loss(gen, batch, cfg), cfg,
                                               train=False)[1])

    return step
