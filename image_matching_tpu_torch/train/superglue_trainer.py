"""SuperGlue training step with pair generation on the device — the
counterpart of `image_matching_tpu/train/superglue_trainer.py`:

  sample homographies -> warp the images -> (optionally) an independent
  photometric corruption of each view -> frozen SuperPoint on both views
  (no grad; optionally subpixel-refined) -> ground-truth assignment by
  mutual nearest neighbour of the warped keypoints (< 3 px) ->
  SuperGlue(train=True) -> NLL -> Adam update of SuperGlue, skipped when
  the loss is not finite.

Both views are detected in one 2B-batched SuperPoint call (the JAX
package makes two calls; the detector is per image, so the keypoints are
the same). Random numbers come from a `torch.Generator`: the homographies,
then each view's photometric draws.

Under a data mesh (`parallel.use_mesh`), a step on a rank's shard of the
global batch is that shard's part of the global step: the draws are made
for the global batch and sliced, the loss's count, the batch norms'
statistics and the metrics' counts are global, the gradients are summed
over the ranks, and the guard reads the global loss, so every rank
applies or skips the same update.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from image_matching_tpu_torch.data.photometric import PhotometricConfig, apply_photometric, draw_photometric
from image_matching_tpu_torch.geometry.homography import (
    HomographyConfig,
    invert_homography,
    sample_homography_batch,
    warp_points,
)
from image_matching_tpu_torch.geometry.warp import warp_image
from image_matching_tpu_torch.losses.superglue_loss import make_gt_matches, superglue_nll_loss
from image_matching_tpu_torch.models.superpoint import superpoint_postprocess
from image_matching_tpu_torch.parallel.mesh import all_sum_dict, global_count, local_shard, sync_gradients
from image_matching_tpu_torch.train.metrics import matching_precision_recall
from image_matching_tpu_torch.train.state import TrainState


class SuperGluePairConfig(NamedTuple):
    max_keypoints: int = 512
    keypoint_threshold: float = 0.005
    nms_radius: int = 4
    subpixel: bool = False  # refine the keypoints as the evaluation's postprocess does
    gt_dist_thresh: float = 3.0
    homography: HomographyConfig = HomographyConfig(patch_ratio=0.85, allow_artifacts=True)
    # an independent photometric corruption of each view, after the warp:
    # detection and description see the gap, the ground truth stays geometric
    photometric: PhotometricConfig = PhotometricConfig(enable=False)


def generate_pair_from_homographies(hs, superpoint, images, cfg: SuperGluePairConfig, draws=None):
    """images (B, H, W, 1), hs (B, 3, 3) image -> warped view ->
    (kpts0, kpts1, gt0, gt1, warped). With `cfg.photometric.enable`,
    `draws` holds the two views' `PhotometricDraws` (images, warped)."""
    b = images.shape[0]
    warped = warp_image(images, invert_homography(hs))
    if cfg.photometric.enable:
        if draws is None:
            raise ValueError("photometric pair generation needs each view's PhotometricDraws")
        images = apply_photometric(images, draws[0], cfg.photometric)
        warped = apply_photometric(warped, draws[1], cfg.photometric)
    with torch.no_grad():
        kp = superpoint_postprocess(superpoint(torch.cat([images, warped], 0)),
                                    max_keypoints=cfg.max_keypoints, threshold=cfg.keypoint_threshold,
                                    nms_radius=cfg.nms_radius, subpixel=cfg.subpixel)
    kp0, kp1 = kp.select(slice(None, b)), kp.select(slice(b, None))
    gt0, gt1 = make_gt_matches(warp_points(kp0.xy, hs), kp1.xy, kp0.mask, kp1.mask, cfg.gt_dist_thresh)
    return kp0, kp1, gt0, gt1, warped


def generate_pair(gen: torch.Generator, superpoint, images, cfg: SuperGluePairConfig):
    """Sample B homographies (and, with photometric corruption, each view's
    draws) from `gen` (on the images' device) and generate the pair."""
    b, h, w, c = images.shape
    n = global_count(b)  # draws for the global batch, then this rank's slice
    hs = local_shard(sample_homography_batch(gen, n, h, w, cfg.homography))
    draws = None
    if cfg.photometric.enable:
        draws = tuple(local_shard(draw_photometric(gen, (n, h, w, c), cfg.photometric)) for _ in range(2))
    return generate_pair_from_homographies(hs, superpoint, images, cfg, draws)


def train_on_pair(state: TrainState, kp0, kp1, gt0, gt1, image_shape) -> dict:
    """One SuperGlue update on a generated pair. The loss is read on the
    host (one sync per step) to decide the non-finite guard: when it is
    not finite, the update is skipped and the batch statistics the
    forward moved are restored."""
    sg = state.module
    stats = [buf.clone() for buf in sg.buffers()]
    state.optimizer.zero_grad(set_to_none=True)
    out = sg(kp0, kp1, image_shape, image_shape, train=True)
    loss = superglue_nll_loss(out["log_coupling"], gt0, gt1, kp0.mask, kp1.mask)
    loss.backward()
    n1 = kp1.mask.shape[-1]
    metrics = all_sum_dict({"loss": loss.detach(), "gt_matches": (gt0 < n1).sum(),
                            "pred_matches": (out["matches0"] >= 0).sum()})
    ok = bool(torch.isfinite(metrics["loss"]))
    if ok:
        sync_gradients(sg.parameters())
        state.apply_gradients()
    else:
        with torch.no_grad():
            for buf, old in zip(sg.buffers(), stats):
                buf.copy_(old)
    metrics.update(matching_precision_recall(out["matches0"], gt0, kp0.mask, n1))
    metrics["skipped_nonfinite"] = int(not ok)
    return metrics


def make_superglue_train_step(superglue, superpoint, cfg: SuperGluePairConfig = SuperGluePairConfig()):
    """`step(state, images, gen) -> metrics`: generate a pair from the
    (B, H, W, 1) images with homographies drawn from `gen`, then one
    update of `superglue`, which `state` must hold. SuperPoint stays
    frozen."""

    def step(state: TrainState, images, gen: torch.Generator) -> dict:
        if state.module is not superglue:
            raise ValueError("train step: the state holds another module than this step's SuperGlue")
        kp0, kp1, gt0, gt1, _ = generate_pair(gen, superpoint, images, cfg)
        return train_on_pair(state, kp0, kp1, gt0, gt1, tuple(images.shape[1:3]))

    return step
