"""Homographic-adaptation pseudo-label export — the counterpart of
`image_matching_tpu/export.py`: for each image, the detector runs on
`num_homographies` random warps of it (warp 0 is the identity), the
heatmaps are warped back, masked and averaged, then NMS, top-k and an
optional soft-argmax subpixel refinement give its pseudo-label keypoints.

The views of a batch (B images x N warps) go through the model in chunks
of at most `VIEW_PIXELS_PER_CALL` pixels a call: the image entry conv's
32-bit limit, or 400 views at 240x320 if that is less (the cycle's batch 8
and 50 warps, which stays one call; 480x640 takes 4 calls of 100 views).
The chunks' heatmaps are joined in view order before the sum, so the sum
is the unchunked one. The homographies are drawn from a `torch.Generator`
by `draw_export_homographies` and applied by
`homographic_adaptation_heatmap` / `export_pseudo_labels`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from image_matching_tpu_torch.geometry.homography import HomographyConfig, invert_homography, sample_homography_batch
from image_matching_tpu_torch.geometry.labels import combine_heatmaps, flatten_detection
from image_matching_tpu_torch.geometry.warp import compute_valid_mask, warp_image
from image_matching_tpu_torch.ops.detect import detect_keypoints
from image_matching_tpu_torch.ops.entry_conv import MAX_PIXELS
from image_matching_tpu_torch.ops.sampling import refine_keypoints_subpixel
from image_matching_tpu_torch.structs import Keypoints


# pixels a model call: under the entry conv's limit, at most 400 views at 240x320
VIEW_PIXELS_PER_CALL = min(MAX_PIXELS - 1, 400 * 240 * 320)


class ExportConfig(NamedTuple):
    """The JAX package's defaults (the reference's export config)."""

    num_homographies: int = 50
    top_k: int = 1200
    detection_threshold: float = 0.015
    nms_radius: int = 4
    subpixel: bool = True
    subpixel_patch: int = 5
    filter_counts: int = 0  # suppress pixels seen by fewer warped views than this (0: off)
    homography: HomographyConfig = HomographyConfig(
        scaling_amplitude=0.2,
        perspective_amplitude_x=0.2,
        perspective_amplitude_y=0.2,
        patch_ratio=0.85,
        allow_artifacts=True,
    )


def draw_export_homographies(gen: torch.Generator, batch: int, height: int, width: int,
                             cfg: ExportConfig = ExportConfig()):
    """(batch, num_homographies, 3, 3) sampling homographies from `gen`,
    the first of each image the identity."""
    hs = sample_homography_batch(gen, batch * cfg.num_homographies, height, width, cfg.homography)
    hs = hs.reshape(batch, cfg.num_homographies, 3, 3)
    hs[:, 0] = torch.eye(3, device=hs.device)
    return hs


def homographic_adaptation_heatmap(hs, apply_fn: Callable, images, cfg: ExportConfig = ExportConfig()):
    """images (B, H, W, 1), hs (B, N, 3, 3) image -> view; `apply_fn`: views
    (V, H, W, 1) -> semi logits (V, Hc, Wc, 65), called on consecutive
    chunks of the B*N views (`VIEW_PIXELS_PER_CALL`). Returns the aggregated
    f32 heatmaps (B, H, W, 1)."""
    b, h, w, c = images.shape
    n = hs.shape[1]
    h_inv = invert_homography(hs.reshape(b * n, 3, 3))
    chunk = max(1, VIEW_PIXELS_PER_CALL // (h * w))
    heats = []
    for start in range(0, b * n, chunk):
        view = torch.arange(start, min(start + chunk, b * n), device=images.device)
        heats.append(flatten_detection(apply_fn(warp_image(images[view // n], h_inv[view])), dtype=torch.float32))
    heat = torch.cat(heats)
    masks = compute_valid_mask(h_inv, h, w)[..., None]
    agg = combine_heatmaps(heat.reshape(b, n, h, w, 1), hs, masks.reshape(b, n, h, w, 1))
    if cfg.filter_counts > 0:
        counts = warp_image(masks, hs.reshape(b * n, 3, 3), mode="nearest").reshape(b, n, h, w, 1).sum(dim=1)
        agg = torch.where(counts >= cfg.filter_counts, agg, 0.0)
    return agg


def export_pseudo_labels(hs, apply_fn: Callable, images, cfg: ExportConfig = ExportConfig()) -> Keypoints:
    """Images (B, H, W, 1) and their homographies (B, N, 3, 3) ->
    pseudo-label Keypoints (B, top_k): xy, score, mask."""
    heat = homographic_adaptation_heatmap(hs, apply_fn, images, cfg)
    kpts = detect_keypoints(heat, max_keypoints=cfg.top_k, threshold=cfg.detection_threshold,
                            nms_radius=cfg.nms_radius)
    if cfg.subpixel:
        xy = refine_keypoints_subpixel(heat[..., 0], kpts.xy, cfg.subpixel_patch)
        kpts = kpts.replace(xy=torch.where(kpts.mask[..., None], xy, kpts.xy))
    return kpts


def make_export_fn(model, cfg: ExportConfig = ExportConfig()):
    """`export(gen, images) -> Keypoints` with a SuperPoint model in
    inference (no grad) and homographies drawn from `gen`."""

    @torch.no_grad()
    def export(gen: torch.Generator, images) -> Keypoints:
        b, h, w, _ = images.shape
        hs = draw_export_homographies(gen, b, h, w, cfg)
        return export_pseudo_labels(hs, lambda views: model(views)["semi"], images, cfg)

    return export
