"""SuperPoint training batches built on the device — the counterpart of
`image_matching_tpu/data/pipeline.py`: from images and their label
points, a warped pair with labels and valid masks.

Per batch: a random homography per image; the image warped by it; the
points warped by it and kept where they land inside; labels of both views
(the points scattered to their pixels, then, with `gaussian_label_sigma`
> 0, blurred by two separable SAME Gaussian convolutions and divided by
each map's maximum; without, the warped view's points are splatted
bilinearly); the warped view's valid mask eroded by
`valid_border_margin`; then an independent photometric augmentation of
each view.

Random numbers come in a `WarpedPairDraws` (`draw_warped_pair`, from a
`torch.Generator`: the homographies, then each view's photometric draws),
which `warped_pair_from_draws` applies.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from image_matching_tpu_torch.data.photometric import (
    PhotometricConfig,
    PhotometricDraws,
    apply_photometric,
    draw_photometric,
)
from image_matching_tpu_torch.geometry.homography import (
    HomographyConfig,
    invert_homography,
    sample_homography_batch,
    warp_points,
)
from image_matching_tpu_torch.geometry.labels import scatter_points, splat_points_bilinear
from image_matching_tpu_torch.geometry.warp import compute_valid_mask, warp_image


class WarpedPairConfig(NamedTuple):
    """The JAX package's defaults (the reference's training config)."""

    homography: HomographyConfig = HomographyConfig(
        scaling_amplitude=0.2,
        perspective_amplitude_x=0.2,
        perspective_amplitude_y=0.2,
        patch_ratio=0.85,
        max_angle=1.57,
        allow_artifacts=True,
    )
    valid_border_margin: int = 3
    photometric: PhotometricConfig = PhotometricConfig()
    gaussian_label_sigma: float = 0.2


class WarpedPairDraws(NamedTuple):
    homographies: torch.Tensor  # (B, 3, 3) image -> warped view
    photometric: Optional[Tuple[PhotometricDraws, PhotometricDraws]]  # (image, warped view), None: no augmentation


def draw_warped_pair(gen: torch.Generator, shape, cfg: WarpedPairConfig = WarpedPairConfig(),
                     augment: bool = True) -> WarpedPairDraws:
    """The random numbers of one batch of `shape` (B, H, W, 1), from `gen`."""
    b, h, w, _ = shape
    hs = sample_homography_batch(gen, b, h, w, cfg.homography)
    photo = None
    if augment and cfg.photometric.enable:
        photo = tuple(draw_photometric(gen, shape, cfg.photometric) for _ in range(2))
    return WarpedPairDraws(hs, photo)


def _labels_from_points(xy, mask, height: int, width: int, sigma: float):
    """Masked points (B, K, 2) -> (B, H, W, 1) labels: the points scattered
    to their pixels, then with sigma > 0 blurred by a Gaussian of radius
    max(1, int(3 sigma + 0.5)) (rows, then columns, zero padded) and
    divided by each map's maximum (floored at 1e-6)."""
    hard = scatter_points(xy, mask, height, width)
    if sigma <= 0:
        return hard[..., None]
    radius = max(1, int(3 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=xy.device)
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    m = F.conv2d(hard[:, None], g[None, None, :, None], padding=(radius, 0))
    m = F.conv2d(m, g[None, None, None, :], padding=(0, radius))[:, 0]
    return (m / m.amax(dim=(1, 2), keepdim=True).clamp_min(1e-6))[..., None]


def warped_pair_from_draws(draws: WarpedPairDraws, images, points, points_mask,
                           cfg: WarpedPairConfig = WarpedPairConfig()) -> dict:
    """images (B, H, W, 1) f32 in [0, 1]; points (B, K, 2) label points
    (x, y); points_mask (B, K). Returns the training batch: image,
    labels_2d, valid_mask, warped_image, warped_labels, warped_valid_mask
    (each (B, H, W, 1)) and homographies (B, 3, 3) image -> warped view."""
    b, h, w, _ = images.shape
    hs = draws.homographies
    h_inv = invert_homography(hs)
    warped = warp_image(images, h_inv)
    wxy = warp_points(points, hs)
    in_bounds = (wxy[..., 0] >= 0) & (wxy[..., 0] <= w - 1) & (wxy[..., 1] >= 0) & (wxy[..., 1] <= h - 1)
    wmask = points_mask & in_bounds
    sigma = cfg.gaussian_label_sigma
    if sigma > 0:
        warped_labels = _labels_from_points(wxy, wmask, h, w, sigma)
    else:
        warped_labels = splat_points_bilinear(wxy, wmask, h, w)[..., None]
    if draws.photometric is not None:
        image_out = apply_photometric(images, draws.photometric[0], cfg.photometric)
        warped_out = apply_photometric(warped, draws.photometric[1], cfg.photometric)
    else:
        image_out, warped_out = images, warped
    return {
        "image": image_out,
        "labels_2d": _labels_from_points(points, points_mask, h, w, sigma),
        "valid_mask": torch.ones_like(images),
        "warped_image": warped_out,
        "warped_labels": warped_labels,
        "warped_valid_mask": compute_valid_mask(h_inv, h, w, cfg.valid_border_margin)[..., None],
        "homographies": hs,
    }


def make_warped_pair_batch(gen: torch.Generator, images, points, points_mask,
                           cfg: WarpedPairConfig = WarpedPairConfig(), augment: bool = True) -> dict:
    """`warped_pair_from_draws` on draws from `gen`; `augment=False` (or a
    disabled photometric config) skips the photometric augmentation."""
    return warped_pair_from_draws(draw_warped_pair(gen, images.shape, cfg, augment), images, points, points_mask, cfg)
