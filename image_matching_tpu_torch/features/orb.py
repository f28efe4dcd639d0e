"""FAST + rotated BRIEF (ORB-style) detector and binary descriptor — the
counterpart of `image_matching_tpu/features/orb.py`, batched over images.

The FAST ring test is 16 rolled comparisons over whole maps, and the
longest circular run a 32-step loop over them; orientation is the
intensity centroid; BRIEF is 256 pairwise intensity tests at rotated
offsets, packed MSB first into 32 uint8 bytes for
`ops/matching.match_hamming`. An 8-level pyramid of 1.2x antialiased
linear downscales (`ops/resize.resize_linear`) carries geometric
per-level quotas.

The test pattern is the JAX package's: its default draw from JAX's PRNG
is committed as a table (`features/_brief_table.py`), so a config with
another `pattern_seed` or `n_tests` is refused. The per-level top-k keeps
`lax.top_k`'s order among equal FAST scores (`ops/topk.py`), and the
FAST score is summed over the ring in ring order, so level 0's score map
and its top-k are the JAX package's bit for bit on the CPU.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from image_matching_tpu_torch.features import _brief_table
from image_matching_tpu_torch.features.sift import _as_batch, separable_filter
from image_matching_tpu_torch.geometry.warp import nearest_sample
from image_matching_tpu_torch.ops.nms import simple_nms
from image_matching_tpu_torch.ops.resize import resize_linear
from image_matching_tpu_torch.ops.sampling import bilinear_sample
from image_matching_tpu_torch.ops.topk import topk_lower_index_first
from image_matching_tpu_torch.structs import Keypoints

# Bresenham circle of radius 3: the FAST-9/16 ring, clockwise from 12 o'clock, as (dx, dy)
_RING = [
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
]


class ORBConfig(NamedTuple):
    max_keypoints: int = 512
    fast_threshold: float = 20.0 / 255.0
    fast_arc: int = 9  # contiguous ring pixels required
    nms_radius: int = 3
    n_tests: int = 256  # BRIEF bits (32 bytes)
    patch_radius: int = 15
    pattern_seed: int = 7
    blur_sigma: float = 1.2
    n_levels: int = 8  # scale pyramid depth (cv2.ORB_create default)
    scale_factor: float = 1.2


def _ring_stack(img):
    """(16, B, H, W): the ring pixel at each offset, by wrapping rolls."""
    return torch.stack([torch.roll(torch.roll(img, -dy, 1), -dx, 2) for dx, dy in _RING])


def _max_run(mask):
    """Longest circular run of True along axis 0 (16 entries) of a bool
    (16, ...) stack, as the JAX package's scan over the doubled ring."""
    run = torch.zeros(mask.shape[1:], dtype=torch.int32, device=mask.device)
    best = run
    m = mask.to(torch.int32)
    for i in range(2 * mask.shape[0]):
        run = (run + 1) * m[i % mask.shape[0]]
        best = torch.maximum(best, run)
    return best


def fast_score(img, cfg: ORBConfig):
    """FAST-N corner score map (B, H, W) of images (B, H, W): the sum of
    absolute ring differences past the threshold, 0 where no arc of
    `fast_arc` brighter or darker ring pixels exists. The sum runs in ring
    order, as XLA's reduction does."""
    ring = _ring_stack(img)
    center = img[None]
    brighter = ring > center + cfg.fast_threshold
    darker = ring < center - cfg.fast_threshold
    is_corner = (_max_run(brighter) >= cfg.fast_arc) | (_max_run(darker) >= cfg.fast_arc)
    # OpenCV's sumAbsDiff variant
    diff = torch.where(brighter | darker, (ring - center).abs(), 0.0)
    score = torch.zeros_like(img)
    for i in range(diff.shape[0]):
        score = score + diff[i]
    return torch.where(is_corner, score, 0.0)


def _orientation_centroid(img, xy, radius: int):
    """Intensity-centroid orientation (Rosin moment) theta = atan2(m01,
    m10) over a disk; img (B, H, W), xy (B, K, 2) -> (B, K)."""
    steps = torch.arange(-radius, radius + 1, device=img.device)
    dy, dx = torch.meshgrid(steps, steps, indexing="ij")
    w = (dx * dx + dy * dy <= radius * radius).float().reshape(-1)
    offs = torch.stack([dx, dy], -1).reshape(-1, 2).float()
    b, k = xy.shape[:2]
    coords = (xy[:, :, None, :] + offs).reshape(b, -1, 2)
    vals = bilinear_sample(img[..., None], coords)[..., 0].reshape(b, k, -1) * w
    m10 = (vals * offs[:, 0]).sum(-1)
    m01 = (vals * offs[:, 1]).sum(-1)
    return torch.atan2(m01, m10)


@functools.lru_cache(maxsize=8)
@torch.inference_mode(False)  # a plain tensor, whether first asked for inside inference mode or not
def brief_pattern(cfg: ORBConfig, device) -> torch.Tensor:
    """(n_tests, 2, 2) gaussian test-point pairs on `device`: the committed
    unit normals scaled by patch_radius / 2 and clipped to the patch, as
    the JAX package's `_brief_pattern`. Built and uploaded once a config
    and device; another `pattern_seed` or `n_tests` raises."""
    if cfg.pattern_seed != _brief_table.SEED or cfg.n_tests != _brief_table.N_TESTS:
        raise ValueError(f"the port holds the BRIEF pattern of pattern_seed={_brief_table.SEED} and "
                         f"n_tests={_brief_table.N_TESTS} only (the JAX package draws it from JAX's PRNG); "
                         f"got pattern_seed={cfg.pattern_seed}, n_tests={cfg.n_tests}")
    pts = torch.from_numpy(_brief_table.unit_normals()) * (cfg.patch_radius / 2.0)
    return pts.clamp(-cfg.patch_radius, cfg.patch_radius).to(device)


def _blur7(img, sigma: float):
    """7-tap gaussian of (B, H, W), zero padding, columns then rows."""
    g = torch.exp(-0.5 * (torch.arange(-3, 4, dtype=torch.float32) / sigma) ** 2)
    return separable_filter(img, g / g.sum())


def _detect_level(image, k_level: int, cfg: ORBConfig, pattern) -> Keypoints:
    """FAST + oriented BRIEF on one pyramid level: images (B, H, W) at this
    level's resolution; keeps the `k_level` best corners (level coords);
    `pattern` is `brief_pattern(cfg, image.device)`."""
    b, h, w = image.shape
    score = simple_nms(fast_score(image, cfg), cfg.nms_radius)
    bd = cfg.patch_radius + 1
    ys = torch.arange(h, device=image.device)[:, None]
    xs = torch.arange(w, device=image.device)[None, :]
    score = torch.where((ys >= bd) & (ys < h - bd) & (xs >= bd) & (xs < w - bd), score, 0.0)

    top, idx = topk_lower_index_first(score.reshape(b, -1), k_level)
    xy = torch.stack([(idx % w).float(), (idx // w).float()], -1)
    mask = top > 0

    sm = _blur7(image, cfg.blur_sigma)  # the BRIEF tests compare a smoothed image
    theta = _orientation_centroid(sm, xy, cfg.patch_radius // 2)
    ct, st = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
    px, py = pattern[..., 0], pattern[..., 1]  # (T, 2)
    rp = torch.stack([px * ct + py * (-st), px * st + py * ct], -1)  # (B, K, T, 2, 2)
    coords = xy[:, :, None, None, :] + rp
    vals = nearest_sample(sm[..., None], coords.reshape(b, -1, 2))[..., 0].reshape(coords.shape[:-1])
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int32)  # (B, K, T)

    # 8 bits a byte, MSB first (as ops/matching._unpack_pm1 reads them)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=image.device)
    packed = (bits.reshape(b, -1, cfg.n_tests // 8, 8) << shifts).sum(-1).to(torch.uint8)
    return Keypoints(xy=xy, score=torch.where(mask, top, 0.0), mask=mask, desc=packed)


def _level_quotas(cfg: ORBConfig, n_levels: int) -> list:
    """cv2-style geometric per-level budget summing to max_keypoints
    (ORB.cpp distributes nfeatures in proportion to level area)."""
    f = 1.0 / cfg.scale_factor
    w = [f ** i for i in range(n_levels)]
    s = sum(w)
    q = [int(cfg.max_keypoints * wi / s) for wi in w]
    q[0] += cfg.max_keypoints - sum(q)
    return q


def orb_detect_and_describe(image, cfg: ORBConfig = ORBConfig()) -> Keypoints:
    """Images (B, H, W, 1) or (B, H, W) grayscale in [0, 1] -> Keypoints
    with xy (B, K, 2) full-resolution pixels and packed uint8 descriptors
    (B, K, n_tests / 8), K = `max_keypoints`, level by level. Detects over
    an up-to-`n_levels` pyramid (downscale by `scale_factor`, cv2.ORB_create's
    8 x 1.2), a level only while its smaller side keeps 2 (patch_radius + 1)
    + 8 pixels. Each image of the batch gets what the JAX package's
    function gives it alone."""
    image = _as_batch(image)
    pattern = brief_pattern(cfg, image.device)  # refuses another pattern before any work
    h, w = image.shape[1:]
    min_side = 2 * (cfg.patch_radius + 1) + 8
    n_run = 1
    while n_run < cfg.n_levels and min(h, w) / cfg.scale_factor ** n_run >= min_side:
        n_run += 1
    parts = []
    for level, k_level in enumerate(_level_quotas(cfg, n_run)):
        scale = cfg.scale_factor ** level
        img_l = image if level == 0 else resize_linear(image, (int(round(h / scale)), int(round(w / scale))))
        kp = _detect_level(img_l, k_level, cfg, pattern)
        parts.append(kp.replace(xy=kp.xy * scale))
    return Keypoints(xy=torch.cat([p.xy for p in parts], 1), score=torch.cat([p.score for p in parts], 1),
                     mask=torch.cat([p.mask for p in parts], 1), desc=torch.cat([p.desc for p in parts], 1))
