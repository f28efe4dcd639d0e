"""Registration evaluation on pairs with exact ground truth — the
counterpart of `image_matching_tpu/evaluation.py`: the pair makers
(`photo_texture`, `photometric_asymmetry`, `make_eval_pairs`),
`corner_error`, `evaluate_pipeline` and the sequence maker
`make_synthetic_sequence`.

Metrics per pipeline: success rate (fit valid and mean corner error
below a threshold), mean / median corner error (px) of the estimated
against the ground-truth transform, matches and inliers per pair.

Everything here is numpy (no OpenCV): the makers call `imgproc`, which
follows OpenCV's routines, and draw the same random numbers in the same
order as the JAX package's makers, so a seed gives the same ground truth
and the same images.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

from image_matching_tpu_torch import imgproc


class EvalPair(NamedTuple):
    template: np.ndarray  # (H, W, 1) float32
    source: np.ndarray  # (H, W, 1)
    gt_matrix: np.ndarray  # (2, 3) similarity or (3, 3) homography, template -> source


def photo_texture(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """Photographic-texture image: multi-octave value noise, occluding
    structure (shaded rectangles, bars, disks) and an illumination
    gradient, blurred and normalised to [0, 1]; (H, W) float32."""
    img = np.zeros((height, width), np.float32)
    amp, total = 1.0, 0.0
    for cell in (64, 32, 16, 8, 4):
        g = rng.uniform(0, 1, (height // cell + 2, width // cell + 2))
        img += amp * imgproc.resize(g.astype(np.float32), (width, height))
        total += amp
        amp *= 0.55
    img /= total

    for _ in range(int(rng.integers(6, 14))):
        kind = rng.integers(0, 3)
        shade = float(rng.uniform(0.05, 0.95))
        alpha = float(rng.uniform(0.5, 1.0))
        overlay = img.copy()
        if kind == 0:
            x0, y0 = rng.uniform([0, 0], [width - 20, height - 20])
            wid, hei = rng.uniform(12, width / 3), rng.uniform(12, height / 3)
            pts = np.array([[x0, y0], [x0 + wid, y0], [x0 + wid, y0 + hei], [x0, y0 + hei]], np.float32)
            ang = rng.uniform(0, np.pi)
            c, s = np.cos(ang), np.sin(ang)
            ctr = pts.mean(0)
            pts = (pts - ctr) @ np.array([[c, -s], [s, c]], np.float32).T + ctr
            imgproc.fill_poly(overlay, pts.astype(np.int32), shade)
        elif kind == 1:
            p0 = rng.uniform([0, 0], [width, height])
            p1 = rng.uniform([0, 0], [width, height])
            imgproc.line(overlay, tuple(p0.astype(int)), tuple(p1.astype(int)), shade, int(rng.integers(1, 4)))
        else:
            c0 = rng.uniform([16, 16], [width - 16, height - 16])
            imgproc.circle(overlay, (int(c0[0]), int(c0[1])), int(rng.uniform(4, 24)), shade)
        img = (1 - alpha) * img + alpha * overlay

    yy, xx = np.meshgrid(np.linspace(-1, 1, height), np.linspace(-1, 1, width), indexing="ij")
    gx, gy = rng.uniform(-0.25, 0.25, 2)
    img = img * (1.0 + gx * xx + gy * yy)
    img = imgproc.gaussian_blur(img.astype(np.float32), 0.8)
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return img.astype(np.float32)


def photometric_asymmetry(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """A photometric domain gap for one side of a pair: contrast and
    brightness, an additive elliptical shade, gaussian sensor noise."""
    h, w = img.shape[:2]
    out = img.astype(np.float32).copy()
    c = rng.uniform(0.6, 1.4)
    b = rng.uniform(-50.0 / 255.0, 50.0 / 255.0)
    mean = out.mean()
    out = (out - mean) * c + mean + b
    cx, cy = rng.uniform(0, w), rng.uniform(0, h)
    ax_, ay_ = rng.uniform(0.15 * w, 0.5 * w), rng.uniform(0.15 * h, 0.5 * h)
    ang = rng.uniform(0, np.pi)
    transparency = rng.uniform(-0.5, 0.5)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    ca, sa = np.cos(ang), np.sin(ang)
    xr = (xs - cx) * ca + (ys - cy) * sa
    yr = -(xs - cx) * sa + (ys - cy) * ca
    mask = ((xr / ax_) ** 2 + (yr / ay_) ** 2 <= 1.0).astype(np.float32)
    mask = imgproc.gaussian_blur(mask, max(h, w) / 24.0)
    if out.ndim == 3:
        mask = mask[..., None]
    out = out * (1.0 + transparency * mask)
    std = rng.uniform(0.0, 8.0 / 255.0)
    out = out + rng.normal(0.0, std, out.shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def make_eval_pairs(
    rng: np.random.Generator,
    n_pairs: int,
    height: int = 240,
    width: int = 320,
    max_angle: float = 0.25,
    scale_range=(0.9, 1.1),
    max_shift: float = 24.0,
    texture: str = "blobs",  # "blobs" | "photo" | "noise"
    gt_model: str = "similarity",  # "similarity" | "perspective"
    max_perspective: float = 0.0,  # corner jitter (px) when gt_model="perspective"
    photo_asym: bool = False,
) -> List[EvalPair]:
    """Synthetic pairs with exact ground truth: a textured template and its
    warp by a random similarity (composed, for `gt_model="perspective"`,
    with a random 4-corner jitter of up to `max_perspective` px); with
    `photo_asym`, `photometric_asymmetry` on the source only."""
    pairs = []
    for _ in range(n_pairs):
        if texture == "blobs":
            img = rng.uniform(0, 0.35, (height, width)).astype(np.float32)
            img = imgproc.gaussian_blur(img, 1.5)
            for _ in range(60):
                c = rng.uniform([12, 12], [width - 12, height - 12])
                imgproc.circle(img, (int(c[0]), int(c[1])), int(rng.uniform(2, 7)), float(rng.uniform(0.4, 1.0)))
        elif texture == "photo":
            img = photo_texture(rng, height, width)
        else:
            img = rng.uniform(0, 1, (height, width)).astype(np.float32)
            img = imgproc.gaussian_blur(img, 2.0)
            img = (img - img.min()) / (img.max() - img.min() + 1e-9)
        img = imgproc.gaussian_blur(img, 1.0)

        ang = rng.uniform(-max_angle, max_angle)
        sc = rng.uniform(*scale_range)
        tx, ty = rng.uniform(-max_shift, max_shift, 2)
        c, s = np.cos(ang) * sc, np.sin(ang) * sc
        cx, cy = width / 2, height / 2
        mat = np.float32([[c, -s, tx + cx - c * cx + s * cy], [s, c, ty + cy - s * cx - c * cy]])
        if gt_model == "perspective":
            corners = np.float32([[0, 0], [width - 1, 0], [width - 1, height - 1], [0, height - 1]])
            dst = corners @ mat[:, :2].T + mat[:, 2]
            dst = dst + rng.uniform(-max_perspective, max_perspective, (4, 2)).astype(np.float32)
            hom = imgproc.get_perspective_transform(corners, dst)
            src = imgproc.warp_perspective(img, hom, (width, height))
            gt = hom.astype(np.float32)
        else:
            src = imgproc.warp_affine(img, mat, (width, height))
            gt = mat
        if photo_asym:
            src = photometric_asymmetry(rng, src)
        pairs.append(EvalPair(img[..., None], src[..., None], gt))
    return pairs


def _apply(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    if m.shape == (3, 3):
        hom = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ m.T
        return hom[:, :2] / hom[:, 2:3]
    return pts @ m[:, :2].T + m[:, 2]


def corner_error(est: np.ndarray, gt: np.ndarray, height: int, width: int) -> float:
    """Mean distance between the four image corners mapped by est and by
    gt. Either may be a (2, 3) affine or a (3, 3) homography."""
    corners = np.array([[0, 0], [width - 1, 0], [0, height - 1], [width - 1, height - 1]], np.float64)
    return float(np.mean(np.linalg.norm(_apply(est, corners) - _apply(gt, corners), axis=-1)))


def evaluate_pipeline(
    register_fn: Callable,  # (template, source, gen) -> RegistrationResult, batched (1, H, W, 1) tensors
    pairs: List[EvalPair],
    gen: torch.Generator,
    success_px: float = 5.0,
    per_pair: bool = False,
) -> Dict:
    """Run a registration function over eval pairs, one pair per call, and
    aggregate the metrics. The images are put on the generator's device.
    Each pair's small results come to the host in one transfer."""
    device = gen.device
    errors, matches, inliers, valids = [], [], [], []
    h, w = pairs[0].template.shape[:2]
    for p in pairs:
        res = register_fn(torch.from_numpy(p.template)[None].to(device),
                          torch.from_numpy(p.source)[None].to(device), gen)
        fit = res.fit
        summary = torch.cat([fit.valid[0].reshape(1).double(), fit.matrix[0].reshape(-1).double(),
                             res.matches.num_matches()[0].reshape(1).double(),
                             fit.num_inliers[0].reshape(1).double()]).cpu().numpy()
        fit_valid = bool(summary[0])
        mat = summary[1:-2].reshape(tuple(fit.matrix.shape[-2:]))
        errors.append(corner_error(mat, p.gt_matrix, h, w) if fit_valid else np.inf)
        matches.append(int(summary[-2]))
        inliers.append(int(summary[-1]))
        valids.append(fit_valid)

    errors = np.asarray(errors)
    ok = errors < success_px
    extra = {}
    if per_pair:
        extra["per_pair"] = [
            {"corner_err_px": float(e) if np.isfinite(e) else None, "matches": m, "inliers": i, "fit_valid": v}
            for e, m, i, v in zip(errors, matches, inliers, valids)
        ]
    finite = np.isfinite(errors)
    return {
        **extra,
        "n_pairs": len(pairs),
        "success_rate": float(np.mean(ok)),
        "mean_corner_err_px": float(np.mean(errors[ok])) if ok.any() else None,
        "median_corner_err_px": float(np.median(errors[finite])) if finite.any() else None,
        "mean_matches": float(np.mean(matches)),
        "mean_inliers": float(np.mean(inliers)),
        "fit_valid_rate": float(np.mean(valids)),
    }


def make_synthetic_sequence(rng: np.random.Generator, n_frames: int = 8, h: int = 160, w: int = 160):
    """A drifting-camera synthetic video over a fixed textured world, as
    the JAX package's maker draws it. Returns (frames, gt): frames are (H,
    W, 1) float32 arrays; gt[i] the world-from-frame similarity params (a,
    b, tx, ty) of frame i."""
    # smoothed noise: distinctive texture everywhere (uniform blobs are
    # self-similar and die in the ratio test)
    world = rng.uniform(0, 1, (h * 2, w * 2)).astype(np.float32)
    world = imgproc.gaussian_blur(world, 2.0)
    world = (world - world.min()) / (world.max() - world.min() + 1e-9)

    frames, gt = [], []
    x, y, ang = w // 2, h // 2, 0.0
    for _ in range(n_frames):
        c, s = np.cos(ang), np.sin(ang)
        # world <- frame: rotate by ang, then translate by (x, y)
        m = np.float32([[c, -s, x], [s, c, y]])
        gt.append(np.array([c, s, x, y], np.float32))
        frame = imgproc.warp_affine(world, imgproc.invert_affine_transform(m), (w, h))
        frames.append(frame[..., None])
        x += rng.uniform(2, 10)
        y += rng.uniform(-4, 6)
        ang += rng.uniform(-0.05, 0.05)
    return frames, np.stack(gt)
