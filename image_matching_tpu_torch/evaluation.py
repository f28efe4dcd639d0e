"""Registration evaluation on pairs with exact ground truth — the
counterpart of `image_matching_tpu/evaluation.py:211-306`
(`corner_error`, `evaluate_pipeline`).

Metrics per pipeline: success rate (fit valid and mean corner error
below a threshold), mean / median corner error (px) of the estimated
against the ground-truth transform, matches and inliers per pair.

`corner_error` is plain numpy (no OpenCV). The JAX package's OpenCV pair
makers (`photo_texture`, `make_eval_pairs`, ...) are not ported
(`ROADMAP.md`, Queue A): callers bring their own `EvalPair`s.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch


class EvalPair(NamedTuple):
    template: np.ndarray  # (H, W, 1) float32
    source: np.ndarray  # (H, W, 1)
    gt_matrix: np.ndarray  # (2, 3) similarity or (3, 3) homography, template -> source


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
