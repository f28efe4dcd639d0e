"""End-to-end registration — the counterpart of
`image_matching_tpu/registration.py`: an image pair goes in, and the
keypoints, the matches, the robust similarity or homography and
(optionally) image 0 warped into image 1's frame come out, all on the
device the model lives on.

  * SuperPoint + ratio-KNN + RANSAC   (`matcher="ratio"`)
  * SuperPoint + SuperGlue + RANSAC   (`matcher="superglue"`)

Each side is detected on its own (`Matching.detect`), as in the JAX
package. Sampling draws from a `torch.Generator` where the JAX package
takes a PRNG key.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from image_matching_tpu_torch.geometry.homography import invert_homography, warp_points
from image_matching_tpu_torch.geometry.warp import warp_image
from image_matching_tpu_torch.models.matching import Matching
from image_matching_tpu_torch.models.superglue import match_result_from_outputs
from image_matching_tpu_torch.ops.matching import (
    gather_matched_points,
    match_ratio_mutual,
    ratio_gate_matches,
)
from image_matching_tpu_torch.ops.ransac import (
    ransac_homography_from_indices,
    ransac_similarity_from_indices,
    sample_indices,
)
from image_matching_tpu_torch.structs import Keypoints, MatchResult, RobustFit


@dataclasses.dataclass(frozen=True)
class RegistrationResult:
    kpts0: Keypoints
    kpts1: Keypoints
    matches: MatchResult
    fit: RobustFit
    warped: Optional[torch.Tensor] = None  # image0 warped into image1's frame


def affine_to_homography(mat23):
    last = torch.tensor([[0.0, 0.0, 1.0]], dtype=mat23.dtype, device=mat23.device)
    return torch.cat([mat23, last.expand(*mat23.shape[:-2], 1, 3)], dim=-2)


def rescale_transform(mat, scale: float):
    """A transform estimated on images resized by `scale` -> the
    full-resolution transform, T_full = S^-1 T S with S = diag(s, s, 1)
    (for a (2, 3) matrix that only divides the translation column)."""
    if tuple(mat.shape[-2:]) == (2, 3):
        return torch.cat([mat[..., :2], mat[..., 2:] / scale], dim=-1)
    s = torch.tensor([[scale, 0, 0], [0, scale, 0], [0, 0, 1.0]], dtype=mat.dtype, device=mat.device)
    s_inv = torch.tensor([[1.0 / scale, 0, 0], [0, 1.0 / scale, 0], [0, 0, 1.0]], dtype=mat.dtype, device=mat.device)
    out = s_inv @ mat @ s
    return out / out[..., 2:3, 2:3]


def fit_and_warp(kpts0: Keypoints, kpts1: Keypoints, matches: MatchResult, image0, *, ransac_model: str,
                 ransac_threshold: float, min_match_count: int, produce_warp: bool, match_weights=None,
                 gen: Optional[torch.Generator] = None, num_hypotheses: int = 512, indices=None):
    """The robust fit over the matched points of a batch and, if asked,
    image 0 warped by it. Samples are drawn from `gen`, or given as
    `indices` (B, M, k)."""
    p0, p1, valid = gather_matched_points(kpts0.xy, kpts1.xy, matches)
    similarity = ransac_model == "similarity"
    if indices is None:
        if gen is None:
            raise ValueError("registration needs a torch.Generator (or given sample indices)")
        indices = sample_indices(gen, valid, num_hypotheses, 2 if similarity else 4, match_weights)
    ransac = ransac_similarity_from_indices if similarity else ransac_homography_from_indices
    fit = ransac(indices, p0, p1, valid, threshold=ransac_threshold, min_matches=min_match_count,
                 weights=match_weights)
    warped = None
    if produce_warp:
        h = affine_to_homography(fit.matrix) if similarity else fit.matrix
        # out(p) = image0(H^-1 p): image0 rendered into image1's frame
        warped = warp_image(image0, invert_homography(h))
    return fit, warped


def build_registration_fn(
    model: Matching,
    matcher: str = "ratio",  # "ratio" | "superglue"
    ratio: float = 0.7,
    ransac_model: str = "similarity",  # "similarity" | "homography"
    ransac_threshold: float = 7.0,
    num_hypotheses: int = 512,
    min_match_count: int = 10,
    produce_warp: bool = True,
    confidence_weighting: bool = True,
    confidence_gamma: float = 1.0,
    sg_ratio_gate: float = 0.0,
):
    """Returns `register(image0, image1, gen, indices=None)`, which runs
    under `torch.inference_mode()`. Images: (B, H, W, 1) f32 in [0, 1] on
    the model's device; `gen` a `torch.Generator` there. `indices`
    (B, num_hypotheses, k) replaces the samples drawn from `gen`.

    `confidence_weighting` (superglue matcher only) feeds SuperGlue's
    calibrated per-match confidences into RANSAC: confidence-biased
    hypothesis sampling and confidence-scaled refit and IRLS weights. The
    ratio matcher's raw cosine scores are not calibrated, so it always fits
    unweighted. `sg_ratio_gate` > 0 drops SuperGlue assignments whose
    descriptor distance does not beat the best alternative by that (loose)
    Lowe ratio (`ops/matching.ratio_gate_matches`)."""
    if matcher not in ("ratio", "superglue"):
        raise ValueError(f"unknown matcher: {matcher}")
    if ransac_model not in ("similarity", "homography"):
        raise ValueError(f"unknown ransac_model: {ransac_model}")

    @torch.inference_mode()
    def register(image0, image1, gen: Optional[torch.Generator] = None, indices=None) -> RegistrationResult:
        kpts0 = model.detect(image0)
        kpts1 = model.detect(image1)
        if matcher == "ratio":
            matches = match_ratio_mutual(kpts0.desc, kpts1.desc, kpts0.mask, kpts1.mask,
                                         ratio=ratio, cross_check=False)
        else:
            out = model.match_keypoints(kpts0, kpts1, tuple(image0.shape[1:3]), tuple(image1.shape[1:3]))
            matches = match_result_from_outputs(out)
            if sg_ratio_gate > 0.0:
                matches = ratio_gate_matches(matches, kpts0.desc, kpts1.desc, kpts0.mask, kpts1.mask,
                                             gate=sg_ratio_gate)
        match_weights = None
        if confidence_weighting and matcher == "superglue":
            # gamma > 1 concentrates sampling and refit weight on the most confident matches
            match_weights = torch.where(matches.matches0 >= 0, matches.scores0, 0.0).float() ** confidence_gamma
        fit, warped = fit_and_warp(
            kpts0, kpts1, matches, image0, ransac_model=ransac_model, ransac_threshold=ransac_threshold,
            min_match_count=min_match_count, produce_warp=produce_warp, match_weights=match_weights,
            gen=gen, num_hypotheses=num_hypotheses, indices=indices)
        return RegistrationResult(kpts0=kpts0, kpts1=kpts1, matches=matches, fit=fit, warped=warped)

    return register


def reprojection_error(fit: RobustFit, p0, p1, valid):
    """Mean reprojection error of a fit over its valid inlier matches (px)."""
    mat = fit.matrix
    if tuple(mat.shape[-2:]) == (2, 3):
        pred = torch.einsum("...ij,...nj->...ni", mat[..., :2], p0) + mat[..., None, :, 2]
    else:
        pred = warp_points(p0, mat)
    err = torch.sqrt(((pred - p1) ** 2).sum(-1))
    w = (valid & fit.inliers).float()
    return (err * w).sum(-1) / w.sum(-1).clamp_min(1.0)
