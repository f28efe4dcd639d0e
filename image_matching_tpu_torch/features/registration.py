"""Classical registration: SIFT or ORB, then matching, then RANSAC — the
counterpart of `image_matching_tpu/features/registration.py`, after the
reference's `SIFT_REGIS` (SIFT, FLANN 2-NN ratio 0.7, RANSAC partial
affine at 7 px) and `ORB_REGIS` (ORB, brute-force Hamming with cross
check, the same RANSAC), with `MIN_MATCH_COUNT = 10`.

RANSAC draws its samples from a `torch.Generator` (`ops/ransac.sample_indices`),
or takes them as `indices`, where the JAX package takes a PRNG key.
"""
from __future__ import annotations

from typing import Optional

import torch

from image_matching_tpu_torch.features.orb import ORBConfig, brief_pattern, orb_detect_and_describe
from image_matching_tpu_torch.features.sift import SIFTConfig, sift_detect_and_describe
from image_matching_tpu_torch.ops.matching import gather_matched_points, match_hamming, match_ratio_mutual
from image_matching_tpu_torch.ops.ransac import (
    ransac_homography_from_indices,
    ransac_similarity_from_indices,
    sample_indices,
)
from image_matching_tpu_torch.registration import RegistrationResult

MIN_MATCH_COUNT = 10  # Traditional/registration.py:4


def build_classical_registration_fn(
    method: str = "sift",
    ratio: float = 0.7,
    ransac_model: str = "similarity",  # "similarity" | "homography"
    ransac_threshold: float = 7.0,
    num_hypotheses: int = 512,
    sift_config: SIFTConfig = SIFTConfig(),
    orb_config: ORBConfig = ORBConfig(),
):
    """Returns `register(image0, image1, gen=None, indices=None)`, which
    runs under `torch.inference_mode()` on the images' device. Images:
    (B, H, W, 1) f32 in [0, 1]; `gen` a `torch.Generator` on that device;
    `indices` (B, num_hypotheses, k) replaces the samples drawn from `gen`
    (k = 2 for a similarity, 4 for a homography). The result's `warped` is
    None. Each image pair of the batch gets what the JAX package's
    function gives it alone."""
    if method not in ("sift", "orb"):
        raise ValueError(f"unknown method: {method}")
    if ransac_model not in ("similarity", "homography"):
        raise ValueError(f"unknown ransac_model: {ransac_model}")
    if method == "orb":
        brief_pattern(orb_config, torch.device("cpu"))  # refuse another pattern now, not at the first call
    similarity = ransac_model == "similarity"

    @torch.inference_mode()
    def register(image0, image1, gen: Optional[torch.Generator] = None, indices=None) -> RegistrationResult:
        if method == "sift":
            kp0 = sift_detect_and_describe(image0, sift_config)
            kp1 = sift_detect_and_describe(image1, sift_config)
            matches = match_ratio_mutual(kp0.desc, kp1.desc, kp0.mask, kp1.mask, ratio=ratio,
                                         cross_check=False)
        else:
            kp0 = orb_detect_and_describe(image0, orb_config)
            kp1 = orb_detect_and_describe(image1, orb_config)
            matches = match_hamming(kp0.desc, kp1.desc, kp0.mask, kp1.mask)
        p0, p1, valid = gather_matched_points(kp0.xy, kp1.xy, matches)
        if indices is None:
            if gen is None:
                raise ValueError("registration needs a torch.Generator (or given sample indices)")
            indices = sample_indices(gen, valid, num_hypotheses, 2 if similarity else 4)
        ransac = ransac_similarity_from_indices if similarity else ransac_homography_from_indices
        fit = ransac(indices, p0, p1, valid, threshold=ransac_threshold, min_matches=MIN_MATCH_COUNT)
        return RegistrationResult(kpts0=kp0, kpts1=kp1, matches=matches, fit=fit, warped=None)

    return register
