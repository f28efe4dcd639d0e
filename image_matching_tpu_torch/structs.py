"""Fixed-capacity masked keypoint and match sets — the counterpart of
`image_matching_tpu/structs.py` (`Keypoints`, `MatchResult`,
`RobustFit`)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Keypoints:
    """xy (..., K, 2) f32 (x, y) pixels; score (..., K) f32, 0 where
    invalid; mask (..., K) bool; desc optional (..., K, D) unit-norm."""

    xy: torch.Tensor
    score: torch.Tensor
    mask: torch.Tensor
    desc: Optional[torch.Tensor] = None

    def num_valid(self) -> torch.Tensor:
        return self.mask.sum(-1)

    def replace(self, **changes) -> "Keypoints":
        return dataclasses.replace(self, **changes)

    def select(self, index) -> "Keypoints":
        """Index every field along the leading (batch) dimension."""
        return Keypoints(
            xy=self.xy[index], score=self.score[index], mask=self.mask[index],
            desc=None if self.desc is None else self.desc[index],
        )


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """matches0 (..., K0) int32 index into set 1 or -1; matches1
    likewise; scores0/scores1 the matching confidences."""

    matches0: torch.Tensor
    matches1: torch.Tensor
    scores0: torch.Tensor
    scores1: torch.Tensor

    def num_matches(self) -> torch.Tensor:
        return (self.matches0 >= 0).sum(-1)


@dataclasses.dataclass(frozen=True)
class RobustFit:
    """A robust (RANSAC) model fit: matrix (..., 2, 3) affine or
    (..., 3, 3) homography; inliers (..., N) bool over the match
    candidates; num_inliers (...,) int; valid (...,) bool, False when
    there were too few matches to fit."""

    matrix: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor
    valid: torch.Tensor
