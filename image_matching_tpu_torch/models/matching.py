"""SuperPoint + SuperGlue composition — the counterpart of
`image_matching_tpu/models/matching.py`: detect both images in one
2B-batched backbone pass, then match.

`MatchingConfig` keeps the JAX defaults, including the mismatch that
`Matching` stores attention logits in bf16 while `SuperGlue` alone
defaults to f32 (on the card the attention kernel keeps f32 logits
either way; the setting reaches only the plain CPU attention), with one
exception: `s2d_backbone` defaults to False. The space-to-depth layouts
are devices for the TPU's 128-lane matrix unit, and on an H100 their
in-level convs do more than the useful multiply-adds (4/3 for the H-only
layout, 16/9 for 2x2), so the plain backbone is the port's default.
`s2d_backbone=True` means what it means in JAX: the H-only layout
(`s2d_layout="h"`), or the 2x2 one when asked. Left out are the JAX
config's choices among TPU implementations of one function:
`stack_sides`, `attention_impl`, `sinkhorn_impl`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from image_matching_tpu_torch.device import resolve_device
from image_matching_tpu_torch.models.superglue import SuperGlue
from image_matching_tpu_torch.models.superpoint import (
    SuperPointBN,
    SuperPointVGG,
    superpoint_postprocess,
)
from image_matching_tpu_torch.structs import Keypoints


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    backbone: str = "bn"  # "bn" (SuperPointBN) | "vgg" (SuperPointVGG)
    s2d_backbone: bool = False  # run the backbone in the s2d layout (H, W divisible by 16)
    s2d_layout: str = "h"  # "h" (H-only, (2, 1)) | "2x2"
    descriptor_dim: int = 256
    max_keypoints: int = 1024
    keypoint_threshold: float = 0.005
    nms_radius: int = 4
    border: int = 4
    subpixel: bool = False  # soft-argmax keypoint refinement (registration-quality work)
    keypoint_encoder: Tuple[int, ...] = (32, 64, 128, 256)
    gnn_layers: int = 18
    sinkhorn_iterations: int = 100
    match_threshold: float = 0.2
    logits_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @staticmethod
    def self_trained_128() -> "MatchingConfig":
        """The repo's self-trained pipeline: descriptor_dim 128, keypoint
        encoder (32, 64, 128), 30 Sinkhorn iterations."""
        return MatchingConfig(descriptor_dim=128, keypoint_encoder=(32, 64, 128),
                              sinkhorn_iterations=30, match_threshold=0.1)


class Matching(nn.Module):
    """Full pair matching on the card (`device=None`) or, when asked, the
    CPU. Weights are seeded random until loaded with
    `weights.load_jax_params` / `load_npz` (`superpoint` / `superglue`
    submodules, or the whole `Matching` tree)."""

    def __init__(self, config: MatchingConfig = MatchingConfig(), device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        if config.backbone not in ("bn", "vgg"):
            raise ValueError(f"unknown backbone {config.backbone!r}")
        sp_cls = SuperPointBN if config.backbone == "bn" else SuperPointVGG
        self.superpoint = sp_cls(config.descriptor_dim, config.compute_dtype, device=dev, seed=seed,
                                 s2d=config.s2d_backbone, s2d_layout=config.s2d_layout)
        self.superglue = SuperGlue(
            descriptor_dim=config.descriptor_dim,
            keypoint_encoder=config.keypoint_encoder,
            gnn_layers=config.gnn_layers,
            sinkhorn_iterations=config.sinkhorn_iterations,
            match_threshold=config.match_threshold,
            compute_dtype=config.compute_dtype,
            logits_dtype=config.logits_dtype,
            device=dev, seed=seed + 1,
        )

    @torch.inference_mode()
    def detect(self, image) -> Keypoints:
        """image (B, H, W, 1) in [0, 1] -> fixed-K keypoints with descriptors."""
        cfg = self.config
        return superpoint_postprocess(
            self.superpoint(image), max_keypoints=cfg.max_keypoints,
            threshold=cfg.keypoint_threshold, nms_radius=cfg.nms_radius, border=cfg.border,
            subpixel=cfg.subpixel,
        )

    @torch.inference_mode()
    def match_keypoints(self, kpts0: Keypoints, kpts1: Keypoints, image_shape0, image_shape1) -> dict:
        """SuperGlue on precomputed keypoints; shapes are (H, W)."""
        return self.superglue(kpts0, kpts1, image_shape0, image_shape1)

    @torch.inference_mode()
    def forward(self, image0, image1, kpts0: Optional[Keypoints] = None,
                kpts1: Optional[Keypoints] = None) -> dict:
        """image0/image1 (B, H, W, 1) in [0, 1]. Precomputed keypoints skip
        detection. Returns the SuperGlue output dict plus "keypoints0/1"."""
        if kpts0 is None and kpts1 is None and image0.shape == image1.shape:
            b = image0.shape[0]
            kp = self.detect(torch.cat([image0, image1], 0))
            kpts0, kpts1 = kp.select(slice(None, b)), kp.select(slice(b, None))
        if kpts0 is None:
            kpts0 = self.detect(image0)
        if kpts1 is None:
            kpts1 = self.detect(image1)
        out = self.superglue(kpts0, kpts1, tuple(image0.shape[1:3]), tuple(image1.shape[1:3]))
        out["keypoints0"] = kpts0
        out["keypoints1"] = kpts1
        return out
