"""SuperPointBN detector + descriptor and its postprocess — the
counterpart of `image_matching_tpu/models/superpoint.py`.

Only the plain network is ported. The JAX package's `s2d=True` /
`s2d_layout` backbones are exact re-layouts of this same network for the
TPU's matrix unit (same parameters, same outputs up to rounding), so the
port has no such option. `SuperPointVGG` and subpixel refinement are not
in this slice.

Maps are NCHW in `torch.channels_last` memory inside the network; the
outputs keep the JAX layouts: `semi` (B, Hc, Wc, 65) and `desc_map`
(B, Hc, Wc, D), both f32.
"""
from __future__ import annotations

import torch
from torch import nn

from image_matching_tpu_torch.device import resolve_device
from image_matching_tpu_torch.geometry.labels import flatten_detection
from image_matching_tpu_torch.models.common import (
    BatchNorm,
    DoubleConv,
    conv2d,
    init_weights,
    max_pool_stride2,
)
from image_matching_tpu_torch.ops.detect import detect_keypoints
from image_matching_tpu_torch.ops.sampling import sample_descriptors
from image_matching_tpu_torch.structs import Keypoints

CELL = 8


class SuperPointBN(nn.Module):
    """U-Net-encoder SuperPoint with BatchNorm: inc(64) + 3 x (maxpool +
    double conv) with 64-64-128-128 channels, then BN'd detector (65) and
    descriptor (D) heads through 256-channel 3x3 convs. The first conv of
    `inc` runs as the fused entry conv (`ops/entry_conv.py`)."""

    def __init__(self, descriptor_dim: int = 256, compute_dtype: str = "float32",
                 device=None, seed: int = 0):
        super().__init__()
        c1, c2, c3, c4, c5 = 64, 64, 128, 128, 256
        self.dtype = getattr(torch, compute_dtype)
        self.inc = DoubleConv(1, c1)
        self.down1 = DoubleConv(c1, c2)
        self.down2 = DoubleConv(c2, c3)
        self.down3 = DoubleConv(c3, c4)
        self.convPa = nn.Conv2d(c4, c5, 3, padding=1)
        self.bnPa = BatchNorm(c5, dim=1)
        self.convPb = nn.Conv2d(c5, 65, 1)
        self.bnPb = BatchNorm(65, dim=1)
        self.convDa = nn.Conv2d(c4, c5, 3, padding=1)
        self.bnDa = BatchNorm(c5, dim=1)
        self.convDb = nn.Conv2d(c5, descriptor_dim, 1)
        self.bnDb = BatchNorm(descriptor_dim, dim=1)
        init_weights(self, seed)
        self.to(resolve_device(device))

    def forward(self, image) -> dict:
        """image (B, H, W, 1) in [0, 1] -> {"semi", "desc_map"}."""
        dt = self.dtype
        x = self.inc(image[..., 0].to(dt).contiguous(), dt)
        x = self.down1(max_pool_stride2(x), dt)
        x = self.down2(max_pool_stride2(x), dt)
        x = self.down3(max_pool_stride2(x), dt)

        cpa = torch.relu(self.bnPa(conv2d(x, self.convPa, dt)))
        semi = self.bnPb(conv2d(cpa, self.convPb, dt)).float()
        cda = torch.relu(self.bnDa(conv2d(x, self.convDa, dt)))
        desc = self.bnDb(conv2d(cda, self.convDb, dt)).float()
        desc = desc / torch.linalg.vector_norm(desc, dim=1, keepdim=True).clamp_min(1e-12)
        return {"semi": semi.permute(0, 2, 3, 1), "desc_map": desc.permute(0, 2, 3, 1)}


def superpoint_postprocess(outputs: dict, max_keypoints: int, threshold: float = 0.005,
                           nms_radius: int = 4, border: int = 4) -> Keypoints:
    """Dense outputs -> fixed-K keypoints with sampled descriptors:
    softmax over 65 (f32) into a bf16 heatmap, NMS, border + threshold,
    top-K, bilinear descriptor sampling, invalid slots zeroed."""
    heatmap = flatten_detection(outputs["semi"], CELL)
    kpts = detect_keypoints(heatmap, max_keypoints=max_keypoints, threshold=threshold,
                            nms_radius=nms_radius, border=border)
    desc = sample_descriptors(kpts.xy, outputs["desc_map"], CELL)
    desc = desc * kpts.mask[..., None].to(desc.dtype)
    return kpts.replace(desc=desc)
