"""SuperPoint detector + descriptor networks and their postprocess — the
counterpart of `image_matching_tpu/models/superpoint.py`.

`SuperPointBN` is the U-Net-encoder variant with BatchNorm,
`SuperPointVGG` the MagicLeap VGG variant without it. Both run either as
the plain network or, with `s2d=True`, in one of the space-to-depth
layouts of `ops/s2d_conv.py`, on the same parameters and with the same
outputs up to rounding:

  * `s2d_layout="h"` (the JAX package's default), H-only (2, 1): the
    image conv writes alignedH straight from the fused entry conv
    (`ops/entry_conv.entry_conv_h`, a CUDA kernel on the card), then each
    level is a stride-(2, 1) entry conv, an in-level conv and a pool that
    realigns rows while it reduces, all library ops as they are XLA ops
    in JAX;
  * `s2d_layout="2x2"`: each level one entry conv (`ops/s2d_entry.py`, a
    CUDA kernel on the card), one in-level 2x2 conv and a pool that
    realigns while it reduces (`ops/realign.py`, a CUDA kernel on the
    card).

The layouts are devices for the TPU's matrix unit; on an H100 their
in-level convs do 4/3 (H) and 16/9 (2x2) of the useful multiply-adds, so
the plain network is the port's default and the s2d paths exist to cover
the JAX package's configurations.

Plain maps are NCHW in `torch.channels_last` memory, s2d maps NHWC; the
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
    S2DDoubleConv,
    S2DDoubleConvH,
    conv2d,
    fold_parity,
    init_weights,
    max_pool_stride2,
    s2d_bias_bn,
    unfold_parity,
)
from image_matching_tpu_torch.ops.detect import detect_keypoints
from image_matching_tpu_torch.ops.entry_conv import entry_conv, entry_conv_h
from image_matching_tpu_torch.ops.realign import pool_from_raw
from image_matching_tpu_torch.ops.s2d_conv import (
    conv3x3_s2d_raw,
    conv3x3_s2dh_entry,
    conv3x3_s2dh_raw,
    depth_to_space,
    depth_to_space_h,
    maxpool2x2_s2dh_from_raw,
    mm1x1_s2d,
    mm1x1_s2dh,
    realign,
    realign_h,
)
from image_matching_tpu_torch.ops.s2d_entry import s2d_entry_conv
from image_matching_tpu_torch.ops.sampling import refine_keypoints_subpixel, sample_descriptors
from image_matching_tpu_torch.structs import Keypoints

CELL = 8


def _check_layout(s2d: bool, s2d_layout: str) -> None:
    if s2d and s2d_layout not in ("h", "2x2"):
        raise ValueError(f"unknown s2d_layout {s2d_layout!r}")


def _takes_s2d(image) -> bool:
    """The s2d path needs H and W divisible by 16; other sizes run plain."""
    return image.shape[1] % 16 == 0 and image.shape[2] % 16 == 0


def _s2d_ops(layout: str):
    """An s2d layout's ops, looked up at call time: (parity groups, entry
    conv, in-level raw conv, realigning pool, realign, 1x1 conv,
    depth_to_space)."""
    if layout == "h":
        return (2, conv3x3_s2dh_entry, conv3x3_s2dh_raw, maxpool2x2_s2dh_from_raw, realign_h, mm1x1_s2dh,
                depth_to_space_h)
    return 4, s2d_entry_conv, conv3x3_s2d_raw, pool_from_raw, realign, mm1x1_s2d, depth_to_space


def _hwio(conv: nn.Conv2d, dtype):
    return conv.weight.permute(2, 3, 1, 0).to(dtype)


def _normalize_desc(desc, dim: int):
    return desc / torch.linalg.vector_norm(desc, dim=dim, keepdim=True).clamp_min(1e-12)


class SuperPointBN(nn.Module):
    """U-Net-encoder SuperPoint with BatchNorm: inc(64) + 3 x (maxpool +
    double conv) with 64-64-128-128 channels, then BN'd detector (65) and
    descriptor (D) heads through 256-channel 3x3 convs. Plain, the first
    conv of `inc` runs as the fused entry conv (`ops/entry_conv.py`). With
    `s2d=True` images whose H and W divide by 16 run in the s2d layout
    `s2d_layout` ("h" or "2x2"); the parameters are the same either way."""

    def __init__(self, descriptor_dim: int = 256, compute_dtype: str = "float32",
                 device=None, seed: int = 0, s2d: bool = False, s2d_layout: str = "h"):
        super().__init__()
        _check_layout(s2d, s2d_layout)
        c1, c2, c3, c4, c5 = 64, 64, 128, 128, 256
        self.dtype = getattr(torch, compute_dtype)
        self.s2d = s2d
        self.s2d_layout = s2d_layout
        block = (S2DDoubleConvH if s2d_layout == "h" else S2DDoubleConv) if s2d else DoubleConv
        self.inc = block(1, c1)
        self.down1 = block(c1, c2)
        self.down2 = block(c2, c3)
        self.down3 = block(c3, c4)
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

    def forward(self, image, train: bool = False) -> dict:
        """image (B, H, W, 1) in [0, 1] -> {"semi", "desc_map"}. `train`
        normalises with the batch's statistics and moves the running ones
        (every BN in f32); it always takes the plain path, whose first conv
        is then a library conv, not the fused entry conv."""
        if self.s2d and not train and _takes_s2d(image):
            return self._forward_s2d(image)
        dt = self.dtype
        # f32 BN statistics in training; BN on the compute dtype's output in inference
        bn_in = (lambda y: y.float()) if train else (lambda y: y)
        x = self.inc(image[..., 0].to(dt).contiguous(), dt, train)
        x = self.down1(max_pool_stride2(x), dt, train)
        x = self.down2(max_pool_stride2(x), dt, train)
        x = self.down3(max_pool_stride2(x), dt, train)

        cpa = torch.relu(self.bnPa(bn_in(conv2d(x, self.convPa, dt)), train=train))
        semi = self.bnPb(bn_in(conv2d(cpa, self.convPb, dt)), train=train).float()
        cda = torch.relu(self.bnDa(bn_in(conv2d(x, self.convDa, dt)), train=train))
        desc = _normalize_desc(self.bnDb(bn_in(conv2d(cda, self.convDb, dt)), train=train).float(), 1)
        return {"semi": semi.permute(0, 2, 3, 1), "desc_map": desc.permute(0, 2, 3, 1)}

    def _forward_s2d(self, image) -> dict:
        dt = self.dtype
        groups, _, raw_conv, pool, realign_fn, mm, d2s = _s2d_ops(self.s2d_layout)
        u = self.inc.s2d(image.to(dt), dt)
        u = self.down1.s2d(pool(u), dt)
        u = self.down2.s2d(pool(u), dt)
        u = self.down3.s2d(pool(u), dt)
        x = realign_fn(u)  # aligned s2d of the Hc x Wc 128-channel map (small)

        def head(conv, bn):  # aligned in, U-form out
            return torch.relu(s2d_bias_bn(raw_conv(x, _hwio(conv, dt)), conv.bias, bn, dt, groups))

        def head_out(conv, bn, inp):  # U-form in, direct f32 out
            y = mm(inp, conv.weight[:, :, 0, 0].t().to(dt), conv.bias.to(dt))
            y = unfold_parity(bn(fold_parity(y, groups), dim=-1), y.shape[-1], groups)
            return d2s(realign_fn(y).float())

        semi = head_out(self.convPb, self.bnPb, head(self.convPa, self.bnPa))
        desc = head_out(self.convDb, self.bnDb, head(self.convDa, self.bnDa))
        return {"semi": semi, "desc_map": _normalize_desc(desc, -1)}


class SuperPointVGG(nn.Module):
    """Plain VGG SuperPoint (the MagicLeap architecture, no BatchNorm), with
    the official checkpoint's layer names (`conv1a` ... `convDb`). `s2d=True`
    runs the same network in the s2d layout `s2d_layout`; see
    `SuperPointBN`. Plain and in the H-only layout, `conv1a` runs as the
    fused entry conv with a unit scale."""

    LAYERS = (("conv1a", 1, 64), ("conv1b", 64, 64), ("conv2a", 64, 64), ("conv2b", 64, 64),
              ("conv3a", 64, 128), ("conv3b", 128, 128), ("conv4a", 128, 128), ("conv4b", 128, 128))

    def __init__(self, descriptor_dim: int = 256, compute_dtype: str = "float32",
                 device=None, seed: int = 0, s2d: bool = False, s2d_layout: str = "h"):
        super().__init__()
        _check_layout(s2d, s2d_layout)
        c4, c5 = 128, 256
        self.dtype = getattr(torch, compute_dtype)
        self.s2d = s2d
        self.s2d_layout = s2d_layout
        for name, ci, co in self.LAYERS:
            setattr(self, name, nn.Conv2d(ci, co, 3, padding=1))
        self.convPa = nn.Conv2d(c4, c5, 3, padding=1)
        self.convPb = nn.Conv2d(c5, 65, 1)
        self.convDa = nn.Conv2d(c4, c5, 3, padding=1)
        self.convDb = nn.Conv2d(c5, descriptor_dim, 1)
        init_weights(self, seed)
        self.to(resolve_device(device))

    def forward(self, image) -> dict:
        """image (B, H, W, 1) in [0, 1] -> {"semi", "desc_map"}."""
        if self.s2d and _takes_s2d(image):
            return self._forward_s2d(image)
        dt = self.dtype
        conv = lambda name, x: torch.relu(conv2d(x, getattr(self, name), dt))
        c1a = self.conv1a
        x = entry_conv(image[..., 0].to(dt).contiguous(), c1a.weight.permute(2, 3, 1, 0),
                       torch.ones_like(c1a.bias, dtype=torch.float32), c1a.bias.float())
        x = max_pool_stride2(conv("conv1b", x))
        x = max_pool_stride2(conv("conv2b", conv("conv2a", x)))
        x = max_pool_stride2(conv("conv3b", conv("conv3a", x)))
        x = conv("conv4b", conv("conv4a", x))
        semi = conv2d(conv("convPa", x), self.convPb, dt).float()
        desc = _normalize_desc(conv2d(conv("convDa", x), self.convDb, dt).float(), 1)
        return {"semi": semi.permute(0, 2, 3, 1), "desc_map": desc.permute(0, 2, 3, 1)}

    def _forward_s2d(self, image) -> dict:
        dt = self.dtype
        groups, entry_fn, raw_fn, pool, realign_fn, mm, d2s = _s2d_ops(self.s2d_layout)

        def conv(name, x, mode):
            c = getattr(self, name)
            if mode == "entry" and x.shape[-1] == 1 and groups == 2:  # the image conv: alignedH from the fused pass
                return entry_conv_h(x[..., 0].contiguous(), c.weight.permute(2, 3, 1, 0),
                                    torch.ones_like(c.bias, dtype=torch.float32), c.bias.float())
            fn = entry_fn if mode == "entry" else raw_fn
            return torch.relu(fn(x, _hwio(c, dt)) + c.bias.to(dt).repeat(groups))

        def conv1x1(c, x):
            return mm(x, c.weight[:, :, 0, 0].t().to(dt), c.bias.to(dt))

        def level(a, b, x):  # direct in, U out
            return conv(b, conv(a, x, "entry"), "raw")

        u = level("conv1a", "conv1b", image.to(dt).contiguous())
        u = level("conv2a", "conv2b", pool(u))
        u = level("conv3a", "conv3b", pool(u))
        u = level("conv4a", "conv4b", pool(u))
        x = realign_fn(u)  # aligned s2d of the Hc x Wc 128-channel map
        semi = d2s(realign_fn(conv1x1(self.convPb, conv("convPa", x, "raw"))).float())
        desc = d2s(realign_fn(conv1x1(self.convDb, conv("convDa", x, "raw"))).float())
        return {"semi": semi, "desc_map": _normalize_desc(desc, -1)}


def superpoint_postprocess(outputs: dict, max_keypoints: int, threshold: float = 0.005,
                           nms_radius: int = 4, border: int = 4, subpixel: bool = False) -> Keypoints:
    """Dense outputs -> fixed-K keypoints with sampled descriptors:
    softmax over 65 (f32) into a bf16 heatmap, NMS, border + threshold,
    top-K, bilinear descriptor sampling, invalid slots zeroed.

    `subpixel` refines the keypoint coordinates by a log-patch soft-argmax
    of the heatmap (off by default: it costs a K-point patch gather;
    registration-quality work turns it on)."""
    heatmap = flatten_detection(outputs["semi"], CELL)
    kpts = detect_keypoints(heatmap, max_keypoints=max_keypoints, threshold=threshold,
                            nms_radius=nms_radius, border=border)
    if subpixel:
        refined = refine_keypoints_subpixel(heatmap.float(), kpts.xy)
        h, w = heatmap.shape[1:3]
        top = torch.tensor([w - 1.0, h - 1.0], dtype=refined.dtype, device=refined.device)
        refined = torch.minimum(refined.clamp_min(0.0), top)
        kpts = kpts.replace(xy=torch.where(kpts.mask[..., None], refined, kpts.xy))
    desc = sample_descriptors(kpts.xy, outputs["desc_map"], CELL)
    desc = desc * kpts.mask[..., None].to(desc.dtype)
    return kpts.replace(desc=desc)
