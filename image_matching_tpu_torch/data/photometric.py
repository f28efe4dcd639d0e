"""Photometric augmentation on the device — the counterpart of
`image_matching_tpu/data/photometric.py`: random brightness, contrast,
gaussian noise, speckle noise, motion blur at one of four orientations and
an additive elliptical shade, in that order, then a clip to [0, 1].

Images are float32 in [0, 1], (B, H, W, C); each image gets its own random
parameters. Each op is split into a draw (its random numbers, from a
`torch.Generator` where JAX splits a key) and an apply (a pure function of
the images and those numbers): `draw_photometric` and `apply_photometric`,
whose composition is `photometric_augment`. Both blurs are
cross-correlations with XLA's "SAME" zero padding, as
`jax.lax.conv_general_dilated` computes them.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class PhotometricConfig(NamedTuple):
    enable: bool = True
    max_abs_brightness: float = 50.0 / 255.0
    contrast_range: Tuple[float, float] = (0.5, 1.5)
    gaussian_noise_std_range: Tuple[float, float] = (0.0, 10.0 / 255.0)
    speckle_prob_range: Tuple[float, float] = (0.0, 0.0035)
    motion_blur_max_ksize: int = 3
    shade_transparency_range: Tuple[float, float] = (-0.5, 0.5)
    shade_kernel_size: int = 50  # blur radius of the shade mask
    shade_prob: float = 0.8


class PhotometricDraws(NamedTuple):
    """The random numbers of one augmentation of a batch of B images."""
    brightness: torch.Tensor  # (B,) added
    contrast: torch.Tensor  # (B,) factor about the image's mean
    noise_std: torch.Tensor  # (B,)
    noise: torch.Tensor  # (B, H, W, C) standard normal
    speckle_prob: torch.Tensor  # (B,)
    speckle_u: torch.Tensor  # (B, H, W, C) uniform: a pixel is replaced where u < prob
    speckle_salt: torch.Tensor  # (B, H, W, C) bool: by 1 (salt), else 0
    motion_kernel: torch.Tensor  # (B,) int64 in [0, 4): horizontal, vertical, diagonal, anti-diagonal
    motion_apply: torch.Tensor  # (B,) bool
    shade: torch.Tensor  # (B, 6): centre x, y, semi-axes x, y, angle, transparency
    shade_apply: torch.Tensor  # (B,) bool


def _column(x, images):
    return x.to(images.dtype).reshape(-1, *([1] * (images.dim() - 1)))


def apply_brightness(images, delta):
    return images + _column(delta, images)


def apply_contrast(images, factor):
    mean = images.mean(dim=tuple(range(1, images.dim())), keepdim=True)
    return (images - mean) * _column(factor, images) + mean


def apply_gaussian_noise(images, std, noise):
    return images + _column(std, images) * noise


def apply_speckle(images, prob, u, salt):
    return torch.where(u < _column(prob, images), salt.to(images.dtype), images)


def motion_kernels(ksize: int, device=None) -> torch.Tensor:
    """(4, k, k) line kernels: horizontal, vertical, diagonal, anti-diagonal."""
    k = ksize
    eye = torch.eye(k, device=device)
    horiz = torch.zeros(k, k, device=device)
    horiz[k // 2] = 1.0 / k
    return torch.stack([horiz, horiz.t(), eye / k, eye.flip(0) / k])


def _same_correlate(x, kernels):
    """Per-channel cross-correlation of (N, H, W) planes with (N, kh, kw)
    kernels, zero padded as XLA's "SAME" pads ((k - 1) // 2 before)."""
    kh, kw = kernels.shape[-2:]
    x = F.pad(x[None], ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    return F.conv2d(x, kernels[:, None], groups=kernels.shape[0])[0]


def _planes(images):
    """(B, H, W, C) -> (B * C, H, W) and back."""
    b, h, w, c = images.shape
    return images.permute(0, 3, 1, 2).reshape(b * c, h, w), lambda p: p.reshape(b, c, h, w).permute(0, 2, 3, 1)


def apply_motion_blur(images, kernel_index, apply, ksize: int):
    planes, back = _planes(images)
    kernels = motion_kernels(ksize, images.device).to(images.dtype)[kernel_index]
    kernels = kernels.repeat_interleave(images.shape[-1], 0)
    blurred = back(_same_correlate(planes, kernels))
    return torch.where(_column(apply, images).bool(), blurred, images)


def gaussian_blur_kernel(radius: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def apply_additive_shade(images, shade, apply, kernel_size: int):
    """The image times 1 + transparency * (a filled ellipse blurred by a
    separable gaussian, columns first), where `apply`."""
    b, h, w, c = images.shape
    cx, cy, ax, ay, angle, transparency = (shade[:, i].float().reshape(b, 1, 1) for i in range(6))
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=images.device),
                            torch.arange(w, dtype=torch.float32, device=images.device), indexing="ij")
    ca, sa = torch.cos(angle), torch.sin(angle)
    xr = (xs - cx) * ca + (ys - cy) * sa
    yr = -(xs - cx) * sa + (ys - cy) * ca
    mask = ((xr / ax) ** 2 + (yr / ay) ** 2 <= 1.0).float()
    g = gaussian_blur_kernel(kernel_size // 2, kernel_size / 6.0, images.device)
    mask = _same_correlate(mask, g[None, :, None].expand(b, -1, 1))
    mask = _same_correlate(mask, g[None, None, :].expand(b, 1, -1))
    shaded = images * (1.0 + transparency[..., None] * mask[..., None]).to(images.dtype)
    return torch.where(_column(apply, images).bool(), shaded, images)


def apply_photometric(images, draws: PhotometricDraws, cfg: PhotometricConfig = PhotometricConfig()):
    """The six ops in the JAX package's order, then the clip to [0, 1]."""
    x = apply_brightness(images, draws.brightness)
    x = apply_contrast(x, draws.contrast)
    x = apply_gaussian_noise(x, draws.noise_std, draws.noise)
    x = apply_speckle(x, draws.speckle_prob, draws.speckle_u, draws.speckle_salt)
    x = apply_motion_blur(x, draws.motion_kernel, draws.motion_apply, cfg.motion_blur_max_ksize)
    x = apply_additive_shade(x, draws.shade, draws.shade_apply, cfg.shade_kernel_size)
    return x.clamp(0.0, 1.0)


def draw_photometric(gen: torch.Generator, shape, cfg: PhotometricConfig = PhotometricConfig()) -> PhotometricDraws:
    """Every random number of one augmentation of a batch of `shape`
    (B, H, W, C), from `gen` on its device, with the JAX ops' ranges."""
    b, h, w, _ = shape
    dev = gen.device

    def uniform(lo, hi, size=(b,)):
        return lo + (hi - lo) * torch.rand(size, generator=gen, device=dev)

    return PhotometricDraws(
        brightness=uniform(-cfg.max_abs_brightness, cfg.max_abs_brightness),
        contrast=uniform(*cfg.contrast_range),
        noise_std=uniform(*cfg.gaussian_noise_std_range),
        noise=torch.randn(tuple(shape), generator=gen, device=dev),
        speckle_prob=uniform(*cfg.speckle_prob_range),
        speckle_u=uniform(0.0, 1.0, tuple(shape)),
        speckle_salt=uniform(0.0, 1.0, tuple(shape)) > 0.5,
        motion_kernel=torch.randint(0, 4, (b,), generator=gen, device=dev),
        motion_apply=uniform(0.0, 1.0) > 0.5,
        shade=torch.stack([uniform(0.0, float(w)), uniform(0.0, float(h)), uniform(w * 0.1, w * 0.5),
                           uniform(h * 0.1, h * 0.5), uniform(0.0, math.pi),
                           uniform(*cfg.shade_transparency_range)], 1),
        shade_apply=uniform(0.0, 1.0) < cfg.shade_prob,
    )


def photometric_augment(gen: torch.Generator, images, cfg: PhotometricConfig = PhotometricConfig()):
    """Augment a batch (B, H, W, C) with independent random parameters
    drawn from `gen`; the identity when `cfg.enable` is False."""
    if not cfg.enable:
        return images
    return apply_photometric(images, draw_photometric(gen, images.shape, cfg), cfg)
