"""Homographies: solving, inverting, rescaling, warping and normalising
points, and random sampling —
the counterpart of `image_matching_tpu/geometry/homography.py`.

Points are (..., 2) (x, y) pixels; a homography H is (..., 3, 3) acting
on homogeneous (x, y, 1) columns, p_dst ~ H @ p_src.

The sampler draws from a `torch.Generator` (on the device where the
homographies are wanted) instead of a `jax.random` key, so the two
packages draw different homographies from the same seed; the draw itself
follows the JAX package's: a centred patch, a truncated-normal
perspective jitter, a uniform choice among valid scales, a translation,
a uniform choice among valid rotations, then the 4-point DLT at pixel
scale.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


def identity_homography(dtype=torch.float32, device=None):
    return torch.eye(3, dtype=dtype, device=device)


def _fma(a, b, c):
    """a * b + c with one rounding of the float32 result (float64 holds the
    product exactly; the sum rounds twice only at a float32 midpoint)."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _pivot(m, e, col: int):
    """Rows `col` and the first row at or below it with the largest |m[:, col]|
    exchanged, in m and in the row permutation e."""
    p = col + m[..., col:, col].abs().argmax(-1, keepdim=True)
    idx = torch.arange(3, device=m.device).expand(*m.shape[:-1])
    idx = torch.where(idx == col, p, torch.where(idx == p, col, idx))[..., None].expand(m.shape)
    return m.gather(-2, idx), e.gather(-2, idx)


def invert_homography(h):
    """(..., 3, 3) -> its inverse, as the JAX package computes it on the CPU:
    LAPACK's getrf (partial pivoting, the column scaled by the pivot's
    reciprocal, the left-looking updates) and two triangular solves of the
    permuted identity, with the roundings and fused multiply-adds of the
    OpenBLAS kernels that jaxlib calls. In float32 it equals `jnp.linalg.inv`
    bit for bit on 2000 of the export's homographies; `torch.linalg.inv`
    (MKL) differs in the last bit of a third of the entries, which moves an
    exported keypoint by up to 3e-4 px."""
    m, e = _pivot(h, torch.eye(3, dtype=h.dtype, device=h.device).expand_as(h), 0)
    m = m.clone()
    m[..., 1:, 0] *= (1 / m[..., 0, 0])[..., None]
    m[..., 1:, 1] -= m[..., 1:, 0] * m[..., 0, 1, None]
    m, e = _pivot(m, e, 1)
    m = m.clone()
    m[..., 2, 1] *= 1 / m[..., 1, 1]
    m[..., 1, 2] -= m[..., 1, 0] * m[..., 0, 2]
    m[..., 2, 2] -= _fma(m[..., 2, 1], m[..., 1, 2], m[..., 2, 0] * m[..., 0, 2])
    (l10, l20, l21), (u00, u01, u02, u11, u12, u22) = (
        (m[..., i, j, None] for i, j in ((1, 0), (2, 0), (2, 1))),
        (m[..., i, j, None] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))))
    y0, y1, y2 = e.unbind(-2)
    y1 = y1 - l10 * y0
    y2 = y2 - _fma(l21, y1, l20 * y0)
    x2 = y2 * (1 / u22)
    x1 = (y1 - u12 * x2) * (1 / u11)
    x0 = _fma(-u01, x1, y0 - u02 * x2) * (1 / u00)
    return torch.stack([x0, x1, x2], -2)


def warp_points(points, homography):
    """points (..., N, 2), homography (..., 3, 3) -> (..., N, 2)."""
    hom = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    warped = torch.einsum("...ij,...nj->...ni", homography.to(points.dtype), hom)
    return warped[..., :2] / (warped[..., 2:3] + 1e-12)


def points_in_bounds(points, height: int, width: int):
    """Boolean mask of points inside [0, W-1] x [0, H-1] (inclusive)."""
    x, y = points[..., 0], points[..., 1]
    return (x >= 0) & (x <= width - 1) & (y >= 0) & (y <= height - 1)


def normalize_points(points, height: int, width: int):
    """Pixel coordinates -> [-1, 1] (p / shape * 2 - 1)."""
    shape = torch.tensor([width, height], dtype=points.dtype, device=points.device)
    return points / shape * 2.0 - 1.0


def denormalize_points(points, height: int, width: int):
    shape = torch.tensor([width, height], dtype=points.dtype, device=points.device)
    return (points + 1.0) * shape / 2.0


def scale_homography(h, height: int, width: int, to_normalized: bool = False):
    """Convert a homography between the pixel frame and the [-1, 1]
    normalized frame: by default from one acting on normalized coordinates
    to its pixel-frame equivalent; with `to_normalized`, the reverse."""
    t = torch.tensor([[2.0 / width, 0.0, -1.0], [0.0, 2.0 / height, -1.0], [0.0, 0.0, 1.0]],
                     dtype=h.dtype, device=h.device)
    t_inv = torch.linalg.inv(t)
    if to_normalized:
        return t @ h @ t_inv
    return t_inv @ h @ t


def homography_from_4pts(src, dst, check: bool = True):
    """The exact homography mapping 4 source points onto 4 destination
    points (cv2.getPerspectiveTransform's DLT, h33 = 1). src, dst (..., 4, 2).
    A singular system (coincident or collinear points) raises; with
    `check=False` its homography is NaN instead, for callers that sort
    degenerate samples out themselves (`ops/ransac.py`)."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    ax = torch.stack([x, y, ones, zeros, zeros, zeros, -x * u, -y * u], dim=-1)
    ay = torch.stack([zeros, zeros, zeros, x, y, ones, -x * v, -y * v], dim=-1)
    a = torch.cat([ax, ay], dim=-2)  # (..., 8, 8)
    rhs = torch.cat([u, v], dim=-1)[..., None]
    if check:
        h8 = torch.linalg.solve(a, rhs)[..., 0]
    else:
        sol, info = torch.linalg.solve_ex(a, rhs)
        h8 = torch.where(info[..., None] == 0, sol[..., 0], math.nan)
    h9 = torch.cat([h8, torch.ones_like(h8[..., :1])], dim=-1)
    return h9.reshape(*h9.shape[:-1], 3, 3)


class HomographyConfig(NamedTuple):
    """The sampler's settings, with the JAX package's defaults."""

    perspective: bool = True
    scaling: bool = True
    rotation: bool = True
    translation: bool = True
    n_scales: int = 5
    n_angles: int = 25
    scaling_amplitude: float = 0.1
    perspective_amplitude_x: float = 0.1
    perspective_amplitude_y: float = 0.1
    patch_ratio: float = 0.5
    max_angle: float = math.pi / 2
    allow_artifacts: bool = False
    translation_overflow: float = 0.0


def _uniform(gen, shape):
    return torch.rand(shape, generator=gen, device=gen.device)


def _truncated_normal(gen, shape, bound: float = 2.0):
    """Standard normal truncated to [-bound, bound], by inverting the CDF."""
    lo = 0.5 * (1 + math.erf(-bound / math.sqrt(2)))
    u = lo + (1 - 2 * lo) * _uniform(gen, shape)
    return (math.sqrt(2) * torch.erfinv(2 * u - 1)).clamp(-bound, bound)


def _masked_choice(gen, candidates, valid):
    """Per batch row, one candidate drawn uniformly among the valid ones
    (Gumbel-max over masked logits). candidates (B, C, ...), valid (B, C)."""
    gumbel = -torch.log(-torch.log(_uniform(gen, valid.shape).clamp_min(1e-20)))
    idx = torch.where(valid, gumbel, -math.inf).argmax(dim=1)
    return candidates[torch.arange(candidates.shape[0], device=candidates.device), idx]


def _inside(pts):
    """(..., 4, 2) corners inside the unit square -> (...,) bool."""
    return ((pts >= 0.0) & (pts < 1.0)).all(dim=-1).all(dim=-1)


def sample_homography_batch(gen: torch.Generator, batch: int, height: int, width: int,
                            config: HomographyConfig = HomographyConfig()):
    """(batch, 3, 3) independent random homographies on `gen`'s device,
    each mapping the full image's corners onto a sampled patch."""
    cfg = config
    dev = gen.device
    corners = torch.tensor([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]], device=dev)
    margin = (1.0 - cfg.patch_ratio) / 2.0
    pts2 = (margin + cfg.patch_ratio * corners).expand(batch, 4, 2)

    if cfg.perspective:
        amp_x, amp_y = cfg.perspective_amplitude_x, cfg.perspective_amplitude_y
        if not cfg.allow_artifacts:
            amp_x, amp_y = min(amp_x, margin), min(amp_y, margin)
        disp = _truncated_normal(gen, (batch, 3))
        d, left, right = disp[:, 0] * amp_y / 2.0, disp[:, 1] * amp_x / 2.0, disp[:, 2] * amp_x / 2.0
        pts2 = pts2 + torch.stack([torch.stack([left, d], -1), torch.stack([left, -d], -1),
                                   torch.stack([right, d], -1), torch.stack([right, -d], -1)], dim=1)

    if cfg.scaling:
        scales = 1.0 + _truncated_normal(gen, (batch, cfg.n_scales)) * (cfg.scaling_amplitude / 2.0)
        scales = torch.cat([torch.ones_like(scales[:, :1]), scales], dim=1)
        center = pts2.mean(dim=1, keepdim=True)
        scaled = (pts2 - center)[:, None] * scales[:, :, None, None] + center[:, None]
        valid = torch.ones_like(scales, dtype=torch.bool)
        if not cfg.allow_artifacts:
            valid = _inside(scaled)
            valid[:, 0] = True  # scale 1 is always a fallback
        pts2 = _masked_choice(gen, scaled, valid)

    if cfg.translation:
        t_min = pts2.amin(dim=1)
        t_max = (1.0 - pts2).amin(dim=1)
        if cfg.allow_artifacts:
            t_min = t_min + cfg.translation_overflow
            t_max = t_max + cfg.translation_overflow
        pts2 = pts2 + (-t_min + _uniform(gen, (batch, 2)) * (t_max + t_min))[:, None]

    if cfg.rotation:
        angles = torch.linspace(-cfg.max_angle, cfg.max_angle, cfg.n_angles, device=dev)
        angles = torch.cat([angles, torch.zeros(1, device=dev)])
        c, s = torch.cos(angles), torch.sin(angles)
        rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], dim=-2)  # (A, 2, 2)
        center = pts2.mean(dim=1, keepdim=True)
        rotated = torch.einsum("bnc,acd->band", pts2 - center, rot) + center[:, None]
        valid = torch.ones(rotated.shape[:2], dtype=torch.bool, device=dev)
        if not cfg.allow_artifacts:
            valid = _inside(rotated)
            valid[:, -1] = True  # the identity rotation is always a fallback
        pts2 = _masked_choice(gen, rotated, valid)

    size = torch.tensor([float(width), float(height)], device=dev)
    return homography_from_4pts((corners * size).expand(batch, 4, 2), pts2 * size)


def sample_homography(gen: torch.Generator, height: int, width: int,
                      config: HomographyConfig = HomographyConfig()):
    """One (3, 3) random homography."""
    return sample_homography_batch(gen, 1, height, width, config)[0]
