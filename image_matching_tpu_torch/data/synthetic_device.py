"""Synthetic-shapes training batches made on the device — the counterpart
of `image_matching_tpu/data/synthetic_device.py`.

Each sample is one of three families, with a background shade under it:

  polygons       1-3 star-shaped polygons of 3-6 vertices, each the union
                 of the triangles (centre, v_i, v_i+1); a pixel is inside a
                 triangle where the three half-plane cross products share a
                 sign
  line segments  2-7 segments of thickness 2: pixels within 1 of a segment
  checkerboard   3-5 x 3-5 cells of a shaded checkerboard, by cell index

painted in order over the batch's pixel grid with no branch: every family
is rasterised for every sample and each sample keeps its own. The corners
(polygon vertices, segment ends, checkerboard grid points) are exact: drawn
and reported at the same float coordinates; those outside the image are
masked off. Same families, count ranges, shade ranges and margins as
`datasets.SyntheticShapesDataset`.

Random numbers come in a `SyntheticDraws` (`draw_synthetic`, from a
`torch.Generator`), which `rasterise_synthetic` applies; a batch made on
the card costs no host-to-device copy.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

MAX_POLYS = 3
MAX_VERTS = 6
MAX_LINES = 7
MAX_CB = 5  # checkerboard rows / columns at most


class SyntheticDraws(NamedTuple):
    """The random numbers of a batch of B samples."""
    background: torch.Tensor  # (B,) shade in [0, 0.3)
    kind: torch.Tensor  # (B,) int64: 0 polygons, 1 line segments, 2 checkerboard
    n_polys: torch.Tensor  # (B,) int64 in [1, 3]
    n_verts: torch.Tensor  # (B, 3) int64 in [3, 6]
    centers: torch.Tensor  # (B, 3, 2) (x, y) at least `margin` inside
    radii: torch.Tensor  # (B, 3, 6) in [0.3, 1) * 0.2 * min(H, W)
    angles: torch.Tensor  # (B, 3, 6) in [0, 2 pi), unsorted
    poly_shades: torch.Tensor  # (B, 3) in [0.4, 1)
    n_lines: torch.Tensor  # (B,) int64 in [2, 7]
    ends: torch.Tensor  # (B, 7, 2, 2) segment ends (x, y), at least `margin` inside
    line_shades: torch.Tensor  # (B, 7) in [0.4, 1)
    rows: torch.Tensor  # (B,) int64 in [3, 5]
    cols: torch.Tensor  # (B,) int64 in [3, 5]
    cell: torch.Tensor  # (B,) in [min(H, W) / 16, min(H, W) / 8); the cell is floor(max(4, this))
    corner: torch.Tensor  # (B, 2) uniform in [0, 1): the top-left corner's place within its range
    board_shades: torch.Tensor  # (B, 5, 5) in [0.6, 1)


def _margin(height: int, width: int) -> int:
    return max(4, min(height, width) // 8)


def draw_synthetic(gen: torch.Generator, batch: int, height: int, width: int) -> SyntheticDraws:
    """Every random number of a batch, from `gen` on its device."""
    dev = gen.device
    margin, rmax = _margin(height, width), min(height, width) * 0.2

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand((batch, *shape), generator=gen, device=dev)

    def integers(lo, hi, *shape):
        return torch.randint(lo, hi, (batch, *shape), generator=gen, device=dev)

    def inside(*shape):  # (..., 2) points at least `margin` from the borders
        return torch.stack([uniform(margin, width - margin, *shape), uniform(margin, height - margin, *shape)], -1)

    return SyntheticDraws(
        background=uniform(0.0, 0.3), kind=integers(0, 3),
        n_polys=integers(1, MAX_POLYS + 1), n_verts=integers(3, MAX_VERTS + 1, MAX_POLYS),
        centers=inside(MAX_POLYS), radii=uniform(rmax * 0.3, rmax, MAX_POLYS, MAX_VERTS),
        angles=uniform(0.0, 2 * math.pi, MAX_POLYS, MAX_VERTS), poly_shades=uniform(0.4, 1.0, MAX_POLYS),
        n_lines=integers(2, MAX_LINES + 1), ends=inside(MAX_LINES, 2), line_shades=uniform(0.4, 1.0, MAX_LINES),
        rows=integers(3, MAX_CB + 1), cols=integers(3, MAX_CB + 1),
        cell=uniform(min(height, width) / 16, min(height, width) / 8), corner=uniform(0.0, 1.0, 2),
        board_shades=uniform(0.6, 1.0, MAX_CB, MAX_CB),
    )


def _paint(masks, shades):
    """Paint (B, S, H, W) masks with (B, S) shades in order: the last one
    painted wins. Returns the image and the union of the masks."""
    img = torch.zeros(masks.shape[0], *masks.shape[2:], device=masks.device)
    for s in range(masks.shape[1]):
        img = torch.where(masks[:, s], shades[:, s, None, None], img)
    return img, masks.any(dim=1)


def _polygons(d: SyntheticDraws, xs, ys):
    angles = torch.sort(d.angles, dim=-1).values
    verts = torch.stack([d.centers[..., 0:1] + d.radii * torch.cos(angles),
                         d.centers[..., 1:2] + d.radii * torch.sin(angles)], dim=-1)  # (B, P, V, 2)
    # slots past a polygon's vertex count wrap around, so their triangles repeat real ones
    vid = torch.arange(MAX_VERTS, device=verts.device)
    nv = d.n_verts[..., None]

    def take(i):
        return torch.gather(verts, 2, (i % nv)[..., None].expand(-1, -1, -1, 2))[..., None, None, :]

    a, b = take(vid), take(vid + 1)  # (B, P, V, 1, 1, 2)
    c = d.centers[:, :, None, None, None, :]

    def cross(o, e):
        return (e[..., 0] - o[..., 0]) * (ys - o[..., 1]) - (e[..., 1] - o[..., 1]) * (xs - o[..., 0])

    s1, s2, s3 = cross(a, b), cross(b, c), cross(c, a)
    tri = ((s1 >= 0) & (s2 >= 0) & (s3 >= 0)) | ((s1 <= 0) & (s2 <= 0) & (s3 <= 0))
    live = torch.arange(MAX_POLYS, device=verts.device) < d.n_polys[:, None]  # (B, P)
    img, painted = _paint(tri.any(dim=2) & live[..., None, None], d.poly_shades)
    pts_mask = (vid < nv) & live[..., None]
    return img, painted, verts.reshape(verts.shape[0], -1, 2), pts_mask.reshape(verts.shape[0], -1)


def _lines(d: SyntheticDraws, xs, ys):
    p0, p1 = d.ends[:, :, 0, None, None, :], d.ends[:, :, 1, None, None, :]  # (B, L, 1, 1, 2)
    e = p1 - p0
    len2 = (e * e).sum(dim=-1).clamp_min(1e-6)
    t = (((xs - p0[..., 0]) * e[..., 0] + (ys - p0[..., 1]) * e[..., 1]) / len2).clamp(0.0, 1.0)
    near = torch.hypot(xs - (p0[..., 0] + t * e[..., 0]), ys - (p0[..., 1] + t * e[..., 1])) <= 1.0
    live = torch.arange(MAX_LINES, device=xs.device) < d.n_lines[:, None]
    img, painted = _paint(near & live[..., None, None], d.line_shades)
    return img, painted, d.ends.reshape(d.ends.shape[0], -1, 2), live.repeat_interleave(2, dim=1)


def _checkerboard(d: SyntheticDraws, xs, ys, height: int, width: int):
    margin = float(_margin(height, width))
    cell = torch.floor(d.cell.clamp_min(4.0))[:, None, None]
    size = torch.tensor([width, height], dtype=torch.float32, device=xs.device)
    top = (size - MAX_CB * cell[:, 0] - margin).clamp_min(margin + 1.0)  # (B, 2): the corner's range ends
    corner = torch.floor((d.corner * (top - margin) + margin).clamp_min(margin))
    x0, y0 = corner[:, 0, None, None], corner[:, 1, None, None]
    c = torch.floor((xs - x0) / cell).long()
    r = torch.floor((ys - y0) / cell).long()
    rows, cols = d.rows[:, None, None], d.cols[:, None, None]
    board = (c >= 0) & (c < cols) & (r >= 0) & (r < rows) & ((r + c) % 2 == 0)
    b = torch.arange(d.cell.shape[0], device=xs.device)[:, None, None]
    shade = d.board_shades[b, r.clamp(0, MAX_CB - 1), c.clamp(0, MAX_CB - 1)]
    img = torch.where(board, shade, 0.0)
    gi = torch.arange(MAX_CB + 1, device=xs.device)
    gy, gx = torch.meshgrid(gi, gi, indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    pts = torch.stack([x0[:, :, 0] + gx * cell[:, :, 0], y0[:, :, 0] + gy * cell[:, :, 0]], dim=-1)
    return img, board, pts, (gx <= d.cols[:, None]) & (gy <= d.rows[:, None])


def _pad(pts, mask, max_points: int):
    extra = max_points - pts.shape[1]
    return (torch.cat([pts, pts.new_zeros(pts.shape[0], extra, 2)], 1),
            torch.cat([mask, mask.new_zeros(mask.shape[0], extra)], 1))


def rasterise_synthetic(draws: SyntheticDraws, height: int, width: int, max_points: int = 64) -> dict:
    """The batch of `draws`: {image (B, H, W, 1) f32 in [0, 1], points
    (B, max_points, 2) (x, y), points_mask (B, max_points)}."""
    if max_points < max(MAX_POLYS * MAX_VERTS, MAX_LINES * 2, (MAX_CB + 1) ** 2):
        raise ValueError(f"max_points={max_points} too small")
    dev = draws.background.device
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    families = [_polygons(draws, xs, ys), _lines(draws, xs, ys), _checkerboard(draws, xs, ys, height, width)]
    families = [(f_img, f_painted, *_pad(f_pts, f_mask, max_points)) for f_img, f_painted, f_pts, f_mask in families]
    own = (torch.arange(draws.kind.shape[0], device=dev), draws.kind)  # each sample's own family
    img, painted, pts, mask = (torch.stack(parts, dim=1)[own] for parts in zip(*families))
    img = torch.where(painted, img, draws.background[:, None, None])
    inb = (pts[..., 0] >= 0) & (pts[..., 0] < width) & (pts[..., 1] >= 0) & (pts[..., 1] < height)
    return {"image": img[..., None], "points": pts, "points_mask": mask & inb}


def synthetic_batch(gen: torch.Generator, batch_size: int, height: int, width: int, max_points: int = 64) -> dict:
    """A batch made on `gen`'s device: {image (B, H, W, 1), points, points_mask}."""
    return rasterise_synthetic(draw_synthetic(gen, batch_size, height, width), height, width, max_points)


def synthetic_sample(gen: torch.Generator, height: int, width: int, max_points: int = 64) -> dict:
    """One sample: {image (H, W, 1), points (P, 2), points_mask (P,)}."""
    return {k: v[0] for k, v in synthetic_batch(gen, 1, height, width, max_points).items()}
