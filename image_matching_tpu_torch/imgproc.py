"""Image operations in numpy, with OpenCV's conventions: the JAX
package's pair makers, datasets and plots (`image_matching_tpu/
evaluation.py:28-209`, `data/datasets.py`, `utils/viz.py`) call `cv2`, and
the machine with the card has no OpenCV. Each function follows the OpenCV
routine it replaces closely enough that the same inputs give the same
images (the tests hold them to `cv2` itself):

  * `resize`: INTER_CUBIC (a = -0.75, half-pixel centres, clamped edges);
  * `resize_area`: INTER_AREA shrinking of uint8 images, both of OpenCV's
    routes (integer factors: block sums, 2 x 2 rounded half up, others by
    the float32 mean rounded half to even; other factors: the float32
    area-weight tables summed in OpenCV's order);
  * `gaussian_blur`: sigma only, ksize = round(8 sigma + 1) | 1 for float
    images, BORDER_REFLECT_101;
  * `warp_affine`, `warp_perspective`: bilinear, BORDER_CONSTANT 0, in the
    float32 arithmetic of OpenCV 5's warps (the inverse map rounded to
    float32, each row's term in float32, the column's by a fused
    multiply-add, perspective by a division; interpolation by three fused
    lerps; OpenCV 4's 1/32-px fixed point is gone there);
  * `get_perspective_transform`: the 8 x 8 linear system;
  * `fill_poly`, `line` (thickness 1-3), `circle`, `rectangle` (filled):
    the integer rasterisers of OpenCV's `drawing.cpp` (edge lists in 16.16
    fixed point, Bresenham lines, the midpoint circle), so that every
    pixel matches;
  * `imread_gray`: `cv2.imread(path, IMREAD_GRAYSCALE)` of 8-bit PNG and
    binary PGM / PPM files (zlib and struct, no image library);
    `imwrite_png` writes 8-bit gray or BGR PNG files.

Images are float32 (H, W) arrays unless a function says otherwise; the
drawing functions paint in place, on (H, W) or (H, W, C) images.
"""
from __future__ import annotations

import math
import re
import struct
import zlib

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _round(x):
    """cvRound: to nearest, ties to even (the FPU's default mode)."""
    return np.rint(x).astype(np.int64)


# ---------------------------------------------------------------- resize

def _cubic_weights(fx):
    a = np.float32(-0.75)
    one = np.float32(1)
    x1 = fx + one
    w0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    w1 = ((a + 2) * fx - (a + 3)) * fx * fx + one
    y = one - fx
    w2 = ((a + 2) * y - (a + 3)) * y * y + one
    return np.stack([w0, w1, w2, one - w0 - w1 - w2], axis=-1)


def _cubic_taps(n_src: int, n_dst: int):
    scale = 1.0 / (n_dst / n_src)
    fx = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(np.float32)
    idx = np.clip(sx[:, None] + np.arange(-1, 3)[None], 0, n_src - 1)
    return idx, _cubic_weights(fx).astype(np.float64)


def resize(src: np.ndarray, size) -> np.ndarray:
    """cv2.resize(src, (width, height), interpolation=cv2.INTER_CUBIC) of a
    float32 (H, W) image."""
    width, height = size
    xi, xw = _cubic_taps(src.shape[1], width)
    yi, yw = _cubic_taps(src.shape[0], height)
    rows = (src.astype(np.float64)[:, xi] * xw).sum(-1).astype(np.float32)  # (H_src, width)
    out = (rows.astype(np.float64)[yi] * yw[:, :, None]).sum(1)
    return out.astype(np.float32)


def _area_taps(n_src: int, n_dst: int, scale: float):
    """OpenCV's `computeResizeAreaTab`: for each destination pixel, the
    source pixels it covers and their float32 weights, in OpenCV's order,
    padded with weight-0 taps to one width ((n_dst, k) indices, weights)."""
    taps = []
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s2 = min(math.floor(f2), n_src - 1)
        s1 = min(math.ceil(f1), s2)
        row = [(s1 - 1, (s1 - f1) / cell)] if s1 - f1 > 1e-3 else []
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(f2 - s2, 1.0, cell) / cell))
        taps.append(row)
    idx = np.zeros((n_dst, max(map(len, taps))), np.int64)
    wt = np.zeros(idx.shape, np.float32)
    for d, row in enumerate(taps):
        for j, (s, a) in enumerate(row):
            idx[d, j], wt[d, j] = s, a
    return idx, wt


def _to_u8(x) -> np.ndarray:
    """saturate_cast<uchar> of float32 values: to nearest, ties to even."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _area_integer(img: np.ndarray, dh: int, dw: int, ix: int, iy: int) -> np.ndarray:
    """INTER_AREA at integer factors (OpenCV's `resizeAreaFast`): block
    sums; a whole 2 x 2 block rounds (sum + 2) >> 2 (the SIMD route), any
    other whole block sum * float32(1 / area) to nearest even, and the
    blocks cut by the image's edge their float32 mean."""
    h, w = img.shape
    integral = np.zeros((h + 1, w + 1), np.int64)
    integral[1:, 1:] = img.astype(np.int64).cumsum(0).cumsum(1)
    r0, c0 = np.arange(dh) * iy, np.arange(dw) * ix
    r1, c1 = np.minimum(r0 + iy, h), np.minimum(c0 + ix, w)
    sums = integral[r1][:, c1] - integral[r0][:, c1] - integral[r1][:, c0] + integral[r0][:, c0]
    counts = (r1 - r0)[:, None] * (c1 - c0)[None]
    if ix == iy == 2:
        whole = (sums + 2) >> 2
    else:
        whole = _to_u8(sums.astype(np.float32) * (np.float32(1) / np.float32(ix * iy)))
    cut = _to_u8(sums.astype(np.float32) / counts.astype(np.float32))
    return np.where(counts == ix * iy, whole, cut).astype(np.uint8)


def _area_general(img: np.ndarray, dh: int, dw: int, sx: float, sy: float) -> np.ndarray:
    """INTER_AREA at other factors (OpenCV's `ResizeArea_Invoker`): each
    source row summed over the x taps in float32, then the rows over the y
    taps, products rounded before each sum as OpenCV does."""
    xi, xw = _area_taps(img.shape[1], dw, sx)
    yi, yw = _area_taps(img.shape[0], dh, sy)
    src = img.astype(np.float32)
    rows = src[:, xi[:, 0]] * xw[:, 0]
    for j in range(1, xi.shape[1]):
        rows += src[:, xi[:, j]] * xw[:, j]
    out = yw[:, :1] * rows[yi[:, 0]]
    for j in range(1, yi.shape[1]):
        out += yw[:, j:j + 1] * rows[yi[:, j]]
    return _to_u8(out)


def resize_area(img: np.ndarray, size=None, scale=None) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_AREA) of a uint8 (H, W)
    image for `size=(h, w)`, or cv2.resize(img, None, fx=scale, fy=scale,
    interpolation=INTER_AREA) for `scale`: the output is round(H * scale) x
    round(W * scale), and the area weights follow `scale` itself, as
    OpenCV's do. Shrinks only (each factor <= 1)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"resize_area takes a uint8 (H, W) image, not {img.dtype} {img.shape}")
    if (size is None) == (scale is None):
        raise ValueError("resize_area: give size=(h, w) or scale, one of them")
    h, w = img.shape
    if size is not None:
        dh, dw = size
        fx, fy = dw / w, dh / h
    else:
        fx = fy = float(scale)
        dh, dw = int(np.rint(h * fy)), int(np.rint(w * fx))
    if not (0 < fx <= 1 and 0 < fy <= 1 and dh > 0 and dw > 0):
        raise ValueError(f"resize_area shrinks only: ({h}, {w}) -> ({dh}, {dw})")
    sx, sy = 1.0 / fx, 1.0 / fy
    ix, iy = int(np.rint(sx)), int(np.rint(sy))
    eps = np.finfo(np.float64).eps
    if abs(sx - ix) < eps and abs(sy - iy) < eps:
        return _area_integer(img, dh, dw, ix, iy)
    return _area_general(img, dh, dw, sx, sy)


# ---------------------------------------------------------------- blur

def gaussian_kernel(sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel for a float image's blur: ksize =
    round(8 sigma + 1) | 1, weights computed in float64 and stored as
    float32."""
    n = int(_round(sigma * 8 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (t / t.sum()).astype(np.float32)


def _filter_axis(img: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    r = len(k) // 2
    pad = [(0, 0), (0, 0)]
    pad[axis] = (r, r)
    p = np.pad(img, pad, mode="reflect")  # numpy's "reflect" is BORDER_REFLECT_101
    n = img.shape[axis]
    out = np.zeros(img.shape, np.float64)
    for i, w in enumerate(k.astype(np.float64)):
        out += w * (p[i:i + n] if axis == 0 else p[:, i:i + n])
    return out.astype(np.float32)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), sigma) of a float32 (H, W) image:
    rows, then columns, BORDER_REFLECT_101."""
    k = gaussian_kernel(sigma)
    return _filter_axis(_filter_axis(img.astype(np.float32), k, 1), k, 0)


# ---------------------------------------------------------------- warps

def _fma(a, b, c):
    """float32 a * b + c rounded once (the product of two float32 numbers is
    exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _bilinear(src: np.ndarray, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Bilinear samples of `src` at float32 source coordinates: the 2 x 2
    taps from (floor X, floor Y), taps outside the image read 0
    (BORDER_CONSTANT), two lerps along x and one along y."""
    h, w = src.shape
    ix, iy = np.floor(X).astype(np.int64), np.floor(Y).astype(np.int64)
    ax = (X - ix.astype(np.float32)).astype(np.float32)
    ay = (Y - iy.astype(np.float32)).astype(np.float32)

    def tap(dy, dx):
        xx, yy = ix + dx, iy + dy
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        return np.where(inside, src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)], np.float32(0))

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    f0, f1 = _fma(ax, p01 - p00, p00), _fma(ax, p11 - p10, p10)
    return _fma(ay, f1 - f0, f0)


def _grid(width: int, height: int, m):
    """Per pixel of the destination, each row of the (float32) inverse map
    `m` applied as OpenCV's warps do: the row's term m[1] y + m[2] in
    float32, then fma(m[0], x, row term)."""
    x = np.arange(width, dtype=np.float32)[None]
    y = np.arange(height, dtype=np.float32)[:, None]
    return [_fma(m[i], x, (m[i + 1] * y + m[i + 2]).astype(np.float32)) for i in range(0, len(m), 3)]


def invert_affine_transform(mat: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform of a float32 (2, 3) matrix, as OpenCV 5.0
    computes it (found by probing): the determinant, its reciprocal and the
    2x2 inverse in float32, the translation from those in float64, rounded
    to float32; 0 where the matrix is singular."""
    f = np.asarray(mat, np.float32).reshape(6)
    det = np.float32(np.float32(f[0] * f[4]) - np.float32(f[1] * f[3]))
    d = np.float32(1) / det if det != 0 else np.float32(0)
    a11, a22, a12, a21 = (np.float32(x) for x in (f[4] * d, f[0] * d, -f[1] * d, -f[3] * d))
    m2, m5 = np.float64(f[2]), np.float64(f[5])
    b1 = -np.float64(a11) * m2 - np.float64(a12) * m5
    b2 = -np.float64(a21) * m2 - np.float64(a22) * m5
    return np.array([[a11, a12, b1], [a21, a22, b2]]).astype(np.float32)


def warp_affine(src: np.ndarray, mat: np.ndarray, size) -> np.ndarray:
    """cv2.warpAffine(src, mat, (width, height)): `mat` (2, 3) maps source
    to destination; bilinear, BORDER_CONSTANT 0. The inverse map is
    computed in float64 as OpenCV does, then rounded to float32."""
    m = np.asarray(mat, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    X, Y = _grid(*size, m.astype(np.float32))
    return _bilinear(src.astype(np.float32), X, Y)


def warp_perspective(src: np.ndarray, hom: np.ndarray, size) -> np.ndarray:
    """cv2.warpPerspective(src, hom, (width, height)): `hom` (3, 3) maps
    source to destination; bilinear, BORDER_CONSTANT 0."""
    X, Y, Wt = _grid(*size, np.linalg.inv(np.asarray(hom, np.float64)).astype(np.float32).reshape(9))
    with np.errstate(divide="ignore", invalid="ignore"):
        X, Y = X / Wt, Y / Wt
    return _bilinear(src.astype(np.float32), X, Y)


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """cv2.getPerspectiveTransform: the (3, 3) float64 homography taking
    the four points `src` to `dst`, with H[2, 2] = 1."""
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(np.asarray(src, np.float64), np.asarray(dst, np.float64))):
        a[i] = (x, y, 1, 0, 0, 0, -x * u, -y * u)
        a[i + 4] = (0, 0, 0, x, y, 1, -x * v, -y * v)
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


# ---------------------------------------------------------------- drawing

def _hline(img, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """cv::clipLine: (inside, x1, y1, x2, y2), the ends moved onto the
    image's edges as far as the clipping got (OpenCV moves them in place,
    also where it then finds the segment outside)."""
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(img, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """cv::Line: an 8-connected Bresenham segment (LineIterator, left to
    right), clipped to the image."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        step = err < 0
        err += -2 * dy + (2 * dx if step else 0)
        if vert:
            y += sy
            x += sx if step else 0
        else:
            x += sx
            y += sy if step else 0


def _line2(img, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """cv::Line2: an 8-connected segment between 16.16 fixed-point ends."""
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex_poly(img, pts, color) -> None:
    """cv::FillConvexPoly (LINE_8) of 16.16 fixed-point points: the outline
    by `_line2`, then spans between the two edge chains walked from the top
    vertex."""
    h, w = img.shape[:2]
    n = len(pts)
    half = XY_ONE >> 1
    for (x0, y0), (x1, y1) in zip(pts[-1:] + pts[:-1], pts):
        _line2(img, x0, y0, x1, y1, color)
    xs, ys = [p[0] for p in pts], [p[1] for p in pts]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + half) >> XY_SHIFT, (max(xs) + half) >> XY_SHIFT
    ymin, ymax = (min(ys) + half) >> XY_SHIFT, (max(ys) + half) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin), dict(idx=imin, di=n - 1, x=-XY_ONE, dx=0, ye=ymin)]
    left_edges = n
    y = ymin
    while True:
        for e in edges:
            if y >= e["ye"]:
                idx0, di = e["idx"], e["di"]
                idx = (idx0 + di) % n
                while True:
                    left_edges -= 1
                    if left_edges < 0:
                        break
                    ty = (pts[idx][1] + half) >> XY_SHIFT
                    if ty > y:
                        xs0, xe = pts[idx0][0], pts[idx][0]
                        e.update(ye=ty, dx=_tdiv((xe - xs0) * 2 + (ty - y), 2 * (ty - y)), x=xs0, idx=idx)
                        break
                    idx0, idx = idx, (idx + di) % n
        if left_edges < 0:
            break
        if y >= 0:
            left, right = sorted(edges, key=lambda e: e["x"])
            xx1, xx2 = (left["x"] + half) >> XY_SHIFT, (right["x"] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        for e in edges:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def circle(img, center, radius: int, color) -> None:
    """cv2.circle(img, center, radius, color, -1): the filled midpoint
    circle of OpenCV's `Circle`, spans clipped to the image."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for yy in (y11, y12):
                if 0 <= yy < h:
                    _hline(img, yy, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        _hline(img, yy, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def line(img, p0, p1, color, thickness: int = 1) -> None:
    """cv2.line(img, p0, p1, color, thickness) with LINE_8 and integer
    ends: a Bresenham segment at thickness 1; else the segment's
    rectangle, filled, with round caps (`ThickLine`)."""
    x0, y0 = int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT
    x1, y1 = int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT
    if thickness <= 1:
        r = XY_ONE >> 1
        _line8(img, (x0 + r) >> XY_SHIFT, (y0 + r) >> XY_SHIFT, (x1 + r) >> XY_SHIFT, (y1 + r) >> XY_SHIFT,
               color)
        return
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r2 = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r2) > np.finfo(np.float64).eps:
        r = (t + odd * XY_ONE * 0.5) / math.sqrt(r2)
        dpx, dpy = int(_round(dy * r)), int(_round(dx * r))
        pts = [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy), (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)]
        _fill_convex_poly(img, pts, color)
    for x, y in ((x0, y0), (x1, y1)):
        c = ((x + (XY_ONE >> 1)) >> XY_SHIFT, (y + (XY_ONE >> 1)) >> XY_SHIFT)
        circle(img, c, (t + (XY_ONE >> 1)) >> XY_SHIFT, color)


def fill_poly(img, pts, color) -> None:
    """cv2.fillPoly(img, [pts], color) for one polygon of integer points
    (LINE_8, shift 0), as OpenCV 5 rasterises it: each edge drawn as a
    `_line8` segment, and on every row the even-odd spans between the
    edges that cover it, a span taking the pixels whose centres lie within
    it (from ceil of the left edge's x to floor of the right one's). An edge
    is the line through its two points, or through its ends clipped to the
    image where it leaves the image; it covers the rows from its upper
    point's to just above its lower point's."""
    h, w = img.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []
    for (x0, y0), (x1, y1) in zip(pts[-1:] + pts[:-1], pts):
        _line8(img, x0, y0, x1, y1, color)
        if y0 == y1:
            continue
        ends = (x0, y0, x1, y1)
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            _, a, b, c, d = _clip_line(w, h, x0, y0, x1, y1)
            if b != d:
                ends = (a, b, c, d)
        edges.append((ends, min(y0, y1), max(y0, y1)))
    for y in range(max(min(p[1] for p in pts), 0), min(max(p[1] for p in pts), h)):
        xs = []  # (floor(x), ceil(x)) of each edge's exact x on this row
        for (xa, ya, xb, yb), top, bottom in edges:
            if top <= y < bottom:
                num, den = (xb - xa) * (y - ya), yb - ya
                if den < 0:
                    num, den = -num, -den
                xs.append((xa + num // den, xa - (-num // den)))
        xs.sort()
        for (_, left), (right, _) in zip(xs[0::2], xs[1::2]):
            if left < w and right >= 0:
                _hline(img, y, max(left, 0), min(right, w - 1), color)


def rectangle(img, p0, p1, color) -> None:
    """cv2.rectangle(img, p0, p1, color, -1): the filled rectangle with both
    corners included, clipped to the image."""
    h, w = img.shape[:2]
    (x0, x1), (y0, y1) = sorted((int(p0[0]), int(p1[0]))), sorted((int(p0[1]), int(p1[1])))
    if x1 >= 0 and y1 >= 0:
        img[max(y0, 0):min(y1, h - 1) + 1, max(x0, 0):min(x1, w - 1) + 1] = color


# ---------------------------------------------------------------- image files

READS = ("8-bit PNG (gray, gray + alpha, RGB, RGBA, palette; not interlaced) and binary PGM / PPM "
         "(P5 / P6, maxval <= 255)")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel


def _unsupported(path, what: str) -> ValueError:
    return ValueError(f"{path}: {what}; imread_gray reads {READS}")


def _png_chunks(data: bytes, path):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 12 > len(data):
            raise _unsupported(path, "truncated PNG")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body, crc = data[pos + 8:pos + 8 + n], data[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise _unsupported(path, f"damaged PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, width: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (None, Sub, Up, Average, Paeth) of (H,
    1 + W * bpp) filtered bytes; returns (H, W, bpp) uint8. A pixel depends
    on its left, upper and upper-left neighbours, so the anti-diagonals
    r + c = d are decoded one after another, each in one vector step."""
    h = rows.shape[0]
    kind = rows[:, 0].astype(np.int64)
    if kind.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {kind.max()} does not exist")
    x = rows[:, 1:].reshape(h, width, bpp).astype(np.int64)
    if not kind.any():
        return x.astype(np.uint8)
    out = np.zeros((h + 1, width + 1, bpp), np.int64)  # pixel (r, c) at [r + 1, c + 1]; zero frame
    for d in range(h + width - 1):
        r = np.arange(max(0, d - width + 1), min(h - 1, d) + 1)
        c = d - r
        left, up, corner = out[r + 1, c], out[r, c + 1], out[r, c]
        k = kind[r][:, None]
        pred = np.select([k == 0, k == 1, k == 2, k == 3], [0, left, up, (left + up) >> 1], _paeth(left, up, corner))
        out[r + 1, c + 1] = (x[r, c] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def _png_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's `png_do_rgb_to_gray` with the coefficients OpenCV sets
    (0.299, 0.587 -> 9797, 19234, 3737 of 32768), no gamma: the sum
    truncated, a pixel whose three samples are equal kept as it is."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    gray = (9797 * r + 19234 * g + 3737 * b) >> 15
    return np.where((r == g) & (g == b), r, gray).astype(np.uint8)


def _read_png(data: bytes, path) -> np.ndarray:
    chunks = list(_png_chunks(data, path))
    kinds = {kind: body for kind, body in reversed(chunks)}  # the first chunk of each type
    if chunks[0][0] != b"IHDR":
        raise _unsupported(path, "PNG without IHDR")
    w, h, depth, ctype, compression, filtering, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    bpp = _PNG_CHANNELS.get(ctype)
    if depth != 8 or bpp is None or interlace or compression or filtering:
        raise _unsupported(path, f"{depth}-bit PNG of colour type {ctype}" + (", interlaced" if interlace else ""))
    colour = ctype in (2, 3, 6)
    if colour and (b"sRGB" in kinds or b"iCCP" in kinds or kinds.get(b"gAMA", struct.pack(">I", 100000))
                   != struct.pack(">I", 100000)):
        # libpng would convert to gray through the file's gamma
        raise _unsupported(path, "colour PNG with a gamma or colour-space chunk (gAMA other than 1, sRGB, iCCP)")
    try:
        raw = zlib.decompress(b"".join(body for kind, body in chunks if kind == b"IDAT"))
    except zlib.error as err:
        raise _unsupported(path, f"damaged PNG image data ({err})") from err
    if len(raw) != h * (1 + w * bpp):
        raise _unsupported(path, "PNG whose image data does not fill its size")
    px = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp), w, bpp)
    if ctype == 3:
        palette = np.frombuffer(kinds.get(b"PLTE", b""), np.uint8).reshape(-1, 3)
        if px.max(initial=0) >= len(palette):
            raise _unsupported(path, "palette PNG with indices outside its palette")
        return _png_gray(palette[px[..., 0]])
    if ctype in (2, 6):
        return _png_gray(px)
    return px[..., 0].copy()  # gray; gray + alpha drops the alpha, as libpng's strip_alpha does


_PNM_HEADER = re.compile(rb"P([56])" + rb"(?:\s|#[^\n]*\n)+(\d+)" * 3 + rb"\s")


def _read_pnm(data: bytes, path) -> np.ndarray:
    """Binary PGM / PPM: magic, width, height and maxval, separated by
    whitespace and `#` comments, one whitespace byte, then the samples.
    maxval only bounds the samples: OpenCV does not rescale them."""
    m = _PNM_HEADER.match(data)
    if m is None:
        raise _unsupported(path, "damaged PGM / PPM header")
    w, h, maxval = (int(g) for g in m.groups()[1:])
    if not 0 < maxval <= 255:
        raise _unsupported(path, f"PGM / PPM with maxval {maxval}")
    ch = 1 if m.group(1) == b"5" else 3
    if len(data) - m.end() < h * w * ch:
        raise _unsupported(path, "truncated PGM / PPM")
    px = np.frombuffer(data, np.uint8, count=h * w * ch, offset=m.end()).reshape(h, w, ch)
    if ch == 1:
        return px[..., 0].copy()
    r, g, b = (px[..., i].astype(np.int64) for i in range(3))
    return ((4899 * r + 9617 * g + 1868 * b + 8192) >> 14).astype(np.uint8)  # OpenCV's RGB -> gray


def imread_gray(path) -> np.ndarray:
    """cv2.imread(path, IMREAD_GRAYSCALE) of the formats in `READS`: a
    uint8 (H, W) image. Colour turns gray as OpenCV's decoders do it (PNG
    through libpng's truncating fixed point, PPM through cvtColor's rounding
    one). Any other file raises a `ValueError` that names what is read; a
    missing one raises `FileNotFoundError`."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return _read_png(data, path)
    if data[:2] in (b"P5", b"P6"):
        return _read_pnm(data, path)
    raise _unsupported(path, "not a file of these formats")


def imwrite_png(path, img: np.ndarray) -> None:
    """cv2.imwrite(path, img) for a uint8 (H, W) gray or (H, W, 3) BGR image:
    an 8-bit gray or RGB PNG, rows unfiltered."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"imwrite_png takes uint8 (H, W) or (H, W, 3) BGR images, not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    px = img[..., ::-1] if img.ndim == 3 else img  # BGR -> RGB
    rows = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(px).reshape(h, -1)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if img.ndim == 3 else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
