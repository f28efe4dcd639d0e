"""Host-side plots: keypoint overlays and match plots — the counterpart of
`draw_keypoints`, `make_matching_plot` and `save_image` in
`image_matching_tpu/utils/viz.py`, in numpy.

The canvas, its layout and the colours are the JAX package's. Marks are
drawn by `imgproc.line` / `imgproc.circle`, OpenCV's 8-connected
rasterisers: OpenCV's anti-aliasing (`LINE_AA`), which the JAX package
asks for, is not reproduced, so pixels next to a mark may differ from its
plots. (`draw_tracks` and `heatmap_overlay` are not ported yet.)
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from image_matching_tpu_torch import imgproc

MARGIN = 10  # px of white between the two images of a match plot


def _to_bgr(img: np.ndarray) -> np.ndarray:
    """A float image in [0, 1], (H, W) or (H, W, 1) -> uint8 (H, W, 3) gray BGR."""
    img = np.asarray(img)
    if img.ndim == 3:
        img = img[..., 0]
    u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return np.repeat(u8[..., None], 3, axis=-1)


def _point(p, dx: int = 0):
    return int(round(float(p[0]))) + dx, int(round(float(p[1])))


def draw_keypoints(image: np.ndarray, xy: np.ndarray, mask: Optional[np.ndarray] = None,
                   color=(0, 255, 0), radius: int = 3) -> np.ndarray:
    """The image in BGR with a filled circle on each (valid) keypoint."""
    out = _to_bgr(image)
    for i, p in enumerate(np.asarray(xy)):
        if mask is None or mask[i]:
            imgproc.circle(out, _point(p), radius, color)
    return out


def make_matching_plot(image0: np.ndarray, image1: np.ndarray, xy0: np.ndarray, xy1: np.ndarray,
                       matches0: np.ndarray, scores0: Optional[np.ndarray] = None,
                       mask: Optional[np.ndarray] = None) -> np.ndarray:
    """The pair side by side on a white canvas (image 0 left, image 1 right
    of a `MARGIN`), each match a line from red (score 0) to green (score 1)
    with a dot at both ends. uint8 (max(H0, H1), W0 + MARGIN + W1, 3) BGR."""
    im0, im1 = _to_bgr(image0), _to_bgr(image1)
    (h0, w0), (h1, w1) = im0.shape[:2], im1.shape[:2]
    out = np.full((max(h0, h1), w0 + w1 + MARGIN, 3), 255, np.uint8)
    out[:h0, :w0] = im0
    out[:h1, w0 + MARGIN:] = im1
    xy0, xy1, m0 = np.asarray(xy0), np.asarray(xy1), np.asarray(matches0)
    sc = np.asarray(scores0) if scores0 is not None else np.ones(len(m0))
    for i, j in enumerate(m0):
        if j < 0 or (mask is not None and not mask[i]):
            continue
        p0, p1 = _point(xy0[i]), _point(xy1[j], w0 + MARGIN)
        c = float(np.clip(sc[i], 0, 1))
        color = (int(255 * (1 - c)), int(255 * c), 0)
        imgproc.line(out, p0, p1, color)
        imgproc.circle(out, p0, 2, color)
        imgproc.circle(out, p1, 2, color)
    return out


def save_image(path: str, image: np.ndarray) -> None:
    """cv2.imwrite of a uint8 gray or BGR image, as PNG."""
    imgproc.imwrite_png(path, image)
