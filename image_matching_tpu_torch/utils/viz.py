"""Host-side plots: keypoint overlays, match plots, track overlays and
heatmap overlays — the counterpart of `image_matching_tpu/utils/viz.py`
(`draw_keypoints`, `make_matching_plot`, `save_image`, `draw_tracks`,
`heatmap_overlay`), in numpy.

The canvas, its layout and the colours are the JAX package's. Marks are
drawn by `imgproc.line` / `imgproc.circle`, OpenCV's 8-connected
rasterisers: OpenCV's anti-aliasing (`LINE_AA`), which the JAX package
asks for, is not reproduced, so pixels next to a mark may differ from its
plots. In `draw_tracks`, every pixel painted is one that the JAX package's
anti-aliased stroke paints, in the track's colour at full weight; the JAX
package blends its pixels with the image by their coverage and paints a
fringe up to one pixel wider, which is not drawn here. OpenCV's two colour tables are
committed as they are: `JET_BGR` is `cv2.applyColorMap(0..255,
COLORMAP_JET)` and `HUE_BGR` is `cv2.cvtColor` HSV2BGR of (hue, 255, 255)
for the 180 hues (OpenCV 5.0; the tests hold both to cv2). Blending is
`cv2.addWeighted`'s: the weighted sum in float32, rounded to even.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from image_matching_tpu_torch import imgproc

MARGIN = 10  # px of white between the two images of a match plot

JET_BGR = np.frombuffer(bytes.fromhex(
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000b00000b40000b80000bc0000"
    "c00000c40000c80000cc0000d00000d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc0000"
    "ff0000ff0400ff0800ff0c00ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00"
    "ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00ff7000ff7400ff7800ff7c00"
    "ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00"
    "ffc000ffc400ffc800ffcc00ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2eceff32caff36c6ff3ac2ff3e"
    "beff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e"
    "7eff827aff8676ff8a72ff8e6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe"
    "3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee0efff20afff606fffa01fffe"
    "00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff"
    "00bcff00b8ff00b4ff00b0ff00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff004cff0048ff0044ff0040ff"
    "003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff"
    "0000fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0"
    "0000bc0000b80000b40000b00000ac0000a80000a40000a000009c00009800009400009000008c000088000084000080"), np.uint8).reshape(-1, 3)
HUE_BGR = np.frombuffer(bytes.fromhex(
    "0000ff0008ff0010ff0019ff0021ff002aff0033ff003bff0043ff004cff0055ff005dff0066ff006eff0077ff007fff"
    "0088ff0090ff0099ff00a1ff00aaff00b2ff00bbff00c3ff00ccff00d4ff00ddff00e5ff00eeff00f6ff00ffff00fff6"
    "00ffed00ffe500ffdc00ffd400ffcb00ffc300ffba00ffb200ffa900ffa100ff9800ff9000ff8700ff7f00ff7600ff6e"
    "00ff6500ff5d00ff5400ff4c00ff4300ff3b00ff3200ff2a00ff2100ff1900ff1000ff0800ff0008ff0011ff0019ff00"
    "22ff002aff0033ff003bff0044ff004cff0055ff005dff0066ff006eff0077ff007fff0088ff0090ff0099ff00a1ff00"
    "aaff00b2ff00bbff00c3ff00ccff00d4ff00ddff00e5ff00eeff00f6ff00fffe00fff600ffed00ffe500ffdc00ffd400"
    "ffcb00ffc300ffba00ffb200ffa900ffa100ff9800ff9000ff8700ff7f00ff7600ff6e00ff6500ff5d00ff5400ff4c00"
    "ff4300ff3b00ff3200ff2a00ff2100ff1900ff1000ff0800ff0000ff0008ff0011ff0019ff0022ff002aff0033ff003b"
    "ff0044ff004cff0055ff005dff0066ff006eff0077ff007fff0088ff0090ff0099ff00a1ff00aaff00b2ff00bbff00c3"
    "ff00ccff00d4ff00ddff00e5ff00eeff00f6fe00fff600ffed00ffe500ffdc00ffd400ffcb00ffc300ffba00ffb200ff"
    "aa00ffa100ff9900ff9000ff8800ff7f00ff7700ff6e00ff6600ff5d00ff5500ff4c00ff4400ff3b00ff3300ff2a00ff"
    "2200ff1900ff1100ff0800ff"), np.uint8).reshape(-1, 3)


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


def draw_tracks(image: np.ndarray, tracks, color_by_id: bool = True) -> np.ndarray:
    """Polylines of multi-frame tracks over the newest frame, in BGR, a dot
    on each track's last point. `tracks` is `models/tracker.get_tracks`'
    output: [(track_id, [(frame, x, y), ...])]; a track's colour is hue
    (37 id) mod 180 at full saturation and value, or green."""
    out = _to_bgr(image)
    for tid, obs in tracks:
        color = tuple(int(c) for c in HUE_BGR[(tid * 37) % 180]) if color_by_id else (0, 255, 0)
        pts = [_point((x, y)) for _, x, y in obs]
        for p0, p1 in zip(pts[:-1], pts[1:]):
            imgproc.line(out, p0, p1, color)
        imgproc.circle(out, pts[-1], 2, color)
    return out


def heatmap_overlay(image: np.ndarray, heatmap: np.ndarray) -> np.ndarray:
    """The detector heatmap (H, W) or (H, W, 1), scaled to its maximum,
    through the JET colour table, blended over the image: 0.6 image + 0.4
    colour, uint8 (H, W, 3) BGR."""
    base = _to_bgr(image)
    hm = np.asarray(heatmap)
    if hm.ndim == 3:
        hm = hm[..., 0]
    hm = np.clip(hm / (hm.max() + 1e-9) * 255.0, 0, 255).astype(np.uint8)
    blend = base.astype(np.float32) * np.float32(0.6) + JET_BGR[hm].astype(np.float32) * np.float32(0.4)
    return np.clip(np.rint(blend), 0, 255).astype(np.uint8)
