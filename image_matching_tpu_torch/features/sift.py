"""DoG / SIFT detector and descriptor (Lowe, IJCV 2004) — the counterpart
of `image_matching_tpu/features/sift.py`, batched over images.

The pyramid is built with separable convolutions, scale-space extrema
are found with 3x3 max pools, and refinement, orientation and descriptor
extraction are fixed-K gathers: `per_octave_cap` candidates an octave,
`max_keypoints` kept in all. As in the JAX package:

  * the doubled first octave (`first_octave=-1`): the image is upscaled
    2x by `ops/resize.resize_linear`;
  * 3D quadratic extremum interpolation with `refine_iters`
    re-localisation steps (a fixed count with masks), the interpolated
    contrast test |D^| >= contrast_threshold / scales_per_octave and the
    edge test;
  * per-layer gradient maps: orientation and descriptor sample the layer
    each keypoint lives in;
  * up to two orientations a keypoint (the 0.8-peak rule on the smoothed
    36-bin histogram, with parabolic interpolation);
  * 4x4x8 descriptors with trilinear binning, clipped at 0.2 and
    renormalised.

Top-k keeps `lax.top_k`'s order among equal values (`ops/topk.py`); the
histograms are scatter-adds (`index_add_`), whose float32 sum order on
the card varies from run to run. The blurs are sums of shifted copies
(`separable_filter`), so the pyramid has the same bits on the card and on
the CPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from image_matching_tpu_torch.ops.nms import max_pool_2d
from image_matching_tpu_torch.ops.resize import resize_linear
from image_matching_tpu_torch.ops.sampling import bilinear_sample
from image_matching_tpu_torch.ops.topk import topk_lower_index_first
from image_matching_tpu_torch.structs import Keypoints


class SIFTConfig(NamedTuple):
    n_octaves: int = 5  # counted from `first_octave` (-1..3 by default)
    scales_per_octave: int = 3  # DoG layers searched per octave
    sigma0: float = 1.6
    contrast_threshold: float = 0.04  # |D^| >= contrast_threshold / scales_per_octave
    edge_threshold: float = 10.0
    max_keypoints: int = 1024
    per_octave_cap: int = 512
    descriptor_width: int = 4  # 4x4 spatial bins
    descriptor_bins: int = 8  # orientation bins -> 128-d
    refine_iters: int = 3  # quadratic re-localisation steps
    ori_peak_ratio: float = 0.8  # secondary-orientation threshold
    first_octave: int = -1  # -1: upscale 2x before the pyramid, as OpenCV
    init_sigma: float = 0.5  # assumed blur of the input image


_BORDER = 8  # descriptor-window border guard, pixels (octave coords)
_ORI_GRID = 8  # the orientation window is a (2 * 8 + 1)^2 unit grid
_N_ORI_BINS = 36


def _gauss_kernel(sigma: float):
    radius = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def separable_filter(img, taps):
    """Zero-padded ("SAME") separable filter of (B, H, W) by the float32
    kernel `taps` (odd length): columns, then rows, each a sum of shifted
    copies in tap order. Elementwise float32 products and sums give the
    same bits on any device and for any batch, which a library
    convolution does not promise."""
    taps = taps.tolist()
    r = (len(taps) - 1) // 2
    h, w = img.shape[1:]
    x = F.pad(img, (0, 0, r, r))
    acc = x[:, :h] * taps[0]
    for i in range(1, len(taps)):
        acc = acc + x[:, i:i + h] * taps[i]
    x = F.pad(acc, (r, r))
    acc = x[..., :w] * taps[0]
    for i in range(1, len(taps)):
        acc = acc + x[..., i:i + w] * taps[i]
    return acc


def _blur(img, sigma: float):
    """Separable gaussian blur of (B, H, W) with zero padding, as the JAX
    package's two "SAME" convolutions (columns, then rows)."""
    return separable_filter(img, _gauss_kernel(sigma))


def _gather_cube(dogs, l, y, x):
    """27-neighbourhood of each (layer, y, x) of the (B, S+2, H, W) DoG
    stacks -> (B, K, 3, 3, 3) ordered [dl, dy, dx], indices clipped."""
    b, n_l, h, w = dogs.shape
    d = torch.arange(-1, 2, device=dogs.device)
    li = (l[..., None, None, None] + d[:, None, None]).clamp(0, n_l - 1)
    yi = (y[..., None, None, None] + d[None, :, None]).clamp(0, h - 1)
    xi = (x[..., None, None, None] + d[None, None, :]).clamp(0, w - 1)
    lin = (li * h + yi) * w + xi
    return torch.gather(dogs.reshape(b, -1), 1, lin.reshape(b, -1)).reshape(lin.shape)


def _fit_quadratic(cube):
    """3D gradient, Hessian and -H^-1 g offset of the centre sample of
    (..., 3, 3, 3) cubes ordered [s, y, x]. Returns (offset (..., 3) in
    [x, y, s] order, gradient (..., 3), centre values, (dxx, dyy, dxy))."""
    c = cube[..., 1, 1, 1]
    ds = (cube[..., 2, 1, 1] - cube[..., 0, 1, 1]) / 2.0
    dy = (cube[..., 1, 2, 1] - cube[..., 1, 0, 1]) / 2.0
    dx = (cube[..., 1, 1, 2] - cube[..., 1, 1, 0]) / 2.0
    dss = cube[..., 2, 1, 1] + cube[..., 0, 1, 1] - 2 * c
    dyy = cube[..., 1, 2, 1] + cube[..., 1, 0, 1] - 2 * c
    dxx = cube[..., 1, 1, 2] + cube[..., 1, 1, 0] - 2 * c
    dxy = (cube[..., 1, 2, 2] - cube[..., 1, 2, 0] - cube[..., 1, 0, 2] + cube[..., 1, 0, 0]) / 4.0
    dxs = (cube[..., 2, 1, 2] - cube[..., 2, 1, 0] - cube[..., 0, 1, 2] + cube[..., 0, 1, 0]) / 4.0
    dys = (cube[..., 2, 2, 1] - cube[..., 2, 0, 1] - cube[..., 0, 2, 1] + cube[..., 0, 0, 1]) / 4.0
    grad = torch.stack([dx, dy, ds], -1)
    hess = torch.stack([torch.stack([dxx, dxy, dxs], -1), torch.stack([dxy, dyy, dys], -1),
                        torch.stack([dxs, dys, dss], -1)], -2)
    # the ridge keeps near-singular Hessians solvable; their offsets explode
    # and the |offset| > 1.5 rejection discards them. solve_ex: no host check
    eye = torch.eye(3, dtype=hess.dtype, device=hess.device) * 1e-8
    offset = -torch.linalg.solve_ex(hess + eye, grad[..., None])[0][..., 0]
    return offset, grad, c, (dxx, dyy, dxy)


def _octave_keypoints(dogs, cfg: SIFTConfig, cap: int):
    """Detect and refine the scale-space extrema of one octave's (B, S+2,
    H, W) DoG stacks. Returns (x, y) subpixel octave coords, integer layer,
    sigma offset, |D^| score and validity, each (B, cap)."""
    b, n_l, h, w = dogs.shape
    s_mid = n_l - 2
    thr_final = cfg.contrast_threshold / cfg.scales_per_octave
    maxp = max_pool_2d(dogs.reshape(b * n_l, h, w), 3).reshape(dogs.shape)
    minp = -max_pool_2d(-dogs.reshape(b * n_l, h, w), 3).reshape(dogs.shape)

    mids = dogs[:, 1:-1]
    is_max = (mids >= maxp[:, :-2]) & (mids >= maxp[:, 2:]) & (mids == maxp[:, 1:-1])
    is_min = (mids <= minp[:, :-2]) & (mids <= minp[:, 2:]) & (mids == minp[:, 1:-1])
    # prefilter at half the final interpolated-contrast threshold (OpenCV)
    extremum = (is_max | is_min) & (mids.abs() > 0.5 * thr_final)
    bd = _BORDER
    ys = torch.arange(h, device=dogs.device)[:, None]
    xs = torch.arange(w, device=dogs.device)[None, :]
    extremum = extremum & ((ys >= bd) & (ys < h - bd) & (xs >= bd) & (xs < w - bd))

    resp = torch.where(extremum, mids.abs(), 0.0)
    scores0, idx = topk_lower_index_first(resp.reshape(b, -1), cap)
    layer = idx // (h * w) + 1  # DoG stack index (1..S)
    rem = idx % (h * w)
    yy, xx = rem // w, rem % w
    valid = scores0 > 0

    # 3D quadratic refinement with re-localisation (Lowe 4; OpenCV
    # adjustLocalExtrema): a fixed count of steps, unconverged -> rejected
    offset = torch.zeros((b, cap, 3), device=dogs.device)
    converged = torch.zeros((b, cap), dtype=torch.bool, device=dogs.device)
    for _ in range(cfg.refine_iters):
        off_new = _fit_quadratic(_gather_cube(dogs, layer, yy, xx))[0]
        done = (off_new.abs() < 0.5).all(-1)
        move = torch.round(off_new.clamp(-1.0, 1.0)).long()
        keep = converged | done
        xx = torch.where(keep, xx, (xx + move[..., 0]).clamp(bd, w - 1 - bd))
        yy = torch.where(keep, yy, (yy + move[..., 1]).clamp(bd, h - 1 - bd))
        layer = torch.where(keep, layer, (layer + move[..., 2]).clamp(1, s_mid))
        offset = torch.where(converged[..., None], offset, off_new)
        converged = keep
    # the final fit at the settled location
    offset, grad, center, (dxx, dyy, dxy) = _fit_quadratic(_gather_cube(dogs, layer, yy, xx))
    in_range = (offset.abs() < 1.5).all(-1)
    offset = offset.clamp(-0.5, 0.5)

    # interpolated contrast |D^| = |D + g . offset / 2|
    g_dot = grad[..., 0] * offset[..., 0] + grad[..., 1] * offset[..., 1] + grad[..., 2] * offset[..., 2]
    contrast = center + 0.5 * g_dot
    ok_contrast = contrast.abs() >= thr_final

    # edge response at the refined location (2D spatial Hessian ratio)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = cfg.edge_threshold
    ok_edge = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

    valid = valid & converged & in_range & ok_contrast & ok_edge
    x_sub = xx.float() + offset[..., 0]
    y_sub = yy.float() + offset[..., 1]
    return x_sub, y_sub, layer, offset[..., 2], contrast.abs(), valid


def _sample_layer(stack, lsel, coords):
    """Bilinear samples of each keypoint's own layer: stack (B, H, W, S),
    lsel (B, K) the layer, coords (B, K, P, 2) (x, y) -> (B, K, P); taps
    outside the image read zero. (The JAX package picks the layer by a
    one-hot product, which gives these values exactly.)"""
    b, k, p = coords.shape[:3]
    vals = bilinear_sample(stack, coords.reshape(b, k * p, 2)).reshape(b, k, p, -1)
    return torch.gather(vals, -1, lsel[:, :, None, None].expand(b, k, p, 1))[..., 0]


def _orientation_histograms(gmag_s, gori_s, x, y, lsel, scl):
    """Smoothed 36-bin orientation histograms (B, K, 36). gmag_s / gori_s:
    (B, H, W, S) per-layer gradient stacks; lsel (B, K) the layer; scl
    (B, K) the keypoint's sigma in the octave. The window's unit grid is
    scaled by 4.5 sigma / 8 px, so its gaussian weight is the same in unit
    coordinates for every keypoint."""
    r = _ORI_GRID
    dev = x.device
    steps = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    dy, dx = torch.meshgrid(steps, steps, indexing="ij")
    offs = torch.stack([dx, dy], -1).reshape(-1, 2)  # (P, 2) unit coords
    spacing = (4.5 / r) * scl
    coords = torch.stack([x, y], -1)[:, :, None, :] + offs * spacing[..., None, None]
    mag = _sample_layer(gmag_s, lsel, coords)
    ori = _sample_layer(gori_s, lsel, coords)
    w_u = torch.exp(-(offs ** 2).sum(-1) * (4.5 / r) ** 2 / (2 * 1.5 ** 2))

    nbins = _N_ORI_BINS
    fbin = (ori + math.pi) / (2 * math.pi) * nbins
    b0 = torch.floor(fbin).long() % nbins
    f = fbin - torch.floor(fbin)
    wv = mag * w_u
    b, k = x.shape
    rows = torch.arange(b * k, device=dev)[:, None] * nbins
    hist = torch.zeros(b * k * nbins, device=dev)
    hist.index_add_(0, (rows + b0.reshape(b * k, -1)).reshape(-1), (wv * (1 - f)).reshape(-1))
    hist.index_add_(0, (rows + (b0.reshape(b * k, -1) + 1) % nbins).reshape(-1), (wv * f).reshape(-1))
    hist = hist.reshape(b, k, nbins)
    # circular [1, 4, 6, 4, 1] / 16 smoothing (OpenCV calcOrientationHist)
    smooth = None
    for t, c in zip(range(-2, 3), (1.0, 4.0, 6.0, 4.0, 1.0)):
        term = (c / 16.0) * torch.roll(hist, -t, -1)  # term[b] = hist[(b + t) % 36]
        smooth = term if smooth is None else smooth + term
    return smooth


def _orientation_peaks(hist, peak_ratio: float):
    """Primary and secondary (0.8-peak rule) orientations with parabolic
    bin interpolation. Returns (theta1, theta2, has2)."""
    nbins = hist.shape[-1]
    left, right = torch.roll(hist, 1, -1), torch.roll(hist, -1, -1)
    is_peak = (hist > left) & (hist > right)

    def at(b):
        return torch.gather(hist, -1, (b % nbins)[..., None])[..., 0]

    def interp_theta(b):
        h0, h1, h2 = at(b - 1), at(b), at(b + 1)
        di = (0.5 * (h0 - h2) / torch.clamp_min(h0 - 2 * h1 + h2, 1e-12)).clamp(-0.5, 0.5)
        fb = b.float() + 0.5 + di
        return fb / nbins * 2 * math.pi - math.pi

    b1 = hist.argmax(-1)
    v1 = at(b1)
    # exclude the primary peak and its neighbours, then the best remaining peak
    dist = (torch.arange(nbins, device=hist.device) - b1[..., None]).abs()
    dist = torch.minimum(dist, nbins - dist)
    cand = torch.where(is_peak & (dist > 1), hist, -1.0)
    b2 = cand.argmax(-1)
    v2 = torch.gather(cand, -1, b2[..., None])[..., 0]
    return interp_theta(b1), interp_theta(b2), v2 >= peak_ratio * v1


def _descriptor(gmag_s, gori_s, x, y, lsel, theta, scl, cfg: SIFTConfig):
    """128-d descriptors (B, K, 128) with trilinear soft binning (Lowe 6 /
    OpenCV calcSIFTDescriptor): 4x4 spatial x 8 orientation bins over a
    rotated 16x16 sample grid, 3 sigma px a bin, gaussian-weighted,
    normalised, clipped at 0.2, renormalised."""
    d, nbins = cfg.descriptor_width, cfg.descriptor_bins
    dev = x.device
    lin = (torch.arange(d * 4, dtype=torch.float32, device=dev) + 0.5) / 4.0 - d / 2.0
    sy, sx = torch.meshgrid(lin, lin, indexing="ij")
    ox, oy = sx.reshape(-1), sy.reshape(-1)  # (P,) bin units

    ct, st = torch.cos(theta), torch.sin(theta)
    hist_width = (3.0 * scl)[..., None]
    rx = (ox * ct[..., None] + oy * (-st)[..., None]) * hist_width
    ry = (ox * st[..., None] + oy * ct[..., None]) * hist_width
    coords = torch.stack([x[..., None] + rx, y[..., None] + ry], -1)
    mag = _sample_layer(gmag_s, lsel, coords)
    ori = _sample_layer(gori_s, lsel, coords) - theta[..., None]

    w_g = torch.exp(-(ox ** 2 + oy ** 2) / (0.5 * d * d))
    wv = mag * w_g  # (B, K, P)

    rbin = oy + (d - 1) / 2.0
    cbin = ox + (d - 1) / 2.0
    obin = (ori + math.pi) / (2 * math.pi) * nbins
    r0, c0, o0 = torch.floor(rbin), torch.floor(cbin), torch.floor(obin)
    fr, fc, fo = rbin - r0, cbin - c0, obin - o0
    r0i, c0i, o0i = r0.long(), c0.long(), o0.long()

    b, k = x.shape
    n_flat = d * d * nbins
    rows = torch.arange(b * k, device=dev).reshape(b, k, 1) * n_flat
    acc = torch.zeros(b * k * n_flat, device=dev)
    for dr in (0, 1):
        rr = r0i + dr
        wr = 1 - fr if dr == 0 else fr
        ok_r = (rr >= 0) & (rr < d)
        for dc in (0, 1):
            cc = c0i + dc
            wc = 1 - fc if dc == 0 else fc
            ok_c = (cc >= 0) & (cc < d)
            ok = ok_r & ok_c
            for do in (0, 1):
                oo = (o0i + do) % nbins
                wo = 1 - fo if do == 0 else fo
                idx = (rr * d + cc) * nbins + oo
                wgt = wv * wr * wc * wo * ok_r.float() * ok_c.float()
                acc.index_add_(0, (rows + torch.where(ok, idx, 0)).reshape(-1),
                               torch.where(ok, wgt, 0.0).reshape(-1))
    desc = acc.reshape(b, k, n_flat)
    desc = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-12)
    desc = desc.clamp_max(0.2)
    return desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-12)


def _gradients(gs, s: int):
    """Per-layer gradient magnitude and angle (B, H, W, S) of the
    searchable gaussian layers gs[1..s], central differences that wrap at
    the border (`jnp.roll`)."""
    g = torch.stack(gs[1:s + 1], dim=-1)
    gx = (torch.roll(g, -1, 2) - torch.roll(g, 1, 2)) / 2.0
    gy = (torch.roll(g, -1, 1) - torch.roll(g, 1, 1)) / 2.0
    return torch.sqrt(gx * gx + gy * gy), torch.atan2(gy, gx)


def _as_batch(image):
    """(B, H, W, 1) or (B, H, W) -> (B, H, W) float32."""
    if image.dim() == 4:
        image = image[..., 0]
    if image.dim() != 3:
        raise ValueError(f"expected images (B, H, W, 1) or (B, H, W), got {tuple(image.shape)}")
    return image.float()


def sift_detect_and_describe(image, cfg: SIFTConfig = SIFTConfig()) -> Keypoints:
    """Images (B, H, W, 1) or (B, H, W) grayscale in [0, 1] -> Keypoints
    with xy (B, K, 2) full-resolution pixels, score (B, K) the
    interpolated |DoG| contrast, mask (B, K) and 128-d desc (B, K, 128),
    K = `max_keypoints`. A keypoint with a >= 0.8-ratio secondary
    orientation peak appears twice (one per orientation), as in OpenCV.
    Each image of the batch gets what the JAX package's function gives it
    alone."""
    image = _as_batch(image)
    s = cfg.scales_per_octave
    k = 2.0 ** (1.0 / s)
    sigmas = [cfg.sigma0 * (k ** i) for i in range(s + 3)]

    sig_have = cfg.init_sigma
    if cfg.first_octave < 0:
        # bilinear 2x upscale (OpenCV doubles with INTER_LINEAR)
        image = resize_linear(image, (2 * image.shape[1], 2 * image.shape[2]))
        sig_have = 2.0 * cfg.init_sigma
    base = _blur(image, math.sqrt(max(cfg.sigma0 ** 2 - sig_have ** 2, 0.01)))
    parts = []
    for octave in range(cfg.n_octaves):
        if min(base.shape[1:]) < 32:
            break
        gs = [base]
        for i in range(1, s + 3):
            gs.append(_blur(gs[-1], math.sqrt(max(sigmas[i] ** 2 - sigmas[i - 1] ** 2, 1e-6))))
        dogs = torch.stack([gs[i + 1] - gs[i] for i in range(s + 2)], dim=1)

        xf, yf, layer, xi_s, score, valid = _octave_keypoints(dogs, cfg, cfg.per_octave_cap)
        gmag_s, gori_s = _gradients(gs, s)
        lsel = (layer - 1).clamp(0, s - 1)
        # sigma within the octave (OpenCV scl_octv), with the sub-scale offset
        scl = cfg.sigma0 * torch.pow(2.0, (layer.float() + xi_s) / s)

        hist = _orientation_histograms(gmag_s, gori_s, xf, yf, lsel, scl)
        th1, th2, has2 = _orientation_peaks(hist, cfg.ori_peak_ratio)
        factor = float(2 ** (octave + min(cfg.first_octave, 0)))
        for theta, v in ((th1, valid), (th2, valid & has2)):
            desc = _descriptor(gmag_s, gori_s, xf, yf, lsel, theta, scl, cfg)
            parts.append((torch.stack([xf, yf], -1) * factor, torch.where(v, score, 0.0), v, desc))
        base = gs[s][:, ::2, ::2]  # next octave's base (the 2 sigma0 layer)

    xy, score, valid, desc = (torch.cat([p[i] for p in parts], dim=1) for i in range(4))
    top, sel = topk_lower_index_first(torch.where(valid, score, -1.0), cfg.max_keypoints)
    mask = top > 0
    rows = torch.arange(xy.shape[0], device=xy.device)[:, None]
    return Keypoints(xy=xy[rows, sel], score=torch.where(mask, top, 0.0), mask=mask,
                     desc=desc[rows, sel] * mask[..., None])
