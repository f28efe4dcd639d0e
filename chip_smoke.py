#!/usr/bin/env python3
"""Drive the PyTorch port (`image_matching_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

In order, it:
  1. prints the card (torch's name and count, and `nvidia-smi`'s name and
     power limit);
  2. builds the three CUDA kernels from `image_matching_tpu_torch/csrc/`
     (one `nvcc` each, in parallel) and prints `-Xptxas -v`;
  3. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes, and times kernel, plain version and one
     PyTorch yardstick with CUDA events;
  4. runs the headline configuration through `Matching` (480x640, batch
     4, K=1024, D=256, 18 GNN layers, 30 Sinkhorn iterations, bf16,
     seeded random weights, seeded uniform images), checks that the path
     launched every kernel, times it and compares it with the same model
     on the all-plain path;
  5. runs `MatchingConfig.self_trained_128()` with the banked
     `weights/sp_photo.npz` + `weights/sg_photo.npz` on a seeded textured
     image and its warp by a known homography.

Every check that fails raises; nothing is caught. TF32 is off for every
phase, timed ones included, so f32 convolutions and matmuls are full f32.
The last two lines are the kernels' numbers as JSON and the run's result
as JSON. Without a CUDA device, or without the package beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet), used only for the bounds below
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: check failed: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float, rate: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------- kernels

def check_entry_conv(torch, dev, rng):
    import torch.nn.functional as F
    from image_matching_tpu_torch.ops.entry_conv import entry_conv, entry_conv_plain

    b, h, w = 8, 480, 640  # the 2B-batched backbone input of the main path
    img = torch.from_numpy(rng.uniform(0, 1, (b, h, w)).astype("float32")).to(dev, torch.bfloat16)
    k = torch.from_numpy(rng.normal(0, 0.3, (3, 3, 1, 64)).astype("float32")).to(dev)
    scale = torch.from_numpy(rng.normal(1, 0.2, 64).astype("float32")).to(dev)
    shift = torch.from_numpy(rng.normal(0, 0.2, 64).astype("float32")).to(dev)
    got = entry_conv(img, k, scale, shift).float()
    ref = entry_conv_plain(img, k, scale, shift).float()
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    rel = ((got - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
    # same bf16-rounded inputs, f32 sums of 9 products in another order,
    # one final bf16 rounding each: at most one bf16 step (2^-7 relative)
    print(f"entry_conv (8, 480, 640) -> 64 bf16: max_abs_err {err:.3e}, "
          f"max err/max(|y|,1) {rel:.3e} (tolerance 2^-7 = {2 ** -7:.3e})")
    check(rel <= 2 ** -7, f"entry_conv disagrees with its plain version ({rel})")
    # f32 through the same kernel, at a smaller size
    img32 = img[:2].float()
    r32 = ((entry_conv(img32, k, scale, shift) - entry_conv_plain(img32, k, scale, shift)).abs().max().item())
    print(f"entry_conv (2, 480, 640) f32: max_abs_err {r32:.3e} (tolerance 1e-5)")
    check(r32 <= 1e-5, "entry_conv f32 disagrees with its plain version")

    w_lib = k.permute(3, 2, 0, 1).to(torch.bfloat16)
    sc, sh = scale.to(torch.bfloat16)[:, None, None], shift.to(torch.bfloat16)[:, None, None]
    x4 = img[:, None]
    lib = lambda: torch.relu(F.conv2d(x4, w_lib, padding=1) * sc + sh)
    ms = cuda_ms(lambda: entry_conv(img, k, scale, shift), 20)
    plain_ms = cuda_ms(lambda: entry_conv_plain(img, k, scale, shift), 5)
    lib_ms = cuda_ms(lib, 20)
    npix = b * h * w
    bms, by = bound(npix * 2 + npix * 64 * 2 + (9 + 2) * 64 * 4, npix * 64 * (2 * 9 + 2), F32_FLOPS)
    return dict(name="entry_conv", route="cuda", source="image_matching_tpu_torch/csrc/entry_conv.cu",
                replaces="image_matching_tpu/ops/pallas/entry_h.py:119", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)


def _attention_inputs(torch, dev, rng, b, n, h, dh, dtype=None):
    dtype = dtype or torch.bfloat16
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n, h * dh)).astype("float32")).to(dev, dtype)
               for _ in range(3))
    mask = torch.from_numpy(rng.uniform(size=(b, n)) < 0.8).to(dev)
    mask[:, 0] = True
    return q, k, v, mask


def check_attention(torch, dev, rng):
    import torch.nn.functional as F
    from image_matching_tpu_torch.ops.attention import attention, attention_plain

    results = {}
    for (b, n, h, dh) in ((4, 1024, 4, 64), (4, 1000, 4, 32), (2, 2048, 4, 64)):
        q, k, v, mask = _attention_inputs(torch, dev, rng, b, n, h, dh)
        if n == 1000:
            mask[-1] = False  # one batch element with no valid key
        got = attention(q, k, v, mask, h).float()
        ref = attention_plain(q, k, v, mask, h, "float32").float()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        # f32 logits and softmax on both sides; the plain version also
        # rounds the probabilities to bf16 before the value product:
        # a few bf16 steps of O(1) outputs
        print(f"attention ({b}, {n}, {h}x{dh}) bf16: max_abs_err {err:.3e} (tolerance 3e-2)")
        check(err <= 3e-2, f"attention ({b}, {n}, {h}x{dh}) disagrees with its plain version ({err})")
        results[(b, n, h, dh)] = (q, k, v, mask, err)

    b, n, h, dh = 4, 1024, 4, 64  # 36 calls of this shape per forward
    q, k, v, mask, err = results[(b, n, h, dh)]
    qh, kh, vh = (t.reshape(b, n, h, dh).transpose(1, 2).contiguous() for t in (q, k, v))
    m4 = mask[:, None, None, :]
    ms = cuda_ms(lambda: attention(q, k, v, mask, h), 20)
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, mask, h, "float32"), 10)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m4), 20)
    flops = 4.0 * b * h * n * n * dh
    bms, by = bound(4 * b * n * h * dh * 2 + b * n, flops, BF16_TENSOR_FLOPS)
    return dict(name="attention", route="cuda", source="image_matching_tpu_torch/csrc/attention.cu",
                replaces="image_matching_tpu/ops/pallas/attention.py:371", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)


def check_sinkhorn(torch, dev, rng):
    from image_matching_tpu_torch.ops.sinkhorn import BIG_NEG, log_sinkhorn, log_sinkhorn_plain

    b, m, iters = 4, 1025, 30
    z = torch.from_numpy(rng.normal(0, 3, (b, m, m)).astype("float32")).to(dev)
    mu = torch.full((b, m), -math.log(2 * (m - 1)), device=dev)
    nu = mu.clone()
    mu[:, -1] = nu[:, -1] = math.log(m - 1) - math.log(2 * (m - 1))
    # masked rows and columns, as log_optimal_transport builds them
    rows = torch.from_numpy(rng.uniform(size=(b, m - 1)) < 0.1).to(dev)
    cols = torch.from_numpy(rng.uniform(size=(b, m - 1)) < 0.1).to(dev)
    z[:, :-1][rows] = BIG_NEG
    z[:, :, :-1].masked_fill_(cols[:, None, :], BIG_NEG)
    mu[:, :-1][rows] = BIG_NEG
    nu[:, :-1][cols] = BIG_NEG
    got = log_sinkhorn(z, mu, nu, iters)
    ref = log_sinkhorn_plain(z, mu, nu, iters)
    torch.cuda.synchronize()
    real = (ref > -1e8) & (got > -1e8)
    check(bool(((ref > -1e8) == (got > -1e8)).all()), "sinkhorn: masked entries differ")
    err = (got - ref)[real].abs().max().item()
    # f32 on both sides, the same max-shifted logsumexp; sums in another
    # order over 30 iterations (masked entries, near -1e9, are compared
    # only for being masked: their f32 step is 64)
    print(f"sinkhorn (4, 1025, 1025) x 30 f32: max_abs_err {err:.3e} on unmasked entries (tolerance 1e-4)")
    check(err <= 1e-4, f"sinkhorn disagrees with its plain version ({err})")

    def lib():
        u, v = torch.zeros_like(mu), torch.zeros_like(nu)
        for _ in range(iters):
            u = mu - torch.logsumexp(z + v[:, None, :], dim=2)
            v = nu - torch.logsumexp(z + u[:, :, None], dim=1)
        return z + u[:, :, None] + v[:, None, :]

    ms = cuda_ms(lambda: log_sinkhorn(z, mu, nu, iters), 10)
    plain_ms = cuda_ms(lambda: log_sinkhorn_plain(z, mu, nu, iters), 5)
    lib_ms = cuda_ms(lib, 5)
    elems = b * m * m
    # per element and pass: add, max, subtract, exp, add
    bms, by = bound(2 * elems * 4 + 2 * b * m * 4, iters * 2 * elems * 5, F32_FLOPS)
    return dict(name="sinkhorn", route="cuda", source="image_matching_tpu_torch/csrc/sinkhorn.cu",
                replaces="image_matching_tpu/ops/pallas/sinkhorn.py:59", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)


# ---------------------------------------------------------------- main path

@contextlib.contextmanager
def plain_path():
    """Route the model's kernel call sites to the plain versions. Plain
    attention runs at f32 logits, the kernel's semantics, so the two paths
    compute the same function."""
    from image_matching_tpu_torch.models import common, superglue
    from image_matching_tpu_torch.ops import attention, entry_conv, sinkhorn

    def attention_f32_logits(q, k, v, key_mask, num_heads, logits_dtype):
        return attention.attention_plain(q, k, v, key_mask, num_heads, "float32")

    with mock.patch.object(common, "entry_conv", entry_conv.entry_conv_plain), \
            mock.patch.object(superglue, "attention", attention_f32_logits), \
            mock.patch.object(sinkhorn, "log_sinkhorn", sinkhorn.log_sinkhorn_plain):
        yield


def compare_with_plain(torch, model, image0, image1, out, label, min_kp_iou):
    """Run the same model and inputs on the all-plain path; print and check
    how far the kernel path's output is from it. Detection is compared as
    keypoint sets (bf16 scores tie, and one step of rounding can reorder
    tied slots); matching is compared slot by slot, with the plain
    SuperGlue fed the kernel path's keypoints."""
    from image_matching_tpu_torch.ops import _build

    b = image0.shape[0]
    with plain_path(), torch.inference_mode():
        _build.reset_launch_counts()
        kp_ref = model.detect(torch.cat([image0, image1], 0))
        ref = model(image0, image1, kpts0=out["keypoints0"], kpts1=out["keypoints1"])
        torch.cuda.synchronize()
        check(not _build.LAUNCHES, f"plain path launched kernels: {dict(_build.LAUNCHES)}")
    kp_share = 1.0
    for s, sl in (("keypoints0", slice(None, b)), ("keypoints1", slice(b, None))):
        got, want = out[s], kp_ref.select(sl)
        for i in range(b):
            a = {tuple(p) for p in got.xy[i][got.mask[i]].tolist()}
            r = {tuple(p) for p in want.xy[i][want.mask[i]].tolist()}
            kp_share = min(kp_share, len(a & r) / max(len(a | r), 1))
    k = out["matches0"].shape[-1]
    valid = out["keypoints0"].mask[:, :, None] & out["keypoints1"].mask[:, None, :]
    z_err = (out["log_coupling"][:, :k, :k] - ref["log_coupling"][:, :k, :k])[valid].abs().max().item()
    m, r = out["matches0"], ref["matches0"]
    matched = (m >= 0) | (r >= 0)
    share_matched = (m == r)[matched].float().mean().item() if bool(matched.any()) else 1.0
    print(f"{label}: kernel path vs all-plain path: keypoint sets IoU {kp_share:.6f} (worst image); "
          f"on the same keypoints: log-coupling max_abs_err {z_err:.4e} over valid pairs, "
          f"equal matches0 on {share_matched:.6f} of the {int(matched.sum())} slots matched on either path")
    check(kp_share >= min_kp_iou, f"{label}: keypoints differ between kernel and plain path ({kp_share})")
    check(share_matched >= 0.9, f"{label}: matches differ between kernel and plain path ({share_matched})")


def profile_forward(torch, model, image0, image1, sec):
    """Device time per forward by kernel (torch.profiler, 3 forwards), the
    device's busy share of the median forward, and the detect / match split
    on the host clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model(image0, image1)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    # device-side events only: a host op's device time repeats its kernels'
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in events) / 3 / 1e3
    print(f"profile: device time {total:.3f} ms per forward, busy {total / (sec * 1e3):.3f} of the "
          f"median forward ({sec * 1e3:.2f} ms)")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        print(f"  {dev_us(e) / 3 / 1e3:8.3f} ms  {e.count / 3:6.0f} calls  {e.key[:100]}")

    b = image0.shape[0]
    both = torch.cat([image0, image1], 0)
    split = {"detect": [], "match": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            kp = model.detect(both)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model.superglue(kp.select(slice(None, b)), kp.select(slice(b, None)),
                            tuple(image0.shape[1:3]), tuple(image1.shape[1:3]))
            torch.cuda.synchronize()
        split["detect"].append(t1 - t0)
        split["match"].append(time.perf_counter() - t1)
    print("profile: host clock per forward, median of 5: "
          + ", ".join(f"{k} {statistics.median(v) * 1e3:.2f} ms" for k, v in split.items()))


def run_main_path(torch, dev):
    import numpy as np
    from image_matching_tpu_torch.models import Matching, MatchingConfig
    from image_matching_tpu_torch.ops import _build

    batch, h, w, k = 4, 480, 640, 1024
    cfg = MatchingConfig(descriptor_dim=256, max_keypoints=k, keypoint_threshold=0.005,
                         gnn_layers=18, sinkhorn_iterations=30, match_threshold=0.1,
                         compute_dtype="bfloat16")
    model = Matching(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    image0 = torch.from_numpy(rng.uniform(0, 1, (batch, h, w, 1)).astype("float32")).to(dev)
    image1 = torch.from_numpy(rng.uniform(0, 1, (batch, h, w, 1)).astype("float32")).to(dev)

    for _ in range(2):  # warm-up: cuDNN algorithm choice, allocator
        model(image0, image1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    out = model(image0, image1)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"main path launches per forward: {launches}")
    check(launches == {"entry_conv": 1, "attention": 36, "sinkhorn": 1},
          f"main path launch counts {launches} != entry_conv 1, attention 36, sinkhorn 1")

    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        model(image0, image1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sec = statistics.median(times)
    print(f"main path: {batch / sec:.2f} pairs/s (median of 10 forwards, {sec * 1e3:.2f} ms per batch "
          f"of {batch}; min {min(times) * 1e3:.2f} ms, max {max(times) * 1e3:.2f} ms); "
          f"peak memory {peak_gib:.3f} GiB; TF32 off")

    z = out["log_coupling"]
    kp0, kp1 = out["keypoints0"], out["keypoints1"]
    check(tuple(z.shape) == (batch, k + 1, k + 1), f"log_coupling shape {tuple(z.shape)}")
    check(tuple(kp0.xy.shape) == (batch, k, 2) and tuple(kp0.desc.shape) == (batch, k, 256),
          "keypoint shapes")
    valid = kp0.mask[:, :, None] & kp1.mask[:, None, :]
    check(bool(torch.isfinite(z[:, :k, :k][valid]).all()), "non-finite log-coupling")
    m0 = out["matches0"]
    check(bool(((m0 >= -1) & (m0 < k)).all()), "matches0 out of range")
    print(f"main path: keypoints per image {kp0.num_valid().tolist()} / {kp1.num_valid().tolist()}, "
          f"matches {(m0 >= 0).sum(-1).tolist()}")
    # seeded random weights put every one of the K keypoints far above the
    # threshold: the sets must be identical
    compare_with_plain(torch, model, image0, image1, out, "main path", min_kp_iou=1.0)
    profile_forward(torch, model, image0, image1, sec)
    return launches


# ---------------------------------------------------------------- banked weights

def textured_pair(torch, dev, rng, h=480, w=640):
    """A seeded textured image (multi-scale noise plus random rectangles)
    and its warp by a known homography H (pixel (x, y), image0 -> image1)."""
    import numpy as np
    import torch.nn.functional as F

    img = np.zeros((h, w), np.float32)
    for cell, amp in ((64, 0.5), (16, 0.3), (4, 0.2)):
        small = torch.from_numpy(rng.uniform(0, 1, (1, 1, h // cell + 1, w // cell + 1)).astype("float32"))
        img += amp * F.interpolate(small, size=(h, w), mode="bilinear", align_corners=True)[0, 0].numpy()
    for _ in range(80):
        y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 20)
        img[y0:y0 + rng.integers(8, 60), x0:x0 + rng.integers(8, 60)] = rng.uniform(0, 1)
    img = (img - img.min()) / (img.max() - img.min())

    a = math.radians(8.0)
    cx, cy = w / 2, h / 2
    rot = np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]])
    t0 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]])
    t1 = np.array([[0.95, 0, cx + 12], [0, 0.95, cy - 9], [0, 0, 1]])
    persp = np.array([[1, 0, 0], [0, 1, 0], [2e-5, -1e-5, 1]])
    H = t1 @ rot @ persp @ t0
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)]) .astype(np.float64)
    src = np.linalg.inv(H) @ pts
    src = src[:2] / src[2]
    grid = np.stack([src[0] / (w - 1) * 2 - 1, src[1] / (h - 1) * 2 - 1], -1).reshape(1, h, w, 2)
    im0 = torch.from_numpy(img)[None, None].to(dev)
    im1 = F.grid_sample(im0, torch.from_numpy(grid.astype("float32")).to(dev),
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    return im0[0, 0][None, :, :, None], im1[0, 0][None, :, :, None], H


def run_banked_weights(torch, dev):
    import numpy as np
    from image_matching_tpu_torch.geometry.labels import flatten_detection
    from image_matching_tpu_torch.models import Matching, MatchingConfig
    from image_matching_tpu_torch.ops.nms import simple_nms
    from image_matching_tpu_torch.weights import load_npz

    model = Matching(MatchingConfig.self_trained_128(), device=dev, seed=0)
    load_npz(model.superpoint, str(ROOT / "weights" / "sp_photo.npz"))
    load_npz(model.superglue, str(ROOT / "weights" / "sg_photo.npz"))
    img0, img1, H = textured_pair(torch, dev, np.random.default_rng(1))
    out = model(img0, img1)
    m0 = out["matches0"][0].cpu().numpy()
    xy0 = out["keypoints0"].xy[0].cpu().numpy().astype(np.float64)
    xy1 = out["keypoints1"].xy[0].cpu().numpy().astype(np.float64)
    sel = np.nonzero(m0 >= 0)[0]
    proj = H @ np.concatenate([xy0[sel], np.ones((len(sel), 1))], 1).T
    proj = (proj[:2] / proj[2]).T
    err = np.linalg.norm(proj - xy1[m0[sel]], axis=1)
    share = float((err <= 3.0).mean()) if len(sel) else 0.0
    n_kp = (int(out["keypoints0"].num_valid()[0]), int(out["keypoints1"].num_valid()[0]))
    print(f"banked weights (sp_photo + sg_photo, D=128) on a textured 480x640 pair warped by a known "
          f"homography: keypoints {n_kp}, matches {len(sel)}, within 3 px of ground truth {share:.4f}"
          + (f", median error {float(np.median(err)):.3f} px" if len(sel) else ""))
    check(len(sel) >= 50, f"banked weights: only {len(sel)} matches")
    check(share >= 0.5, f"banked weights: only {share:.3f} of matches within 3 px")

    # how crowded the top-K cut is: NMS survivors above threshold inside
    # the border, and how many lie within one bf16 step of the K-th score
    cfg = model.config
    with torch.inference_mode():
        semi = model.superpoint(torch.cat([img0, img1], 0))["semi"]
        nms = simple_nms(flatten_detection(semi)[..., 0], cfg.nms_radius)
    bd = cfg.border
    crowd = []
    for s in nms[:, bd:-bd, bd:-bd].flatten(1).float():
        v = s[s > cfg.keypoint_threshold].sort(descending=True).values
        kth = v[min(cfg.max_keypoints, len(v)) - 1]
        crowd.append((len(v), int(((v - kth).abs() <= kth * 2 ** -7).sum())))
    print(f"banked weights: (NMS survivors, of them within one bf16 step of the K-th score) per image: {crowd}")
    # trained weights leave thousands of NMS survivors for K=1024 slots,
    # and tens of them lie within one bf16 step of the K-th score (printed
    # below): the rounding differences the entry conv starts, carried
    # through the backbone, swap which of them make the cut (IoU 0.94
    # measured on the H100), so the sets are held to 0.9
    compare_with_plain(torch, model, img0, img1, out, "banked weights", min_kp_iou=0.9)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "image_matching_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: image_matching_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from image_matching_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"built {len(reports)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line or "Compiling" in line):
                print(f"  [{name}] {line.strip()}")

    rng = np.random.default_rng(0)
    kernels = [check_entry_conv(torch, dev, rng), check_attention(torch, dev, rng),
               check_sinkhorn(torch, dev, rng)]
    launches = run_main_path(torch, dev)
    for kern in kernels:
        kern["launches"] = launches.get(kern["name"], 0)
    run_banked_weights(torch, dev)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
