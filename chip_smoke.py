#!/usr/bin/env python3
"""Drive the PyTorch port (`image_matching_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

In order, it:
  1. prints the card (torch's name and count, and `nvidia-smi`'s name and
     power limit);
  2. builds the CUDA kernels from `image_matching_tpu_torch/csrc/` (one
     `nvcc` for each source, all in parallel) and prints `-Xptxas -v`,
     then the shared-memory probe `csrc/lds_probe.cu` (SM cycles of a
     warp-wide LDS.128 by lane pattern);
  3. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes, and times kernel, plain version and one
     PyTorch yardstick with CUDA events, kernel and yardstick also by
     replaying a CUDA graph (no host launch gaps; the JSON rows hold
     these, and the attention forward is timed at the banked model's shape
     too); the image entry conv also at ragged shapes, at the pseudo-label
     export's (400, 240, 320) and in f32, the
     Sinkhorn at the headline's, the banked model's and a streamed shape,
     each with its route and device launches per call, and both beside an
     earlier build interleaved where `build/entry_conv_before.cu` and
     `build/sinkhorn_before.cu` hold one (the first versions' sources,
     put there by hand); where `build/attention_before.cu` holds an earlier version of
     `csrc/attention.cu` (put there by hand, not part of the repository),
     it times that build against this one, interleaved, at the bf16
     forward's nine timed shapes (D = 512's and D = 1024's forward and
     forward with LSE among them), and prints whether it gives this
     build's bits; it runs
     the attention kernels at head dims they
     are not built for (8, 24, 48: zero-padded to 16, 32, 64), forward,
     forward with LSE and backward, against the plain versions; then the
     kernels at head width 128 and the chunked kernels above it (bf16 and
     f32: forward, forward with LSE, dQ, dK/dV) at heads of 80, 96, 128,
     160, 192, 256, 320 and 512 with masked keys and a dead batch element,
     against the plain versions and, in f32, a float64 run, the forwards
     bit-identical on a second run, and times each
     at D = 512's and D = 1024's shapes ((4, 1024, 4x128 / 4x256) forward,
     (4, 512, 4x128 / 4x256) training), and D = 640's heads of 160 (zero-
     padded to 256), beside `scaled_dot_product_attention` and the bound;
  4. runs the headline configuration through `Matching` (480x640, batch
     4, K=1024, D=256, 18 GNN layers, 30 Sinkhorn iterations, bf16,
     seeded random weights, seeded uniform images), checks that the path
     launched every kernel, times it and compares it with the same model
     on the all-plain path;
  5. runs `MatchingConfig.self_trained_128()` with the banked
     `weights/sp_photo.npz` + `weights/sg_photo.npz` on a seeded textured
     image and its warp by a known homography;
  6. holds the training kernels (attention forward with LSE, dQ with its
     delta, dK/dV) against their plain versions and against autograd of
     the plain attention, at the training path's shapes, beyond, and at
     ragged ones, and times them (CUDA graph replay at three shapes, the
     profiler's device time at the training path's) beside their bounds
     and `scaled_dot_product_attention`'s forward and backward;
  7. trains SuperGlue at the training CLI's default configuration (240x320,
     batch 4, K=512, D=128, 18 GNN layers, 100 Sinkhorn iterations, lr
     1e-4, bf16; frozen SuperPoint and warm start from the banked weights):
     launch counts per step, steps/s, peak memory, per-step metrics; the
     same at compute_dtype="float32" (the f32 kernels' path), with every
     attention backward call of one f32 step against the plain version and
     its float64 exact gradient, and the f32 step profiled on the earlier
     builds of `build/attention_before.cu` and `build/attention_bwd_before.cu`
     where those are there; the kernel path's gradients against the
     all-plain path's on one step, every attention backward call of a bf16
     step against the plain version on its own inputs, and a falling loss
     from a random init on one fixed batch;
  8. holds the two kernels of the 2x2 space-to-depth backbone (the s2d
     entry conv and the realigning max pool) against their plain versions
     at the shapes one detect of 4 images at 480x640 gives them and at
     ragged ones (every route of the entry conv, two runs bit-identical),
     and times them beside a library convolution / max pool, the entry
     conv per shape and interleaved with its first version where
     `build/s2d_entry_conv_before.cu` holds it; then holds the f32
     attention forward (`attention_ffma`, with and without LSE) against
     its plain version and a float64 run at deep ragged shapes with a
     dead element, two runs bit-identical, and times it at the f32
     inference forward's and the f32 training step's shapes, and
     `attention_wide_3xtf32` at D = 1024's two, beside f32 SDPA's forward,
     interleaved with `build/attention_before.cu`'s build where that file
     is there; times the f32 image entry conv beside f32
     cuDNN; holds the f32 dQ and dK/dV kernels (`dq_ffma`,
     `dkdv_ffma`) against their plain version and a float64 run at the f32
     training step's shape and D = 256's, two runs bit-identical, and
     times each beside f32 SDPA's backward and two bounds, interleaved
     with `build/attention_bwd_before.cu`'s build where that file is
     there; the same for the chunked f32 pair (`dq_3xtf32_chunked`,
     `dkdv_3xtf32_chunked`) at D = 1024's training shape, interleaved with
     `build/attention_bwd_chunked_before.cu`'s build where that file is
     there, which also times what held that earlier pair (its recompute
     against its restaging, once); and holds the f32 s2d entry conv
     (`s2d_entry_ffma`, the image conv `s2d_entry_simt_image`) against its
     plain version at the four shapes of one detect, two runs bit-identical,
     timed per shape beside f32 cuDNN conv + `space_to_depth` and
     interleaved with the earlier build; then runs the headline's
     `Matching` at compute_dtype="float32" (the f32 forward's path, 36
     launches a forward) against the all-plain f32 path, profiled on this
     build and on `build/attention_before.cu`'s where that file is there;
  9. registers image pairs (detect each side -> SuperGlue -> homography
     RANSAC with 512 hypotheses -> warp) at the headline's width through
     the 2x2 backbone, `SuperPointBN` and `SuperPointVGG`: launch counts
     per call, pairs/s, peak memory, busy share, the 2x2 backbone's detect
     time beside the plain backbone's and their agreement; then one f32
     detect of 4 images through the 2x2 backbone: launch counts, agreement
     with the plain f32 backbone, both backbones' device time (and the 2x2
     one's on the earlier build);
 10. registers seeded textured pairs with known homographies with the
     banked weights, subpixel refinement on, through both backbones and
     both matchers: corner error against the truth, every pair held to
     less than 5 px;
 11. holds the image entry conv's alignedH output (`entry_conv_h`, the
     H-only backbone's first layer) against its plain version at
     (8, 480, 640) bf16, in f32 and at ragged shapes, bit for bit against
     `space_to_depth_h` of the direct kernel's output, and times it beside
     the direct kernel and cuDNN conv + affine + ReLU + `space_to_depth_h`;
 12. runs one detect of 4 images at 480x640 through the H-only backbone
     (the JAX package's default layout), bn and vgg, bf16 and f32: launch
     counts, agreement with the plain backbone, device times beside the
     plain (and, bn bf16, the 2x2) backbone's;
 13. runs the evaluation CLI (`image_matching_tpu_torch/cli/evaluate.py`)
     in-process at its defaults with the banked weights, through the H
     backbone and then the plain one: each config's metrics beside the JAX
     package's `EVAL_reference_regime.json`, held to a success rate and a
     mean corner error, and the two layouts held to each other;
 14. runs the registration CLI (`cli/match_pair.py`) in-process at its
     defaults (the H-only backbone, K = 1200, similarity RANSAC at 7 px, the
     banked D = 128 weights) on a template and 8 sources written as
     1920x2560 PNG files, registered at 480x640, with the ratio matcher and
     with SuperGlue: each written transform against the known similarity
     (at least 7 of 8 under 5 px of corner error at the 480x640 scale, a
     mean under 1 px), per-pair wall time, launches; then its official
     variant (--backbone vgg --descriptor_dim 256, SuperGlue loaded from a
     seeded synthetic official state dict) on 2 pairs;
 15. runs SuperGlue at descriptor_dim 512 and 1024 (4 heads of 128 values,
     the kernels at 128 (bf16 forward `attention_wide<128>`), and of 256,
     `attention_wide<256>` / `attention_wide_3xtf32` and the chunked
     backward; seeded weights:
     no banked ones exist at those widths): the headline's `Matching` in
     bf16 and f32 (launches, pairs/s, peak memory, agreement with the
     all-plain path, the log-coupling held to `WIDE_MAX_Z_ERR`, the
     profile, on `build/attention_before.cu`'s build too where that file
     is there), training at the training CLI's defaults in bf16 and f32
     through the trainer's step (launches, steps/s, peak memory, finite
     metrics, the step's device time, on `build/attention_before.cu`'s
     build too and at 1024 on `build/attention_bwd_chunked_before.cu`'s,
     where those files are there,
     every attention backward call of two steps against the
     plain version and, in f32, float64), the training CLI with --descriptor_dim
     D --gnn_layers 2 for one epoch of 6 steps (and at 1024 a resumed one:
     checkpoints, the step count), and match_pair --matcher superglue
     --descriptor_dim D on 2 of its sources (a run check);
 16. runs the training CLI (`cli/train_superglue.py`) in-process at its
     defaults with --synthetic, the banked SuperPoint, --photometric
     --subpixel --warmup_steps 5 --grad_clip 1.0: 2 epochs of 10 steps, then
     --resume for one more; finite losses, checkpoints, the step count
     continued, the training kernels' launches a step, steps/s, peak memory
     and the busy share of a step;
 17. runs the self-supervised cycle's SuperPoint stages in-process: stage 1,
     `cli/train_superpoint.py --synthetic` at its defaults (240x320, batch 8,
     D = 128, bf16, synthetic shapes made on the card) for 30 steps with
     diagnostics, evaluation steps and checkpoints, then --resume to step
     40: steps/s, the non-finite guard's read-back (its wait a step, and
     steps/s with and without it), peak memory, a step's profile, the entry
     conv's launches (diagnostics and evaluation only); stage 2,
     `cli/export_pseudo.py` with `weights/sp_synth.npz` at 240x320, batch 8,
     50 warps (400 views a model call) on 16 train and 8 val PNG files: s a
     batch, keypoints an image, peak memory, and the first batch again on
     the all-plain path with the same homographies (keypoint-set IoU >= 0.9);
     stage 3, `train_superpoint --data_root --labels --init_weights
     weights/sp_synth.npz` on those files and labels for 20 steps;
 18. runs the classical configs of the evaluation CLI (`cli/evaluate.py
     --configs sift orb`) at its defaults cut to 20 pairs at 480x640 and in the
     regime of the JAX package's `EVAL_classical_photo.json` (40 pairs at
     240x320, each method held to a success rate of 0.9): metrics, ms a
     pair, peak memory, a pair's profile and busy share, where a pair's time
     goes by stage, and one pair a method held to the port's CPU path with
     the same sample indices (fits within 1e-3 px of corner error);
 19. runs `cli/traditional.py` at its defaults (--resize_scale 0.5) on
     match_pair's template and 8 sources of 1920x2560, --method sift and
     orb: corner error per source at 960x1280 (at least 7 of 8 under 5 px),
     the CLI's seconds a pair, peak memory;
 20. runs `cli/sequence.py --synthetic --n_frames 24 --ba`: valid edges,
     both ATEs (under 0.1 px), tracks and landmarks beside the JAX
     package's `EVAL_sequence.json`, wall time, and the two solvers' wall
     time, device time and device launches. No kernel of the port runs in
     18-20: each checks that none launched;
 21. checks that g++ finds `jpeglib.h` and `png.h` and links `-ljpeg
     -lpng` (and says so on a line of its own; without them the phase stops
     there), builds the C++ image loader (`native/imloader/imloader.cpp`
     into `build/imloader/`), holds `imgproc.imread_gray` of the committed
     JPEG, BMP and TIFF files of `tests/data/images/` to their committed
     pixels and `NativeImageLoader` batches (4 threads) per index to
     `decode_image`, then trains SuperPoint on the JPEG files (labels from
     `export_pseudo`) for 20 steps with `--native_loader` and with the host
     decoder: steps/s of each;
 22. runs `export_pseudo` at 480x640, batch 8, 50 warps on 16 seeded PNG
     files: the 400 views of a batch in 4 model calls (4 entry conv
     launches), s a batch, peak memory, and the first batch through the
     all-plain path with the same homographies (keypoint-set IoU >= 0.9);
 23. runs `train_superglue` and `train_superpoint --synthetic` at their
     defaults for 10 steps each, as one process, in a world of one NCCL
     rank (a process group made here) and as one process again: the
     losses, metrics and trained state bit-equal (cuDNN and PyTorch in
     their deterministic algorithms for this phase), the training kernels'
     launches a step, steps/s. More than one card is not run;
 24. runs the JAX package's sharded paths, ported: context-parallel
     SuperGlue (ring attention, the row-sharded Sinkhorn) and pipelined
     SuperGlue (2 stages, 4 microbatches) at the headline's width in f32
     (18 layers, K = 1024, batch 4, seeded weights), a tensor-parallel
     training step at the training CLI's defaults in f32, and the sharded
     pose graph and bundle adjustment on step 20's problem; in a world of
     one NCCL rank (made here), then in a world of 4 gloo ranks all on
     this card (spawned: NCCL refuses two ranks on one card, which the
     phase asks it and prints); each path against the unsharded port on
     the card (matches and scores; the step's metrics, statistics and
     parameters; the solvers' distance from a float64 solve), with wall ms
     and the kernels' launches a call on every rank, and peak memory.

Every check that fails raises; nothing is caught. TF32 is off for every
phase, timed ones included, so f32 convolutions and matmuls are full f32.
The last two lines are the kernels' numbers as JSON (each kernel's
launches counted on its own path: inference per forward, training per
step, the 2x2 backbone's per registration call, its f32 route per f32
detect, the f32 attention forward per f32 forward and, with LSE, per f32
step, the alignedH entry conv per H-layout detect, the kernels at head
width 128 per D = 512 forward or step, the chunked kernels per D = 1024
forward or step) and the run's result as JSON. Without a CUDA device, or without the package beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
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


def device_ms(fn, reps: int, warmup: int = 3):
    """Device time per call of `fn`: the sum of its kernels' time from
    torch.profiler over `reps` calls, without the host's launch gaps. Every
    call launches the same kernels, so a profile whose kernel count is not
    a multiple of `reps` lost events; it is taken again, up to 5 times, and
    then given up: None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _kernel_events(prof)
        count = sum(e.count for e in events)
        if count and count % reps == 0:
            return sum(_dev_us(e) for e in events) / reps / 1e3
        print(f"  profiler: {count} kernel events for {reps} calls; profiling again")
    return None


_SIDE_STREAM: list = []


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Device time per call of `fn`: `reps` calls captured into one CUDA
    graph and replayed, timed with CUDA events. No host launch gaps and no
    profiler; the few microseconds between a graph's nodes are in it. `fn`
    must not synchronise with the host."""
    import torch

    # one side stream for every warm-up and capture: cuBLAS keeps a workspace of
    # 32 MiB for each stream it has run on, which would add up in the later
    # phases' peak memory
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants it
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def print_replayed(label, ms, lib_ms, lib_name, fn, lib, reps: int = 20):
    """Print a kernel's and its library call's time by CUDA graph replay
    beside the CUDA-event figures `ms` and `lib_ms`, which hold the host's
    launch rate too; returns the two graph-replay times."""
    g_ms, g_lib = graph_ms(fn, reps), graph_ms(lib, reps)
    print(f"{label}: ms per call, CUDA events over back-to-back calls: kernel {ms:.4f}, {lib_name} {lib_ms:.4f} "
          f"({ms / lib_ms:.3f} of it); CUDA graph replay of {reps} calls: kernel {g_ms:.4f}, {lib_name} {g_lib:.4f} "
          f"({g_ms / g_lib:.3f} of it)")
    return g_ms, g_lib


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _kernel_events(prof):
    """Device-side events of a profile, without user-annotation ranges
    (such as `Optimizer.step`), which span kernels counted on their own."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and _dev_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]


def bound(bytes_moved: float, flops: float, rate: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def free_port() -> int:
    """A free TCP port on this host, for a process group's store."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------- kernels

EARLIER_ENTRY_CONV = ROOT / "build" / "entry_conv_before.cu"


def with_library(name, lib, call):
    """`call` run with the kernel library `name` swapped for `lib`, a build
    of another version of the same source with the same C interface."""
    from image_matching_tpu_torch.ops import _build

    def run():
        own = _build._libraries.get(name)
        _build._libraries[name] = lib
        try:
            return call()
        finally:
            _build._libraries[name] = own
    return run


def _entry_inputs(torch, dev, rng, b, h, w):
    img = torch.from_numpy(rng.uniform(0, 1, (b, h, w)).astype("float32")).to(dev, torch.bfloat16)
    k = torch.from_numpy(rng.normal(0, 0.3, (3, 3, 1, 64)).astype("float32")).to(dev)
    scale = torch.from_numpy(rng.normal(1, 0.2, 64).astype("float32")).to(dev)
    shift = torch.from_numpy(rng.normal(0, 0.2, 64).astype("float32")).to(dev)
    return img, k, scale, shift


EXPORT_VIEWS = (400, 240, 320)  # the export's one call: batch 8 x 50 warps at 240x320


def check_entry_conv_export_shape(torch, dev):
    """The image entry conv at the pseudo-label export's shape, (400, 240,
    320) bf16 (more tiles a block of the persistent grid than any other
    path), held to its plain version chunk by chunk (the plain version's f32
    temporaries of the whole batch would take 24 GiB), and timed by CUDA
    events over back-to-back calls, beside its bound. Its own seeded inputs,
    so that the other checks' inputs stay as they were."""
    import numpy as np
    from image_matching_tpu_torch.ops.entry_conv import entry_conv, entry_conv_plain

    b, h, w = EXPORT_VIEWS
    img, k, scale, shift = _entry_inputs(torch, dev, np.random.default_rng(14), b, h, w)
    got = entry_conv(img, k, scale, shift)
    rel = err = 0.0
    for i in range(0, b, 50):
        ref = entry_conv_plain(img[i:i + 50], k, scale, shift).float()
        diff = (got[i:i + 50].float() - ref).abs()
        err = max(err, diff.max().item())
        rel = max(rel, (diff / ref.abs().clamp_min(1.0)).max().item())
        del ref, diff
    same = bool(torch.equal(got, entry_conv(img, k, scale, shift)))
    ms = cuda_ms(lambda: entry_conv(img, k, scale, shift), 5, warmup=1)
    npix = b * h * w
    bms, by = bound(npix * 2 + npix * 64 * 2 + (9 + 2) * 64 * 4, npix * 64 * (2 * 9 + 2), F32_FLOPS)
    print(f"entry_conv {EXPORT_VIEWS} -> 64 bf16 (the export's views): max_abs_err {err:.3e}, max err/max(|y|,1) "
          f"{rel:.3e} (tolerance 2^-7), a second run bit-identical: {same}; {ms:.4f} ms per call (CUDA events over "
          f"5 calls), bound {bms:.4f} ({by}; {bms / ms:.2f} of it reached)")
    check(rel <= 2 ** -7 and same, f"entry_conv {EXPORT_VIEWS} disagrees with its plain version or is not reproducible")
    del got
    torch.cuda.empty_cache()


def check_entry_conv(torch, dev, rng):
    """The image entry conv against its plain version at the main path's
    shape, at ragged ones (tiles the image does not fill, B = 1) and in
    f32; times by CUDA graph replay, this checkout's kernel interleaved with
    `build/entry_conv_before.cu`'s when that file is there, beside cuDNN
    conv + affine + ReLU."""
    import torch.nn.functional as F
    from image_matching_tpu_torch.ops import _build
    from image_matching_tpu_torch.ops.entry_conv import entry_conv, entry_conv_plain

    b, h, w = 8, 480, 640  # the 2B-batched backbone input of the main path
    img, k, scale, shift = _entry_inputs(torch, dev, rng, b, h, w)
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
    # tiles of 8 x 64 pixels that the image does not fill, borders, B = 1;
    # two runs giving the same bits
    for rb, rh, rw in ((3, 37, 53), (1, 17, 5)):
        xb, kk, sc, sh = _entry_inputs(torch, dev, rng, rb, rh, rw)
        for x, tol in ((xb, 2 ** -7), (xb.float(), 1e-5)):
            y = entry_conv(x, kk, sc, sh)
            r = entry_conv_plain(x, kk, sc, sh).float()
            rel_r = ((y.float() - r).abs() / r.abs().clamp_min(1.0)).max().item()
            same = bool(torch.equal(y, entry_conv(x, kk, sc, sh)))
            print(f"entry_conv ({rb}, {rh}, {rw}) {str(x.dtype)[6:]}: max err/max(|y|,1) {rel_r:.3e} "
                  f"(tolerance {tol}), a second run bit-identical: {same}")
            check(rel_r <= tol and same, f"entry_conv ({rb}, {rh}, {rw}) {x.dtype} disagrees or is not reproducible")

    check_entry_conv_export_shape(torch, dev)

    builds = [("before", EARLIER_ENTRY_CONV, ())] if EARLIER_ENTRY_CONV.exists() else []
    libs = {"this checkout": _build.library("entry_conv"), **build_variants("entry_conv", builds)}
    fns = {label: with_library("entry_conv", lib, lambda: entry_conv(img, k, scale, shift))
           for label, lib in libs.items()}
    for label, fn in fns.items():
        e = ((fn().float() - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
        check(e <= 2 ** -7, f"entry_conv [{label}] disagrees with its plain version ({e})")
    times = time_interleaved(fns, reps=20)
    w_lib = k.permute(3, 2, 0, 1).to(torch.bfloat16)
    sc, sh = scale.to(torch.bfloat16)[:, None, None], shift.to(torch.bfloat16)[:, None, None]
    x4 = img[:, None]
    lib = lambda: torch.relu(F.conv2d(x4, w_lib, padding=1) * sc + sh)
    ms = statistics.mean(times["this checkout"])
    events_ms = cuda_ms(lambda: entry_conv(img, k, scale, shift), 20)
    plain_ms = graph_ms(lambda: entry_conv_plain(img, k, scale, shift), 5)
    lib_ms = graph_ms(lib, 20)
    npix = b * h * w
    bms, by = bound(npix * 2 + npix * 64 * 2 + (9 + 2) * 64 * 4, npix * 64 * (2 * 9 + 2), F32_FLOPS)
    print(f"entry_conv (8, 480, 640) -> 64 bf16: ms per call by CUDA graph replay, builds interleaved: "
          + "; ".join(f"{label} " + " / ".join(f"{t:.4f}" for t in ts) for label, ts in times.items())
          + f"; CUDA events over back-to-back calls {events_ms:.4f}; plain {plain_ms:.4f}; cuDNN conv + affine + "
          f"ReLU {lib_ms:.4f} ({ms / lib_ms:.3f} of it); bound {bms:.4f} ({by}; {bms / ms:.2f} of it reached)")
    return dict(name="entry_conv", route="cuda", source="image_matching_tpu_torch/csrc/entry_conv.cu",
                replaces="image_matching_tpu/ops/pallas/entry_h.py:119", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)


# lane patterns of `csrc/lds_probe.cu`, in its order
LDS_PATTERNS = ("8 rows on distinct banks, each to 4 lanes (nt_product's own operand)",
                "4 rows, each broadcast to 8 lanes (nt_product's looped operand)",
                "32 distinct rows", "one row broadcast to all 32 lanes")


def probe_lds(torch, dev):
    """The shared-memory probe `csrc/lds_probe.cu`: what one warp-wide
    16-byte-a-lane load (LDS.128) costs an SM, by lane pattern. One block of
    32 warps an SM, each warp 2048 x 16 independent loads; the patterns in
    turn and again in reverse, each timed by CUDA graph replay (3 launches a
    graph) and by the blocks' own clock (median block of the last replay).
    Prints the SM cycles and nanoseconds a warp-wide load."""
    import ctypes

    from image_matching_tpu_torch.ops import _build

    fn = _build.library("lds_probe").lds_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    iters, warps, smem = 2048, 32, 160 * 1024  # 160 KB of shared memory: one block an SM
    loads = warps * 16 * iters  # warp-wide loads an SM runs in a launch
    out = torch.empty(sms * 1024, device=dev)
    cycles = torch.zeros(sms, dtype=torch.int64, device=dev)
    res = {p: {"ms": [], "cycles": []} for p in range(len(LDS_PATTERNS))}
    for p in list(res) + list(res)[::-1]:
        res[p]["ms"].append(graph_ms(lambda: _build.check(fn(p, iters, _build.ptr(out), _build.ptr(cycles), sms, smem,
                                                             _build.stream_ptr(dev)), "lds_probe"), 3))
        res[p]["cycles"].append(cycles.median().item() / loads)
    for p, r in res.items():
        ghz = statistics.mean(r["cycles"]) * loads / (statistics.mean(r["ms"]) * 1e6)
        print(f"lds probe, {LDS_PATTERNS[p]}: SM cycles per warp LDS.128 " + " / ".join(f"{c:.3f}" for c in r["cycles"])
              + " (clock64, median block); ns per warp LDS.128 an SM " + " / ".join(
                  f"{t * 1e6 / loads:.4f}" for t in r["ms"]) + f" (CUDA graph replay); implied SM clock {ghz:.3f} GHz")


def _attention_inputs(torch, dev, rng, b, n, h, dh):
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n, h * dh)).astype("float32")).to(dev, torch.bfloat16)
               for _ in range(3))
    mask = torch.from_numpy(rng.uniform(size=(b, n)) < 0.8).to(dev)
    mask[:, 0] = True
    return q, k, v, mask


def _sdpa(torch, q, k, v, mask, h):
    """`scaled_dot_product_attention` on the heads of packed (B, N, H*dh)
    inputs with the key mask: the attention forward's yardstick."""
    import torch.nn.functional as F

    b, n, dt = q.shape
    qh, kh, vh = (t.reshape(b, -1, h, dt // h).transpose(1, 2).contiguous() for t in (q, k, v))
    m4 = mask[:, None, None, :]

    def lib():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m4)
    return lib


def check_attention(torch, dev, rng):
    from image_matching_tpu_torch.ops.attention import attention, attention_plain

    results = {}
    for (b, n, h, dh) in ((4, 1024, 4, 64), (4, 1000, 4, 32), (2, 2048, 4, 64), (1, 1024, 4, 32)):
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

    # the headline's shape (36 calls per forward), then the banked model's (D = 128);
    # the JSON row holds the headline's graph-replay times
    row = None
    for (b, n, h, dh) in ((4, 1024, 4, 64), (1, 1024, 4, 32)):
        q, k, v, mask, err = results[(b, n, h, dh)]
        kernel, lib = (lambda: attention(q, k, v, mask, h)), _sdpa(torch, q, k, v, mask, h)
        ms, lib_ms = print_replayed(f"attention ({b}, {n}, {h}x{dh}) bf16", cuda_ms(kernel, 20), cuda_ms(lib, 20),
                                    "scaled_dot_product_attention", kernel, lib)
        plain_ms = graph_ms(lambda: attention_plain(q, k, v, mask, h, "float32"), 5)
        bms, by = bound(4 * b * n * h * dh * 2 + b * n, 4.0 * b * h * n * n * dh, BF16_TENSOR_FLOPS)
        print(f"  bound {bms:.5f} ms ({by}), plain version {plain_ms:.4f} ms (graph replay)")
        row = row or dict(name="attention", route="cuda", source="image_matching_tpu_torch/csrc/attention.cu",
                          replaces="image_matching_tpu/ops/pallas/attention.py:371", max_abs_err=err,
                          ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
    return row


def check_attention_head_dims(torch, dev, rng):
    """Head dims the kernels are not built for (8, 24, 48: the CPU tests'
    D = 32 model has 8) run zero-padded to the next width the kernels take
    (16, 32, 64), at the scale of the real dh: the forward, the forward
    with LSE and both backward kernels against their plain versions, one
    launch each; then the heads of 80-512 values that the kernels at 128
    and the chunked kernels take (`check_wide_head_dims`). Returns the wide
    kernels' worst errors (`check_wide_head_dims`)."""
    from image_matching_tpu_torch.ops import _build
    from image_matching_tpu_torch.ops import attention as A

    for dh in (8, 24, 48):
        b, n, m, h = 3, 200, 333, 4
        q = torch.from_numpy(rng.normal(size=(b, n, h * dh)).astype("float32")).to(dev, torch.bfloat16)
        kv = torch.from_numpy(rng.normal(size=(b, m, 2 * h * dh)).astype("float32")).to(dev, torch.bfloat16)
        k, v = kv[..., :h * dh], kv[..., h * dh:]  # views of a fused projection, as in the model
        mask = torch.from_numpy(rng.uniform(size=(b, m)) < 0.8).to(dev)
        mask[:, 0] = True
        mask[-1] = False  # a batch element with no valid key
        dout = torch.from_numpy(rng.normal(size=(b, n, h * dh)).astype("float32")).to(dev, torch.bfloat16)
        _build.reset_launch_counts()
        out = A.attention(q, k, v, mask, h)
        out_lse, lse = A.attention_lse(q, k, v, mask, h)
        grads = A.attention_backward(q, k, v, mask, lse, dout, h)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        ref_out, ref_lse = A.attention_lse_plain(q, k, v, mask, h)
        plain = A.attention_backward_plain(q, k, v, mask, lse, dout, h)
        e_out = max((out.float() - ref_out.float()).abs().max().item(),
                    (out_lse.float() - ref_out.float()).abs().max().item())
        e_lse = (lse - ref_lse).abs().max().item()
        e_bwd = _grad_error(grads, plain)
        shapes_ok = all(tuple(t.shape) == tuple(r.shape) for t, r in zip((out, *grads), (ref_out, *plain)))
        # the tolerances of the built widths (check_attention_training): bf16 P for P V and dV
        print(f"attention ({b}, {n}->{m}, {h}x{dh}) bf16, heads zero-padded to {A.padded_head_dim(dh)}: out "
              f"{e_out:.3e} (tol 3e-2), lse {e_lse:.3e} (tol 2e-4), dq/dk/dv {e_bwd:.3e} of the largest entry "
              f"(tol 2e-2); launches {launches}")
        check(shapes_ok and e_out <= 3e-2 and e_lse <= 2e-4 and e_bwd <= 2e-2,
              f"attention at head dim {dh} disagrees with its plain version")
        check(launches == {"attention": 1, "attention_lse": 1, "attention_dq": 1, "attention_dkdv": 1},
              f"attention at head dim {dh}: launches {launches}")
    return check_wide_head_dims(torch, dev, rng)


# (B, N, M) of the wide heads' checks: ragged across the 64-row tiles, and deep (16 key
# tiles), the last batch element dead in both; the f32 kernels are held to a float64 run
# at the deep one, where the sums' rounding outweighs the chance of a few terms
WIDE_CHECKS = ((3, 200, 333), (2, 1024, 1000))
# SuperGlue's 4 heads at descriptor_dim 320, 384, 512 (the kernels at 128), and at 640,
# 768, 1024, 1280, 2048 (2, 2, 2, 3 and 4 chunks of 128: in bf16 the forwards at 2 chunks
# are `attention_wide`'s, the rest the chunked kernels')
WIDE_DIMS = (80, 96, 128, 160, 192, 256, 320, 512)
CHUNKED_ROW_WIDTH = 256  # the chunked kernels' JSON rows: their launches on the D = 1024 path


def _wide_row(name: str, f32: bool, width: int) -> str:
    """The JSON name of wrapper `name`'s kernel at head width 128, or of the
    chunked kernel above it (named by `CHUNKED_ROW_WIDTH`): attention_dq_dh128,
    attention_dq_f32_dh256, ..."""
    return name + ("_f32" if f32 else "") + f"_dh{128 if width == 128 else CHUNKED_ROW_WIDTH}"


def check_wide_head_dims(torch, dev, rng):
    """The kernels at head width 128 and the chunked kernels above it
    (forward, forward with LSE, dQ with its delta, dK/dV; bf16 and f32) at
    heads of `WIDE_DIMS` values (80, 96 zero-padded to 128; 160, 192 to 256
    and 320 to 384, at the scale of the real dh), at `WIDE_CHECKS` with
    masked keys and a dead batch element, against their plain versions, one
    launch each under its own count (`launch_name` of the padded width):
    bf16 to the tolerances of the built widths (out 3e-2, LSE 2e-4,
    gradients 2e-2 of the largest entry); f32 within 1e-4 of max(|y|, 1)
    (LSE 1e-5), and, at the deep shape, no further from the same functions
    run in float64 than twice the plain f32 version; the dead element's
    mean of V, log(M) and zero dQ, dK; both forwards bit-identical on a
    second run. Returns the worst absolute error of
    each kernel against its plain version, keyed by its JSON name (the
    chunked kernels' over every chunked width)."""
    from image_matching_tpu_torch.ops import _build
    from image_matching_tpu_torch.ops import attention as A

    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        f32, kind = dtype == torch.float32, str(dtype)[6:]
        for dh in WIDE_DIMS:
            width = A.padded_head_dim(dh)
            want = {A.launch_name(name, width): 1 for name in ("attention", "attention_lse", "attention_dq",
                                                               "attention_dkdv")}
            for b, n, m in WIDE_CHECKS:
                h = 4
                q = torch.from_numpy(rng.normal(size=(b, n, h * dh)).astype("float32")).to(dev, dtype)
                kv = torch.from_numpy(rng.normal(size=(b, m, 2 * h * dh)).astype("float32")).to(dev, dtype)
                k, v = kv[..., :h * dh], kv[..., h * dh:]  # views of a fused projection, as in the model
                mask = torch.from_numpy(rng.uniform(size=(b, m)) < 0.8).to(dev)
                mask[:, 0] = True
                mask[-1] = False  # a batch element with no valid key
                dout = torch.from_numpy(rng.normal(size=(b, n, h * dh)).astype("float32")).to(dev, dtype)
                _build.reset_launch_counts()
                out = A.attention(q, k, v, mask, h)
                out_lse, lse = A.attention_lse(q, k, v, mask, h)
                grads = A.attention_backward(q, k, v, mask, lse, dout, h)
                torch.cuda.synchronize()
                launches = dict(_build.LAUNCHES)
                ref_out, ref_lse = A.attention_lse_plain(q, k, v, mask, h)
                plain = A.attention_backward_plain(q, k, v, mask, lse, dout, h)
                shape = f"({b}, {n}->{m}, {h}x{dh}) {kind}"
                check(all(tuple(t.shape) == tuple(r.shape) for t, r in zip((out, out_lse, *grads), (ref_out, ref_out, *plain))),
                      f"attention {shape}: output shapes")
                abs_err = {"attention": (out.float() - ref_out.float()).abs().max().item(),
                           "attention_lse": (out_lse.float() - ref_out.float()).abs().max().item(),
                           "attention_dq": (grads[0].float() - plain[0].float()).abs().max().item(),
                           "attention_dkdv": max((g.float() - p.float()).abs().max().item()
                                                 for g, p in zip(grads[1:], plain[1:]))}
                for name, e in abs_err.items():
                    key = _wide_row(name, f32, width)
                    worst[key] = max(worst.get(key, 0.0), e)
                e_out = max(abs_err["attention"], abs_err["attention_lse"]) / max(ref_out.float().abs().max().item(), 1.0)
                e_lse = (lse - ref_lse).abs().max().item()
                e_bwd = [_grad_error((g,), (p,)) for g, p in zip(grads, plain)]
                t_out, t_lse, t_bwd = (1e-4, 1e-5, 1e-4) if f32 else (3e-2, 2e-4, 2e-2)
                dq, dk, dv = grads
                dead_dv = (dv[-1].float() - (dout[-1].float().sum(0) / m).expand_as(dv[-1])).abs().max().item()
                dead = {"out - mean(V)": (out[-1].float() - v[-1].float().mean(0)).abs().max().item(),
                        "lse - log(M)": (lse[-1] - math.log(m)).abs().max().item(),
                        "dv - sum(dO)/M": dead_dv / max(dv[-1].float().abs().max().item(), 1e-30),
                        "|dq|, |dk|": max(dq[-1].float().abs().max().item(), dk[-1].float().abs().max().item())}
                line = (f"attention {shape}, kernels at {width}: out {e_out:.2e} of max(|y|, 1) (tol {t_out}), lse "
                        f"{e_lse:.2e} (tol {t_lse}), dq/dk/dv " + "/".join(f"{e:.2e}" for e in e_bwd)
                        + f" of the largest entry (tol {t_bwd}); dead element: " + ", ".join(
                            f"{key} {e:.1e}" for key, e in dead.items()) + f"; launches {launches}")
                check(e_out <= t_out and e_lse <= t_lse and max(e_bwd) <= t_bwd, f"attention {shape} disagrees with "
                                                                                  "its plain version")
                check(launches == want, f"attention {shape}: launches {launches} != {want}")
                # bf16: the mean of bf16 V in f32 then rounded, P = 1/M and the stored dV rounded once
                check(dead["out - mean(V)"] <= (1e-5 if f32 else 2e-2) and dead["lse - log(M)"] <= 1e-5
                      and dead["dv - sum(dO)/M"] <= (1e-5 if f32 else 2e-2) and dead["|dq|, |dk|"] == 0,
                      f"attention {shape}: the dead element")
                again, (again_out, again_lse) = A.attention(q, k, v, mask, h), A.attention_lse(q, k, v, mask, h)
                same = torch.equal(again, out) and torch.equal(again_out, out_lse) and torch.equal(again_lse, lse)
                line += f"; forwards bit-identical on a second run: {same}"
                check(same, f"attention {shape}: a second forward gives other bits")
                if f32 and m >= 1000:
                    # how far any f32 order of these sums lies from the answer: float64
                    q64, k64, v64, do64 = (t.double() for t in (q, k, v, dout))
                    ex_out, ex_lse = A.attention_lse_plain(q64, k64, v64, mask, h)
                    exact = A.attention_backward_plain(q64, k64, v64, mask, ex_lse, do64, h)
                    to_ex = lambda a, e: (a.double() - e).abs().max().item() / e.abs().max().item()
                    pairs = {"out": (out, ref_out, ex_out), "lse": (lse, ref_lse, ex_lse),
                             **{g: (a, p, e) for g, a, p, e in zip(("dq", "dk", "dv"), grads, plain, exact)}}
                    dist = {key: (to_ex(a, e), to_ex(p, e)) for key, (a, p, e) in pairs.items()}
                    line += "; distance to float64, kernel / plain f32: " + ", ".join(
                        f"{key} {a:.2e} / {p:.2e}" for key, (a, p) in dist.items())
                    check(all(a <= 2 * p for a, p in dist.values()), f"attention {shape}: further from float64 "
                                                                     "than twice the plain f32 version")
                    del q64, k64, v64, do64, exact
                print(line)
    return worst


def _attention_calls(torch, A, q, k, v, mask, dout, h):
    """The attention functions at one shape, each a call that CUDA graphs
    capture: the kernels' (forward, forward with LSE, the whole backward
    and, at a width the kernels are built for, dQ writing delta and dK/dV
    reading it, each on its own), their plain versions and
    `scaled_dot_product_attention`'s forward and forward + backward; and
    the LSE that the backward ones take."""
    import torch.nn.functional as F

    b, n, dt = q.shape
    dh = dt // h
    lse = A.attention_lse(q, k, v, mask, h)[1]
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)  # written by the dQ kernel
    dq, dk, dv = (torch.empty((b, n, dt), dtype=q.dtype, device=q.device) for _ in range(3))
    kernel = lambda name, outs: lambda: A.attention_backward_kernel(name, q, k, v, mask, dout, lse, delta, outs, h)
    qh, kh, vh = (t.reshape(b, n, h, dh).transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    m4, doh = mask[:, None, None, :], dout.reshape(b, n, h, dh).transpose(1, 2).contiguous()

    def lib_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m4)

    calls = {"attention": lambda: A.attention(q, k, v, mask, h),
             "attention_lse": lambda: A.attention_lse(q, k, v, mask, h),
             "attention_backward": lambda: A.attention_backward(q, k, v, mask, lse, dout, h),
             "plain": lambda: A.attention_plain(q, k, v, mask, h, "float32"),
             "plain_lse": lambda: A.attention_lse_plain(q, k, v, mask, h),
             "plain_bwd": lambda: A.attention_backward_plain(q, k, v, mask, lse, dout, h),
             "lib_fwd": lib_fwd,
             "lib_fb": lambda: torch.autograd.grad(F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m4),
                                                   (qh, kh, vh), doh)}
    if A.kernel_width(dh):  # the kernels on their own, at a width they are built for
        calls.update(attention_dq=kernel("attention_dq", (dq,)), attention_dkdv=kernel("attention_dkdv", (dk, dv)))
        calls["attention_dq"]()  # writes the delta that dK/dV reads
    return calls, lse


# (B, N, H, dh) at which the kernels at 128 and the chunked ones are timed: D = 512's and
# D = 1024's inference forward (the headline's K = 1024, 36 calls a forward) and training
# step (K = 512, 36 calls of each training kernel a step); D = 640's heads of 160 values,
# zero-padded to 256, show what the padding costs, and D = 256's heads of 64 re-time the
# kernels at 64 (`dq_wg<4>`, `dkdv_wg<3>`) beside SDPA (both printed, no JSON rows)
WIDE_TIMED = ((128, True), (256, True), (160, False), (64, False))
WIDE_INFERENCE, WIDE_TRAINING = (4, 1024, 4), (4, 512, 4)


def cluster_blocks(c: int) -> int:
    """Blocks of a cluster of the chunked backward at c chunks: the
    largest divisor of c up to 8 (`cluster_blocks` of
    csrc/attention_bwd_chunked.cu)."""
    return max(g for g in range(1, min(c, 8) + 1) if c % g == 0)


def chunked_work_factor(name: str, dh: int) -> float:
    """The wide kernels' operations over the function's, at a head of dh
    values in C = ceil(dh / 128) chunks (1 at 128 and below). The
    forwards: 1 at C = 2, whose heads `attention_wide` (bf16) and
    `attention_wide_3xtf32` (f32) take whole; above it each of the C output
    chunks' blocks (`attention_chunked`, `attention_ffma_chunked`) sums S
    over all C chunks, C (C + 1) chunk products for the function's 2 C.
    The backward, bf16
    and f32 alike: a cluster's G blocks own P = C / G chunks each and add
    their partial S and dP; dQ a delta pass (2 C) and P output passes (2 C
    partials and C / P output products each), C (3 + 2 P) for 3 C; dK/dV
    P passes of 2 C + 2 C / P, C (2 P + 2) for 4 C (5/3 and 1 up to 8
    chunks). The backward: the two together over its 5 C."""
    c = -(-dh // 128)
    if c == 1:
        return 1.0
    if name in ("attention", "attention_lse"):
        return 1.0 if c == 2 else (c + 1) / 2
    p = c // cluster_blocks(c)
    factors = {"attention_dq": (3 + 2 * p) / 3, "attention_dkdv": (2 * p + 2) / 4,
               "attention_backward": (4 * p + 5) / 5}
    return factors[name]


def _graph_ms_or_refused(fn, reps: int):
    """`graph_ms`, or None where the call raises (a shape a library call
    refuses)."""
    try:
        return graph_ms(fn, reps)
    except RuntimeError as e:
        print(f"  refused: {str(e).splitlines()[0][:160]}")
        return None


def _timed_inputs_error(torch, A, calls, q, k, v, mask, lse, dout, h, names, kind, f32):
    """The kernels of `names` against their plain versions on the inputs
    that `time_wide_attention` times them on, to `check_wide_head_dims`'s
    tolerances (bf16: out 3e-2 of max(|y|, 1), LSE 2e-4, gradients 2e-2 of
    the largest entry; f32: 1e-4, 1e-5, 1e-4). Returns each name's largest
    absolute error."""
    b, n, dt = q.shape
    t_out, t_lse, t_bwd = (1e-4, 1e-5, 1e-4) if f32 else (3e-2, 2e-4, 2e-2)
    err, rel = {}, {}
    if "attention" in names:
        out, ref = calls["attention"](), calls["plain"]()
        err["attention"] = (out.float() - ref.float()).abs().max().item()
        rel["attention"] = (err["attention"] / max(ref.float().abs().max().item(), 1.0), t_out)
    if "attention_lse" in names:
        (out, got_lse), (ref, ref_lse) = calls["attention_lse"](), calls["plain_lse"]()
        err["attention_lse"] = (out.float() - ref.float()).abs().max().item()
        rel["attention_lse"] = (err["attention_lse"] / max(ref.float().abs().max().item(), 1.0), t_out)
        rel["lse"] = ((got_lse - ref_lse).abs().max().item(), t_lse)
    if any(name in names for name in ("attention_dq", "attention_dkdv", "attention_backward")):
        grads = A.attention_backward(q, k, v, mask, lse, dout, h)
        plain = calls["plain_bwd"]()
        err["attention_dq"] = (grads[0].float() - plain[0].float()).abs().max().item()
        err["attention_dkdv"] = max((g.float() - r.float()).abs().max().item() for g, r in zip(grads[1:], plain[1:]))
        err["attention_backward"] = max(err["attention_dq"], err["attention_dkdv"])
        rel["dq, dk, dv"] = (_grad_error(grads, plain), t_bwd)
    torch.cuda.synchronize()
    line = ", ".join(f"{key} {e:.2e} (tol {tol})" for key, (e, tol) in rel.items())
    print(f"  on the timed inputs ({b}, {n}, {h}x{dt // h}) {kind}, against the plain versions: {line}")
    check(all(e <= tol for e, tol in rel.values()), f"attention ({b}, {n}, {h}x{dt // h}) {kind} on the timed "
                                                   "inputs disagrees with its plain version")
    return err


def time_wide_attention(torch, dev, rng, worst):
    """The kernels at head width 128 and the chunked kernels, bf16 and f32,
    timed by CUDA graph replay at heads of `WIDE_TIMED` values: the forward
    at `WIDE_INFERENCE`, the forward with LSE, dQ and dK/dV at
    `WIDE_TRAINING`, each beside its plain version,
    `scaled_dot_product_attention` (forward, or backward: forward +
    backward less forward, which computes dq, dk and dv together) at the
    same shape and dtype (or that it refused), and its bound: every input
    read and output written once, and the products the function needs at
    the real dh (forward 2, dQ 3, dK/dV 4, of 2 B H N M dh operations each)
    at the tensor cores' bf16 rate or the FMA pipe's f32 one, with the
    chunked kernels' work factor (`chunked_work_factor`) beside it; the
    f32 backward from 128 up and the f32 forwards at 256 run their products
    as 3xTF32, so their bound takes that rate, with the FMA pipe's beside it
    (`bound_fma_ms`). Each kernel with a JSON row (widths 128 and 256) is
    first held against its plain version on the inputs it is timed on, to
    `check_wide_head_dims`'s tolerances. Returns the JSON rows of 128 and
    256, their `max_abs_err` the larger of that error and the kernel's
    worst in `worst` (`check_wide_head_dims`), launches to be filled in by
    the D = 512 and D = 1024 phases."""
    from image_matching_tpu_torch.ops import attention as A

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        f32, kind = dtype == torch.float32, str(dtype)[6:]
        esize, rate = (4, F32_FLOPS) if f32 else (2, BF16_TENSOR_FLOPS)
        for dh, with_row in WIDE_TIMED:
            # a padded width: the backward's two kernels with the padding and the cut back
            backward = ("attention_dq", "attention_dkdv") if A.kernel_width(dh) else ("attention_backward",)
            for shape, names in ((WIDE_INFERENCE, ("attention",)), (WIDE_TRAINING, ("attention_lse", *backward))):
                b, n, h = shape
                qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * dh)).astype("float32")).to(dev, dtype)
                q, k, v = qkv[..., :h * dh], qkv[..., h * dh:2 * h * dh], qkv[..., 2 * h * dh:]  # as the model
                mask = torch.from_numpy(rng.uniform(size=(b, n)) < 0.8).to(dev)
                mask[:, 0] = True
                dout = torch.from_numpy(rng.normal(size=(b, n, h * dh)).astype("float32")).to(dev, dtype)
                calls, lse = _attention_calls(torch, A, q, k, v, mask, dout, h)
                timed_err = _timed_inputs_error(torch, A, calls, q, k, v, mask, lse, dout, h, names, kind,
                                                f32) if with_row else {}
                t = {key: graph_ms(fn, 3 if key.startswith("plain") else 20) for key, fn in calls.items()
                     if key in names or key in ("plain", "plain_lse", "plain_bwd")}
                for key in ("lib_fwd", "lib_fb"):
                    t[key] = _graph_ms_or_refused(calls[key], 20)
                t["lib_bwd"] = None if None in (t["lib_fwd"], t["lib_fb"]) else t["lib_fb"] - t["lib_fwd"]
                one, rows_b = b * n * h * dh * esize, b * h * n * 4  # one operand; an LSE or delta row set
                pair = 2.0 * b * h * n * n * dh  # one (N x M x dh) product
                needs = {"attention": (2, 4 * one + b * n), "attention_lse": (2, 4 * one + rows_b + b * n),
                         "attention_dq": (3, 5 * one + 2 * rows_b + b * n),
                         "attention_dkdv": (4, 6 * one + 2 * rows_b + b * n),
                         "attention_backward": (5, 7 * one + rows_b + b * n)}
                for name in names:
                    products, nbytes = needs[name]
                    factor = chunked_work_factor(name, dh) * A.padded_head_dim(dh) / dh  # zero columns too
                    # the f32 backward from 128 up and the f32 forwards at 256 run their products as
                    # 3xTF32: their bound at that rate, the FMA pipe's beside it
                    width = A.padded_head_dim(dh)
                    tf32 = f32 and (width == 2 * A.CHUNK if name in ("attention", "attention_lse")
                                    else width >= A.CHUNK)
                    bms, by = bound(nbytes, products * pair, F32_3XTF32_FLOPS if tf32 else rate)
                    fma = bound(nbytes, products * pair, rate)[0] if tf32 else None
                    plain, lib = {"attention": ("plain", "lib_fwd"), "attention_lse": ("plain_lse", "lib_fwd")}.get(
                        name, ("plain_bwd", "lib_bwd"))
                    key = _wide_row(name, f32, A.padded_head_dim(dh)) if with_row else name
                    lib_text = ("refused" if t[lib] is None else f"{t[lib]:.4f} ms ({t[name] / t[lib]:.3f} of it)")
                    fma_text = "" if fma is None else f", FMA pipe's bound {fma:.5f} ms ({fma / t[name]:.3f} of it)"
                    print(f"{key} at dh {dh} ({b}, {n}, {h}x{dh}) {kind}: {t[name]:.4f} ms by CUDA graph replay, "
                          f"{'3xTF32 ' if tf32 else ''}bound {bms:.5f} ms ({by}; {bms / t[name]:.3f} of it reached; the "
                          f"kernels do {factor:.3f}x the function's operations){fma_text}, plain {t[plain]:.4f} ms, "
                          f"scaled_dot_product_attention "
                          f"{'backward' if lib == 'lib_bwd' else 'forward'} {lib_text}")
                    if with_row:
                        source = ("attention.cu" if name in ("attention", "attention_lse")
                                  else "attention_bwd.cu" if dh == 128 else "attention_bwd_chunked.cu")
                        line = {"attention": 371, "attention_lse": 560, "attention_dq": 168,
                                "attention_dkdv": 121}[name]
                        rows.append(dict(name=key, route="cuda", source=f"image_matching_tpu_torch/csrc/{source}",
                                         replaces=f"image_matching_tpu/ops/pallas/attention.py:{line}",
                                         max_abs_err=max(worst[key], timed_err[name]), ms=t[name],
                                         plain_ms=t[plain], bound_ms=bms,
                                         bound_by=by, library_ms=t[lib],
                                         **({"work_factor": factor} if dh > 128 else {}),
                                         **({"bound_fma_ms": fma} if fma is not None else {}),
                                         **({"library_covers": WHOLE_BACKWARD} if lib == "lib_bwd" else {})))
                if "attention_dq" in names:
                    both = t["attention_dq"] + t["attention_dkdv"]
                    vs = "" if t["lib_bwd"] is None else (f", {both / t['lib_bwd']:.3f} of scaled_dot_product_"
                                                          f"attention's backward; its forward + backward "
                                                          f"{t['lib_fb']:.4f} ms")
                    print(f"  dQ + dK/dV {kind} at ({b}, {n}, {h}x{dh}): {both:.4f} ms{vs}")
                del calls
    return rows


def time_f32_kernels(torch, dev, rng, libs):
    """The f32 kernels, which serve `compute_dtype="float32"`, timed by CUDA
    graph replay beside their bounds (f32 operations at 67 TFLOP/s, no
    tensor cores) and a PyTorch call in full f32 (TF32 off): the f32
    attention forward, with and without LSE (`time_f32_attention_forward`),
    the f32 dQ and dK/dV kernels each on its own
    (`time_f32_attention_backward`; at 128 and below, then the chunked ones
    at D = 1024's training shape, interleaved with
    `build/attention_bwd_chunked_before.cu` where that file is there), the
    f32 image entry conv, and the f32
    s2d entry conv at the four shapes of one detect of 4 images at 480x640
    (`s2d_entry_ffma`; the image conv `s2d_entry_simt_image`), each against
    its plain version (two runs bit-identical) and timed beside its own f32
    cuDNN conv + `space_to_depth`, interleaved with the build of
    `build/s2d_entry_conv_before.cu` where that file is there (`libs` is
    `s2d_entry_libs()`). Returns the f32 s2d entry conv's JSON row (per
    launch, means over the four shapes), the f32 forward rows and the f32 dQ
    and dK/dV rows."""
    import torch.nn.functional as F
    from image_matching_tpu_torch.ops.s2d_conv import conv3x3_s2d_entry, space_to_depth

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    fwd_rows = time_f32_attention_forward(torch, dev, rng)
    bwd_rows = time_f32_attention_backward(torch, dev, rng)
    time_f32_attention_backward(torch, dev, rng, "attention_bwd_chunked", EARLIER_ATTENTION_BWD_CHUNKED,
                                (CHUNKED_BACKWARD_SHAPE,), "D = 1024")

    from image_matching_tpu_torch.ops.entry_conv import entry_conv, entry_conv_plain

    b, hh, ww = 8, 480, 640  # the plain backbone's image conv at compute_dtype="float32"
    img, k, scale, shift = _entry_inputs(torch, dev, rng, b, hh, ww)
    img = img.float()
    err = (entry_conv(img, k, scale, shift) - entry_conv_plain(img, k, scale, shift)).abs().max().item()
    x4, w_lib = img[:, None], k.permute(3, 2, 0, 1).contiguous()
    sc, sh = scale[:, None, None], shift[:, None, None]
    ms = graph_ms(lambda: entry_conv(img, k, scale, shift), 10)
    lib = graph_ms(lambda: torch.relu(F.conv2d(x4, w_lib, padding=1) * sc + sh), 10)
    plain_ms = graph_ms(lambda: entry_conv_plain(img, k, scale, shift), 5)
    npix = b * hh * ww
    bms, by = bound(npix * 4 + npix * 64 * 4 + (9 + 2) * 64 * 4, npix * 64 * (2 * 9 + 2), F32_FLOPS)
    print(f"f32 entry_simt ({b}, {hh}, {ww}) -> 64: max_abs_err {err:.2e} (tol 1e-5); {ms:.4f} ms, f32 cuDNN conv + "
          f"affine + ReLU {lib:.4f} ms ({ms / lib:.2f}x), plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}); launches "
          f"per forward at compute_dtype=float32: 1")
    check(err <= 1e-5, "f32 entry conv disagrees with its plain version")

    totals, per_build, bound_ms, worst = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}, dict.fromkeys(libs, 0.0), 0.0, 0.0
    for ci, co, hh, ww in S2D_ENTRY_SHAPES:
        x = torch.from_numpy(rng.normal(size=(S2D_BATCH, hh, ww, ci)).astype("float32")).to(dev)
        kk = torch.from_numpy(rng.normal(0, 0.3, (3, 3, ci, co)).astype("float32")).to(dev)
        ref = conv3x3_s2d_entry(x, kk)
        fns = s2d_entry_callers(torch, libs, x, kk)
        kernel = "s2d_entry_simt_image" if ci == 1 else "s2d_entry_ffma"
        # how far any f32 order of these sums lies from the answer: the float64 conv
        exact = space_to_depth(F.conv2d(x.double().permute(0, 3, 1, 2), kk.double().permute(3, 2, 0, 1),
                                        padding=1).permute(0, 2, 3, 1))
        to_exact = {name: _rel_err(y.double(), exact)[0] for name, y in (("kernel", fns["this checkout"]()),
                                                                         ("plain", ref))}
        del exact
        print(f"f32 s2d_entry_conv ({S2D_BATCH}, {hh}, {ww}) {ci}->{co}: max err/max(|y|,1) against the float64 conv: "
              f"kernel {to_exact['kernel']:.2e}, plain version (cuDNN f32) {to_exact['plain']:.2e}")
        for label, fn in fns.items():
            got = fn().clone()
            same = bool(torch.equal(got, fn()))
            rel, err = _rel_err(got, ref)
            if label == "this checkout":
                worst = max(worst, err)
            # f32 sums of 9 ci products (up to 1152) in another order: two f32
            # orders of such sums lie up to ~3e-5 of max(|y|, 1) apart
            print(f"f32 s2d_entry_conv ({S2D_BATCH}, {hh}, {ww}) {ci}->{co} [{label}]: max_abs_err {err:.3e}, max "
                  f"err/max(|y|,1) {rel:.2e} (tolerance 1e-4), a second run bit-identical: {same}")
            check(rel <= 1e-4 and same, f"f32 s2d_entry_conv {ci}->{co} [{label}] disagrees or is not reproducible")
        x_nchw, k_oihw = x.permute(0, 3, 1, 2), kk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib = lambda: space_to_depth(F.conv2d(x_nchw, k_oihw, padding=1).permute(0, 2, 3, 1))
        times = time_interleaved(fns, reps=5)
        t = {"ms": statistics.mean(times["this checkout"]), "plain_ms": graph_ms(lambda: conv3x3_s2d_entry(x, kk), 5),
             "library_ms": graph_ms(lib, 5)}
        npix = S2D_BATCH * hh * ww
        bms, by = bound(npix * ci * 4 + 9 * ci * co * 4 + npix * co * 4, 2.0 * npix * co * 9 * ci, F32_FLOPS)
        print(f"f32 s2d_entry_conv ({S2D_BATCH}, {hh}, {ww}) {ci}->{co} ({kernel}): device time (CUDA graph replay, "
              "builds interleaved) " + "; ".join(f"{label} " + " / ".join(f"{v:.4f}" for v in ts) + " ms"
                                                for label, ts in times.items())
              + f"; plain {t['plain_ms']:.4f} ms, f32 cuDNN conv + space_to_depth {t['library_ms']:.4f} ms "
              f"({t['ms'] / t['library_ms']:.2f}x); bound {bms:.4f} ms ({by})")
        for name in totals:
            totals[name] += t[name]
        for label, ts in times.items():
            per_build[label] += statistics.mean(ts)
        bound_ms += bms
    n = len(S2D_ENTRY_SHAPES)
    print(f"f32 s2d_entry_conv, one detect of {S2D_BATCH} images (4 launches): " + "; ".join(
        f"{label} {v:.4f} ms" for label, v in per_build.items()) + f"; plain {totals['plain_ms']:.4f} ms, f32 cuDNN "
          f"conv + space_to_depth {totals['library_ms']:.4f} ms, bound {bound_ms:.4f} ms; the JSON line holds the mean "
          "per launch")
    # three of the four shapes are bound by f32 operations, and they hold most of the summed bound
    return dict(name="s2d_entry_conv_f32", route="cuda", source="image_matching_tpu_torch/csrc/s2d_entry_conv.cu",
                replaces="image_matching_tpu/ops/pallas/entry_conv.py:66", max_abs_err=worst,
                ms=totals["ms"] / n, plain_ms=totals["plain_ms"] / n, bound_ms=bound_ms / n, bound_by="operations",
                library_ms=totals["library_ms"] / n), fwd_rows, bwd_rows


# (B, N, H, dh, with LSE) of the f32 forward's timed shapes: the f32 inference forward at
# the headline's width (36 calls a forward) and the f32 training step's (D = 128, 36 a step);
# then D = 1024's two at heads of 256 (`attention_wide_3xtf32`, 36 calls each), whose JSON
# rows `time_wide_attention` gives
F32_FORWARD_SHAPES = ((4, 1024, 4, 64, False), (4, 512, 4, 32, True), (4, 1024, 4, 256, False),
                      (4, 512, 4, 256, True))
# (B, N, M, H, dh) of its deep checks: ragged key counts, the last batch element dead
F32_FORWARD_DEEP = ((4, 1024, 1000, 4, 64), (2, 2048, 2000, 4, 64))


def time_f32_attention_forward(torch, dev, rng):
    """The f32 attention forward (`attention_ffma`), with and without LSE:
    at `F32_FORWARD_DEEP` against the plain f32 version (1e-5, the LSE too)
    and against the same function in float64, the kernel's distance to it
    beside the plain f32 version's own (held to twice that), the dead
    element's mean of V and log(M), two runs bit-identical; then at
    `F32_FORWARD_SHAPES`, timed by CUDA graph replay interleaved with
    `build/attention_before.cu`'s build where that file is there
    (`compare_attention_builds`), beside f32 SDPA's forward, the plain
    version and the bound (f32 operations at 67 TFLOP/s; at heads of 256,
    `attention_wide_3xtf32`, at 3xTF32's 165 TFLOP/s with the FMA pipe's
    beside it). Returns the JSON rows `attention_f32` and
    `attention_lse_f32` (heads of 64 and 32)."""
    from image_matching_tpu_torch.ops import attention as A

    worst = {False: 0.0, True: 0.0}
    for b, n, m, h, dh in F32_FORWARD_DEEP:
        q = torch.from_numpy(rng.normal(size=(b, n, 3 * h * dh)).astype("float32")).to(dev)[..., :h * dh]
        kv = torch.from_numpy(rng.normal(size=(b, m, 2 * h * dh)).astype("float32")).to(dev)
        k, v = kv[..., :h * dh], kv[..., h * dh:]  # views of fused projections, as in the model
        mask = torch.from_numpy(rng.uniform(size=(b, m)) < 0.8).to(dev)
        mask[:, 0] = True
        mask[-1] = False  # a batch element with no valid key
        out, lse = A.attention_lse(q, k, v, mask, h)
        out_inf = A.attention(q, k, v, mask, h)
        again, again_lse = A.attention_lse(q, k, v, mask, h)
        same = torch.equal(out, again) and torch.equal(lse, again_lse) and torch.equal(out_inf, A.attention(q, k, v, mask, h))
        ref, ref_lse = A.attention_lse_plain(q, k, v, mask, h)
        # how far any f32 order of these sums lies from the answer: the same function in float64
        ex, ex_lse = A.attention_lse_plain(q.double(), k.double(), v.double(), mask, h)
        torch.cuda.synchronize()
        err = {False: (out_inf - ref).abs().max().item(), True: (out - ref).abs().max().item()}
        e_lse = (lse - ref_lse).abs().max().item()
        to_ex = lambda a, e: (a.double() - e).abs().max().item() / e.abs().max().item()
        d_out = {"kernel": to_ex(out, ex), "kernel without LSE": to_ex(out_inf, ex), "plain": to_ex(ref, ex)}
        d_lse = {"kernel": to_ex(lse, ex_lse), "plain": to_ex(ref_lse, ex_lse)}
        dead_out = (out[-1] - v[-1].mean(0)).abs().max().item()
        dead_lse = (lse[-1] - math.log(m)).abs().max().item()
        shape = f"({b}, {n}->{m}, {h}x{dh})"
        # f32 on both sides, sums in other orders: within 1e-5 of O(1) outputs
        print(f"f32 attention {shape}, last element dead: error against the plain f32 version {err[False]:.2e}, with "
              f"LSE {err[True]:.2e}, LSE {e_lse:.2e} (tol 1e-5); distance to float64 relative to the largest entry: out "
              + ", ".join(f"{key} {d:.2e}" for key, d in d_out.items()) + "; lse " + ", ".join(
                  f"{key} {d:.2e}" for key, d in d_lse.items())
              + f"; dead element: out - mean(V) {dead_out:.1e}, lse - log(M) {dead_lse:.1e}; a second run "
              f"bit-identical: {same}")
        check(max(err.values()) <= 1e-5 and e_lse <= 1e-5 and same, f"f32 attention {shape} disagrees or is not "
                                                                     "reproducible")
        check(max(d_out["kernel"], d_out["kernel without LSE"]) <= 2 * d_out["plain"] and d_lse["kernel"] <= 2 * d_lse[
            "plain"], f"f32 attention {shape}: further from float64 than twice the plain f32 version")
        check(dead_out <= 1e-5 and dead_lse <= 1e-5, f"f32 attention {shape}: the dead element")
        for key in worst:
            worst[key] = max(worst[key], err[key])
        del ex, ex_lse

    earlier = [("before", EARLIER_ATTENTION, ())] if EARLIER_ATTENTION.exists() else []
    timed = compare_attention_builds(torch, dev, rng, earlier, F32_FORWARD_SHAPES, torch.float32)
    rows = []
    for (b, n, h, dh, with_lse), t in timed.items():
        ms = statistics.mean(t["times"]["this checkout"])
        wide = dh > 128  # `attention_wide_3xtf32`: products as 3xTF32
        # q, k, v and out read or written once, the mask, the LSE
        nbytes, ops = 4 * b * n * h * dh * 4 + b * n + (b * h * n * 4 if with_lse else 0), 4.0 * b * h * n * n * dh
        bms, by = bound(nbytes, ops, F32_3XTF32_FLOPS if wide else F32_FLOPS)
        before = {label: statistics.mean(ts) for label, ts in t["times"].items() if label != "this checkout"}
        print(f"f32 {'attention_wide_3xtf32' if wide else 'attention_ffma'}{' with LSE' if with_lse else ''} ({b}, "
              f"{n}, {h}x{dh}): {ms:.4f} ms" + "".join(f" ({label} build {x:.4f} ms, interleaved)"
                                                        for label, x in before.items())
              + f", f32 SDPA forward {t['sdpa']:.4f} ms ({ms / t['sdpa']:.3f} of it), plain {t['plain']:.4f} ms, "
              f"{'3xTF32 ' if wide else ''}bound {bms:.4f} ms ({by}; {bms / ms:.3f} of it reached)"
              + (f", FMA pipe's bound {bound(nbytes, ops, F32_FLOPS)[0]:.4f} ms" if wide else "")
              + "; launches: 36 per " + ("D = 1024 " if wide else "") + "f32 "
              + ("training step" if with_lse else "forward" + ("" if wide else " at the headline's width")))
        if wide:
            continue
        rows.append(dict(name="attention_lse_f32" if with_lse else "attention_f32", route="cuda",
                         source="image_matching_tpu_torch/csrc/attention.cu",
                         replaces=f"image_matching_tpu/ops/pallas/attention.py:{560 if with_lse else 371}",
                         max_abs_err=max(worst[with_lse], t["err"]), ms=ms, plain_ms=t["plain"], bound_ms=bms,
                         bound_by=by, library_ms=t["sdpa"]))
    return rows


EARLIER_ATTENTION_BWD = ROOT / "build" / "attention_bwd_before.cu"
# (B, N, H, dh) of the f32 backward's timed shapes: the f32 training step's (D = 128,
# 36 calls a step), whose numbers go into the JSON line, a D = 256 training run's and
# D = 512's training step's (`dq_3xtf32`, `dkdv_3xtf32`, 36 calls of each a step)
F32_BACKWARD_SHAPES = ((4, 512, 4, 32), (4, 1024, 4, 64), (4, 512, 4, 128))
# PyTorch's f32 SDPA backward (the memory-efficient route, TF32 off) runs its products
# on the tensor cores as three TF32 products each (CUTLASS `OpMultiplyAddFastF32`):
# 495 / 3 TFLOP/s of f32-accurate products
F32_3XTF32_FLOPS = 495e12 / 3
# what `plain_ms` and `library_ms` of a dQ or dK/dV row time: no single call computes
# one kernel's share, so both rows carry the whole backward's call
WHOLE_BACKWARD = "the whole backward (dq, dk and dv), in plain_ms and library_ms alike"


def with_attention_library(name, lib, call):
    """`call` run with the attention library `name` ("attention" or
    "attention_bwd") swapped for `lib`, a build of another version of its
    source with the same C interface (the wrapper's cached launchers are
    dropped on the way in and out)."""
    from image_matching_tpu_torch.ops import attention as A

    swapped = with_library(name, lib, call)

    def run():
        A._launcher.cache_clear()
        try:
            return swapped()
        finally:
            A._launcher.cache_clear()
    return run


EARLIER_ATTENTION_BWD_CHUNKED = ROOT / "build" / "attention_bwd_chunked_before.cu"
# the chunked backward's timed shape: D = 1024's training step (36 calls of each a step)
CHUNKED_BACKWARD_SHAPE = (4, 512, 4, 256)


def time_f32_attention_backward(torch, dev, rng, library="attention_bwd", earlier=EARLIER_ATTENTION_BWD,
                                shapes=F32_BACKWARD_SHAPES, step="D = 128"):
    """The f32 dQ (with its delta) and dK/dV kernels of `library`, each on
    its own, at `shapes` (q, k, v views of one fused projection, as the
    model gives them): each build's error against the plain version (1e-4
    of the largest entry) and its distance to a float64 run of the same
    function beside the plain f32 version's own, two runs bit-identical;
    times by CUDA graph replay, this checkout's build interleaved with
    `earlier` where that file is there (whose f32 and bf16 outputs are
    printed as bit-identical to this build's or not), beside f32 SDPA's
    backward (forward + backward less forward), the
    plain version and two bounds on the 7 products the function needs: the
    FMA pipe's 67 TFLOP/s
    and the 3xTF32 tensor-core rate SDPA's own products (and the chunked
    kernels') run at; each kernel's bound at the rate its products run at
    (from 128 up 3xTF32's, the FMA pipe's beside it) and the kernels' work
    factor. At dh 128 this checkout's kernels are also held to float64: no
    further from it than twice the plain f32 version. `step` names the
    f32 training step whose 36 launches of each the shapes are. With
    `earlier` there, the bf16 kernels of both builds too, on the same
    inputs rounded to bf16: each build's error against the bf16 plain
    version and the builds' distance from each other (relative to the
    largest entry), and the dQ and dK/dV ms interleaved beside bf16 SDPA's
    backward and the bound on the 7 products at 989 TFLOP/s. Returns the
    JSON rows of the two kernels at the first shape."""
    import torch.nn.functional as F
    from image_matching_tpu_torch.ops import _build
    from image_matching_tpu_torch.ops import attention as A

    builds = [("before", earlier, ())] if earlier.exists() else []
    libs = {"this checkout": _build.library(library), **build_variants(library, builds)}
    rows = None
    for b, n, h, dh in shapes:
        qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * dh)).astype("float32")).to(dev)
        q, k, v = qkv[..., :h * dh], qkv[..., h * dh:2 * h * dh], qkv[..., 2 * h * dh:]
        mask = torch.from_numpy(rng.uniform(size=(b, n)) < 0.8).to(dev)
        mask[:, 0] = True
        dout = torch.from_numpy(rng.normal(size=(b, n, h * dh)).astype("float32")).to(dev)
        _, lse = A.attention_lse(q, k, v, mask, h)
        delta = torch.empty((b, h, n), dtype=torch.float32, device=dev)  # written by dQ, read by dK/dV
        dq, dk, dv = (torch.empty((b, n, h * dh), dtype=torch.float32, device=dev) for _ in range(3))
        calls = {"dQ": lambda: A.attention_backward_kernel("attention_dq", q, k, v, mask, dout, lse, delta, (dq,), h),
                 "dK/dV": lambda: A.attention_backward_kernel("attention_dkdv", q, k, v, mask, dout, lse, delta,
                                                             (dk, dv), h)}
        plain = A.attention_backward_plain(q, k, v, mask, lse, dout, h)
        # how far any f32 order of these sums lies from the answer: the same function in
        # float64, on the float64 upcasts and their own float64 LSE
        q64, k64, v64, do64 = (t.double() for t in (q, k, v, dout))
        exact = A.attention_backward_plain(q64, k64, v64, mask, A.attention_lse_plain(q64, k64, v64, mask, h)[1],
                                           do64, h)
        plain_to_exact = [_grad_error((p,), (e,)) for p, e in zip(plain, exact)]
        shape = f"({b}, {n}, {h}x{dh})"
        print(f"f32 attention backward {shape}: plain f32 version's distance to float64, relative to the largest "
              f"entry: dq {plain_to_exact[0]:.2e}, dk {plain_to_exact[1]:.2e}, dv {plain_to_exact[2]:.2e}")
        worst, first = {"dQ": 0.0, "dK/dV": 0.0}, {}
        for label, lib in libs.items():
            runs = []
            for _ in range(2):
                for call in calls.values():  # dQ first: it writes the delta dK/dV reads
                    with_attention_library(library, lib, call)()
                runs.append((dq.clone(), dk.clone(), dv.clone()))
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(*runs))
            first[label] = runs[0]
            err = [_grad_error((g,), (p,)) for g, p in zip(runs[0], plain)]
            to_exact = [_grad_error((g,), (e,)) for g, e in zip(runs[0], exact)]
            if label == "this checkout":
                worst = {"dQ": (runs[0][0] - plain[0]).abs().max().item(),
                         "dK/dV": max((runs[0][i] - plain[i]).abs().max().item() for i in (1, 2))}
            print(f"f32 attention backward {shape} [{label}]: error against the plain version, relative to the "
                  f"largest entry (tol 1e-4): dq {err[0]:.2e}, dk {err[1]:.2e}, dv {err[2]:.2e}; distance to float64: "
                  f"dq {to_exact[0]:.2e}, dk {to_exact[1]:.2e}, dv {to_exact[2]:.2e}; a second run bit-identical: "
                  f"{same}")
            check(max(err) <= 1e-4 and same, f"f32 attention backward {shape} [{label}] disagrees or is not "
                                             "reproducible")
            if label == "this checkout" and dh == 128:  # the 3xTF32 pair
                check(all(x <= 2 * y for x, y in zip(to_exact, plain_to_exact)),
                      f"f32 attention backward {shape}: further from float64 than twice the plain f32 version")
        pair = 2.0 * b * h * n * n * dh  # operations of one (N x M x dh) product
        one, row_bytes = b * n * h * dh * 4, b * h * n * 4  # one f32 operand; lse or delta
        if len(libs) > 1:  # the bf16 kernels of each build too, on the same inputs rounded to bf16
            qkv_b, db = qkv.to(torch.bfloat16), dout.to(torch.bfloat16)
            qb, kb, vb = qkv_b[..., :h * dh], qkv_b[..., h * dh:2 * h * dh], qkv_b[..., 2 * h * dh:]
            calls_b, _ = _attention_calls(torch, A, qb, kb, vb, mask, db, h)
            plain_b = calls_b["plain_bwd"]()
            bf16 = {label: with_attention_library(library, lib, calls_b["attention_backward"])()
                    for label, lib in libs.items()}
            for label in list(libs)[1:]:
                same = all(torch.equal(a, c) for a, c in zip(first[label], first["this checkout"]))
                same_bf16 = all(torch.equal(a, c) for a, c in zip(bf16[label], bf16["this checkout"]))
                print(f"attention backward {shape} [{label}]: bit-identical to this checkout's build: f32 dq, dk, dv "
                      f"{same}; bf16 dq, dk, dv {same_bf16} (largest distance "
                      f"{_grad_error(bf16[label], bf16['this checkout']):.2e} of the largest entry)")
            times_b = time_interleaved({(label, name): with_attention_library(library, lib, calls_b[key])
                                        for label, lib in libs.items()
                                        for name, key in (("dQ", "attention_dq"), ("dK/dV", "attention_dkdv"))}, reps=10)
            sdpa_b = graph_ms(calls_b["lib_fb"], 10) - graph_ms(calls_b["lib_fwd"], 10)
            bound_b = bound(6 * one // 2 + 2 * row_bytes + b * n, 7 * pair, BF16_TENSOR_FLOPS)[0]
            for label in libs:
                dq_ms, dkdv_ms = (statistics.mean(times_b[label, name]) for name in ("dQ", "dK/dV"))
                print(f"bf16 attention backward {shape} [{label}]: dQ {dq_ms:.4f} ms, dK/dV {dkdv_ms:.4f} ms, pair "
                      f"{dq_ms + dkdv_ms:.4f} ms by CUDA graph replay, interleaved: "
                      f"{(dq_ms + dkdv_ms) / sdpa_b:.3f} of bf16 SDPA's backward ({sdpa_b:.4f} ms), "
                      f"{bound_b / (dq_ms + dkdv_ms):.3f} of the bound on its 7 products ({bound_b:.5f} ms at 989 "
                      f"TFLOP/s); error against the plain version, relative to the largest entry: dq/dk/dv "
                      + "/".join(f"{_grad_error((g,), (p,)):.2e}" for g, p in zip(bf16[label], plain_b)))
            del qkv_b, db, calls_b, plain_b, bf16
        del exact, q64, k64, v64, do64, first
        times = time_interleaved({f"{name} [{label}]": with_attention_library(library, lib, call)
                                  for label, lib in libs.items() for name, call in calls.items()}, reps=10)
        qh, kh, vh = (t.reshape(b, n, h, dh).transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        m4, doh = mask[:, None, None, :], dout.reshape(b, n, h, dh).transpose(1, 2).contiguous()

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m4)

        lib_ms = graph_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m4),
                                                      (qh, kh, vh), doh), 10) - graph_ms(sdpa_fwd, 10)
        plain_ms = graph_ms(lambda: A.attention_backward_plain(q, k, v, mask, lse, dout, h), 3)
        # every input read and output written once: the function's 7 products; dQ needs
        # S, dP, dS K and writes delta, dK/dV needs S^T, dP^T, P^T dO, dS^T Q and reads it
        fma7, tc7 = (bound(6 * one + 2 * row_bytes + b * n, 7 * pair, rate) for rate in (F32_FLOPS, F32_3XTF32_FLOPS))
        # each kernel's bound at its products' rate: the FMA pipe's below 128, 3xTF32 from 128 up
        # (the FMA pipe's beside it there)
        tf32 = dh >= 128
        rate, rate_text = (F32_3XTF32_FLOPS, "3xTF32's 165 TFLOP/s") if tf32 else (F32_FLOPS, "67 TFLOP/s")
        needs = {"dQ": (5 * one + 2 * row_bytes + b * n, 3 * pair), "dK/dV": (6 * one + 2 * row_bytes + b * n, 4 * pair)}
        bounds = {name: bound(*need, rate) for name, need in needs.items()}
        fma_text = ("; at the FMA pipe's 67 TFLOP/s: " + ", ".join(
            f"{name} {bound(*need, F32_FLOPS)[0]:.4f}" for name, need in needs.items())) if tf32 else ""
        mean = {key: statistics.mean(ts) for key, ts in times.items()}
        print(f"f32 attention backward {shape}: ms per call by CUDA graph replay, builds interleaved: " + "; ".join(
            f"{key} " + " / ".join(f"{t:.4f}" for t in ts) for key, ts in times.items()))
        for label in libs:
            both = mean[f"dQ [{label}]"] + mean[f"dK/dV [{label}]"]
            print(f"  [{label}] dQ + dK/dV {both:.4f} ms: {both / lib_ms:.3f} of f32 SDPA's backward ({lib_ms:.4f}); "
                  f"{fma7[0] / both:.3f} of the FMA pipe's bound reached, {tc7[0] / both:.3f} of the 3xTF32 one")
        work = ("" if dh <= 128 else "; the kernels do " + ", ".join(
            f"{name} {chunked_work_factor(key, dh):.3f}x" for name, key in (("dQ", "attention_dq"),
                                                                            ("dK/dV", "attention_dkdv")))
                + " the function's operations")
        print(f"  plain backward (dq, dk, dv together) {plain_ms:.4f} ms; bounds on the 7 products: FMA pipe at 67 "
              f"TFLOP/s {fma7[0]:.4f} ms, 3xTF32 tensor cores at 165 TFLOP/s {tc7[0]:.4f} ms; per kernel at "
              f"{rate_text}: dQ {bounds['dQ'][0]:.4f} (3 products), dK/dV {bounds['dK/dV'][0]:.4f} (4){fma_text}{work}; "
              f"launches per f32 training step at {step}: 36 of each" + (" (at dh 128: D = 512)" if dh == 128 else ""))
        if rows is None:
            rows = [dict(name=f"attention_{key}_f32", route="cuda", source="image_matching_tpu_torch/csrc/attention_bwd.cu",
                         replaces=f"image_matching_tpu/ops/pallas/attention.py:{line}", max_abs_err=worst[name],
                         ms=mean[f"{name} [this checkout]"], plain_ms=plain_ms, bound_ms=bounds[name][0],
                         bound_by=bounds[name][1], library_ms=lib_ms, library_covers=WHOLE_BACKWARD)
                    for key, name, line in (("dq", "dQ", 168), ("dkdv", "dK/dV", 121))]
    return rows


# (B, N, H, dh, with LSE): the forward's timed shapes: the headline (36 calls per
# forward) and the banked model's inference; D = 256 training, the TPU's flash band
# and the training path's (36 calls per step) with LSE; D = 512's and D = 1024's
# inference forwards and their training steps' forwards with LSE (heads of 128 and
# 256, `attention_wide`, 36 calls each)
ATTENTION_TIMED = ((4, 1024, 4, 64, False), (1, 1024, 4, 32, False), (4, 1024, 4, 64, True),
                   (2, 2048, 4, 64, True), (4, 512, 4, 32, True), (4, 1024, 4, 128, False),
                   (4, 512, 4, 128, True), (4, 1024, 4, 256, False), (4, 512, 4, 256, True))
EARLIER_ATTENTION = ROOT / "build" / "attention_before.cu"


def build_variants(name, builds):
    """Build other versions of the kernel source `name` (an earlier file, or
    this checkout's with -D flags), one `nvcc` each, all in parallel, with
    `-I csrc` for the shared header; prints each build's `-Xptxas -v`
    lines and returns {label: ctypes library}. `builds` lists (label,
    source, extra nvcc flags)."""
    import ctypes
    import hashlib

    from image_matching_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = []
    for label, src, flags in builds:
        # named as `_build._target` names a library: the source, every shared header, all flags
        h = hashlib.sha256(Path(src).read_bytes())
        for header in sorted(_build.CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join((*_build.NVCC_FLAGS, *flags)).encode())
        out = _build.BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
        if out.exists():  # the same build, made before
            started.append((label, None, out, None))
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC), "-o", str(tmp), str(src)]
        started.append((label, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                        out, tmp))
    libs = {}
    for label, proc, out, tmp in started:
        if proc is None:
            libs[label] = ctypes.CDLL(str(out))
            continue
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed for the {label} build of {name}.cu:\n{log}")
        os.replace(tmp, out)  # a later run never loads half a file
        for line in log.splitlines():
            if any(word in line for word in ("Compiling entry", "registers", "spill", "wgmma", "Performance")):
                print(f"  [{label}] {line.strip()[:160]}")
        libs[label] = ctypes.CDLL(str(out))
    return libs


def compare_attention_builds(torch, dev, rng, builds, shapes=ATTENTION_TIMED, dtype=None):
    """Time other builds of `csrc/attention.cu` beside this checkout's, at
    `shapes` in `dtype` (bf16 unless given), by CUDA graph replay,
    interleaved: every build in turn, then every build again in the reverse
    order, so that a drift of the card's clock falls on all alike. `builds`
    lists (label, source, extra nvcc flags). Every build is held against the
    plain version first (bf16 3e-2, f32 1e-5, the LSE too), and this
    checkout's against itself on a second run (the same bits); in bf16,
    whose kernels this checkout shares with the earlier builds, whether each
    build gives this checkout's bits is printed. The C interface of each is
    the checkout's, so the wrapper drives them all. Returns {shape: {"times":
    {label: [ms, ms]}, "sdpa": ms, "plain": ms, "err": this checkout's error}}."""
    from image_matching_tpu_torch.ops import _build
    from image_matching_tpu_torch.ops import attention as A

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    tol = 1e-5 if f32 else 3e-2
    own = _build.library("attention")
    libs = {"this checkout": own, **build_variants("attention", builds)}
    results = {}

    def use(lib):
        _build._libraries["attention"] = lib
        A._launcher.cache_clear()

    try:
        for b, n, h, dh, with_lse in shapes:
            qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * dh)).astype("float32")).to(dev, dtype)
            q, k, v = qkv[..., :h * dh], qkv[..., h * dh:2 * h * dh], qkv[..., 2 * h * dh:]  # as the model
            mask = torch.from_numpy(rng.uniform(size=(b, n)) < 0.8).to(dev)
            mask[:, 0] = True
            fn = (lambda: A.attention_lse(q, k, v, mask, h)) if with_lse else (lambda: A.attention(q, k, v, mask, h))
            plain = (lambda: A.attention_lse_plain(q, k, v, mask, h)) if with_lse else (
                lambda: A.attention_plain(q, k, v, mask, h, "float32"))
            ref = plain()
            ref, ref_lse = ref if with_lse else (ref, None)
            times, outs = {label: [] for label in libs}, {}
            for label in list(libs) + list(libs)[::-1]:
                use(libs[label])
                if not times[label]:
                    got = fn()
                    out, lse = got if with_lse else (got, None)
                    err = (out.float() - ref.float()).abs().max().item()
                    if with_lse:  # bf16: the fast exponentials
                        err_lse = (lse - ref_lse).abs().max().item()
                        check(err_lse <= (1e-5 if f32 else 2e-4), f"attention LSE, {label} build, ({b}, {n}, {h}x{dh}) "
                                                                   f"{str(dtype)[6:]}: error {err_lse}")
                    check(err <= tol, f"attention, {label} build, ({b}, {n}, {h}x{dh}) {str(dtype)[6:]}: error {err}")
                    outs[label] = (out.clone(), None if lse is None else lse.clone())
                    if label == "this checkout":
                        again = fn()
                        again = again if with_lse else (again, None)
                        check(all(a is None or torch.equal(a, c) for a, c in zip(outs[label], again)),
                              f"attention ({b}, {n}, {h}x{dh}) {str(dtype)[6:]}: a second run gives other bits")
                        results[(b, n, h, dh, with_lse)] = {"err": err}
                times[label].append(graph_ms(fn, 20))
            sdpa = graph_ms(_sdpa(torch, q, k, v, mask, h), 20)
            plain_ms = graph_ms(plain, 5)
            results[(b, n, h, dh, with_lse)].update(times=times, sdpa=sdpa, plain=plain_ms)
            same = "" if f32 else "; bit-identical to this checkout's build: " + ", ".join(
                f"{label} {all(a is None or torch.equal(a, c) for a, c in zip(outs[label], outs['this checkout']))}"
                for label in list(libs)[1:])
            print(f"attention{' with LSE' if with_lse else ''} ({b}, {n}, {h}x{dh}) {str(dtype)[6:]}, ms per call by "
                  f"CUDA graph replay, builds interleaved: " + "; ".join(
                      f"{label} " + " / ".join(f"{t:.4f}" for t in ts) for label, ts in times.items())
                  + f"; scaled_dot_product_attention {sdpa:.4f}; plain {plain_ms:.4f}{same}")
    finally:
        use(own)
    return results


EARLIER_SINKHORN = ROOT / "build" / "sinkhorn_before.cu"
# (B, M+1, N+1) timed: the headline's, the banked model's and one beyond the
# blocks' shared memory (the streamed route)
SINKHORN_SHAPES = ((4, 1025, 1025), (1, 1025, 1025), (2, 2049, 2049))
SINKHORN_ITERS = 30
# SFU exponentials: 16 a clock an SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) x 132 SMs x 1.98 GHz
EXPS_PER_S = 16 * 132 * 1.98e9


def sinkhorn_problem(torch, dev, rng, b, m, n):
    """A log-coupling with dustbins and masked rows and columns as
    `log_optimal_transport` builds them (BIG_NEG scores and marginals),
    one row and one column of every element masked."""
    from image_matching_tpu_torch.ops.sinkhorn import BIG_NEG

    z = torch.from_numpy(rng.normal(0, 3, (b, m, n)).astype("float32")).to(dev)
    norm = -math.log(m + n - 2)
    mu = torch.full((b, m), norm, device=dev)
    nu = torch.full((b, n), norm, device=dev)
    mu[:, -1] = math.log(n - 1) + norm
    nu[:, -1] = math.log(m - 1) + norm
    rows = torch.from_numpy(rng.uniform(size=(b, m - 1)) < 0.1).to(dev)
    cols = torch.from_numpy(rng.uniform(size=(b, n - 1)) < 0.1).to(dev)
    rows[:, 0] = cols[:, 1] = True
    z[:, :-1][rows] = BIG_NEG
    z[:, :, :-1].masked_fill_(cols[:, None, :], BIG_NEG)
    mu[:, :-1][rows] = BIG_NEG
    nu[:, :-1][cols] = BIG_NEG
    return z, mu, nu


def _earlier_sinkhorn(torch, lib, z, mu, nu, iters):
    """A call of the Sinkhorn through the C interface of its first version
    (the first `csrc/sinkhorn.cu`: 2 * iters + 1 launches, v zero on entry)."""
    import ctypes

    from image_matching_tpu_torch.ops import _build

    fn = lib.sinkhorn_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, m, n = z.shape
    u, v, out = torch.zeros((b, m), device=z.device), torch.zeros((b, n), device=z.device), torch.empty_like(z)

    def call():
        v.zero_()
        _build.check(fn(_build.ptr(z), _build.ptr(mu), _build.ptr(nu), _build.ptr(u), _build.ptr(v), _build.ptr(out),
                        b, m, n, iters, _build.stream_ptr(z.device)), "sinkhorn (earlier build)")
        return out
    return call


def kernel_launches(torch, fn, reps: int = 3) -> float:
    """Device kernels per call of `fn`, counted by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in _kernel_events(prof)) / reps


def check_sinkhorn(torch, dev, rng):
    """The Sinkhorn kernel against its plain version at the headline's, the
    banked model's and a streamed shape (each route asserted, masked
    pattern equal, a second run bit-identical); per shape its route and
    device launches per call, and times by CUDA graph replay: this
    checkout's kernel, interleaved with `build/sinkhorn_before.cu`'s when
    that file is there, beside the `torch.logsumexp` loop and the bound.
    Returns the headline's JSON row."""
    from image_matching_tpu_torch.ops.sinkhorn import log_sinkhorn, log_sinkhorn_plain, route_on

    iters = SINKHORN_ITERS
    earlier = (build_variants("sinkhorn", [("before", EARLIER_SINKHORN, ())])["before"]
               if EARLIER_SINKHORN.exists() else None)
    routes, row = set(), None
    for b, m, n in SINKHORN_SHAPES:
        z, mu, nu = sinkhorn_problem(torch, dev, rng, b, m, n)
        route = route_on(dev, b, m, n)
        routes.add(route.name)
        got = log_sinkhorn(z, mu, nu, iters)
        ref = log_sinkhorn_plain(z, mu, nu, iters)
        torch.cuda.synchronize()
        check(bool(((ref > -1e8) == (got > -1e8)).all()), f"sinkhorn ({b}, {m}, {n}): masked entries differ")
        real = (ref > -1e8) & (got > -1e8)
        err = (got - ref)[real].abs().max().item()
        same = bool(torch.equal(got, log_sinkhorn(z, mu, nu, iters)))
        # f32 on both sides, the same max-shifted logsumexp; sums in another
        # order over 30 iterations (masked entries, near -1e9, are compared
        # only for being masked: their f32 step is 64)
        print(f"sinkhorn ({b}, {m}, {n}) x {iters} f32, {route.name} route ({route.rows} rows a block, "
              f"{b * route.bands} blocks, {route.smem} bytes of shared memory): max_abs_err {err:.3e} on unmasked "
              f"entries (tolerance 1e-4), masked pattern equal, a second run bit-identical: {same}")
        check(err <= 1e-4 and same, f"sinkhorn ({b}, {m}, {n}) disagrees with its plain version ({err}) "
                                    "or is not reproducible")

        fns = {"this checkout": lambda: log_sinkhorn(z, mu, nu, iters)}
        if earlier is not None:
            fns["before"] = _earlier_sinkhorn(torch, earlier, z, mu, nu, iters)
        launches = {label: kernel_launches(torch, fn) for label, fn in fns.items()}

        def lib():
            u, v = torch.zeros_like(mu), torch.zeros_like(nu)
            for _ in range(iters):
                u = mu - torch.logsumexp(z + v[:, None, :], dim=2)
                v = nu - torch.logsumexp(z + u[:, :, None], dim=1)
            return z + u[:, :, None] + v[:, None, :]

        times = time_interleaved(fns, reps=5)
        ms = statistics.mean(times["this checkout"])
        lib_ms = graph_ms(lib, 2)
        plain_ms = graph_ms(lambda: log_sinkhorn_plain(z, mu, nu, iters), 2)
        elems = b * m * n
        t_bytes = (2 * elems * 4 + 2 * b * (m + n) * 4) / HBM_BYTES_PER_S
        # per element and half-iteration: add, max, subtract, add on the FMA
        # pipe, one exponential on the SFU
        t_fma = iters * 2 * elems * 5 / F32_FLOPS
        t_exp = iters * 2 * elems / EXPS_PER_S
        bms = max(t_bytes, t_fma, t_exp) * 1e3
        by = "bytes" if t_bytes >= max(t_fma, t_exp) else "operations"
        print(f"sinkhorn ({b}, {m}, {n}) x {iters}: ms per call by CUDA graph replay, builds interleaved: "
              + "; ".join(f"{label} " + " / ".join(f"{t:.4f}" for t in ts) + f" ({launches[label]:.0f} device "
                          f"launches a call)" for label, ts in times.items())
              + f" [the route launches {route.launches(iters)}]"
              + f"; torch.logsumexp loop {lib_ms:.4f}; plain {plain_ms:.4f}; bound {bms:.4f} ({by}: exps "
              f"{t_exp * 1e3:.4f}, FMA-pipe operations {t_fma * 1e3:.4f}, bytes {t_bytes * 1e3:.4f})")
        if row is None:
            row = dict(name="sinkhorn", route="cuda", source="image_matching_tpu_torch/csrc/sinkhorn.cu",
                       replaces="image_matching_tpu/ops/pallas/sinkhorn.py:59", max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
    check(routes == {"resident", "streamed"}, f"sinkhorn: routes driven {routes}, not both")
    return row


# ---------------------------------------------------------------- main path

@contextlib.contextmanager
def plain_path():
    """Route the model's kernel call sites to the plain versions. Plain
    attention runs at f32 logits, the kernel's semantics, so the two paths
    compute the same function."""
    from image_matching_tpu_torch.models import common, superglue, superpoint
    from image_matching_tpu_torch.ops import attention, entry_conv, s2d_conv, sinkhorn

    def attention_f32_logits(q, k, v, key_mask, num_heads, logits_dtype):
        return attention.attention_plain(q, k, v, key_mask, num_heads, "float32")

    with mock.patch.object(common, "entry_conv", entry_conv.entry_conv_plain), \
            mock.patch.object(superpoint, "entry_conv", entry_conv.entry_conv_plain), \
            mock.patch.object(common, "entry_conv_h", entry_conv.entry_conv_h_plain), \
            mock.patch.object(superpoint, "entry_conv_h", entry_conv.entry_conv_h_plain), \
            mock.patch.object(common, "s2d_entry_conv", s2d_conv.conv3x3_s2d_entry), \
            mock.patch.object(superpoint, "s2d_entry_conv", s2d_conv.conv3x3_s2d_entry), \
            mock.patch.object(superpoint, "pool_from_raw", s2d_conv.maxpool2x2_s2d_from_raw), \
            mock.patch.object(superglue, "attention", attention_f32_logits), \
            mock.patch.object(sinkhorn, "log_sinkhorn", sinkhorn.log_sinkhorn_plain):
        yield


def keypoint_set_iou(got, want) -> float:
    """The worst image's IoU of two batches of keypoints, as sets of (x, y)."""
    worst = 1.0
    for i in range(got.xy.shape[0]):
        a = {tuple(p) for p in got.xy[i][got.mask[i]].tolist()}
        r = {tuple(p) for p in want.xy[i][want.mask[i]].tolist()}
        worst = min(worst, len(a & r) / max(len(a | r), 1))
    return worst


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
    kp_share = min(keypoint_set_iou(out["keypoints0"], kp_ref.select(slice(None, b))),
                   keypoint_set_iou(out["keypoints1"], kp_ref.select(slice(b, None))))
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
    return z_err


def profile_forward(torch, model, image0, image1, sec, label: str = "profile"):
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
    launches = sum(e.count for e in _kernel_events(prof)) / 3
    print(f"{label}: device time {total:.3f} ms per forward in {launches:.0f} device launches, busy "
          f"{total / (sec * 1e3):.3f} of the median forward ({sec * 1e3:.2f} ms)")
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
    print(f"{label}: host clock per forward, median of 5: "
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


F32_MAIN_LAUNCHES = {"entry_conv": 1, "attention": 36, "sinkhorn": 1}


def run_f32_main_path(torch, dev):
    """The headline's `Matching` (480x640, batch 4, K=1024, D=256, 18 GNN
    layers, 30 Sinkhorn iterations, plain backbone, seeded random weights)
    at compute_dtype="float32", the path of the f32 attention forward:
    launch counts of one forward, pairs/s, its agreement with the all-plain
    f32 path and its device time, profiled on this build and, where
    `build/attention_before.cu` is there, on that build's attention
    kernels. Returns the launch counts of one forward."""
    import numpy as np
    from image_matching_tpu_torch.models import Matching, MatchingConfig
    from image_matching_tpu_torch.ops import _build

    batch, h, w, k = 4, 480, 640, 1024
    cfg = MatchingConfig(descriptor_dim=256, max_keypoints=k, keypoint_threshold=0.005,
                         gnn_layers=18, sinkhorn_iterations=30, match_threshold=0.1,
                         compute_dtype="float32")
    model = Matching(cfg, device=dev, seed=0)
    rng = np.random.default_rng(6)
    image0 = torch.from_numpy(rng.uniform(0, 1, (batch, h, w, 1)).astype("float32")).to(dev)
    image1 = torch.from_numpy(rng.uniform(0, 1, (batch, h, w, 1)).astype("float32")).to(dev)
    label = "f32 main path"
    for _ in range(2):  # warm-up: cuDNN algorithm choice, allocator
        model(image0, image1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    out = model(image0, image1)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label} launches per forward: {launches}")
    check(launches == F32_MAIN_LAUNCHES, f"{label} launch counts {launches} != {F32_MAIN_LAUNCHES}")
    def median_forward():
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            model(image0, image1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    sec = median_forward()
    print(f"{label}: {batch / sec:.2f} pairs/s (median of 10 forwards, {sec * 1e3:.2f} ms per batch of {batch}); "
          f"peak memory {peak_gib:.3f} GiB; TF32 off")
    z, kp0 = out["log_coupling"], out["keypoints0"]
    check(tuple(z.shape) == (batch, k + 1, k + 1) and z.dtype == torch.float32, f"{label}: log_coupling")
    valid = kp0.mask[:, :, None] & out["keypoints1"].mask[:, None, :]
    check(bool(torch.isfinite(z[:, :k, :k][valid]).all()), f"{label}: non-finite log-coupling")
    print(f"{label}: keypoints per image {kp0.num_valid().tolist()}, matches {(out['matches0'] >= 0).sum(-1).tolist()}")
    # f32 on both paths; the entry conv and the attention sum in other orders than
    # cuDNN and the einsums, a few f32 steps, which can swap keypoints whose scores
    # tie that closely at the K-th cut
    compare_with_plain(torch, model, image0, image1, out, label, min_kp_iou=0.99)
    profile_forward(torch, model, image0, image1, sec, f"{label} profile")
    if EARLIER_ATTENTION.exists():  # the same forward on the earlier build of the attention kernels
        earlier = build_variants("attention", [("before", EARLIER_ATTENTION, ())])["before"]
        before = with_attention_library("attention", earlier, median_forward)()
        print(f"{label} on build/attention_before.cu: {batch / before:.2f} pairs/s (median of 10 forwards, "
              f"{before * 1e3:.2f} ms); this build again: {batch / median_forward():.2f} pairs/s")
        with_attention_library("attention", earlier, lambda: profile_forward(
            torch, model, image0, image1, before, f"{label} profile on build/attention_before.cu"))()
    return launches


# ---------------------------------------------------------------- banked weights

def texture(torch, rng, h, w):
    """A seeded textured (h, w) f32 numpy image in [0, 1]: multi-scale
    noise plus random rectangles."""
    import numpy as np
    import torch.nn.functional as F

    img = np.zeros((h, w), np.float32)
    for cell, amp in ((64, 0.5), (16, 0.3), (4, 0.2)):
        small = torch.from_numpy(rng.uniform(0, 1, (1, 1, h // cell + 1, w // cell + 1)).astype("float32"))
        img += amp * F.interpolate(small, size=(h, w), mode="bilinear", align_corners=True)[0, 0].numpy()
    for _ in range(80 * h * w // (480 * 640)):
        y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 20)
        img[y0:y0 + rng.integers(8, 60), x0:x0 + rng.integers(8, 60)] = rng.uniform(0, 1)
    return (img - img.min()) / (img.max() - img.min())


def warped_pair(torch, dev, img, H):
    """A (h, w) numpy image and its warp by the homography H (pixel (x, y),
    image0 -> image1), both as (1, h, w, 1) tensors on the card."""
    import numpy as np
    import torch.nn.functional as F

    h, w = img.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    src = np.linalg.inv(H) @ np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)]).astype(np.float64)
    src = src[:2] / src[2]
    grid = np.stack([src[0] / (w - 1) * 2 - 1, src[1] / (h - 1) * 2 - 1], -1).reshape(1, h, w, 2)
    im0 = torch.from_numpy(img)[None, None].to(dev)
    im1 = F.grid_sample(im0, torch.from_numpy(grid.astype("float32")).to(dev),
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    return im0[0, 0][None, :, :, None], im1[0, 0][None, :, :, None]


def pair_homography(h, w, degrees, scale, shift, persp):
    """Rotation about the image centre, scale, shift (dx, dy) and a little
    perspective (two entries of the last row), as one (3, 3) float64 matrix."""
    import numpy as np

    a = math.radians(degrees)
    cx, cy = w / 2, h / 2
    rot = np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]])
    t0 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]])
    t1 = np.array([[scale, 0, cx + shift[0]], [0, scale, cy + shift[1]], [0, 0, 1]])
    return t1 @ rot @ np.array([[1, 0, 0], [0, 1, 0], [persp[0], persp[1], 1]]) @ t0


def textured_pair(torch, dev, rng, h=480, w=640):
    """A seeded textured image and its warp by a known homography H
    (pixel (x, y), image0 -> image1)."""
    H = pair_homography(h, w, 8.0, 0.95, (12, -9), (2e-5, -1e-5))
    return (*warped_pair(torch, dev, texture(torch, rng, h, w), H), H)


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


# ---------------------------------------------------------------- training kernels

def _grad_error(got, ref):
    """max |got - ref| / max |ref| over a tuple of gradients."""
    return max(((a.float() - r.float()).abs().max() / r.float().abs().max().clamp_min(1e-30)).item()
               for a, r in zip(got, ref))


def check_attention_training(torch, dev, rng):
    """The forward with LSE and the dK/dV, dQ kernels against their plain
    versions (and the gradients against autograd of the plain attention at
    f32 logits) at the training path's shapes and beyond; then their times
    at the training path's shape and two larger ones."""
    from image_matching_tpu_torch.ops import attention as A

    cases = (((4, 512, 512, 4, 32), torch.bfloat16, "trainer, D=128"),
             ((4, 1024, 1024, 4, 64), torch.bfloat16, "D=256"),
             ((2, 2048, 2048, 4, 64), torch.bfloat16, "the TPU's flash band"),
             ((3, 70, 133, 4, 32), torch.float32, "ragged N != M, one dead element"),
             ((3, 70, 133, 4, 32), torch.bfloat16, "ragged N != M, one dead element"),
             ((2, 333, 40, 4, 16), torch.bfloat16, "M under one tile, one dead element"),
             ((2, 50, 1100, 2, 64), torch.bfloat16, "N under one tile, 18 key tiles, one dead element"))
    errs = {"attention_lse": 0.0, "attention_dkdv": 0.0, "attention_dq": 0.0}
    for (b, n, m, h, dh), dtype, label in cases:
        dead = "dead element" in label
        q = torch.from_numpy(rng.normal(size=(b, n, h * dh)).astype("float32")).to(dev, dtype)
        kv = torch.from_numpy(rng.normal(size=(b, m, 2 * h * dh)).astype("float32")).to(dev, dtype)
        k, v = kv[..., :h * dh], kv[..., h * dh:]  # views of a fused projection, as in the model
        mask = torch.from_numpy(rng.uniform(size=(b, m)) < 0.8).to(dev)
        mask[:, 0] = True
        if dead:
            mask[-1] = False
        dout = torch.from_numpy(rng.normal(size=(b, n, h * dh)).astype("float32")).to(dev, dtype)
        out, lse = A.attention_lse(q, k, v, mask, h)
        ref_out, ref_lse = A.attention_lse_plain(q, k, v, mask, h)
        grads = A.attention_backward(q, k, v, mask, lse, dout, h)
        plain = A.attention_backward_plain(q, k, v, mask, lse, dout, h)
        qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))
        A.attention_plain(qa, ka, va, mask, h, "float32").backward(dout)
        torch.cuda.synchronize()
        e_out = (out.float() - ref_out.float()).abs().max().item()
        e_lse = (lse - ref_lse).abs().max().item()
        e_bwd = _grad_error(grads, plain)
        e_auto = _grad_error(grads, (qa.grad, ka.grad, va.grad))
        bf16 = dtype == torch.bfloat16
        # out: f32 logits both sides, P rounded to bf16 for P V on both;
        # lse: f32, fast exponentials in the kernel; gradients (the same
        # lse on both sides): the kernels round P to bf16 for dV, against
        # f32 on the plain side (relative to the largest entry). f32 is
        # full f32.
        t_out, t_lse, t_bwd = (3e-2, 2e-4, 2e-2) if bf16 else (1e-5, 1e-5, 1e-4)
        # autograd of the plain attention also rounds P to bf16 before P V
        # and dP to bf16 in its einsum: a few bf16 steps more
        t_auto = 3e-2 if bf16 else 1e-4
        print(f"attention training kernels ({b}, {n}->{m}, {h}x{dh}) {str(dtype)[6:]} [{label}]: "
              f"out {e_out:.3e} (tol {t_out}), lse {e_lse:.3e} (tol {t_lse}), dq/dk/dv vs plain FA2 "
              f"{e_bwd:.3e} (tol {t_bwd}), vs autograd of plain attention {e_auto:.3e} (tol {t_auto}) "
              f"[gradient errors relative to the largest entry]")
        check(e_out <= t_out and e_lse <= t_lse, f"attention forward with LSE disagrees ({label})")
        check(e_bwd <= t_bwd, f"attention backward kernels disagree with the plain FA2 ({label})")
        check(e_auto <= t_auto, f"attention backward kernels disagree with autograd ({label})")
        if dead:
            dq, dk, dv = grads
            check(not dq[-1].any() and not dk[-1].any(), "dead element: dq, dk not zero")
            want = (dout[-1].float().sum(0) / m).expand_as(dv[-1])
            # bf16: P = 1/M and the stored dV are each rounded once
            check((dv[-1].float() - want).abs().max().item() <= (2e-2 * want.abs().max().item() if bf16 else 1e-5),
                  "dead element: dv != sum(dO) / M")
            check((lse[-1] - math.log(m)).abs().max().item() <= 1e-5, "dead element: lse != log M")
        # the delta that the dQ kernel writes for the dK/dV kernel, against its plain version:
        # f32 from the same products and the same lse, another order of sums (bf16: fast
        # exponentials too)
        got_delta = torch.empty((b, h, n), dtype=torch.float32, device=dev)
        A.attention_backward_kernel("attention_dq", q, k, v, mask, dout, lse, got_delta, (torch.empty_like(q),), h)
        ref_delta = A.attention_delta_plain(q, k, v, mask, lse, dout, h)
        e_delta = (got_delta - ref_delta).abs().max().item() / ref_delta.abs().max().item()
        print(f"  delta written by the dQ kernel vs its plain version: {e_delta:.3e} of the largest entry (tol 1e-4)")
        check(e_delta <= 1e-4, f"the dQ kernel's delta disagrees ({label})")
        errs["attention_lse"] = max(errs["attention_lse"], e_out)
        errs["attention_dkdv"] = max(errs["attention_dkdv"], (grads[1].float() - plain[1].float()).abs().max().item(),
                                     (grads[2].float() - plain[2].float()).abs().max().item())
        errs["attention_dq"] = max(errs["attention_dq"], (grads[0].float() - plain[0].float()).abs().max().item())

    # times: the training path's shape, (4, 512, 4x32) bf16, 36 calls per step, whose
    # numbers go into the JSON line; and two larger shapes, where the bound means more
    rows = None
    for shape in ((4, 512, 4, 32), (4, 1024, 4, 64), (2, 2048, 4, 64)):
        timed = time_attention_training(torch, dev, rng, *shape, profiled=rows is None)
        rows = rows or timed
    for row in rows:
        row["max_abs_err"] = errs[row["name"]]
    return rows


def time_attention_training(torch, dev, rng, b, n, h, dh, profiled):
    """Times of the forward with LSE and the two backward kernels at one
    bf16 shape, beside their bounds, plain versions and
    `scaled_dot_product_attention`: by CUDA graph replay, which is what the
    returned JSON rows hold if `profiled`, and then by the profiler's
    device time too, where it keeps its events."""
    from image_matching_tpu_torch.ops import attention as A

    q = torch.from_numpy(rng.normal(size=(b, n, 3 * h * dh)).astype("float32")).to(dev, torch.bfloat16)
    q, k, v = q[..., :h * dh], q[..., h * dh:2 * h * dh], q[..., 2 * h * dh:]
    mask = torch.from_numpy(rng.uniform(size=(b, n)) < 0.8).to(dev)
    mask[:, 0] = True
    dout = torch.from_numpy(rng.normal(size=(b, n, h * dh)).astype("float32")).to(dev, torch.bfloat16)
    calls, lse = _attention_calls(torch, A, q, k, v, mask, dout, h)
    fns = {"fwd": calls["attention_lse"], "dq": calls["attention_dq"], "dkdv": calls["attention_dkdv"],
           "bwd": lambda: A.attention_backward(q, k, v, mask, lse, dout, h),  # the two, with their allocations
           "plain_fwd": calls["plain_lse"], "plain_bwd": calls["plain_bwd"], "lib_fwd": calls["lib_fwd"],
           "lib_fb": calls["lib_fb"]}
    pair = b * h * n * n * dh  # one (N x M x dh) product is 2 * pair operations
    qkv_bytes = 3 * b * n * h * dh * 2
    one = b * n * h * dh * 2  # dO, or one gradient
    row_bytes = b * h * n * 4  # lse or delta
    # the products the function needs, every input read and output written once, delta
    # an output of dQ and an input of dK/dV (the dQ kernel does more: its first pass,
    # for delta, computes S and dP too)
    needs = {"fwd": (2, qkv_bytes + one + row_bytes + b * n),             # S, P V
             "dq": (3, qkv_bytes + 2 * one + 2 * row_bytes + b * n),      # S, dP, dS K
             "dkdv": (4, qkv_bytes + 3 * one + 2 * row_bytes + b * n)}    # S^T, P^T dO, dP^T, dS^T Q
    bounds = {name: bound(nbytes, products * 2 * pair, BF16_TENSOR_FLOPS) for name, (products, nbytes) in needs.items()}

    def report(method, t):
        t["lib_bwd"] = t["lib_fb"] - t["lib_fwd"]
        both = t["dq"] + t["dkdv"]
        whole = f" (one call of both with their allocations {t['bwd']:.4f})" if "bwd" in t else ""
        print(f"attention training kernels at ({b}, {n}, {h}x{dh}) bf16, ms per call, {method}: forward with LSE "
              f"{t['fwd']:.4f} (bound {bounds['fwd'][0]:.5f}); dQ {t['dq']:.4f} (bound {bounds['dq'][0]:.5f}), dK/dV "
              f"{t['dkdv']:.4f} (bound {bounds['dkdv'][0]:.5f}), the pair {both:.4f}{whole}; plain forward "
              f"{t['plain_fwd']:.4f}, plain backward (dq, dk, dv together) {t['plain_bwd']:.4f}; "
              f"scaled_dot_product_attention forward {t['lib_fwd']:.4f}, forward + backward {t['lib_fb']:.4f} "
              f"(backward {t['lib_bwd']:.4f}): the pair takes {both / t['lib_bwd']:.3f} of its backward, the forward "
              f"{t['fwd'] / t['lib_fwd']:.3f} of its forward")

    if profiled:
        # the profiler's device time is the kernels' own, as a graph's replay is but for the
        # few microseconds between its nodes; it loses events now and then, and is read
        # first because it loses more once graphs have been replayed
        dev_ms = {}
        for name, fn in fns.items():
            if name != "bwd" and None not in dev_ms.values():
                dev_ms[name] = device_ms(fn, 20)
        if None in dev_ms.values():
            print(f"attention training kernels at ({b}, {n}, {h}x{dh}) bf16: device time (profiler) not measured: "
                  f"the profiler lost kernel events five times running")
        else:
            report("device time (profiler)", dev_ms)
    replayed = {name: graph_ms(fn, 20) for name, fn in fns.items()}
    report("CUDA graph replay of 20 calls", replayed)
    if not profiled:
        return None
    # CUDA events over back-to-back calls also count the host's launch rate, which bounds
    # calls this small
    wall = {name: cuda_ms(fns[name], 20) for name in ("fwd", "dq", "dkdv")}
    print(f"  CUDA events over back-to-back calls (launch rate included): forward with LSE {wall['fwd']:.4f} ms, "
          f"dQ {wall['dq']:.4f} ms, dK/dV {wall['dkdv']:.4f} ms")
    rows = []
    for name, key, plain, lib, line in (
            ("attention_lse", "fwd", "plain_fwd", "lib_fwd", "image_matching_tpu/ops/pallas/attention.py:560"),
            ("attention_dkdv", "dkdv", "plain_bwd", "lib_bwd", "image_matching_tpu/ops/pallas/attention.py:121"),
            ("attention_dq", "dq", "plain_bwd", "lib_bwd", "image_matching_tpu/ops/pallas/attention.py:168")):
        source = "attention.cu" if name == "attention_lse" else "attention_bwd.cu"
        rows.append(dict(name=name, route="cuda", source=f"image_matching_tpu_torch/csrc/{source}",
                         replaces=line, ms=replayed[key], plain_ms=replayed[plain], bound_ms=bounds[key][0],
                         bound_by=bounds[key][1], library_ms=replayed[lib],
                         **({"library_covers": WHOLE_BACKWARD} if lib == "lib_bwd" else {})))
    return rows


# ---------------------------------------------------------------- training path

def profile_calls(torch, run, sec, label: str, unit: str, reps: int):
    """Device time per call of `run` by kernel (torch.profiler over `reps`
    calls) and the device's busy share of the median call. `unit` names a
    call in the print: a training step, a registration call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    events = _kernel_events(prof)
    total = sum(_dev_us(e) for e in events) / reps / 1e3
    launches = sum(e.count for e in events) / reps
    print(f"{label} profile: device time {total:.3f} ms per {unit} in {launches:.0f} kernel launches, busy "
          f"{total / (sec * 1e3):.3f} of the median {unit} ({sec * 1e3:.2f} ms)")
    for e in sorted(events, key=_dev_us, reverse=True)[:14]:
        print(f"  {_dev_us(e) / reps / 1e3:8.3f} ms  {e.count / reps:6.0f} calls  {e.key[:100]}")


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    den = (a.norm() * b.norm()).item()
    return (a @ b).item() / den if den > 0 else (1.0 if not (a.any() or b.any()) else 0.0)


@contextlib.contextmanager
def recorded_backward_calls(torch, calls):
    """Append the arguments of every `attention_backward` call that
    `AttentionFunction` makes to `calls`, cloned."""
    from image_matching_tpu_torch.ops import attention as A

    real = A.attention_backward

    def record(*args):
        calls.append(tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args))
        return real(*args)

    with mock.patch.object(A, "attention_backward", record):
        yield


def check_backward_calls(torch, calls, label, n_attn, dtype):
    """The dK/dV and dQ kernels against their plain versions on the inputs
    of every attention backward of one training step in `dtype`, and all
    three against each call's exact gradient: what the kernels compute on
    the model's own q, k, v, mask, LSE and upstream gradient, apart from
    how the model carries it on."""
    from image_matching_tpu_torch.ops import attention as A

    check(len(calls) == n_attn, f"{label}: {len(calls)} attention backward calls recorded, not {n_attn}")
    # as the kernel checks: in bf16 the kernels round P to bf16 for dV, the
    # plain version keeps f32, and the kernels are held to the plain bf16
    # version. In f32 they are held to the plain version run in float64 on
    # the same inputs (the exact values): two f32 orders of these sums lie
    # further apart than either lies from the exact values where dP - delta
    # cancels (the plain f32 version 1.31e-4 from them, the kernel 5.05e-5,
    # on one call of the f32 step; NVIDIA H100 80GB HBM3, 700.00 W). Errors
    # are relative to each tensor's largest entry.
    f32 = dtype == torch.float32
    errs = {"dq": [], "dk": [], "dv": []}
    plain_errs = {"dq": [], "dk": [], "dv": []}  # f32: the plain f32 version's own distance from the exact values
    for args in calls:
        got = A.attention_backward(*args)
        ref = A.attention_backward_plain(*args)
        if f32:
            exact = A.attention_backward_plain(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                                                 for a in args))
            for name, r, e in zip(plain_errs, ref, exact):
                plain_errs[name].append(_grad_error((r,), (e,)))
            ref = exact
        for name, a, r in zip(errs, got, ref):
            errs[name].append(_grad_error((a,), (r,)))
    torch.cuda.synchronize()
    # the f32 kernels at heads of 128 (3xTF32 products): each gradient's worst distance from the
    # exact values over the step's calls no more than twice the plain f32 version's worst. Call by
    # call the plain version's own distance swings tenfold, and no f32 order holds to twice it:
    # the f32 FFMA kernels at 128 that these replaced came to 3.06x on one call (PERF.md)
    if f32 and A.padded_head_dim(calls[0][0].shape[2] // calls[0][-1]) == A.CHUNK:
        step_ratio = max(max(errs[n]) / max(max(plain_errs[n]), 1e-30) for n in errs)
        call_ratio = max(errs[n][i] / max(plain_errs[n][i], 1e-30) for n in errs for i in range(len(calls)))
        print(f"  the kernels' worst distance from the exact values over the plain f32 version's, per gradient "
              f"over the step's calls: {step_ratio:.3f} (limit 2); call by call at worst {call_ratio:.3f}")
        check(step_ratio <= 2, f"{label}: the f32 kernels at 128 lie further from float64 than twice the plain "
                               "version")
    kind = str(dtype)[6:]
    tol = 1e-4 if f32 else 2e-2
    against = "the plain version in float64" if f32 else "plain FA2"
    print(f"training ({label}): the {len(calls)} attention backward calls of one {kind} step, kernels vs {against} "
          f"on the same inputs, error relative to the largest entry (tol {tol}): " + ", ".join(
              f"{n} worst {max(e):.3e} median {statistics.median(e):.3e}" for n, e in errs.items())
          + ("; the plain f32 version's own: " + ", ".join(f"{n} worst {max(e):.3e}" for n, e in plain_errs.items())
             if f32 else ""))
    worst = max(max(e) for e in errs.values())
    check(worst <= tol, f"{label}: attention backward kernels disagree with {against} in training ({worst})")

    # each call's exact gradient: autograd of the plain attention on the
    # float64 upcast of its inputs. How far from it are the kernels (delta =
    # rowsum(P * dP)), FA2's delta = rowsum(dO * O) from the stored output
    # (the TPU kernel's choice, in the plain version) and what the
    # all-plain path computes (autograd of the plain attention in `dtype`)?
    # "sum dq" is dq summed over batch and rows, which is what the query
    # projection's bias receives (the key projection's gets 0 in exact
    # arithmetic: a shift shared by all keys leaves the softmax as it is).
    cands = ("kernels", f"FA2 delta from {kind} O", f"plain {kind} autograd")
    cos = {c: {n: [] for n in ("dq", "dk", "dv", "sum dq")} for c in cands}
    dist = {c: [] for c in cands}  # the largest of dq, dk, dv's distances, relative to the largest entry
    for q, k, v, mask, lse, dout, h in calls:
        qf, kf, vf = (t.double().requires_grad_() for t in (q, k, v))
        truth = torch.autograd.grad(A.attention_plain(qf, kf, vf, mask, h, "float32"), (qf, kf, vf), dout.double())
        out = A.attention_lse(q, k, v, mask, h)[0]  # the forward's output, in `dtype`
        b, n, dt = out.shape
        delta = (out.float() * dout.float()).reshape(b, n, h, dt // h).sum(-1).transpose(1, 2)
        qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
        got = dict(zip(cands, (A.attention_backward(q, k, v, mask, lse, dout, h),
                               A.attention_backward_plain(q, k, v, mask, lse, dout, h, delta),
                               torch.autograd.grad(A.attention_plain(qb, kb, vb, mask, h, "float32"),
                                                   (qb, kb, vb), dout))))
        for c, g in got.items():
            for i, name in enumerate(("dq", "dk", "dv")):
                cos[c][name].append(_cosine(g[i], truth[i]))
            dist[c].append(_grad_error(g, truth))
            cos[c]["sum dq"].append(_cosine(g[0].double().sum((0, 1)), truth[0].sum((0, 1))))
    for c in cands:
        print(f"  gradient cosine to each call's exact gradient, {c}: " + ", ".join(
            f"{n} median {statistics.median(v):.5f} worst {min(v):.5f}" for n, v in cos[c].items())
              + f"; distance to it, relative to the largest entry: median {statistics.median(dist[c]):.2e}, worst "
              f"{max(dist[c]):.2e}")
    # every call's gradients point where the exact ones do: bf16 inputs,
    # f32 inside (the plain bf16 path's attention read 0.9994 at worst on
    # the H100)
    worst = min(min(v) for v in cos["kernels"].values())
    check(worst >= 0.99, f"{label}: attention backward kernels turn from the exact gradient ({worst})")


def compare_paths(torch, sg, label, kp0, kp1, gt0, gt1, shape, n_attn):
    """One step's loss and gradients of copies of `sg` on the kernel path
    and the all-plain path, each in bf16 and f32, on the same pair; and
    the kernel bf16 step's attention backward calls, one by one."""
    import copy

    from image_matching_tpu_torch.losses.superglue_loss import superglue_nll_loss
    from image_matching_tpu_torch.ops import _build

    h, w = shape
    paths = (("kernel bf16", False, torch.bfloat16), ("plain bf16", True, torch.bfloat16),
             ("kernel f32", False, torch.float32), ("plain f32", True, torch.float32))
    grads, losses, calls = {}, {}, []
    for path, plain, dtype in paths:
        model = copy.deepcopy(sg)
        model.dtype = dtype
        if plain:
            ctx = plain_path()
        elif path == "kernel bf16":
            ctx = recorded_backward_calls(torch, calls)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            _build.reset_launch_counts()
            out = model(kp0, kp1, (h, w), (h, w), train=True)
            loss = superglue_nll_loss(out["log_coupling"], gt0, gt1, kp0.mask, kp1.mask)
            loss.backward()
            torch.cuda.synchronize()
            if plain:
                check(not _build.LAUNCHES, f"plain training path launched kernels: {dict(_build.LAUNCHES)}")
            else:
                check(_build.LAUNCHES["attention_dq"] == n_attn, f"{path} path missed the kernels")
        losses[path] = loss.item()
        grads[path] = {n: p.grad for n, p in model.named_parameters()}
    check_backward_calls(torch, calls, label, n_attn, torch.bfloat16)
    # some biases have a gradient of 0 in exact arithmetic, because the
    # per-channel shift they add reaches a batch norm, which removes it:
    # a Dense bias ahead of a norm; the merge projection's and the value
    # projection's (softmax rows sum to 1, so a shift of V shifts the
    # output), which reach the message MLP's norm; and the key
    # projection's (a shift shared by all keys leaves the softmax as it
    # is). Every path holds rounding noise there, so those are reported
    # by size, not by direction.
    ref = grads["plain f32"]
    shifted = {n for n in ref if n.endswith(("attn.proj_k.bias", "attn.proj_v.bias", "attn.merge.bias"))
               or (n.endswith(".bias") and ".Dense_" in n
                   and n.replace(".Dense_", ".MaskedBatchNorm1d_").replace(".bias", ".weight") in ref)}
    names = [n for n in ref if n not in shifted]
    cos = {(a, b): {n: _cosine(grads[a][n], grads[b][n]) for n in names}
           for a, b in (("kernel bf16", "plain bf16"), ("kernel bf16", "plain f32"), ("plain bf16", "plain f32"),
                        ("kernel f32", "plain f32"))}
    flat = lambda g: torch.cat([g[n].float().flatten() for n in names])
    glob = {pair: _cosine(flat(grads[pair[0]]), flat(grads[pair[1]])) for pair in cos}
    noise = max(grads[lab][n].abs().max().item() for n in shifted for lab in grads) / max(
        g.abs().max().item() for g in ref.values())
    print(f"training ({label}): one step, same parameters and pair: loss " + ", ".join(
        f"{lab} {v:.6f}" for lab, v in losses.items()) + f"; the {len(shifted)} biases with zero exact "
          f"gradient: largest entry {noise:.3e} of the largest f32 gradient entry")
    for pair, c in cos.items():
        worst = min(c, key=c.get)
        print(f"  gradient cosine {pair[0]} / {pair[1]}: all {len(names)} tensors as one {glob[pair]:.6f}; per "
              f"tensor median {statistics.median(c.values()):.6f}, worst {c[worst]:.6f} ({worst})")
    bf = cos[("kernel bf16", "plain bf16")]
    big = sorted(names, key=lambda n: -ref[n].norm().item())[:4]
    for n in sorted(names, key=bf.get)[:4] + big:
        print(f"    {n}: kernel/plain bf16 {bf[n]:.5f}; against f32: kernel bf16 "
              f"{cos[('kernel bf16', 'plain f32')][n]:.5f}, plain bf16 {cos[('plain bf16', 'plain f32')][n]:.5f}; "
              f"|g| {ref[n].norm().item() / max(g.norm().item() for g in ref.values()):.3e} of the largest tensor's")
    # f32: the two paths differ only in summation order and the kernels'
    # fast exponentials, so every tensor whose exact gradient is not 0 must
    # point the same way. bf16 is not held per tensor at the model's level:
    # rounding to bf16 at every layer, compounded through 36 batch-normed
    # layer sides, turns the model's gradient around on its own (the plain
    # bf16 path against f32, printed above, measured a global cosine of
    # 0.13 at random init on the H100). The bf16 kernels are held call by
    # call above, and the two bf16 paths by loss.
    c32 = cos[("kernel f32", "plain f32")]
    check(min(c32.values()) >= 0.99, f"f32 kernel and plain gradients disagree ({min(c32, key=c32.get)})")
    check(abs(losses["kernel f32"] - losses["plain f32"]) <= 1e-4 * abs(losses["plain f32"]),
          "f32 kernel and plain losses disagree")
    check(abs(losses["kernel bf16"] - losses["plain bf16"]) <= 1e-2 * abs(losses["plain bf16"]),
          "bf16 kernel and plain losses disagree")


# the training CLI's SuperGlue (D = 128, 18 GNN layers, 100 Sinkhorn iterations)
SG_TRAIN_KW = dict(descriptor_dim=128, keypoint_encoder=(32, 64, 128), gnn_layers=18, sinkhorn_iterations=100)


def train_at_cli_defaults(torch, dev, images, dtype: str):
    """SuperGlue training at the training CLI's defaults in `dtype` on
    `images` (batch 4 at 240x320; K=512, lr 1e-4, frozen SuperPoint in the
    same dtype, warm start from the banked weights), through the kernels:
    launch counts of one step, steps/s, peak memory, per-step metrics and
    the profile of a step. Returns (sg, sp, state, step, gen, launches, sec)."""
    from image_matching_tpu_torch.models import SuperGlue, SuperPointBN
    from image_matching_tpu_torch.ops import _build
    from image_matching_tpu_torch.train.state import TrainState
    from image_matching_tpu_torch.train.superglue_trainer import SuperGluePairConfig, make_superglue_train_step
    from image_matching_tpu_torch.weights import load_npz

    label = "training" if dtype == "bfloat16" else "f32 training"
    sp = SuperPointBN(128, compute_dtype=dtype, device=dev)
    load_npz(sp, str(ROOT / "weights" / "sp_photo.npz"))
    sg = SuperGlue(**SG_TRAIN_KW, compute_dtype=dtype, device=dev)
    load_npz(sg, str(ROOT / "weights" / "sg_photo.npz"))
    state = TrainState.create(sg, 1e-4)
    # K=512, threshold 0.005, NMS 4, 3 px, patch 0.85 with artifacts
    step = make_superglue_train_step(sg, sp, SuperGluePairConfig())
    gen = torch.Generator(device=dev).manual_seed(0)

    for _ in range(2):  # warm-up: cuDNN algorithm choice, allocator
        step(state, images, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    m = step(state, images, gen)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_attn = 2 * SG_TRAIN_KW["gnn_layers"]
    print(f"{label} launches per step: {launches} (entry_conv 1: both views in one 2B-batched "
          f"SuperPoint call, where the JAX trainer makes two; no Sinkhorn kernel: training runs the "
          f"differentiable loop)")
    check(launches == {"entry_conv": 1, "attention_lse": n_attn, "attention_dkdv": n_attn, "attention_dq": n_attn},
          f"{label} launch counts {launches}")

    history, times = [m], []
    for _ in range(10):
        t0 = time.perf_counter()
        history.append(step(state, images, gen))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sec = statistics.median(times)
    print(f"{label}: {1 / sec:.3f} steps/s ({sec * 1e3:.2f} ms per step of batch {images.shape[0]}, median of 10 "
          f"after 2 warm-up steps; min {min(times) * 1e3:.2f} ms, max {max(times) * 1e3:.2f} ms); peak memory "
          f"{peak_gib:.3f} GiB; TF32 off")
    for i, mm in enumerate(history):
        vals = {k: float(v) for k, v in mm.items()}
        print(f"  step {i}: loss {vals['loss']:.4f}, gt_matches {int(vals['gt_matches'])}, "
              f"pred_matches {int(vals['pred_matches'])}, match precision {vals['match_precision']:.4f}, "
              f"recall {vals['match_recall']:.4f}, skipped {int(vals['skipped_nonfinite'])}")
        check(all(math.isfinite(x) for x in vals.values()), f"{label} step {i}: non-finite metrics {vals}")
        check(vals["skipped_nonfinite"] == 0, f"{label} step {i} was skipped")
    check(state.step == 13, f"train state step {state.step} != 13")
    profile_calls(torch, lambda: step(state, images, gen), sec, label, "step", reps=2)
    check(all(torch.isfinite(p).all() for p in sg.parameters()), f"non-finite parameters after {label}")
    return sg, sp, state, step, gen, launches, sec


def run_training(torch, dev):
    """SuperGlue training at the training CLI's defaults, through the
    kernels, in bf16 and then f32 (`run_f32_training`). Returns the launch
    counts of one step of each."""
    import numpy as np
    from image_matching_tpu_torch.models import SuperGlue
    from image_matching_tpu_torch.train.state import TrainState
    from image_matching_tpu_torch.train.superglue_trainer import (
        SuperGluePairConfig,
        generate_pair_from_homographies,
        train_on_pair,
    )
    from image_matching_tpu_torch.geometry.homography import sample_homography_batch

    batch, h, w = 4, 240, 320
    rng = np.random.default_rng(2)
    images = torch.from_numpy(np.stack([texture(torch, rng, h, w) for _ in range(batch)])[..., None]).to(dev)
    sg, sp, _, _, gen, launches, _ = train_at_cli_defaults(torch, dev, images, "bfloat16")
    f32_launches = run_f32_training(torch, dev, images)

    # kernel path vs all-plain path, one step: same parameters, same pair
    cfg = SuperGluePairConfig()
    n_attn = 2 * SG_TRAIN_KW["gnn_layers"]
    hs = sample_homography_batch(gen, batch, h, w, cfg.homography)
    pair = generate_pair_from_homographies(hs, sp, images, cfg)
    kp0, kp1, gt0, gt1 = pair[:4]
    compare_paths(torch, sg, "warm start", kp0, kp1, gt0, gt1, (h, w), n_attn)
    fresh = SuperGlue(**SG_TRAIN_KW, compute_dtype="bfloat16", device=dev, seed=1)
    compare_paths(torch, fresh, "random init", kp0, kp1, gt0, gt1, (h, w), n_attn)

    # learning: random init, lr 1e-3, 10 steps on one fixed batch and pair
    fstate = TrainState.create(fresh, 1e-3)
    curve = [float(train_on_pair(fstate, kp0, kp1, gt0, gt1, (h, w))["loss"]) for _ in range(10)]
    print("training: random init, lr 1e-3, one fixed batch: loss " + ", ".join(f"{x:.4f}" for x in curve))
    check(all(math.isfinite(x) for x in curve) and curve[-1] < curve[0], "loss did not fall on one batch")
    return launches, f32_launches


def run_f32_training(torch, dev, images):
    """The same training at compute_dtype="float32" (SuperPoint and SuperGlue
    in f32, TF32 off), the path of the f32 kernels, on the same images
    (`train_at_cli_defaults`); every attention backward call of the next
    f32 step against the plain version and its float64 exact gradient; then
    the step profiled on the builds of `build/attention_before.cu` and
    `build/attention_bwd_before.cu` where those files are there (one
    swapped at a time). Returns the launch counts of one step."""
    _, _, state, step, gen, launches, sec = train_at_cli_defaults(torch, dev, images, "float32")
    # the checked step comes first, so that it is the same step whether or not earlier builds
    # are there to profile (each profiled step trains on)
    calls = []
    with recorded_backward_calls(torch, calls):
        step(state, images, gen)
    check_backward_calls(torch, calls, "f32 training", 2 * SG_TRAIN_KW["gnn_layers"], torch.float32)
    for name, source in (("attention", EARLIER_ATTENTION), ("attention_bwd", EARLIER_ATTENTION_BWD)):
        if source.exists():  # the same step on an earlier build of the attention kernels
            earlier = build_variants(name, [("before", source, ())])["before"]
            profile_calls(torch, with_attention_library(name, earlier, lambda: step(state, images, gen)), sec,
                          f"f32 training on build/{source.name} (busy share against this build's median step)",
                          "step", reps=2)
    return launches


# ---------------------------------------------------------------- 2x2 s2d backbone: kernels

# one detect of 4 images at 480x640 through the 2x2 backbone: (ci, co, H, W) of
# its four entry convs and (H, W, C) of its three pools' outputs
S2D_BATCH = 4
S2D_ENTRY_SHAPES = ((1, 64, 480, 640), (64, 64, 240, 320), (64, 128, 120, 160), (128, 128, 60, 80))
S2D_POOL_SHAPES = ((240, 320, 64), (120, 160, 64), (60, 80, 128))


def _rel_err(got, ref):
    """max |got - ref| / max(|ref|, 1), and max |got - ref|."""
    d = (got.float() - ref.float()).abs()
    return (d / ref.float().abs().clamp_min(1.0)).max().item(), d.max().item()


EARLIER_S2D_ENTRY = ROOT / "build" / "s2d_entry_conv_before.cu"


def _earlier_s2d_entry(torch, lib, x, k):
    """A call of the s2d entry conv through the C interface of its first
    version (the first `csrc/s2d_entry_conv.cu`: `s2d_entry_conv_bf16_mma`
    with (co, 9 ci) weights where ci % 16 == 0 and co % 64 == 0, else
    `s2d_entry_conv_bf16_simt` with ((ky, kx, ci), co) f32 weights). The
    weights are re-laid out here, once, so that the returned function
    launches the kernel alone."""
    import ctypes

    from image_matching_tpu_torch.ops import _build

    b, h, w, ci = x.shape
    co = k.shape[3]
    if ci % 16 == 0 and co % 64 == 0:
        fn, weights = lib.s2d_entry_conv_bf16_mma, k.permute(3, 0, 1, 2).reshape(co, 9 * ci).contiguous()
    else:
        fn, weights = lib.s2d_entry_conv_bf16_simt, k.float().reshape(9 * ci, co).contiguous()
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, h // 2, w // 2, 4 * co), dtype=x.dtype, device=x.device)

    def call():
        _build.check(fn(_build.ptr(x), _build.ptr(weights), _build.ptr(out), b, h, w, ci, co,
                        _build.stream_ptr(x.device)), "s2d_entry_conv (earlier build)")
        return out
    return call


def s2d_entry_callers(torch, libs, x, k):
    """{label: function} of the s2d entry conv through each build in
    `libs` (label -> library): the wrapper where the library exports this
    checkout's C interface, `_earlier_s2d_entry` where it exports the first
    version's."""
    from image_matching_tpu_torch.ops.s2d_entry import s2d_entry_conv

    return {label: (with_library("s2d_entry_conv", lib, lambda: s2d_entry_conv(x, k))
                    if hasattr(lib, "s2d_entry_conv_bf16_wg") else _earlier_s2d_entry(torch, lib, x, k))
            for label, lib in libs.items()}


def s2d_entry_libs():
    """{label: library} of the s2d entry conv: this checkout's build and,
    where `build/s2d_entry_conv_before.cu` holds an earlier source (left
    there by hand to compare with), that one's."""
    from image_matching_tpu_torch.ops import _build

    builds = [("before", EARLIER_S2D_ENTRY, ())] if EARLIER_S2D_ENTRY.exists() else []
    return {"this checkout": _build.library("s2d_entry_conv"), **build_variants("s2d_entry_conv", builds)}


def time_interleaved(fns, reps: int = 10):
    """Graph-replay ms per call of each of `fns` (label -> function), every
    one in turn and then again in the reverse order: {label: [ms, ms]}."""
    times = {label: [] for label in fns}
    for label in list(fns) + list(fns)[::-1]:
        times[label].append(graph_ms(fns[label], reps))
    return times


def check_s2d_entry_conv(torch, dev, rng, libs):
    """The s2d entry conv against its plain version at the four shapes of
    one detect of 4 images at 480x640 and at ragged ones; times per shape
    by CUDA graph replay: this checkout's kernel, interleaved with the
    first version's kernel from `build/s2d_entry_conv_before.cu` when that
    file is there, cuDNN conv + `space_to_depth`, the plain version and
    the bound. `libs` is `s2d_entry_libs()`."""
    import torch.nn.functional as F
    from image_matching_tpu_torch.ops.s2d_conv import conv3x3_s2d_entry, space_to_depth
    from image_matching_tpu_torch.ops.s2d_entry import s2d_entry_conv


    b = S2D_BATCH
    worst, totals, bound_ms, bytes_bound_ms = 0.0, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}, 0.0, 0.0
    per_build = {label: 0.0 for label in libs}
    for ci, co, h, w in S2D_ENTRY_SHAPES:
        x = torch.from_numpy(rng.normal(size=(b, h, w, ci)).astype("float32")).to(dev, torch.bfloat16)
        k = torch.from_numpy(rng.normal(0, 0.3, (3, 3, ci, co)).astype("float32")).to(dev, torch.bfloat16)
        ref = conv3x3_s2d_entry(x, k)
        fns = s2d_entry_callers(torch, libs, x, k)
        for label, fn in fns.items():
            rel, err = _rel_err(fn(), ref)
            torch.cuda.synchronize()
            if label == "this checkout":
                worst = max(worst, err)
            # the same bf16 products summed in f32 in another order, one rounding
            # to bf16 each: at most one bf16 step (2^-7 relative)
            print(f"s2d_entry_conv ({b}, {h}, {w}) {ci}->{co} bf16 [{label}]: max_abs_err {err:.3e}, "
                  f"max err/max(|y|,1) {rel:.3e} (tolerance 2^-7)")
            check(rel <= 2 ** -7, f"s2d_entry_conv {ci}->{co} at {h}x{w} [{label}] disagrees with its plain version")
        # the library's way: one cuDNN conv on the NCHW (channels_last) view, then the re-layout
        x_nchw, k_oihw = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib = lambda: space_to_depth(F.conv2d(x_nchw, k_oihw, padding=1).permute(0, 2, 3, 1))
        times = time_interleaved(fns)
        t = {"ms": statistics.mean(times["this checkout"]), "plain_ms": graph_ms(lambda: conv3x3_s2d_entry(x, k), 5),
             "library_ms": graph_ms(lib, 10)}
        npix = b * h * w
        # the 1-channel image conv pads its 9 taps to 16 for the tensor cores,
        # but the function needs 9: its bound is its bytes either way
        bms, by = bound(npix * ci * 2 + 9 * ci * co * 2 + npix * co * 2, 2.0 * npix * co * 9 * ci, BF16_TENSOR_FLOPS)
        print(f"s2d_entry_conv ({b}, {h}, {w}) {ci}->{co} bf16: device time (CUDA graph replay, builds interleaved) "
              + "; ".join(f"{label} " + " / ".join(f"{v:.4f}" for v in ts) + " ms" for label, ts in times.items())
              + f"; plain {t['plain_ms']:.4f} ms, cuDNN conv + space_to_depth {t['library_ms']:.4f} ms "
              f"({t['ms'] / t['library_ms']:.2f}x); bound {bms:.4f} ms ({by})")
        for name in totals:
            totals[name] += t[name]
        for label, ts in times.items():
            per_build[label] += statistics.mean(ts)
        bound_ms += bms
        bytes_bound_ms += bms if by == "bytes" else 0.0

    # ragged shapes (no tile divides them) through every route, and two runs
    # giving the same bits: the register-tiled SIMT kernel in f32 and in bf16
    # (48 channels in); bf16 wgmma at 16, 64 and 128 channels; the bf16 image
    # conv on tensor cores
    for (rb, rh, rw, ci, co, dtype) in ((3, 38, 50, 8, 16, torch.float32), (2, 30, 26, 48, 64, torch.bfloat16),
                                        (2, 22, 36, 16, 64, torch.bfloat16),
                                        (3, 38, 50, 64, 128, torch.bfloat16), (1, 60, 80, 128, 128, torch.bfloat16),
                                        (3, 38, 50, 1, 64, torch.bfloat16), (2, 30, 26, 1, 128, torch.bfloat16)):
        x = torch.from_numpy(rng.normal(size=(rb, rh, rw, ci)).astype("float32")).to(dev, dtype)
        k = torch.from_numpy(rng.normal(0, 0.3, (3, 3, ci, co)).astype("float32")).to(dev, dtype)
        got = s2d_entry_conv(x, k)
        rel, _ = _rel_err(got, conv3x3_s2d_entry(x, k))
        tol = 1e-5 if dtype == torch.float32 else 2 ** -7
        same = bool(torch.equal(got, s2d_entry_conv(x, k)))
        print(f"s2d_entry_conv ({rb}, {rh}, {rw}) {ci}->{co} {str(dtype)[6:]}: max err/max(|y|,1) {rel:.3e} "
              f"(tolerance {tol}), a second run bit-identical: {same}")
        check(rel <= tol and same, f"s2d_entry_conv ({rb}, {rh}, {rw}) {ci}->{co} disagrees or is not reproducible")
    n = len(S2D_ENTRY_SHAPES)
    print(f"s2d_entry_conv: one detect of {b} images (4 launches): " + "; ".join(
        f"{label} {v:.4f} ms" for label, v in per_build.items()) + f"; plain {totals['plain_ms']:.4f} ms, library "
          f"{totals['library_ms']:.4f} ms, bound {bound_ms:.4f} ms; the JSON line holds the mean per launch")
    return dict(name="s2d_entry_conv", route="cuda", source="image_matching_tpu_torch/csrc/s2d_entry_conv.cu",
                replaces="image_matching_tpu/ops/pallas/entry_conv.py:66", max_abs_err=worst,
                ms=totals["ms"] / n, plain_ms=totals["plain_ms"] / n, bound_ms=bound_ms / n,
                # what sets most of the summed bound of the four shapes
                bound_by="bytes" if bytes_bound_ms >= 0.5 * bound_ms else "operations",
                library_ms=totals["library_ms"] / n)


def check_realign(torch, dev, rng):
    import torch.nn.functional as F
    from image_matching_tpu_torch.ops.realign import maxpool_realign
    from image_matching_tpu_torch.ops.s2d_conv import depth_to_space, maxpool2x2_s2d_from_raw, realign

    b = S2D_BATCH
    worst, totals, bound_ms = 0.0, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}, 0.0
    for h, w, c in S2D_POOL_SHAPES:
        u = torch.from_numpy(rng.normal(size=(b, h + 1, w + 1, 4 * c)).astype("float32")).to(dev, torch.bfloat16)
        got, ref = maxpool_realign(u), maxpool2x2_s2d_from_raw(u)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        worst = max(worst, err)
        check(err == 0.0, f"realign at U ({b}, {h + 1}, {w + 1}, {4 * c}) differs from its plain version ({err})")
        # the library's way: realign, back to the direct layout, F.max_pool2d
        lib = lambda: F.max_pool2d(depth_to_space(realign(u)).permute(0, 3, 1, 2), 2, 2)
        check(bool((lib().permute(0, 2, 3, 1) == ref).all()), "max_pool2d of the realigned U differs")
        t = {"ms": graph_ms(lambda: maxpool_realign(u), 10), "plain_ms": graph_ms(lambda: maxpool2x2_s2d_from_raw(u), 5),
             "library_ms": graph_ms(lib, 5)}
        bms, by = bound(u.numel() * 2 + got.numel() * 2, 3.0 * got.numel(), F32_FLOPS)
        print(f"realign U ({b}, {h + 1}, {w + 1}, {4 * c}) bf16 -> ({b}, {h}, {w}, {c}): max_abs_err {err:.1e} "
              f"(exact); device time (CUDA graph replay) kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, realign + d2s + "
              f"F.max_pool2d {t['library_ms']:.4f} ms; bound {bms:.4f} ms ({by})")
        for name in totals:
            totals[name] += t[name]
        bound_ms += bms
    # f32, a U widened by extra columns, odd sizes, a NaN
    u = torch.from_numpy(rng.normal(size=(3, 8, 17, 4 * 12)).astype("float32")).to(dev)
    u[1, 2, 3, 12] = float("nan")
    got, ref = maxpool_realign(u, out_w=11), maxpool2x2_s2d_from_raw(u, 11)
    check(bool(torch.isnan(got[1, 2, 2, 0])) and int(torch.isnan(got).sum()) == 1, "realign: a NaN tap is not carried")
    check(bool(((got == ref) | (torch.isnan(got) & torch.isnan(ref))).all()), "realign f32 / out_w differs from its plain version")
    print("realign U (3, 8, 17, 48) f32, out_w 11, one NaN tap: equal to the plain version, NaN carried")
    n = len(S2D_POOL_SHAPES)
    print(f"realign: one detect of {b} images (3 launches): kernel {totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} "
          f"ms, library {totals['library_ms']:.4f} ms, bound {bound_ms:.4f} ms; the JSON line holds the mean per launch")
    return dict(name="realign", route="cuda", source="image_matching_tpu_torch/csrc/realign.cu",
                replaces="image_matching_tpu/ops/pallas/realign.py:77", max_abs_err=worst,
                ms=totals["ms"] / n, plain_ms=totals["plain_ms"] / n, bound_ms=bound_ms / n, bound_by="bytes",
                library_ms=totals["library_ms"] / n)


# ---------------------------------------------------------------- registration path

REGISTRATION_LAUNCHES = {"s2d_entry_conv": 8, "realign": 6, "attention": 36, "sinkhorn": 1}


def compare_backbones(torch, model, plain_model, images, label, tol, layout: str = "2x2", others=()):
    """The s2d backbone (`layout`) through its kernels against (a) the same
    s2d path on the plain versions and (b) the plain backbone with the same
    weights, on `semi` and `desc_map`; then both backbones' time, and that
    of each (name, model) in `others`."""
    from image_matching_tpu_torch.ops import _build

    with torch.inference_mode():
        got = model.superpoint(images)
        with plain_path():
            _build.reset_launch_counts()
            same_path = model.superpoint(images)
            torch.cuda.synchronize()
            check(not _build.LAUNCHES, f"plain {layout} path launched kernels: {dict(_build.LAUNCHES)}")
        other = plain_model.superpoint(images)
    errs = {}
    for key in ("semi", "desc_map"):
        scale = other[key].abs().max().item()
        errs[key] = ((got[key] - same_path[key]).abs().max().item() / scale,
                     (got[key] - other[key]).abs().max().item() / scale)
    print(f"{label}: {layout} backbone through the kernels, max error relative to the largest entry: against the "
          f"{layout} path on the plain versions semi {errs['semi'][0]:.3e}, desc_map {errs['desc_map'][0]:.3e}; against "
          f"the plain backbone semi {errs['semi'][1]:.3e}, desc_map {errs['desc_map'][1]:.3e} (tolerance {tol})")
    check(max(max(e) for e in errs.values()) <= tol, f"{label}: the {layout} backbone disagrees with the plain one")
    # the backbone alone can be captured into a CUDA graph (the postprocess,
    # the same for both, copies small constants from the host)
    with torch.inference_mode():
        t = {name: (graph_ms(lambda: m.superpoint(images), 3), cuda_ms(lambda: m.detect(images), 5))
             for name, m in ((layout, model), ("plain", plain_model), *others)}
    print(f"{label}: {images.shape[0]} images: backbone alone, device time (CUDA graph replay): "
          + ", ".join(f"{name} {v[0]:.3f} ms" for name, v in t.items())
          + "; whole detect, CUDA events over back-to-back eager calls (the host's launch rate included): "
          + ", ".join(f"{name} {v[1]:.3f} ms" for name, v in t.items()))


def run_registration(torch, dev, backbone: str, timed: bool):
    """Registration at the headline's width through the 2x2 s2d backbone:
    detect each side, SuperGlue, homography RANSAC with 512 hypotheses,
    warp. Returns the launch counts of one call."""
    import dataclasses

    import numpy as np
    from image_matching_tpu_torch.models import Matching, MatchingConfig
    from image_matching_tpu_torch.ops import _build
    from image_matching_tpu_torch.registration import build_registration_fn

    batch, h, w, k = 4, 480, 640, 1024
    cfg = MatchingConfig(backbone=backbone, s2d_backbone=True, s2d_layout="2x2", descriptor_dim=256,
                         max_keypoints=k, keypoint_threshold=0.005, gnn_layers=18, sinkhorn_iterations=30,
                         match_threshold=0.1, compute_dtype="bfloat16")
    model = Matching(cfg, device=dev, seed=0)
    plain_model = Matching(dataclasses.replace(cfg, s2d_backbone=False), device=dev, seed=0)
    plain_model.load_state_dict(model.state_dict(), strict=True)
    register = build_registration_fn(model, matcher="superglue", ransac_model="homography", num_hypotheses=512)
    rng = np.random.default_rng(3)
    image0 = torch.from_numpy(rng.uniform(0, 1, (batch, h, w, 1)).astype("float32")).to(dev)
    image1 = torch.from_numpy(rng.uniform(0, 1, (batch, h, w, 1)).astype("float32")).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    label = f"registration ({backbone}, 2x2)"

    for _ in range(2):  # warm-up: cuDNN algorithm choice, allocator
        register(image0, image1, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = register(image0, image1, gen)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label} launches per call of {batch} pairs: {launches}")
    check(launches == REGISTRATION_LAUNCHES, f"{label} launch counts {launches} != {REGISTRATION_LAUNCHES}")
    check(tuple(res.fit.matrix.shape) == (batch, 3, 3) and bool(torch.isfinite(res.fit.matrix).all()),
          f"{label}: fit matrix")
    check(tuple(res.warped.shape) == (batch, h, w, 1) and bool(torch.isfinite(res.warped).all()), f"{label}: warp")
    check(tuple(res.kpts0.desc.shape) == (batch, k, 256) and tuple(res.fit.inliers.shape) == (batch, k),
          f"{label}: shapes")
    print(f"{label}: keypoints per image {res.kpts0.num_valid().tolist()} / {res.kpts1.num_valid().tolist()}, matches "
          f"{res.matches.num_matches().tolist()}, fits valid {res.fit.valid.tolist()} (random weights)")
    # bf16 rounds at other places on the two backbones (the plain one's first
    # layer is one fused pass, the 2x2 one rounds the conv before the bias);
    # a dozen layers carry that on: a few bf16 steps of the largest entry
    compare_backbones(torch, model, plain_model, image0, label, tol=5e-2)
    if timed:
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            register(image0, image1, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        sec = statistics.median(times)
        print(f"{label}: {batch / sec:.2f} pairs/s (median of 10 calls, {sec * 1e3:.2f} ms per batch of {batch}; min "
              f"{min(times) * 1e3:.2f} ms, max {max(times) * 1e3:.2f} ms); peak memory {peak_gib:.3f} GiB; TF32 off")
        profile_calls(torch, lambda: register(image0, image1, gen), sec, label, "call", reps=3)
        plain_register = build_registration_fn(plain_model, matcher="superglue", ransac_model="homography",
                                               num_hypotheses=512)
        for _ in range(2):
            plain_register(image0, image1, gen)
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            plain_register(image0, image1, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"registration ({backbone}, plain backbone), same weights: {batch / statistics.median(times):.2f} pairs/s "
              f"(median of 10 calls, {statistics.median(times) * 1e3:.2f} ms)")
    return launches


F32_BACKBONE_LAUNCHES = {"s2d_entry_conv": 4, "realign": 3}


def run_f32_backbone(torch, dev, libs):
    """One f32 detect of 4 images at 480x640 through the 2x2 s2d backbone
    (`Matching` at compute_dtype="float32", `SuperPointBN`: its three deep
    entry convs take `s2d_entry_ffma`): launch counts, agreement with the
    2x2 path on the plain versions and with the plain f32 backbone on the
    same weights, and both backbones' device time, the 2x2 one on each
    build in `libs` (`s2d_entry_libs()`). Returns the launch counts of the
    detect."""
    import dataclasses

    import numpy as np
    from image_matching_tpu_torch.models import Matching, MatchingConfig
    from image_matching_tpu_torch.ops import _build

    batch, h, w, k = 4, 480, 640, 1024
    cfg = MatchingConfig(backbone="bn", s2d_backbone=True, s2d_layout="2x2", descriptor_dim=256, max_keypoints=k,
                         keypoint_threshold=0.005, compute_dtype="float32")
    model = Matching(cfg, device=dev, seed=0)
    plain_model = Matching(dataclasses.replace(cfg, s2d_backbone=False), device=dev, seed=0)
    plain_model.load_state_dict(model.state_dict(), strict=True)
    images = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (batch, h, w, 1)).astype("float32")).to(dev)
    label = "f32 detect (bn, 2x2)"
    with torch.inference_mode():
        model.detect(images)  # warm-up
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        kp = model.detect(images)
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"{label} launches per detect of {batch} images: {launches}")
    check(launches == F32_BACKBONE_LAUNCHES, f"{label} launch counts {launches} != {F32_BACKBONE_LAUNCHES}")
    check(tuple(kp.desc.shape) == (batch, k, 256) and kp.desc.dtype == torch.float32
          and bool(torch.isfinite(kp.desc).all()), f"{label}: descriptors")
    print(f"{label}: keypoints per image {kp.num_valid().tolist()} (random weights)")
    # f32 on both backbones: sums in other orders through a dozen layers
    compare_backbones(torch, model, plain_model, images, label, tol=1e-4)
    if len(libs) > 1:  # the same backbone on each build of the s2d entry conv
        with torch.inference_mode():
            t = {name: graph_ms(with_library("s2d_entry_conv", lib, lambda: model.superpoint(images)), 3)
                 for name, lib in libs.items()}
        print(f"{label}: {batch} images: 2x2 backbone alone, device time (CUDA graph replay) by build of the s2d entry "
              "conv: " + "; ".join(f"{name} {ms:.3f} ms" for name, ms in t.items()))
    return launches


def random_pair(torch, dev, rng, h=480, w=640):
    """A seeded textured image and its warp by a seeded mild homography
    (rotation up to 10 degrees, scale 0.9-1.1, shift up to 20 px, a little
    perspective). Returns (image0, image1, H) with H (3, 3) float32 numpy,
    image0 -> image1 in pixels."""
    img = texture(torch, rng, h, w)
    H = pair_homography(h, w, rng.uniform(-10, 10), rng.uniform(0.9, 1.1), rng.uniform(-20, 20, 2),
                        rng.uniform(-3e-5, 3e-5, 2))
    return (*warped_pair(torch, dev, img, H), H.astype("float32"))


def run_banked_registration(torch, dev, n_pairs: int = 4):
    """Registration quality with the banked weights (sp_photo + sg_photo,
    D=128), subpixel refinement on: seeded textured pairs with known
    homographies through both backbones and both matchers."""
    import dataclasses

    import numpy as np
    from image_matching_tpu_torch.evaluation import EvalPair, evaluate_pipeline
    from image_matching_tpu_torch.models import Matching, MatchingConfig
    from image_matching_tpu_torch.models.superpoint import superpoint_postprocess
    from image_matching_tpu_torch.ops import _build
    from image_matching_tpu_torch.registration import build_registration_fn
    from image_matching_tpu_torch.weights import load_npz

    models = {}
    for name, s2d in (("2x2", True), ("plain", False)):
        cfg = dataclasses.replace(MatchingConfig.self_trained_128(), s2d_backbone=s2d, s2d_layout="2x2",
                                  subpixel=True)
        models[name] = Matching(cfg, device=dev, seed=0)
        load_npz(models[name].superpoint, str(ROOT / "weights" / "sp_photo.npz"))
        load_npz(models[name].superglue, str(ROOT / "weights" / "sg_photo.npz"))
    rng = np.random.default_rng(4)
    pairs, images = [], []
    for _ in range(n_pairs):
        im0, im1, H = random_pair(torch, dev, rng)
        pairs.append(EvalPair(im0[0].cpu().numpy(), im1[0].cpu().numpy(), H))
        images += [im0, im1]

    # detection: the two backbones' keypoint sets (before refinement)
    cfg = models["2x2"].config
    kp = {}
    with torch.inference_mode():
        for name, m in models.items():
            kp[name] = superpoint_postprocess(m.superpoint(torch.cat(images, 0)), cfg.max_keypoints,
                                              cfg.keypoint_threshold, cfg.nms_radius, cfg.border)
    iou = keypoint_set_iou(kp["2x2"], kp["plain"])
    print(f"banked registration: keypoint sets of the 2x2 and the plain backbone on {len(images)} images: IoU "
          f"{iou:.4f} (worst image; held to 0.9: bf16 NMS survivors tie within one step of the K-th score)")
    check(iou >= 0.9, f"banked registration: the backbones' keypoints differ ({iou})")

    for matcher in ("superglue", "ratio"):
        for name, m in models.items():
            register = build_registration_fn(m, matcher=matcher, ransac_model="homography", num_hypotheses=512,
                                             produce_warp=False)
            _build.reset_launch_counts()
            out = evaluate_pipeline(register, pairs, torch.Generator(device=dev).manual_seed(5), success_px=5.0,
                                    per_pair=True)
            errs = ", ".join("none" if p["corner_err_px"] is None else f"{p['corner_err_px']:.3f}" for p in out["per_pair"])
            print(f"banked registration ({matcher}, {name} backbone, subpixel): corner error per pair [{errs}] px, "
                  f"median {out['median_corner_err_px']}, success (< 5 px) {out['success_rate']:.2f}, mean matches "
                  f"{out['mean_matches']:.0f}, mean inliers {out['mean_inliers']:.0f}; launches over the "
                  f"{n_pairs} pairs {dict(_build.LAUNCHES)}")
            check(out["success_rate"] == 1.0, f"banked registration ({matcher}, {name}): a pair failed ({errs})")
            if name == "2x2":
                check(_build.LAUNCHES["s2d_entry_conv"] == 8 * n_pairs and _build.LAUNCHES["realign"] == 6 * n_pairs,
                      f"banked registration ({matcher}, 2x2) missed the kernels")


# ---------------------------------------------------------------- H-only layout and the evaluation CLI

def check_entry_conv_h(torch, dev, rng):
    """The image entry conv's alignedH output (`ops/entry_conv.entry_conv_h`,
    the H-only backbone's first layer) against its plain version at the
    2B-batched shape (8, 480, 640) in bf16, in f32 and at ragged shapes; equal
    bit for bit to `space_to_depth_h` of the direct kernel's output, two runs
    bit-identical; timed by CUDA graph replay beside the direct kernel
    (interleaved) and cuDNN conv + affine + ReLU + `space_to_depth_h`."""
    import torch.nn.functional as F
    from image_matching_tpu_torch.ops.entry_conv import entry_conv, entry_conv_h, entry_conv_h_plain
    from image_matching_tpu_torch.ops.s2d_conv import space_to_depth_h

    def direct_h(x, kk, sc, sh):
        return space_to_depth_h(entry_conv(x, kk, sc, sh).permute(0, 2, 3, 1))

    err = 0.0
    for b, h, w, dtype in ((8, 480, 640, torch.bfloat16), (2, 480, 640, torch.float32), (3, 96, 200, torch.bfloat16),
                           (3, 96, 200, torch.float32), (3, 38, 53, torch.bfloat16), (1, 2, 5, torch.float32)):
        img, k, scale, shift = _entry_inputs(torch, dev, rng, b, h, w)
        img = img.to(dtype)
        got = entry_conv_h(img, k, scale, shift)
        ref = entry_conv_h_plain(img, k, scale, shift).float()
        torch.cuda.synchronize()
        check(tuple(got.shape) == (b, h // 2, w, 128) and got.dtype == dtype, f"entry_conv_h shape {tuple(got.shape)}")
        rel = ((got.float() - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
        tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
        same = bool(torch.equal(got, entry_conv_h(img, k, scale, shift)))
        exact = bool(torch.equal(got, direct_h(img, k, scale, shift)))
        if (b, h, w, dtype) == (8, 480, 640, torch.bfloat16):
            err = (got.float() - ref).abs().max().item()
        # the same bf16-rounded inputs, f32 sums of 9 products in another order
        # than the plain version's, one rounding: at most one bf16 step
        print(f"entry_conv_h ({b}, {h}, {w}) {str(dtype)[6:]} -> ({b}, {h // 2}, {w}, 128): max err/max(|y|,1) "
              f"{rel:.3e} (tolerance {tol}); a second run bit-identical: {same}; equal bit for bit to "
              f"space_to_depth_h of the direct kernel's output: {exact}")
        check(rel <= tol and same and exact, f"entry_conv_h ({b}, {h}, {w}) {dtype} disagrees or is not reproducible")

    b, h, w = 8, 480, 640
    img, k, scale, shift = _entry_inputs(torch, dev, rng, b, h, w)
    times = time_interleaved({"alignedH": lambda: entry_conv_h(img, k, scale, shift),
                              "direct": lambda: entry_conv(img, k, scale, shift)}, reps=20)
    ms = statistics.mean(times["alignedH"])
    plain_ms = graph_ms(lambda: entry_conv_h_plain(img, k, scale, shift), 5)
    w_lib = k.permute(3, 2, 0, 1).to(torch.bfloat16)
    sc, sh = scale.to(torch.bfloat16)[:, None, None], shift.to(torch.bfloat16)[:, None, None]
    lib = lambda: space_to_depth_h(torch.relu(F.conv2d(img[:, None], w_lib, padding=1) * sc + sh).permute(0, 2, 3, 1))
    lib_ms = graph_ms(lib, 20)
    img32 = img.float()
    f32 = time_interleaved({"alignedH": lambda: entry_conv_h(img32, k, scale, shift),
                            "direct": lambda: entry_conv(img32, k, scale, shift)}, reps=20)
    npix = b * h * w
    bms, by = bound(npix * 2 + npix * 64 * 2 + (9 + 2) * 64 * 4, npix * 64 * (2 * 9 + 2), F32_FLOPS)
    bms32, _ = bound(npix * 4 + npix * 64 * 4 + (9 + 2) * 64 * 4, npix * 64 * (2 * 9 + 2), F32_FLOPS)
    print(f"entry_conv_h ({b}, {h}, {w}) bf16: ms per call by CUDA graph replay, interleaved: "
          + "; ".join(f"{label} " + " / ".join(f"{t:.4f}" for t in ts) for label, ts in times.items())
          + f" ({ms / statistics.mean(times['direct']):.3f} of the direct layout's); plain {plain_ms:.4f}; cuDNN conv + "
          f"affine + ReLU + space_to_depth_h {lib_ms:.4f} ({ms / lib_ms:.3f} of it); bound {bms:.4f} ({by}; "
          f"{bms / ms:.2f} of it reached). f32: "
          + "; ".join(f"{label} " + " / ".join(f"{t:.4f}" for t in ts) for label, ts in f32.items())
          + f"; bound {bms32:.4f}")
    return dict(name="entry_conv_h", route="cuda", source="image_matching_tpu_torch/csrc/entry_conv.cu",
                replaces="image_matching_tpu/ops/pallas/entry_h.py:119", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)


H_DETECT_LAUNCHES = {"entry_conv_h": 1}


def run_h_backbone(torch, dev):
    """One detect of 4 images at 480x640 through the H-only backbone (the
    JAX package's default layout), `SuperPointBN` and `SuperPointVGG`, bf16
    and f32, seeded random weights: launch counts, agreement with the H path
    on the plain versions and with the plain backbone on the same weights
    (bf16 within 5e-2, f32 within 1e-4 of the largest entry), and the
    backbones' device time (bn bf16: beside the 2x2 one too). Returns the
    launch counts of the bn bf16 detect."""
    import dataclasses

    import numpy as np
    from image_matching_tpu_torch.models import Matching, MatchingConfig
    from image_matching_tpu_torch.ops import _build

    batch, h, w, k = 4, 480, 640, 1024
    images = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, (batch, h, w, 1)).astype("float32")).to(dev)
    result = None
    for backbone in ("bn", "vgg"):
        for dtype in ("bfloat16", "float32"):
            cfg = MatchingConfig(backbone=backbone, s2d_backbone=True, s2d_layout="h", descriptor_dim=256,
                                 max_keypoints=k, keypoint_threshold=0.005, compute_dtype=dtype)
            model = Matching(cfg, device=dev, seed=0)
            plain_model = Matching(dataclasses.replace(cfg, s2d_backbone=False), device=dev, seed=0)
            plain_model.load_state_dict(model.state_dict(), strict=True)
            others = ()
            if (backbone, dtype) == ("bn", "bfloat16"):
                other = Matching(dataclasses.replace(cfg, s2d_layout="2x2"), device=dev, seed=0)
                other.load_state_dict(model.state_dict(), strict=True)
                others = (("2x2", other),)
            label = f"H-layout detect ({backbone}, {dtype})"
            with torch.inference_mode():
                model.detect(images)  # warm-up
                torch.cuda.synchronize()
                _build.reset_launch_counts()
                kp = model.detect(images)
                torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            print(f"{label} launches per detect of {batch} images: {launches}")
            check(launches == H_DETECT_LAUNCHES, f"{label} launch counts {launches} != {H_DETECT_LAUNCHES}")
            check(tuple(kp.desc.shape) == (batch, k, 256) and bool(torch.isfinite(kp.desc).all()),
                  f"{label}: descriptors")
            # bf16 rounds at other places on the two backbones; f32 sums in other orders
            compare_backbones(torch, model, plain_model, images, label, 5e-2 if dtype == "bfloat16" else 1e-4,
                              layout="h", others=others)
            if result is None:
                result = launches
            del model, plain_model, others
    return result


EVAL_MIN_SUCCESS, EVAL_MAX_MEAN_PX, EVAL_H_AGAINST_PLAIN_PX = 0.96, 1.0, 0.25


def run_evaluation_cli(torch, dev):
    """`python -m image_matching_tpu_torch.cli.evaluate --configs sp spsg`
    in-process at its defaults (50 photo-texture pairs at 480x640, K = 1200,
    similarity RANSAC at 7 px; the classical configs are
    `run_classical_evaluation`'s) with the banked weights, through the H-only
    backbone and then the plain one on the same pairs: each config's JSON
    beside the JAX package's `EVAL_reference_regime.json`, each held to a
    success rate of 0.96 and a mean corner error of 1 px, and the two
    layouts to the same success count and per-pair errors within 0.25 px."""
    from image_matching_tpu_torch.cli import evaluate as cli
    from image_matching_tpu_torch.ops import _build

    weights = ["--sp_checkpoint", str(ROOT / "weights" / "sp_photo.npz"),
               "--sg_checkpoint", str(ROOT / "weights" / "sg_photo.npz")]
    keys = ("success_rate", "mean_corner_err_px", "median_corner_err_px", "mean_matches", "mean_inliers",
            "fit_valid_rate", "wall_s_total")
    results = {}
    for layout, kernel in (("h", "entry_conv_h"), ("off", "entry_conv")):
        out = ROOT / "build" / f"eval_{layout}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        results[layout] = cli.main([*weights, "--configs", "sp", "spsg", "--s2d_backbone", layout, "--per_pair",
                                    "--out", str(out)])
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        n = results[layout]["sp"]["n_pairs"]
        print(f"evaluation CLI, defaults, --s2d_backbone {layout}: {n} pairs, sp and spsg in "
              f"{time.perf_counter() - t0:.1f} s; launches {launches}")
        check(n == 50 and launches.get(kernel) == 2 * 2 * n and launches.get("attention", 0) > 0
              and launches.get("sinkhorn") == n, f"evaluation CLI ({layout}) missed its kernels: {launches}")
        for name, res in results[layout].items():
            print(f"evaluation CLI {name} (--s2d_backbone {layout}): "
                  + json.dumps({key: res[key] for key in keys}))
            check(res["success_rate"] >= EVAL_MIN_SUCCESS and res["mean_corner_err_px"] <= EVAL_MAX_MEAN_PX,
                  f"evaluation CLI {name} ({layout}): success {res['success_rate']}, mean "
                  f"{res['mean_corner_err_px']} px")
    ref = json.loads((ROOT / "EVAL_reference_regime.json").read_text())
    for name in ("sp", "spsg"):
        print(f"JAX package, EVAL_reference_regime.json, {name} (a TPU run on pairs made with OpenCV): "
              + json.dumps({key: ref[name][key] for key in keys}))
        h, off = (results[layout][name]["per_pair"] for layout in ("h", "off"))
        ok = lambda p: p["corner_err_px"] is not None and p["corner_err_px"] < 5.0
        both = [(a["corner_err_px"], b["corner_err_px"]) for a, b in zip(h, off) if ok(a) and ok(b)]
        worst = max(abs(a - b) for a, b in both)
        print(f"evaluation CLI {name}: H against plain backbone: successes {sum(map(ok, h))} / {sum(map(ok, off))}; "
              f"largest per-pair corner error difference {worst:.4f} px over {len(both)} pairs (tolerance "
              f"{EVAL_H_AGAINST_PLAIN_PX})")
        check(sum(map(ok, h)) == sum(map(ok, off)) and worst <= EVAL_H_AGAINST_PLAIN_PX,
              f"evaluation CLI {name}: the H backbone's registrations differ from the plain one's")


# ---------------------------------------------------------------- the SuperGlue entry points

MATCH_PAIR_FULL = (1920, 2560)  # the files' size; the CLI's --resize_scale 0.25 registers at 480x640
MATCH_PAIR_SCALE = 0.25
MATCH_PAIR_SOURCES = 8
MATCH_PAIR_MIN_SUCCESS, MATCH_PAIR_SUCCESS_PX, MATCH_PAIR_MAX_MEAN_PX = 7, 5.0, 1.0  # px at the 480x640 scale


def write_match_pair_files(root, n_sources: int, seed: int):
    """A template and `n_sources` sources at 1920x2560 as PNG files
    (`imgproc.imwrite_png`): the evaluation's photo texture made at 480x640
    (`evaluation.photo_texture`, blurred as `make_eval_pairs` blurs it),
    brought to full size by a cubic resize, and warped by similarities drawn
    as `make_eval_pairs` draws them (angle up to 0.25 rad, scale 0.9-1.1,
    shift up to 48 px at 480x640). Returns the full-size template -> source
    matrices, one a source, in file order."""
    import numpy as np
    from image_matching_tpu_torch import evaluation, imgproc

    h, w = MATCH_PAIR_FULL
    rng = np.random.default_rng(seed)
    small = imgproc.gaussian_blur(evaluation.photo_texture(rng, h // 4, w // 4), 1.0)
    template = np.clip(imgproc.resize(small, (w, h)), 0, 1)
    (root / "src").mkdir(parents=True, exist_ok=True)
    imgproc.imwrite_png(str(root / "template.png"), (template * 255).astype(np.uint8))
    gts = []
    for i in range(n_sources):
        ang, sc = rng.uniform(-0.25, 0.25), rng.uniform(0.9, 1.1)
        tx, ty = rng.uniform(-48 * 4, 48 * 4, 2)
        c, s = np.cos(ang) * sc, np.sin(ang) * sc
        cx, cy = w / 2, h / 2
        mat = np.float32([[c, -s, tx + cx - c * cx + s * cy], [s, c, ty + cy - s * cx - c * cy]])
        source = np.clip(imgproc.warp_affine(template, mat, (w, h)), 0, 1)
        imgproc.imwrite_png(str(root / "src" / f"s{i}.png"), (source * 255).astype(np.uint8))
        gts.append(mat)
    return gts


def _match_pair(torch, argv):
    """`cli/match_pair.main(argv)` with the launch counts set to 0 before it
    and read after; returns (records, launches, seconds)."""
    from image_matching_tpu_torch.cli import match_pair as cli
    from image_matching_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    records = cli.main(argv)
    torch.cuda.synchronize()
    return records, dict(_build.LAUNCHES), time.perf_counter() - t0


def run_match_pair_cli(torch, dev, smi: str):
    """`python -m image_matching_tpu_torch.cli.match_pair` in-process at its
    defaults (--resize_scale 0.25, K = 1200, similarity RANSAC at 7 px, D =
    128, the H-only backbone, banked weights) on one template and 8 sources
    at 1920x2560, with the ratio matcher and with SuperGlue: each written
    transform against the known one (corner error at the 480x640 scale:
    success under 5 px, at least 7 of 8 successes, a mean under 1 px a
    matcher), the image entry conv's alignedH output twice a pair, attention
    and the Sinkhorn under SuperGlue. Then the official variant (--backbone
    vgg --descriptor_dim 256; SuperGlue from a seeded synthetic official
    state dict through `load_magicleap_superglue`; 2 pairs): a run check,
    dh = 64 attention. Returns the superglue run's launch counts."""
    import numpy as np
    from image_matching_tpu_torch.evaluation import corner_error
    from image_matching_tpu_torch.models import SuperGlue
    from image_matching_tpu_torch.weights import load_magicleap_superglue, save_npz

    root = ROOT / "build" / "match_pair"
    n = MATCH_PAIR_SOURCES
    gts = write_match_pair_files(root, n, seed=11)
    h, w = MATCH_PAIR_FULL
    weights = ["--sp_checkpoint", str(ROOT / "weights" / "sp_photo.npz"),
               "--sg_checkpoint", str(ROOT / "weights" / "sg_photo.npz")]
    result = None
    for matcher in ("ratio", "superglue"):
        out = root / f"out_{matcher}"
        records, launches, sec = _match_pair(torch, ["--template", str(root / "template.png"), "--source_dir",
                                                     str(root / "src"), "--out", str(out), "--matcher", matcher,
                                                     *weights])
        errs = []
        for rec, gt in zip(records, gts):
            written = np.loadtxt(out / f"{rec['name']}_transform.txt")
            check(np.allclose(written, rec["transform"], rtol=1e-6, atol=1e-6) and written.shape == (2, 3),
                  f"match_pair ({matcher}) {rec['name']}: the written transform is not the one returned")
            check(all((out / f"{rec['name']}_{kind}.png").is_file() for kind in ("matches", "warped")),
                  f"match_pair ({matcher}) {rec['name']}: a plot is missing")
            errs.append(corner_error(written, gt, h, w) * MATCH_PAIR_SCALE if rec["valid"] else float("inf"))
        ok = [e < MATCH_PAIR_SUCCESS_PX for e in errs]
        mean = float(np.mean([e for e in errs if e < MATCH_PAIR_SUCCESS_PX])) if any(ok) else float("inf")
        walls = [rec["wall_s"] for rec in records]
        for rec, e in zip(records, errs):
            print(f"match_pair ({matcher}) {rec['name']}: {rec['wall_s'] * 1e3:.1f} ms, {rec['matches']} matches, "
                  f"{rec['inliers']} inliers, valid {rec['valid']}, corner error {e:.4f} px at 480x640 "
                  f"({e / MATCH_PAIR_SCALE:.3f} px at 1920x2560)")
        print(f"match_pair ({matcher}), CLI defaults, {n} sources at 1920x2560 -> 480x640: {sum(ok)} / {n} under "
              f"{MATCH_PAIR_SUCCESS_PX} px, mean corner error {mean:.4f} px at 480x640; wall s a pair (the CLI's own "
              f"timer around the registration) median {statistics.median(walls):.4f}, first {walls[0]:.4f}, after "
              f"the first median {statistics.median(walls[1:]):.4f}; whole run {sec:.1f} s with reading, resizing, "
              f"plotting and writing; launches {launches}; {smi}")
        check(sum(ok) >= MATCH_PAIR_MIN_SUCCESS and mean < MATCH_PAIR_MAX_MEAN_PX,
              f"match_pair ({matcher}): {sum(ok)} successes, mean {mean} px")
        want = {"entry_conv_h": 2 * n}
        if matcher == "superglue":
            want.update(attention=36 * n, sinkhorn=n)
            result = launches
        check(launches == want, f"match_pair ({matcher}) launch counts {launches} != {want}")

    # the official variant: VGG backbone, D = 256 (dh = 64 heads), official SuperGlue names
    official = root / "official"
    (official / "src").mkdir(parents=True, exist_ok=True)
    for i in range(2):
        (official / "src" / f"s{i}.png").write_bytes((root / "src" / f"s{i}.png").read_bytes())
    sg = SuperGlue(256, (32, 64, 128, 256), gnn_layers=18, device="cpu")
    load_magicleap_superglue(sg, synthetic_official_superglue(torch, 256, 18, (32, 64, 128, 256), seed=0))
    save_npz(sg, str(official / "sg_official.npz"))
    records, launches, sec = _match_pair(torch, ["--template", str(root / "template.png"), "--source_dir",
                                                 str(official / "src"), "--out", str(official / "out"), "--matcher",
                                                 "superglue", "--backbone", "vgg", "--descriptor_dim", "256",
                                                 "--sg_checkpoint", str(official / "sg_official.npz")])
    print(f"match_pair official variant (--backbone vgg --descriptor_dim 256, seeded random SuperPointVGG, SuperGlue "
          f"from a seeded synthetic official state dict; a run check, no quality claim): "
          + "; ".join(f"{r['name']} {r['wall_s'] * 1e3:.1f} ms, {r['matches']} matches, valid {r['valid']}"
                      for r in records) + f"; launches {launches} (4 heads of dh 64: attention_wg<2>)")
    want = {"entry_conv_h": 4, "attention": 72, "sinkhorn": 2}
    check(launches == want and all(np.isfinite(r["transform"]).all() for r in records),
          f"match_pair official variant: launches {launches} != {want}, or a non-finite transform")
    return result


def synthetic_official_superglue(torch, d: int, layers: int, kenc, seed: int) -> dict:
    """A seeded state dict with the official MagicLeap SuperGlue's names and
    layouts (Conv1d kernels (O, I, 1); BatchNorm1d with running statistics;
    MLP slots conv, bn, relu)."""
    gen = torch.Generator().manual_seed(seed)
    state = {}

    def conv1d(prefix, o, i):
        state[f"{prefix}.weight"] = torch.randn(o, i, 1, generator=gen) / math.sqrt(i)
        state[f"{prefix}.bias"] = torch.randn(o, generator=gen) * 0.01

    def bn(prefix, c):
        state[f"{prefix}.weight"] = torch.rand(c, generator=gen) + 0.5
        state[f"{prefix}.bias"] = torch.randn(c, generator=gen) * 0.01
        state[f"{prefix}.running_mean"] = torch.randn(c, generator=gen) * 0.1
        state[f"{prefix}.running_var"] = torch.rand(c, generator=gen) + 0.5
        state[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    chans = [3, *kenc, d]
    for i in range(1, len(chans)):
        conv1d(f"kenc.encoder.{3 * (i - 1)}", chans[i], chans[i - 1])
        if i < len(chans) - 1:
            bn(f"kenc.encoder.{3 * (i - 1) + 1}", chans[i])
    for li in range(layers):
        for pi in range(3):
            conv1d(f"gnn.layers.{li}.attn.proj.{pi}", d, d)
        conv1d(f"gnn.layers.{li}.attn.merge", d, d)
        conv1d(f"gnn.layers.{li}.mlp.0", 2 * d, 2 * d)
        bn(f"gnn.layers.{li}.mlp.1", 2 * d)
        conv1d(f"gnn.layers.{li}.mlp.3", d, 2 * d)
    conv1d("final_proj", d, d)
    state["bin_score"] = torch.tensor(1.0)
    return {f"module.{k}": v for k, v in state.items()}


TRAIN_CLI_STEPS = 10  # a CLI epoch here


def run_train_superglue_cli(torch, dev, smi: str):
    """`python -m image_matching_tpu_torch.cli.train_superglue` in-process at
    its defaults (240x320, batch 4, K = 512, D = 128, 18 GNN layers, 100
    Sinkhorn iterations, bf16, --synthetic) with the banked SuperPoint and
    --photometric --subpixel --warmup_steps 5 --grad_clip 1.0: 2 epochs of
    10 steps, then --resume for 1 more. Checks finite losses, the checkpoints
    written, the step count continued, and the training kernels (attention
    with LSE, dQ, dK/dV) launched 36 times a step; prints steps/s (median
    over the steps after the first), peak memory and the busy share of a
    step. Returns the launch counts of one step."""
    import shutil

    from image_matching_tpu_torch.cli import train_superglue as cli
    from image_matching_tpu_torch.ops import _build

    run_dir = ROOT / "build" / "train_superglue"
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--synthetic", "--run_dir", str(run_dir), "--sp_checkpoint", str(ROOT / "weights" / "sp_photo.npz"),
            "--photometric", "--subpixel", "--warmup_steps", "5", "--grad_clip", "1.0",
            "--steps_per_epoch", str(TRAIN_CLI_STEPS), "--log_interval", "5"]
    times, last = [], {}
    real_factory = cli.make_superglue_train_step

    def timed_factory(*args, **kwargs):
        step = real_factory(*args, **kwargs)

        def timed(state, images, gen):
            t0 = time.perf_counter()
            metrics = step(state, images, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            last.update(run=lambda: step(state, images, gen))
            return metrics
        return timed

    runs = {}
    with mock.patch.object(cli, "make_superglue_train_step", timed_factory):
        for label, extra in (("2 epochs", ["--epochs", "2"]), ("--resume, 1 epoch", ["--epochs", "1", "--resume"])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            first = len(times)
            runs[label] = out = cli.main(argv + extra)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            steps = len(times) - first
            step_times = times[first + 1:]
            sec = statistics.median(step_times)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"train_superglue CLI ({label}): steps {out['history'][0]['first_step']} -> {out['state'].step}; "
                  f"{1 / sec:.3f} steps/s (median over the {len(step_times)} steps after the first, {sec * 1e3:.2f} "
                  f"ms; first step {times[first] * 1e3:.1f} ms); peak memory {peak:.3f} GiB; launches {launches}; "
                  f"{smi}")
            for rec in out["logged"]:
                print("  " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in rec.items()))
            for rec in out["history"]:
                print(f"  epoch {rec['epoch']}: steps {rec['first_step']} -> {rec['last_step']}, mean loss "
                      f"{rec['mean_loss']:.4f}, {rec['steps_per_s']:.3f} steps/s (the CLI's own clock)")
            per_step = {k: v / steps for k, v in launches.items()}
            check(per_step == {"entry_conv": 1, "attention_lse": 36, "attention_dq": 36, "attention_dkdv": 36},
                  f"train_superglue CLI ({label}): launches per step {per_step}")
            check(all(math.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0 for r in out["logged"])
                  and all(math.isfinite(r["mean_loss"]) for r in out["history"]),
                  f"train_superglue CLI ({label}): a loss is not finite or a step was skipped")
    ckpts = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
    print(f"train_superglue CLI: checkpoints {ckpts}")
    check(runs["2 epochs"]["state"].step == 2 * TRAIN_CLI_STEPS
          and runs["--resume, 1 epoch"]["history"][0]["first_step"] == 2 * TRAIN_CLI_STEPS
          and runs["--resume, 1 epoch"]["state"].step == 3 * TRAIN_CLI_STEPS
          and ckpts == [f"{k * TRAIN_CLI_STEPS}.npz" for k in (1, 2, 3)],
          "train_superglue CLI: the checkpoints or the resumed step count are wrong")
    profile_calls(torch, last["run"], statistics.median(times[1:]), "train_superglue CLI", "step", reps=2)
    return per_step


SP_SYNTH = ROOT / "weights" / "sp_synth.npz"
SP_STAGE1_STEPS = 30  # then 10 more after --resume
SP_STAGE1_INTERVALS = ["--tensorboard_interval", "10", "--validation_interval", "15", "--save_interval", "15"]
SP_STAGE3_STEPS = 20
EXPORT_FILES = {"train": 16, "val": 8}  # 480x640 PNG files, read at 240x320


def _superpoint_cli(torch, argv, label: str, smi: str):
    """`cli/train_superpoint.main(argv)` with every train step timed on the
    host clock (ending in a synchronize) and the non-finite guard's one
    read-back a step timed on its own (how long the host waits there for
    the device), the launch counts set to 0 before it and read after. Prints
    steps/s (median over the steps after the first), the guard's wait, peak
    memory, the entry conv's launches (one an inference forward: a
    diagnostics interval runs one, an evaluation step two; a training step
    none, its image conv is cuDNN's), the records, and checks finite losses,
    no skipped step and those launches. Returns (out, a closure that runs one
    more step, the median step in s, the launches)."""
    from image_matching_tpu_torch.cli import train_superpoint as cli
    from image_matching_tpu_torch.ops import _build
    from image_matching_tpu_torch.train import superpoint_trainer

    times, waits, last = [], [], {}
    real_factory, real_finite = cli.make_superpoint_train_step, superpoint_trainer.is_finite

    def timed_factory(*args, **kwargs):
        step = real_factory(*args, **kwargs)

        def timed(state, batch, gen):
            t0 = time.perf_counter()
            metrics = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            last.update(run=lambda: step(state, batch, gen))
            return metrics
        return timed

    def timed_finite(loss):
        t0 = time.perf_counter()
        ok = real_finite(loss)
        waits.append(time.perf_counter() - t0)
        return ok

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(cli, "make_superpoint_train_step", timed_factory), \
            mock.patch.object(superpoint_trainer, "is_finite", timed_finite):
        out = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    sec = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train_superpoint CLI ({label}): {len(times)} steps, to step {out['state'].step}; {1 / sec:.3f} steps/s "
          f"(median over the {len(times) - 1} steps after the first, {sec * 1e3:.2f} ms; first step "
          f"{times[0] * 1e3:.1f} ms); the guard's read-back waits {statistics.median(waits[1:]) * 1e3:.2f} ms a step "
          f"(median); peak memory {peak:.3f} GiB; launches {launches}; whole run {wall:.1f} s; {smi}")
    for rec in out["logged"] + out["history"]:
        print("  " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in rec.items()))
    # an evaluation step runs two inference forwards, and with a tensorboardX
    # writer a third, the heatmap overlay's
    overlay = importlib.util.find_spec("tensorboardX") is not None
    want = len(out["logged"]) + (3 if overlay else 2) * len(out["history"])
    check(launches == ({"entry_conv": want} if want else {}), f"train_superpoint CLI ({label}): launches {launches}")
    check(all(math.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0 for r in out["logged"])
          and all(math.isfinite(r["loss"]) for r in out["history"]),
          f"train_superpoint CLI ({label}): a loss is not finite or a step was skipped")
    return out, last["run"], sec, launches


def run_train_superpoint_cli(torch, dev, smi: str):
    """The self-supervised cycle's stage 1: `python -m
    image_matching_tpu_torch.cli.train_superpoint --synthetic` in-process at
    its defaults (240x320, batch 8, D = 128, bf16, synthetic shapes made on
    the card) for 30 steps with a diagnostics interval of 10, an evaluation
    step every 15 and a checkpoint every 15, then `--resume` to step 40.
    Checks the checkpoints and the resumed step, and profiles one step
    (device time, launches, busy share). Returns the launch counts of both
    runs."""
    import shutil

    run_dir = ROOT / "build" / "train_superpoint"
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--synthetic", "--run_dir", str(run_dir), *SP_STAGE1_INTERVALS]
    first, run, sec, launches = _superpoint_cli(torch, argv + ["--train_iter", str(SP_STAGE1_STEPS)], "stage 1", smi)
    resumed, _, _, more = _superpoint_cli(torch, argv + ["--train_iter", str(SP_STAGE1_STEPS + 10), "--resume"],
                                          "stage 1, --resume", smi)
    ckpts = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
    print(f"train_superpoint CLI: checkpoints {ckpts}; resumed at step {first['state'].step}, first record after "
          f"it at step {resumed['logged'][0]['step']}")
    check(first["state"].step == SP_STAGE1_STEPS and resumed["state"].step == SP_STAGE1_STEPS + 10
          and resumed["logged"][0]["step"] == SP_STAGE1_STEPS + 10 and ckpts == ["15.npz", "30.npz", "40.npz"],
          "train_superpoint CLI: the checkpoints or the resumed step count are wrong")
    profile_calls(torch, run, sec, "train_superpoint CLI (stage 1)", "step", reps=2)
    time_guard_read_back(torch, dev)
    return launches, more


def time_guard_read_back(torch, dev, steps: int = 20, shape=(8, 240, 320)):
    """What the non-finite guard's one read-back a step costs: `steps` train
    steps back to back on one batch at stage 1's shapes (one synchronize at
    the end of each run, none between steps), with the guard and with its
    read-back replaced by True, interleaved (with, without, without, with).
    Prints steps/s of each run."""
    from image_matching_tpu_torch.data.pipeline import make_warped_pair_batch
    from image_matching_tpu_torch.data.synthetic_device import synthetic_batch
    from image_matching_tpu_torch.models import SuperPointBN
    from image_matching_tpu_torch.train import superpoint_trainer
    from image_matching_tpu_torch.train.state import TrainState

    gen = torch.Generator(device=dev).manual_seed(3)
    src = synthetic_batch(gen, *shape)
    batch = make_warped_pair_batch(gen, src["image"], src["points"], src["points_mask"])
    model = SuperPointBN(128, compute_dtype="bfloat16", device=dev)
    state = TrainState.create(model, 1e-4)
    step = superpoint_trainer.make_superpoint_train_step(model)
    rates = {"with the read-back": [], "without": []}

    def run(label):
        with contextlib.ExitStack() as stack:
            if label == "without":
                stack.enter_context(mock.patch.object(superpoint_trainer, "is_finite", lambda loss: True))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step(state, batch, gen)
            torch.cuda.synchronize()
            rates[label].append(steps / (time.perf_counter() - t0))

    run("without")  # warm-up
    rates["without"].clear()
    for label in ("with the read-back", "without", "without", "with the read-back"):
        run(label)
    print(f"train_superpoint step, {steps} steps back to back, batch {shape}: steps/s "
          + "; ".join(f"{k} " + " / ".join(f"{r:.3f}" for r in v) for k, v in rates.items()))


def write_export_files(torch, root, seed: int, files=EXPORT_FILES):
    """`files` ({task: count}) seeded textured 480x640 PNG files under root/<task>/."""
    import numpy as np
    from image_matching_tpu_torch import imgproc

    rng = np.random.default_rng(seed)
    for task, n in files.items():
        (root / task).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img = (texture(torch, rng, 480, 640) * 255).astype(np.uint8)
            imgproc.imwrite_png(str(root / task / f"im_{i:02d}.png"), img)


def run_export_pseudo_cli(torch, dev, smi: str):
    """The cycle's stage 2 as `scripts/selfsup_cycle.sh` runs it: `python -m
    image_matching_tpu_torch.cli.export_pseudo --checkpoint
    weights/sp_synth.npz --height 240 --width 320 --batch_size 8` (50 warps,
    top-k 1200: 400 views a model call) in-process on 16 train and 8 val
    PNG files. Prints s a batch (images on the card to keypoints on the
    host), keypoints an image, peak memory and launches (one entry conv a
    batch, checked), then runs the first batch again, with the same
    homographies, through the all-plain path: keypoint sets (at integer
    pixels) with IoU >= 0.9. Returns (data root, labels dir, launches)."""
    import shutil

    from image_matching_tpu_torch import export
    from image_matching_tpu_torch.cli import export_pseudo as cli
    from image_matching_tpu_torch.models import SuperPointBN
    from image_matching_tpu_torch.ops import _build
    from image_matching_tpu_torch.train.checkpoint import load_weights

    root = ROOT / "build" / "export_pseudo"
    shutil.rmtree(root, ignore_errors=True)
    write_export_files(torch, root / "data", seed=14)
    recorded = []
    real = export.export_pseudo_labels

    def recording(hs, apply_fn, images, cfg):
        kp = real(hs, apply_fn, images, cfg)
        recorded.append((hs, images, cfg, kp))
        return kp

    launches = {}
    with mock.patch.object(export, "export_pseudo_labels", recording):
        for task in EXPORT_FILES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            out = cli.main(["--data_root", str(root / "data"), "--out", str(root / "labels"), "--task", task,
                            "--checkpoint", str(SP_SYNTH), "--height", "240", "--width", "320", "--batch_size", "8"])
            wall = time.perf_counter() - t0
            launches[task] = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            kps = [n for b in out["batches"] for n in b["keypoints"]]
            print(f"export_pseudo CLI ({task}, {len(kps)} images, batch 8 x 50 warps at 240x320): s a batch "
                  + ", ".join(f"{b['seconds']:.3f}" for b in out["batches"])
                  + f"; keypoints an image mean {statistics.mean(kps):.1f} (min {min(kps)}, max {max(kps)}); peak "
                  f"memory {peak:.3f} GiB; launches {launches[task]}; whole run {wall:.1f} s; {smi}")
            check(launches[task] == {"entry_conv": len(out["batches"])} and min(kps) > 0
                  and len(out["written"]) == EXPORT_FILES[task],
                  f"export_pseudo CLI ({task}): launches, keypoints or files are wrong")
    hs, images, cfg, kp = recorded[0]
    model = SuperPointBN(128, compute_dtype="bfloat16", device=dev)
    load_weights(model, str(SP_SYNTH))
    with plain_path(), torch.no_grad():
        ref = real(hs, lambda views: model(views)["semi"], images, cfg)
    iou = keypoint_set_iou(kp.replace(xy=torch.round(kp.xy)), ref.replace(xy=torch.round(ref.xy)))
    print(f"export_pseudo CLI: the first batch through the all-plain path, same homographies: keypoint-set IoU "
          f"{iou:.4f} (at least 0.9)")
    check(iou >= 0.9, f"export_pseudo CLI: keypoints of the kernel path and the plain path differ (IoU {iou})")
    return root / "data", root / "labels", launches


def run_retrain_superpoint_cli(torch, dev, smi: str, data_root, labels):
    """The cycle's stage 3: `train_superpoint --data_root ... --labels ...
    --init_weights weights/sp_synth.npz` at its defaults on stage 2's files
    and labels, 20 steps, diagnostics and an evaluation step every 10."""
    import shutil

    run_dir = ROOT / "build" / "retrain_superpoint"
    shutil.rmtree(run_dir, ignore_errors=True)
    out, _, _, launches = _superpoint_cli(
        torch, ["--data_root", str(data_root), "--labels", str(labels), "--run_dir", str(run_dir), "--init_weights",
                str(SP_SYNTH), "--train_iter", str(SP_STAGE3_STEPS), "--tensorboard_interval", "10",
                "--validation_interval", "10", "--save_interval", str(SP_STAGE3_STEPS)], "stage 3", smi)
    check(out["state"].step == SP_STAGE3_STEPS, "train_superpoint CLI (stage 3): the step count is wrong")
    return launches


# ---------------------------------------------------------------- classical registration and the sequence back end

CLASSICAL_MIN_SUCCESS = 0.9  # sift and orb, the 240x320 regime of EVAL_classical_photo.json
CLASSICAL_CPU_MAX_PX = 1e-3  # the card's fit against the port's CPU path on one pair
# the card's descriptors on the keypoints it shares with the CPU path: SIFT's
# differ by float32 sum orders (scatter-adds, resize products; 2.2e-5 measured),
# ORB's bits not at all
CLASSICAL_CPU_MAX_DESC = {"sift": 1e-4, "orb": 0}
TRADITIONAL_FULL = (1920, 2560)  # the files; the CLI's --resize_scale 0.5 registers at 960x1280
TRADITIONAL_SCALE = 0.5
TRADITIONAL_MIN_SUCCESS, TRADITIONAL_SUCCESS_PX = 7, 5.0  # of 8, px at the 960x1280 scale
SEQUENCE_MAX_ATE_PX = 0.1


@contextlib.contextmanager
def staged_times(torch, stages: dict):
    """Each function of `stages` ({label: [(module, attribute), ...]})
    wrapped to add its own host time, bracketed by synchronizes, to its
    label's total; yields the totals (seconds). A stage called inside
    another one counts in both."""
    totals = {label: 0.0 for label in stages}
    patches = []
    for label, targets in stages.items():
        for module, attr in targets:
            real = getattr(module, attr)

            def timed(*args, _real=real, _label=label, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(*args, **kwargs)
                torch.cuda.synchronize()
                totals[_label] += time.perf_counter() - t0
                return out
            patches.append(mock.patch.object(module, attr, timed))
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        yield totals


def classical_stages(method: str) -> dict:
    """Where a classical registration's time goes, by the functions each
    stage calls."""
    from image_matching_tpu_torch.features import orb, registration, sift

    common = {"matching": [(registration, "match_ratio_mutual" if method == "sift" else "match_hamming")],
              "RANSAC": [(registration, "sample_indices"), (registration, "ransac_similarity_from_indices")]}
    if method == "sift":
        return {"2x upscale": [(sift, "resize_linear")], "pyramid blurs": [(sift, "_blur")],
                "extrema + refine": [(sift, "_octave_keypoints")], "gradients": [(sift, "_gradients")],
                "orientations": [(sift, "_orientation_histograms"), (sift, "_orientation_peaks")],
                "descriptors": [(sift, "_descriptor")], **common}
    return {"pyramid resizes": [(orb, "resize_linear")], "FAST": [(orb, "fast_score")], "NMS": [(orb, "simple_nms")],
            "blur": [(orb, "_blur7")], "orientation": [(orb, "_orientation_centroid")], **common}


def classical_against_cpu(torch, dev, pair, method: str):
    """One pair registered on the card and by the port's CPU path with the
    same sample indices: keypoint agreement, descriptor distance on shared
    keypoints, and the corner error between the two fits."""
    import numpy as np
    from image_matching_tpu_torch.evaluation import corner_error
    from image_matching_tpu_torch.features.registration import build_classical_registration_fn
    from image_matching_tpu_torch.ops.ransac import sample_indices

    register = build_classical_registration_fn(method)
    t, s = (torch.from_numpy(a)[None] for a in (pair.template, pair.source))
    card = register(t.to(dev), s.to(dev), torch.Generator(device=dev).manual_seed(0))
    idx = sample_indices(torch.Generator(device=dev).manual_seed(1), card.matches.matches0 >= 0, 512, 2)
    card = register(t.to(dev), s.to(dev), indices=idx)
    cpu = register(t, s, indices=idx.cpu())
    shared, counts, desc_err = [], [], []
    for side in ("kpts0", "kpts1"):
        kc, kp = getattr(card, side), getattr(cpu, side)
        mc, mp = kc.mask[0].cpu().numpy(), kp.mask[0].numpy()
        xc, xp = kc.xy[0].cpu().numpy()[mc], kp.xy[0].numpy()[mp]
        dc, dp = kc.desc[0].cpu().numpy()[mc], kp.desc[0].numpy()[mp]
        counts.append((len(xc), len(xp)))
        for i in range(len(xc)):
            near = np.nonzero(np.abs(xp - xc[i]).max(-1) <= 1e-3)[0]
            shared.append(len(near) > 0)
            if len(near):  # a keypoint with two orientations has two slots at one position
                if method == "orb":
                    desc_err.append(min(int((np.unpackbits(dc[i]) != np.unpackbits(dp[j])).sum()) for j in near))
                else:
                    desc_err.append(min(float(np.abs(dc[i] - dp[j]).max()) for j in near))
    h, w = pair.template.shape[:2]
    fit_px = corner_error(card.fit.matrix[0].cpu().numpy(), cpu.fit.matrix[0].numpy(), h, w)
    same_matches = bool(torch.equal(card.matches.matches0.cpu(), cpu.matches.matches0))
    unit = "bits" if method == "orb" else "abs"
    print(f"classical {method}, card against the port's CPU path on one {h}x{w} pair (the same sample indices): "
          f"keypoints (card, CPU) {counts}, {np.mean(shared):.4f} of the card's within 1e-3 px of the CPU's, "
          f"descriptor distance on those max "
          f"{max(desc_err)} ({unit}), matches0 equal {same_matches}, fits {fit_px:.2e} px apart in corner error "
          f"(tolerances {CLASSICAL_CPU_MAX_DESC[method]} {unit}, {CLASSICAL_CPU_MAX_PX} px)")
    check(np.mean(shared) >= 0.98 and all(abs(a - b) <= 0.02 * a for a, b in counts) and fit_px <= CLASSICAL_CPU_MAX_PX
          and max(desc_err) <= CLASSICAL_CPU_MAX_DESC[method] and same_matches and bool(card.fit.valid[0]),
          f"classical {method}: the card's registration differs from the CPU path's")


def run_classical_evaluation(torch, dev, smi: str):
    """`cli/evaluate.py --configs sift orb` in-process: the reference regime
    (its defaults: photo-texture pairs at 480x640, similarity RANSAC at 7
    px, SIFT doubled to 960x1280, ORB over 8 levels; 20 of its 50 pairs,
    to keep the script inside its time limit), then the regime of
    the JAX package's `EVAL_classical_photo.json` (40 pairs at 240x320),
    printed beside that record and held to a success rate of 0.9 a method;
    launches of the port's kernels (none), peak memory, a pair's profile
    (device launches, busy share), where a pair's time goes by stage; and
    one pair a method held to the port's CPU path."""
    import numpy as np
    from image_matching_tpu_torch.cli import evaluate as cli
    from image_matching_tpu_torch.features.registration import build_classical_registration_fn
    from image_matching_tpu_torch.ops import _build

    keys = ("success_rate", "mean_corner_err_px", "median_corner_err_px", "mean_matches", "mean_inliers",
            "fit_valid_rate", "wall_s_total")
    record = json.loads((ROOT / "EVAL_classical_photo.json").read_text())
    for label, extra in (("reference regime, 20 pairs at 480x640", ["--n_pairs", "20"]),
                         ("EVAL_classical_photo.json regime, 40 pairs at 240x320",
                          ["--n_pairs", "40", "--height", "240", "--width", "320"])):
        out = ROOT / "build" / f"eval_classical_{'x'.join(extra[3::2]) or 'defaults'}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        results = cli.main(["--configs", "sift", "orb", *extra, "--out", str(out)])
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(launches == {}, f"classical evaluation: the port's kernels launched {launches}")
        for name, res in results.items():
            print(f"evaluation CLI {name} ({label}): " + json.dumps({k: res[k] for k in keys})
                  + f"; {res['wall_s_total'] / res['n_pairs'] * 1e3:.1f} ms a pair; peak memory {peak:.3f} GiB; "
                  f"launches of the port's kernels {launches}; {smi}")
            if extra:
                print(f"JAX package, EVAL_classical_photo.json, {name} (a TPU run, for quality only): "
                      + json.dumps({k: record[name][k] for k in keys}))
                check(res["success_rate"] >= CLASSICAL_MIN_SUCCESS,
                      f"classical evaluation {name} ({label}): success {res['success_rate']}")
            check(res["fit_valid_rate"] > 0.5, f"classical evaluation {name} ({label}): too few valid fits")

    pairs = cli.make_pairs(cli.parse_args([]))[:4]
    for method in ("sift", "orb"):
        register = build_classical_registration_fn(method)
        gen = torch.Generator(device=dev).manual_seed(0)
        t, s = (torch.from_numpy(a)[None].to(dev) for a in (pairs[0].template, pairs[0].source))
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            register(t, s, gen)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        sec = statistics.median(walls)
        profile_calls(torch, lambda: register(t, s, gen), sec, f"classical {method} pair (480x640)", "pair", 3)
        with staged_times(torch, classical_stages(method)) as totals:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for p in pairs:
                register(torch.from_numpy(p.template)[None].to(dev), torch.from_numpy(p.source)[None].to(dev), gen)
            torch.cuda.synchronize()
            whole = (time.perf_counter() - t0) / len(pairs)
        print(f"classical {method} pair (480x640), stages timed one by one (synchronized), ms a pair over "
              f"{len(pairs)} pairs: " + ", ".join(f"{k} {v / len(pairs) * 1e3:.2f}" for k, v in totals.items())
              + f"; whole {whole * 1e3:.2f} (median unstaged {sec * 1e3:.2f}); {smi}")
        classical_against_cpu(torch, dev, pairs[1], method)


def run_traditional_cli(torch, dev, smi: str):
    """`cli/traditional.py` in-process at its defaults (--resize_scale 0.5,
    ratio 0.7, similarity RANSAC at 7 px) on match_pair's template and 8
    sources of 1920x2560 with known similarities, --method sift and orb:
    each written transform's corner error against the known one at the
    960x1280 scale (at least 7 of 8 under 5 px), the CLI's seconds a pair,
    launches of the port's kernels (none), peak memory, the written files."""
    import numpy as np
    from image_matching_tpu_torch.cli import traditional as cli
    from image_matching_tpu_torch.evaluation import corner_error
    from image_matching_tpu_torch.ops import _build

    root = ROOT / "build" / "traditional"
    gts = write_match_pair_files(root, MATCH_PAIR_SOURCES, seed=11)
    h, w = TRADITIONAL_FULL
    for method in ("sift", "orb"):
        out = root / f"out_{method}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        records = cli.main(["--template", str(root / "template.png"), "--source_dir", str(root / "src"), "--out",
                            str(out), "--method", method])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, peak = dict(_build.LAUNCHES), torch.cuda.max_memory_allocated() / 2 ** 30
        errs = []
        for rec, gt in zip(records, gts):
            written = np.loadtxt(out / f"{rec['name']}_transform.txt")
            check(np.allclose(written, rec["transform"], rtol=1e-6, atol=1e-6) and written.shape == (2, 3),
                  f"traditional ({method}) {rec['name']}: the written transform is not the one returned")
            check(all((out / f"{rec['name']}_{kind}.png").is_file() for kind in ("matches", "warped")),
                  f"traditional ({method}) {rec['name']}: a picture is missing")
            errs.append(corner_error(written, gt, h, w) * TRADITIONAL_SCALE if rec["valid"] else float("inf"))
            print(f"traditional ({method}) {rec['name']}: {rec['wall_s'] * 1e3:.1f} ms, {rec['matches']} matches, "
                  f"{rec['inliers']} inliers, valid {rec['valid']}, corner error {errs[-1]:.4f} px at 960x1280")
        ok = [e < TRADITIONAL_SUCCESS_PX for e in errs]
        walls = [rec["wall_s"] for rec in records]
        print(f"traditional ({method}), CLI defaults, {len(records)} sources at 1920x2560 -> 960x1280: {sum(ok)} / "
              f"{len(records)} under {TRADITIONAL_SUCCESS_PX} px, mean corner error "
              f"{np.mean([e for e in errs if e < TRADITIONAL_SUCCESS_PX]):.4f} px; s a pair (the CLI's timer) median "
              f"{statistics.median(walls):.4f}, first {walls[0]:.4f}; whole run {wall:.1f} s with reading, resizing, "
              f"plotting and writing; peak memory {peak:.3f} GiB; launches of the port's kernels {launches}; {smi}")
        check(sum(ok) >= TRADITIONAL_MIN_SUCCESS and launches == {},
              f"traditional ({method}): {sum(ok)} successes, launches {launches}")


def run_sequence_cli(torch, dev, smi: str):
    """`cli/sequence.py --synthetic --n_frames 24 --ba` in-process (the
    regime of the JAX package's `EVAL_sequence.json`): valid edges, both
    ATEs (each under 0.1 px), tracks and landmarks beside that record;
    the run's wall time; then the two solvers (pose graph, robust bundle
    adjustment) called again on the run's own inputs under the profiler:
    device time, device launches, wall time. Returns those inputs,
    {solver: (args, kwargs)}."""
    from torch.profiler import ProfilerActivity, profile
    from image_matching_tpu_torch.cli import sequence as cli
    from image_matching_tpu_torch.ops import _build

    captured = {}

    def capture(name, real):
        def run(*args, **kwargs):
            captured[name] = (args, kwargs)
            return real(*args, **kwargs)
        return run

    out = ROOT / "build" / "sequence.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(cli, "solve_trajectory", capture("pose graph", cli.solve_trajectory)), \
            mock.patch.object(cli, "refine_trajectory_with_tracks",
                              capture("bundle adjustment", cli.refine_trajectory_with_tracks)):
        result = cli.main(["--synthetic", "--n_frames", "24", "--ba", "--out", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, peak = dict(_build.LAUNCHES), torch.cuda.max_memory_allocated() / 2 ** 30
    ref = json.loads((ROOT / "EVAL_sequence.json").read_text())
    keys = ("valid_edges", "ate_pose_graph_px", "ate_bundle_adjusted_px", "num_tracks", "num_landmarks")
    print(f"sequence CLI --synthetic --n_frames 24 --ba: " + json.dumps({k: result[k] for k in keys})
          + f"; whole run {wall:.2f} s; peak memory {peak:.3f} GiB; launches of the port's kernels {launches}; {smi}")
    print("JAX package, EVAL_sequence.json (a TPU run, for quality only): " + json.dumps({k: ref[k] for k in keys}))
    check(result["ate_pose_graph_px"] < SEQUENCE_MAX_ATE_PX and result["ate_bundle_adjusted_px"] < SEQUENCE_MAX_ATE_PX
          and launches == {} and len(result["trajectory"]) == 24,
          f"sequence CLI: ATEs {result['ate_pose_graph_px']} / {result['ate_bundle_adjusted_px']}, launches {launches}")
    for name, (args, kwargs) in captured.items():
        fn = cli.solve_trajectory if name == "pose graph" else cli.refine_trajectory_with_tracks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*args, **kwargs)
            torch.cuda.synchronize()
        events = _kernel_events(prof)
        dev_ms = sum(_dev_us(e) for e in events) / 1e3
        n = sum(e.count for e in events)
        print(f"sequence CLI, {name} solver (CG, 300 iterations{', 4 IRLS rounds' if 'bundle' in name else ''}): "
              f"wall {sec * 1e3:.1f} ms, device time {dev_ms:.3f} ms in {n} device launches, busy "
              f"{dev_ms / (sec * 1e3):.3f}; {smi}")
    return captured


# ---------------------------------------------------------------- native loader, chunked export, data parallelism

TEST_IMAGES = ROOT / "tests" / "data" / "images"  # seeded JPEG / BMP / TIFF files and their pixels (.npy)
NATIVE_STEPS = 20
CHUNKED_EXPORT = dict(files=16, batch=8, warps=50, height=480, width=640)  # 400 views a batch: 4 calls of 100
DP_STEPS = 10


def check_native_toolchain():
    """Whether g++ finds jpeglib.h and png.h and links -ljpeg -lpng -lz here.
    Returns (all present, the line to print)."""
    build = ROOT / "build" / "imloader"
    build.mkdir(parents=True, exist_ok=True)
    found = {}
    try:
        for header in ("jpeglib.h", "png.h"):
            src = f"#include <cstdio>\n#include <{header}>\n"
            found[header] = subprocess.run(["g++", "-x", "c++", "-E", "-", "-o", "/dev/null"], input=src, text=True,
                                           capture_output=True).returncode == 0
        probe = build / "probe.cpp"
        probe.write_text("#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n"
                         "int main() { jpeg_error_mgr e; jpeg_std_error(&e); return png_access_version_number() == 0; }\n")
        link = subprocess.run(["g++", "-std=c++17", str(probe), "-o", str(build / "probe"), "-ljpeg", "-lpng", "-lz"],
                              capture_output=True, text=True)
        found["-ljpeg -lpng -lz link"] = link.returncode == 0
    except FileNotFoundError:
        return False, "native loader toolchain: g++ not found"
    try:
        cache = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True).stdout
    except FileNotFoundError:
        cache = ""
    runtime = {lib: f"{lib}.so" in cache for lib in ("libjpeg", "libpng")}
    line = ("native loader toolchain: " + ", ".join(f"{k} {'yes' if v else 'NO'}" for k, v in found.items())
            + "; runtime libraries (ldconfig): " + ", ".join(f"{k} {'yes' if v else 'NO'}" for k, v in runtime.items()))
    return all(found.values()), line


def run_native_loader(torch, dev, smi: str):
    """The C++ loader (`native_imloader.py`, `data/native_loader.py`, built from
    `native/imloader/imloader.cpp` into `build/imloader/`): the toolchain
    check, then the committed JPEG / BMP / TIFF files read by
    `imgproc.imread_gray` against their committed pixels, `NativeImageLoader`
    batches (4 threads) held per index to `decode_image`, and
    `train_superpoint` on the 4 JPEG files (labels from `export_pseudo`)
    for `NATIVE_STEPS` steps with `--native_loader` and with the host's
    decoder: steps/s of each. Without the headers it says so and returns."""
    import shutil

    import numpy as np
    from image_matching_tpu_torch import imgproc, native_imloader
    from image_matching_tpu_torch.cli import export_pseudo
    from image_matching_tpu_torch.data import native_loader

    ok, line = check_native_toolchain()
    print(line)
    if not ok:
        print("native loader phase: not run, the headers or libraries above are missing on this machine")
        return None
    t0 = time.perf_counter()
    native_imloader.load_library()
    print(f"native loader: built {native_imloader.library_path().relative_to(ROOT)} "
          f"in {time.perf_counter() - t0:.1f} s")
    files = sorted(p for p in TEST_IMAGES.iterdir() if p.suffix != ".npy")
    for path in files:
        want = np.load(path.with_suffix(".npy"))
        got = imgproc.imread_gray(str(path))
        diff = int(np.abs(got.astype(int) - want).max()) if got.shape == want.shape else None
        print(f"  imread_gray {path.name}: {got.shape}, max difference from the committed pixels {diff}")
        check(diff == 0, f"native loader: imread_gray({path.name}) differs from its committed pixels")
    jpegs = [str(p) for p in files if p.suffix == ".jpg"]
    seen = {}
    loader = native_loader.NativeImageLoader(jpegs, 240, 320, n_threads=4, loop=False, seed=0)
    for batch in loader.batches(3):
        seen.update({int(i): img for i, img in zip(batch["indices"], batch["image"])})
    loader.close()
    check(sorted(seen) == list(range(len(jpegs))), f"native loader: drained indices {sorted(seen)}")
    for i, path in enumerate(jpegs):
        want = native_loader.decode_image(path, 240, 320)
        check(np.array_equal(seen[i], want) and np.array_equal(np.rint(want[..., 0] * 255), imgproc.imread_gray(path)),
              f"native loader: batch image {i} differs from decode_image / imread_gray")
    print(f"native loader: {len(jpegs)} JPEG files through 4 threads equal decode_image per index, and imread_gray")

    root = ROOT / "build" / "native_loader"
    shutil.rmtree(root, ignore_errors=True)
    for task in ("train", "val"):
        (root / "data" / task).mkdir(parents=True)
        for path in jpegs:
            shutil.copy(path, root / "data" / task)
        export_pseudo.main(["--data_root", str(root / "data"), "--out", str(root / "labels"), "--task", task,
                            "--checkpoint", str(SP_SYNTH), "--height", "240", "--width", "320", "--batch_size", "4",
                            "--num_homographies", "10"])
    common = ["--data_root", str(root / "data"), "--labels", str(root / "labels"), "--init_weights", str(SP_SYNTH),
              "--batch_size", "4", "--train_iter", str(NATIVE_STEPS), "--tensorboard_interval", "10",
              "--validation_interval", str(NATIVE_STEPS), "--save_interval", str(NATIVE_STEPS)]
    rates = {}
    for label, extra in (("host decoder", []), ("--native_loader", ["--native_loader"])):
        out, _, sec, _ = _superpoint_cli(torch, [*common, *extra, "--run_dir", str(root / label.strip("-"))],
                                         f"JPEG files, {label}", smi)
        check(out["state"].step == NATIVE_STEPS, f"train_superpoint ({label}): the step count is wrong")
        rates[label] = 1 / sec
    print("native loader: train_superpoint on the JPEG files, batch 4 at 240x320: "
          + "; ".join(f"{k} {v:.3f} steps/s" for k, v in rates.items()) + f"; {smi}")
    return rates


def run_chunked_export(torch, dev, smi: str):
    """`export_pseudo` at 480x640, batch 8, 50 warps (400 views a batch, past
    the entry conv's one-call pixel limit) on 16 seeded PNG files: 4 model
    calls of 100 views a batch (4 entry conv launches), s a batch (the
    first holds the new shapes' warm-up), peak memory, keypoints; then the
    first batch again through the all-plain path with the same homographies
    (keypoint-set IoU >= 0.9). Returns the launches."""
    import shutil

    from image_matching_tpu_torch import export
    from image_matching_tpu_torch.cli import export_pseudo as cli
    from image_matching_tpu_torch.models import SuperPointBN
    from image_matching_tpu_torch.ops import _build
    from image_matching_tpu_torch.train.checkpoint import load_weights

    c = CHUNKED_EXPORT
    root = ROOT / "build" / "export_chunked"
    shutil.rmtree(root, ignore_errors=True)
    write_export_files(torch, root / "data", seed=16, files={"train": c["files"]})
    recorded, real = [], export.export_pseudo_labels

    def recording(hs, apply_fn, images, cfg):
        kp = real(hs, apply_fn, images, cfg)
        recorded.append((hs, images, cfg, kp))
        return kp

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with mock.patch.object(export, "export_pseudo_labels", recording):
        out = cli.main(["--data_root", str(root / "data"), "--out", str(root / "labels"), "--checkpoint", str(SP_SYNTH),
                        "--height", str(c["height"]), "--width", str(c["width"]), "--batch_size", str(c["batch"]),
                        "--num_homographies", str(c["warps"])])
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    views = c["batch"] * c["warps"]
    chunk = export.VIEW_PIXELS_PER_CALL // (c["height"] * c["width"])
    calls = -(-views // chunk)
    kps = [n for b in out["batches"] for n in b["keypoints"]]
    print(f"export_pseudo CLI, chunked ({c['files']} images at {c['height']}x{c['width']}, batch {c['batch']} x "
          f"{c['warps']} warps = {views} views in {calls} calls of {chunk}): s a batch "
          + ", ".join(f"{b['seconds']:.3f}" for b in out["batches"])
          + f"; keypoints an image mean {statistics.mean(kps):.1f} (min {min(kps)}); peak memory {peak:.3f} GiB; "
          f"launches {launches}; {smi}")
    check(calls == 4 and launches == {"entry_conv": calls * len(out["batches"])} and min(kps) > 0,
          f"export_pseudo CLI, chunked: {calls} calls, launches {launches}")
    hs, images, cfg, kp = recorded[0]
    model = SuperPointBN(128, compute_dtype="bfloat16", device=dev)
    load_weights(model, str(SP_SYNTH))
    with plain_path(), torch.no_grad():
        ref = real(hs, lambda v: model(v)["semi"], images, cfg)
    iou = keypoint_set_iou(kp.replace(xy=torch.round(kp.xy)), ref.replace(xy=torch.round(ref.xy)))
    print(f"export_pseudo CLI, chunked: the first batch through the all-plain path, same homographies: keypoint-set IoU "
          f"{iou:.4f} (at least 0.9)")
    check(iou >= 0.9, f"export_pseudo CLI, chunked: keypoints of the kernel path and the plain path differ ({iou})")
    return launches


@contextlib.contextmanager
def timed_steps(cli, factory: str, times: list):
    """Patch `cli.<factory>` so that every step it makes is timed on the
    host clock, ending in a synchronize; the times go to `times`."""
    import torch

    real = getattr(cli, factory)

    def timed_factory(*args, **kwargs):
        step = real(*args, **kwargs)

        def timed(*a):
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out
        return timed

    with mock.patch.object(cli, factory, timed_factory):
        yield


def run_data_parallel(torch, dev, smi: str):
    """Both training CLIs at their defaults (`train_superglue --synthetic`
    with the banked SuperPoint, `train_superpoint --synthetic`), `DP_STEPS`
    steps each, as one process, in a world of one NCCL rank (a process
    group over a localhost TCP store, made here), and as one process again:
    losses, metrics and the trained state bit-equal, the training kernels'
    launches a SuperGlue step, steps/s of each run (median step after the
    first), and the all_reduce calls a step of each CLI. cuDNN and PyTorch
    run their deterministic algorithms in this
    phase, so two runs can be compared bit for bit. More than one card is
    not run here."""
    import shutil

    import torch.distributed as dist
    from image_matching_tpu_torch.cli import train_superglue, train_superpoint
    from image_matching_tpu_torch.ops import _build

    root = ROOT / "build" / "data_parallel"
    shutil.rmtree(root, ignore_errors=True)
    sg_args = ["--synthetic", "--sp_checkpoint", str(ROOT / "weights" / "sp_photo.npz"), "--epochs", "1",
               "--steps_per_epoch", str(DP_STEPS), "--log_interval", str(DP_STEPS // 2)]
    sp_args = ["--synthetic", "--train_iter", str(DP_STEPS), "--tensorboard_interval", str(DP_STEPS // 2),
               "--validation_interval", str(DP_STEPS), "--save_interval", str(DP_STEPS)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    all_reduce, reduces = dist.all_reduce, [0]

    def counted_all_reduce(*args, **kwargs):
        reduces[0] += 1
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counted_all_reduce
    runs = []
    try:
        for i, label in enumerate(("one process", "NCCL, world 1", "one process, again")):
            if label.startswith("NCCL"):
                dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
            sg_times, sp_times = [], []
            _build.reset_launch_counts()
            reduces[0] = 0
            with timed_steps(train_superglue, "make_superglue_train_step", sg_times):
                sg = train_superglue.main([*sg_args, "--run_dir", str(root / f"sg{i}")])
            sg_launches = {k: v / DP_STEPS for k, v in _build.LAUNCHES.items()}
            sg_reduces, reduces[0] = reduces[0] / DP_STEPS, 0
            with timed_steps(train_superpoint, "make_superpoint_train_step", sp_times):
                sp = train_superpoint.main([*sp_args, "--run_dir", str(root / f"sp{i}")])
            sp_reduces = reduces[0] / DP_STEPS
            backend = dist.get_backend() if dist.is_initialized() else None
            if dist.is_initialized():
                dist.destroy_process_group()
            runs.append((sg, sp))
            rates = [1 / statistics.median(t[1:]) for t in (sg_times, sp_times)]
            print(f"data parallel ({label}, backend {backend}): train_superglue {rates[0]:.3f} steps/s, "
                  f"train_superpoint {rates[1]:.3f} steps/s (median step after the first of {DP_STEPS}); "
                  f"all_reduce calls a step (the CLI's runs over the steps, its evaluations included) "
                  f"{sg_reduces:.1f} / {sp_reduces:.1f}; launches a SuperGlue step {sg_launches}; losses " + ", ".join(f"{r['loss']:.6f}" for r in sg["logged"])
                  + " / " + ", ".join(f"{r['loss']:.6f}" for r in sp["logged"]) + f"; {smi}")
            check(sg_launches == {"entry_conv": 1, "attention_lse": 36, "attention_dq": 36, "attention_dkdv": 36},
                  f"data parallel ({label}): launches a SuperGlue step {sg_launches}")
    finally:
        dist.all_reduce = all_reduce
        torch.backends.cudnn.deterministic = deterministic
        torch.use_deterministic_algorithms(False)
    worst = {}
    for j, name in enumerate(("superglue", "superpoint")):
        ref = runs[0][j]
        for other in runs[1:]:
            got = other[j]
            sa, sb = ref["state"].module.state_dict(), got["state"].module.state_dict()
            d = max(float((sa[k].double() - sb[k].double()).abs().max()) for k in sa)
            worst[name] = max(worst.get(name, 0.0), d)
            same = [{k: v for k, v in r.items() if k != "steps_per_s"} for r in ref["logged"]] == [
                {k: v for k, v in r.items() if k != "steps_per_s"} for r in got["logged"]]
            check(same and d == 0.0, f"data parallel: {name} differs between runs (parameters up to {d}, records "
                                     f"equal {same})")
    print(f"data parallel: losses, metrics, parameters and batch statistics bit-equal across the three runs, both "
          f"CLIs (largest parameter difference {worst}); more than one card not run")
    return runs


# ---------------------------------------------------------------- model parallelism

# the headline's SuperGlue (bench.py:45-54) in f32, as the JAX package's context-parallel and
# pipelined forwards compute; seeded random weights
MP_SG = dict(descriptor_dim=256, keypoint_encoder=(32, 64, 128, 256), gnn_layers=18, sinkhorn_iterations=30,
             match_threshold=0.2, compute_dtype="float32")
MP_BATCH, MP_K, MP_SHAPE = 4, 1024, (480, 640)
MP_MICROBATCHES = 4
MP_WORLD = 4  # gloo ranks, all on the one card
MP_TIMEOUT = 300.0  # s the phase waits for its ranks
MP_SCORE_TOL = 1e-4  # the scores of equal matches against the unsharded forward
# equal matches0 / matches1 and mutual nearest neighbours against the unsharded forward (f32 sums in
# another order move near-tied argmaxes)
MP_MIN_AGREE = 0.99
# float32 CG of 300 iterations ends at its accuracy floor (PR 15), where the all-reduced sums' order
# moves it: the sharded solvers are held to the float64 solution no further than twice the unsharded
# float32 solver, plus this share of max(|value|, 1)
MP_SOLVER_TOL = 1e-5


def model_parallel_keypoints(torch, dev):
    """Seeded keypoint sets (B, K) of the headline's size: set 1 is set 0
    permuted within its valid slots, moved by up to half a pixel and with
    its descriptors perturbed, so that the forwards find matches; element
    i has 64 i padded slots."""
    import numpy as np
    from image_matching_tpu_torch.structs import Keypoints

    rng = np.random.default_rng(17)
    b, k, d = MP_BATCH, MP_K, MP_SG["descriptor_dim"]
    h, w = MP_SHAPE
    mask = np.arange(k)[None] < (k - 64 * np.arange(b))[:, None]
    xy = rng.uniform(0, (w - 1, h - 1), (b, k, 2)).astype(np.float32)
    desc = rng.normal(size=(b, k, d)).astype(np.float32)
    score = rng.uniform(0.1, 1.0, (b, k)).astype(np.float32)
    perm = np.stack([np.concatenate([rng.permutation(int(m.sum())), np.arange(int(m.sum()), k)]) for m in mask])
    take = lambda a: np.take_along_axis(a, perm.reshape(b, k, *([1] * (a.ndim - 2))), 1)  # noqa: E731
    xy1 = take(xy) + rng.uniform(-0.5, 0.5, (b, k, 2)).astype(np.float32)
    desc1 = take(desc) + 0.1 * rng.normal(size=(b, k, d)).astype(np.float32)

    def kpts(xy, score, desc):
        desc = desc / np.linalg.norm(desc, axis=-1, keepdims=True) * mask[..., None]
        arrays = dict(xy=xy, score=score * mask, mask=mask, desc=desc.astype(np.float32))
        return Keypoints(**{n: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for n, a in arrays.items()})

    return kpts(xy, score, desc), kpts(xy1, take(score), desc1)


def model_parallel_training(torch, dev):
    """The training step of the TP path: the training CLI's defaults
    (240x320, batch 4, K = 512, D = 128, 18 layers, 100 Sinkhorn
    iterations, lr 1e-4, SuperPoint and warm start from the banked
    weights), in f32, on seeded textured images; returns (sp, sg, images,
    generator, config)."""
    import numpy as np
    from image_matching_tpu_torch.models import SuperGlue, SuperPointBN
    from image_matching_tpu_torch.train.superglue_trainer import SuperGluePairConfig
    from image_matching_tpu_torch.weights import load_npz

    sp = SuperPointBN(128, compute_dtype="float32", device=dev)
    load_npz(sp, str(ROOT / "weights" / "sp_photo.npz"))
    sg = SuperGlue(**SG_TRAIN_KW, compute_dtype="float32", device=dev)
    load_npz(sg, str(ROOT / "weights" / "sg_photo.npz"))
    rng = np.random.default_rng(2)
    images = torch.from_numpy(np.stack([texture(torch, rng, 240, 320) for _ in range(4)])[..., None]).to(dev)
    return sp, sg, images, torch.Generator(device=dev).manual_seed(0), SuperGluePairConfig()


def model_parallel_paths(torch, dev, problems, world: int):
    """Each sharded path on this rank, on meshes of `world` ranks:
    context-parallel SuperGlue over a `context` axis of `world`, the
    pipelined one over a `pipe` axis of 2 (of 1 in a world of one; the
    data axis beside it feeds each pipeline the whole batch), a
    tensor-parallel training step over a `model` axis of `world` (the
    whole batch on every rank, so pair generation is the one process's),
    the sharded pose graph and bundle adjustment over a `data` axis of
    `world`. Returns this rank's outputs (on the host), the wall ms and
    the kernels' launches of one call of each, and the peak memory."""
    from image_matching_tpu_torch.models import SuperGlue
    from image_matching_tpu_torch.ops import _build
    from image_matching_tpu_torch.parallel import mesh as pmesh
    from image_matching_tpu_torch.parallel.collectives import all_gather
    from image_matching_tpu_torch.parallel.context_parallel import make_context_parallel_superglue
    from image_matching_tpu_torch.parallel.pipeline import make_pipelined_superglue
    from image_matching_tpu_torch.parallel.sharding import (
        apply_param_sharding,
        gather_param,
        superglue_param_sharding,
    )
    from image_matching_tpu_torch.slam import bundle_adjustment as ba
    from image_matching_tpu_torch.slam import pose_graph as pg
    from image_matching_tpu_torch.structs import Keypoints
    from image_matching_tpu_torch.train.state import TrainState
    from image_matching_tpu_torch.train.superglue_trainer import make_superglue_train_step

    out, ms, launches = {}, {}, {}

    def timed(name, call, warm: bool = True):
        if warm:
            call()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        result = call()
        torch.cuda.synchronize()
        ms[name], launches[name] = (time.perf_counter() - t0) * 1e3, dict(_build.LAUNCHES)
        return result

    torch.cuda.reset_peak_memory_stats()
    sg = SuperGlue(**MP_SG, device=dev, seed=3).eval()
    kp0, kp1 = model_parallel_keypoints(torch, dev)
    mesh = pmesh.make_mesh({"context": world}, dev)
    axis = mesh.axis("context")
    cp = make_context_parallel_superglue(mesh, MP_SG["gnn_layers"], MP_SG["sinkhorn_iterations"],
                                         MP_SG["match_threshold"])
    k0, k1 = (Keypoints(*(t[:, axis.shard(MP_K)] for t in (kp.xy, kp.score, kp.mask, kp.desc))) for kp in (kp0, kp1))
    out["context parallel"] = [t.cpu() for t in timed("context parallel", lambda: cp(sg, k0, k1, MP_SHAPE, MP_SHAPE))]
    stages = 2 if world > 1 else 1
    mesh = pmesh.make_mesh({"data": world // stages, "pipe": stages}, dev)
    pp = make_pipelined_superglue(mesh, MP_SG["gnn_layers"], MP_SG["sinkhorn_iterations"], MP_SG["match_threshold"],
                                  MP_MICROBATCHES)
    res = timed("pipeline", lambda: pp(sg, kp0, kp1, MP_SHAPE, MP_SHAPE))
    out["pipeline"] = [res[k].cpu() for k in ("matches0", "matches1", "matching_scores0", "matching_scores1")]

    sp, tsg, images, gen, cfg = model_parallel_training(torch, dev)
    mesh = pmesh.make_mesh({"data": 1, "model": world}, dev)
    specs = superglue_param_sharding(tsg, mesh)
    apply_param_sharding(tsg, specs)
    state = TrainState.create(tsg, 1e-4)
    step = make_superglue_train_step(tsg, sp, cfg)
    with pmesh.use_mesh(mesh):
        metrics = timed("tensor parallel", lambda: step(state, images, gen), warm=False)
    model = mesh.axis("model")
    sd = tsg.state_dict()
    out["tensor parallel"] = {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "state": {k: gather_param(t, specs[k]).cpu() for k, t in sd.items()},
        "split": sum(s.dim is not None for s in specs.values()),
        "replicated differ": [k for k, t in sd.items() if specs[k].dim is None
                              and not all(torch.equal(g, t) for g in all_gather(t, model))]}

    graph, bap, traj = (problems[k] for k in ("pose graph", "bundle adjustment", "trajectory"))
    mesh = pmesh.make_mesh({"data": world}, dev)
    data = mesh.axis("data")
    edges = [graph[k].to(dev)[data.shard(graph["src"].shape[0])] for k in ("src", "dst", "rel", "weight")]
    solve = pg.make_sharded_pose_graph_solver(mesh, graph["num_frames"], iters=graph["iters"])
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(graph["num_frames"], 1)
    out["pose graph"] = [timed("pose graph", lambda: solve(*edges, ident)).cpu()]
    obs = [bap[k].to(dev)[data.shard(bap["frame"].shape[0])] for k in ("frame", "landmark", "uv", "weight")]
    solve = ba.make_sharded_bundle_adjuster(mesh, bap["num_frames"], bap["num_landmarks"], iters=bap["iters"])
    out["bundle adjustment"] = [t.cpu() for t in timed("bundle adjustment", lambda: solve(*obs, traj.to(dev)))]
    return {"out": out, "ms": ms, "launches": launches, "peak GiB": torch.cuda.max_memory_allocated() / 2 ** 30}


def model_parallel_reference(torch, dev, problems):
    """The unsharded port on the same inputs, in this process: the
    SuperGlue forward, one training step (its state and gradients after),
    the pose graph and bundle adjustment."""
    from image_matching_tpu_torch.models import SuperGlue
    from image_matching_tpu_torch.slam import bundle_adjustment as ba
    from image_matching_tpu_torch.slam import pose_graph as pg
    from image_matching_tpu_torch.train.state import TrainState
    from image_matching_tpu_torch.train.superglue_trainer import make_superglue_train_step

    sg = SuperGlue(**MP_SG, device=dev, seed=3).eval()
    kp0, kp1 = model_parallel_keypoints(torch, dev)
    with torch.no_grad():
        res = sg(kp0, kp1, MP_SHAPE, MP_SHAPE)
    fwd = [res[k].cpu() for k in ("matches0", "matches1", "matching_scores0", "matching_scores1")]
    sp, tsg, images, gen, cfg = model_parallel_training(torch, dev)
    state = TrainState.create(tsg, 1e-4)
    metrics = make_superglue_train_step(tsg, sp, cfg)(state, images, gen)
    train = {"metrics": {k: float(v) for k, v in metrics.items()},
             "state": {k: t.cpu() for k, t in tsg.state_dict().items()},
             "grads": {k: p.grad.cpu() for k, p in tsg.named_parameters()}, "lr": 1e-4}
    graph, bap, traj = (problems[k] for k in ("pose graph", "bundle adjustment", "trajectory"))
    g = pg.PoseGraph(*(graph[k].to(dev) for k in ("src", "dst", "rel", "weight")), graph["num_frames"])
    p = ba.BAProblem(*(bap[k].to(dev) for k in ("frame", "landmark", "uv", "weight")), bap["num_frames"],
                     bap["num_landmarks"])
    # float64 solves (converged: 96 unknowns) that both solvers' float32 results are held to
    g64 = pg.PoseGraph(g.src, g.dst, g.rel.double(), g.weight.double(), g.num_frames)
    p64 = p.replace(obs_uv=p.obs_uv.double(), obs_weight=p.obs_weight.double())
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64, device=dev).repeat(g.num_frames, 1)
    return {"context parallel": fwd, "pipeline": fwd, "tensor parallel": train,
            "pose graph": {"f32": [pg.optimize_pose_graph(g, iters=graph["iters"]).cpu()],
                           "f64": [pg.optimize_pose_graph(g64, init=ident, iters=graph["iters"]).cpu()]},
            "bundle adjustment": {
                "f32": [t.cpu() for t in ba.bundle_adjust(p, init=traj.to(dev), iters=bap["iters"])],
                "f64": [t.cpu() for t in ba.bundle_adjust(p64, init=traj.to(dev).double(), iters=bap["iters"])]}}


def sequence_problems(torch, captured: dict) -> dict:
    """The sequence CLI's pose graph and its bundle-adjustment problem
    (the tracks that `refine_trajectory_with_tracks` keeps, weight 1), on
    the host, padded with weight-0 edges and observations to a multiple of
    `MP_WORLD`, and the pose-graph trajectory that seeds the BA."""
    from image_matching_tpu_torch.slam.bundle_adjustment import tracks_to_ba_problem

    (graph,), gkw = captured["pose graph"]
    (tracks, traj, n), bkw = captured["bundle adjustment"]
    tracks = [t for t in tracks if len(t[1]) >= bkw["min_track_length"]]
    n_obs = sum(len(t[1]) for t in tracks)
    prob = tracks_to_ba_problem(tracks, n, -(-n_obs // MP_WORLD) * MP_WORLD, device="cpu")
    e = graph.src.shape[0]
    pad = lambda t: torch.cat([t.cpu(), t.new_zeros((-e % MP_WORLD, *t.shape[1:])).cpu()])  # noqa: E731
    return {"pose graph": {"src": pad(graph.src), "dst": pad(graph.dst), "rel": pad(graph.rel),
                           "weight": pad(graph.weight), "num_frames": graph.num_frames, "iters": gkw["iters"]},
            "bundle adjustment": {"frame": prob.obs_frame, "landmark": prob.obs_landmark, "uv": prob.obs_uv,
                                  "weight": prob.obs_weight, "num_frames": n, "num_landmarks": prob.num_landmarks,
                                  "iters": bkw["iters"]},
            "trajectory": traj.cpu()}


def _model_parallel_rank(rank: int, world: int, port: int, root: str, backend: str):
    """One rank of a model-parallel world: its paths' results to
    `root/rank<r>.pt`. "gloo": every rank on card 0, then ranks 0 and 1 ask
    NCCL for a group of two ranks on one card and write its answer to
    `root/nccl<r>.txt`; "nccl": rank r on card r."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    card = 0 if backend == "gloo" else rank
    torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    problems = torch.load(os.path.join(root, "problems.pt"), weights_only=False)  # written by the phase
    result = model_parallel_paths(torch, torch.device("cuda", card), problems, world)
    torch.save(result, os.path.join(root, f"rank{rank}.pt"))
    if backend == "gloo":
        nccl = dist.new_group([0, 1], backend="nccl")
        if rank < 2:
            try:
                x = torch.ones(1, device="cuda")
                dist.all_reduce(x, group=nccl)
                torch.cuda.synchronize()
                msg = f"an all_reduce over two NCCL ranks on one card returned {float(x)}"
            except Exception as e:  # the answer is the point: record it, whatever it is
                msg = f"{type(e).__name__}: {' '.join(str(e).split())[:400]}"
            with open(os.path.join(root, f"nccl{rank}.txt"), "w") as f:
                f.write(msg)
    sys.stdout.flush()
    os._exit(0)  # no teardown of a group whose communicator may have failed


def _spawn_model_parallel(torch, root, backend: str) -> list:
    """`MP_WORLD` ranks of `_model_parallel_rank`, spawned; waits at most
    `MP_TIMEOUT` s, stops any rank still running, returns their results."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_model_parallel_rank, args=(MP_WORLD, free_port(), str(root), backend),
                             nprocs=MP_WORLD, join=False, start_method="spawn")
    deadline = time.perf_counter() + MP_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                break
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    ranks = []
    for r in range(MP_WORLD):
        f = root / f"rank{r}.pt"
        check(f.exists(), f"model parallel: {backend} rank {r} wrote no result in {MP_TIMEOUT:.0f} s")
        ranks.append(torch.load(f, weights_only=False))
    return ranks


def _held_world(torch, label, ranks, ref, smi) -> None:
    """Print and check every rank of a world of `MP_WORLD` against the unsharded port."""
    for r, result in enumerate(ranks):
        _report_rank(label, r, result, MP_WORLD, smi)
    joined = {  # the context-parallel ranks' slices of K, in axis order; the rest from rank 0 (replicated)
        "context parallel": [torch.cat([rk["out"]["context parallel"][i] for rk in ranks], 1) for i in range(4)]}
    for path in ("pipeline", "tensor parallel", "pose graph", "bundle adjustment"):
        joined[path] = ranks[0]["out"][path]
    for path, got in joined.items():
        _held(torch, label, path, got, ref[path], smi)
    for r in range(MP_WORLD):
        for path in ("pipeline", "pose graph", "bundle adjustment"):
            check(all(torch.equal(a, b) for a, b in zip(ranks[r]["out"][path], ranks[0]["out"][path])),
                  f"model parallel ({label}): rank {r}'s {path} differs from rank 0's")
        check(ranks[r]["out"]["tensor parallel"]["replicated differ"] == [],
              f"model parallel ({label}): rank {r}'s replicated tensors differ across the model axis")


def _model_parallel_setup(torch, dev, root, captured):
    """The solver problems written for the ranks, and the unsharded references on `dev`."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    problems = sequence_problems(torch, captured)
    torch.save(problems, root / "problems.pt")
    return problems, model_parallel_reference(torch, dev, problems)


def _held(torch, label, path, got, ref, smi) -> None:
    """Print and check one path's outputs against the unsharded port's."""
    if path in ("context parallel", "pipeline"):
        shares, dscore = [], 0.0
        for m, r, sc, q in ((got[0], ref[0], got[2], ref[2]), (got[1], ref[1], got[3], ref[3])):
            matched = (m >= 0) | (r >= 0)
            shares.append(float((m == r)[matched].double().mean()) if bool(matched.any()) else 1.0)
            shares.append(float(((sc > 0) == (q > 0)).double().mean()))  # mutual nearest neighbours
            same = (m == r) & (m >= 0)
            if bool(same.any()):
                dscore = max(dscore, float((sc - q)[same].abs().max()))
        n, nref = int((got[0] >= 0).sum()), int((ref[0] >= 0).sum())
        print(f"model parallel ({label}), {path}: against the unsharded forward, matches0 / matches1 equal on "
              f"{shares[0]:.5f} / {shares[2]:.5f} of the slots matched on either path, mutual nearest neighbours on "
              f"{shares[1]:.5f} / {shares[3]:.5f} of all slots; {n} matches ({nref} unsharded); largest difference "
              f"of the scores of equal matches {dscore:.3e}; {smi}")
        check(min(shares) >= MP_MIN_AGREE and dscore <= MP_SCORE_TOL and nref > 0,
              f"model parallel ({label}), {path}: agreement {shares}, score difference {dscore}, {nref} matches")
    elif path == "tensor parallel":
        metrics = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-30) for k, v in ref["metrics"].items()}
        moved = noise = 0.0
        gscale = max(float(g.abs().max()) for g in ref["grads"].values())
        for k, g in ref["grads"].items():
            d = (got["state"][k] - ref["state"][k]).abs()
            big = g.abs() > 1e-3 * gscale
            moved = max(moved, float(torch.where(big, d, 0.0).max()) / ref["lr"])
            noise = max(noise, float(torch.where(big, 0.0, d).max()) / ref["lr"])
        stats = max(float((got["state"][k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
                    for k, v in ref["state"].items() if k.endswith(("running_mean", "running_var")))
        print(f"model parallel ({label}), tensor parallel step: {got['split']} tensors split; metrics' relative "
              f"differences {json.dumps({k: float(f'{v:.3e}') for k, v in metrics.items()})}; running statistics "
              f"{stats:.3e}; parameters {moved:.3e} lr where the gradient is above 1e-3 of the largest, {noise:.3e} lr "
              f"elsewhere; replicated tensors that differ across the model axis: {got['replicated differ']}; {smi}")
        # Adam's first step moves an entry by about lr either way: elsewhere two runs lie up to 2 lr apart,
        # plus the float32 rounding of p + lr
        check(max(metrics.values()) <= 1e-5 and stats <= 1e-5 and moved <= 1e-2 and noise <= 2.0 + 1e-3
              and not got["replicated differ"], f"model parallel ({label}): tensor parallel step off the one process's")
    else:
        def dist(z):  # from the float64 solution, of max(|value|, 1)
            return max(float((a.double() - b).abs().max() / b.abs().max().clamp_min(1.0)) for a, b in
                       zip(z, ref["f64"]))

        d, d_ref = dist(got), dist(ref["f32"])
        print(f"model parallel ({label}), sharded {path}: {d:.3e} from the float64 solution (of the largest |value|; "
              f"poses{' and landmarks' if len(got) > 1 else ''}), the unsharded float32 solver {d_ref:.3e}; {smi}")
        check(d <= 2 * d_ref + MP_SOLVER_TOL, f"model parallel ({label}): sharded {path} {d} from the float64 "
                                              f"solution, the unsharded solver {d_ref}")


def _expected_launches(path: str, world: int) -> dict:
    """The port's kernels' launches of one call of each path on one rank."""
    layers = MP_SG["gnn_layers"]
    stages = 2 if world > 1 else 1
    return {"context parallel": {"attention_lse": 2 * layers * world},
            "pipeline": {"attention": 2 * layers // stages * MP_MICROBATCHES, "sinkhorn": 1},
            "tensor parallel": {"entry_conv": 1, "attention_lse": 2 * layers, "attention_dq": 2 * layers,
                                "attention_dkdv": 2 * layers},
            "pose graph": {}, "bundle adjustment": {}}[path]


def _report_rank(label, rank, result, world, smi) -> None:
    for path, ms in result["ms"].items():
        got = result["launches"][path]
        print(f"model parallel ({label}, rank {rank}), {path}: {ms:.1f} ms wall a call"
              f"{' (the first step)' if path == 'tensor parallel' else ''}, launches {got}; {smi}")
        check(got == _expected_launches(path, world), f"model parallel ({label}, rank {rank}): {path} launched "
                                                        f"{got}, expected {_expected_launches(path, world)}")
    print(f"model parallel ({label}, rank {rank}): peak memory {result['peak GiB']:.3f} GiB")


def run_model_parallel(torch, dev, smi: str, captured: dict):
    """The JAX package's sharded paths, ported: context-parallel and
    pipelined SuperGlue at the headline's width (f32), a tensor-parallel
    training step at the training CLI's defaults (f32), and the sharded
    pose graph and bundle adjustment on the sequence CLI's problem
    (`captured`, from `run_sequence_cli`), each held to the unsharded port
    on the card: in a world of one NCCL rank (made here), then in a world
    of `MP_WORLD` gloo ranks all on this card (spawned; gloo's exchanges go
    through host memory, so this world checks correctness, not collective
    speed). Prints per path the agreement, wall ms and launches a call, peak
    memory, and what NCCL says to two ranks on one card."""
    import torch.distributed as dist

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    root = ROOT / "build" / "model_parallel"
    try:
        problems, ref = _model_parallel_setup(torch, dev, root, captured)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
        try:
            one = model_parallel_paths(torch, dev, problems, 1)
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.use_deterministic_algorithms(False)
    _report_rank("NCCL, world 1", 0, one, 1, smi)
    for path, got in one["out"].items():
        _held(torch, "NCCL, world 1", path, got, ref[path], smi)
    t1 = time.perf_counter()
    _held_world(torch, f"gloo, world {MP_WORLD} on one card", _spawn_model_parallel(torch, root, "gloo"), ref, smi)
    for r in range(2):
        f = root / f"nccl{r}.txt"
        print(f"model parallel: NCCL with two ranks on one card (rank {r}): "
              + (f.read_text() if f.exists() else f"no answer within {MP_TIMEOUT:.0f} s"))
    print(f"model parallel: {t1 - t0:.1f} s in this process (unsharded references and the NCCL world of one), "
          f"{time.perf_counter() - t1:.1f} s for the gloo world of {MP_WORLD} (its start included); more than one "
          f"card: `scripts/model_parallel_cards.py`; {smi}")


def run_model_parallel_cards(torch, smi: str, captured: dict):
    """`run_model_parallel`'s paths over NCCL across `MP_WORLD` cards of
    one host, one rank a card (spawned), against the unsharded port on
    card 0 (`scripts/model_parallel_cards.py` runs it)."""
    check(torch.cuda.device_count() >= MP_WORLD, f"model parallel across cards: needs {MP_WORLD} cards, have "
                                                 f"{torch.cuda.device_count()}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    root = ROOT / "build" / "model_parallel_cards"
    try:
        _, ref = _model_parallel_setup(torch, torch.device("cuda", 0), root, captured)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.use_deterministic_algorithms(False)
    t1 = time.perf_counter()
    _held_world(torch, f"NCCL, world {MP_WORLD} across {MP_WORLD} cards", _spawn_model_parallel(torch, root, "nccl"),
                ref, smi)
    print(f"model parallel across cards: {t1 - t0:.1f} s for the unsharded references on card 0, "
          f"{time.perf_counter() - t1:.1f} s for the NCCL world of {MP_WORLD} (its start included); {smi}")


# ---------------------------------------------------------------- wide heads: D = 512 and D = 1024

# SuperGlue at descriptor_dim 512 and 1024: 4 heads of 128 values (the kernels at 128) and
# of 256 (the chunked kernels, 2 chunks of 128). No banked weights exist at those widths:
# every phase runs seeded ones.
WIDE_SG = dict(keypoint_encoder=(32, 64, 128, 256))
WIDE_DESCRIPTOR_DIMS = (512, 1024)
WIDE_TRAIN_STEPS = 6
# the training CLI's wide runs at 2 GNN layers: a checkpoint of the 18 layers at D = 1024 is
# 2.2 GB of compressed npz (weights and Adam's moments), ~2 minutes to write on the card's host
WIDE_CLI_LAYERS = 2
WIDE_MATCH_PAIR_SOURCES = 2
# the kernel path's log-coupling against the all-plain path's, largest distance over the
# valid pairs: both run the 18-layer GNN in bf16 (or f32), rounding in other orders (on an
# H100: 0.117 at D = 256, 0.161 at D = 512, 0.083 at D = 1024 in bf16, 2.2e-4 in f32)
WIDE_MAX_Z_ERR = {"bfloat16": 0.5, "float32": 1e-3}


def wide_launch(name: str, d: int) -> str:
    """The launch count of wrapper `name` on the D = `d` path (4 heads)."""
    from image_matching_tpu_torch.ops import attention as A

    return A.launch_name(name, A.padded_head_dim(d // 4))


def run_wide_main_path(torch, dev, d: int, dtype: str):
    """The headline's `Matching` (480x640, batch 4, K = 1024, 18 GNN layers,
    30 Sinkhorn iterations, plain backbone) at descriptor_dim `d`, seeded
    weights, in `dtype`: launch counts of one forward (the forward kernel
    of the heads' width, 36 a forward), pairs/s by the host clock (median
    of 5 forwards), peak memory, agreement with the all-plain path (the
    log-coupling within `WIDE_MAX_Z_ERR`), and the device time and busy
    share of a forward (profiled; on `build/attention_before.cu`'s build too,
    where that file is there). Returns the launch counts."""
    import numpy as np
    from image_matching_tpu_torch.models import Matching, MatchingConfig
    from image_matching_tpu_torch.ops import _build

    batch, h, w, k = 4, 480, 640, 1024
    label = f"D = {d} main path ({dtype})"
    cfg = MatchingConfig(descriptor_dim=d, **WIDE_SG, max_keypoints=k, keypoint_threshold=0.005, gnn_layers=18, sinkhorn_iterations=30,
                         match_threshold=0.1, compute_dtype=dtype)
    model = Matching(cfg, device=dev, seed=0)
    rng = np.random.default_rng(8)
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
    want = {"entry_conv": 1, wide_launch("attention", d): 36, "sinkhorn": 1}
    print(f"{label} launches per forward: {launches}")
    check(launches == want, f"{label} launch counts {launches} != {want}")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        model(image0, image1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sec = statistics.median(times)
    print(f"{label}: {batch / sec:.2f} pairs/s (median of 5 forwards, {sec * 1e3:.2f} ms per batch of {batch}); peak "
          f"memory {peak_gib:.3f} GiB; TF32 off")
    z, kp0 = out["log_coupling"], out["keypoints0"]
    check(tuple(z.shape) == (batch, k + 1, k + 1) and tuple(kp0.desc.shape) == (batch, k, d), f"{label}: shapes")
    valid = kp0.mask[:, :, None] & out["keypoints1"].mask[:, None, :]
    check(bool(torch.isfinite(z[:, :k, :k][valid]).all()), f"{label}: non-finite log-coupling")
    m0 = out["matches0"]
    check(bool(((m0 >= -1) & (m0 < k)).all()), f"{label}: matches0 out of range")
    print(f"{label}: keypoints per image {kp0.num_valid().tolist()}, matches {(m0 >= 0).sum(-1).tolist()}")
    # as the headline's checks: bf16 keypoint sets identical (every one of the K far above
    # the threshold), f32 ones within a few swaps of closely tied scores at the K-th cut
    z_err = compare_with_plain(torch, model, image0, image1, out, label,
                               min_kp_iou=1.0 if dtype == "bfloat16" else 0.99)
    check(z_err <= WIDE_MAX_Z_ERR[dtype], f"{label}: log-coupling {z_err} from the all-plain path's")
    profile_forward(torch, model, image0, image1, sec, f"{label} profile")
    if EARLIER_ATTENTION.exists():
        earlier = build_variants("attention", [("before", EARLIER_ATTENTION, ())])["before"]
        with_attention_library("attention", earlier, lambda: profile_forward(
            torch, model, image0, image1, sec, f"{label} profile on build/attention_before.cu"))()
    return launches


def train_wide(torch, dev, images, d: int, dtype: str):
    """SuperGlue training at the training CLI's defaults (batch 4 at
    240x320, K = 512, 18 GNN layers, 100 Sinkhorn iterations, lr 1e-4,
    frozen SuperPoint in the same dtype) at descriptor_dim `d` with seeded
    weights, in `dtype`, through the trainer's step
    (`make_superglue_train_step`, which the CLI calls): launch counts of
    one step (each training kernel of the heads' width, 36 a step), steps/s (median of
    `WIDE_TRAIN_STEPS`), peak memory, finite metrics, the step's device
    time (on the build of `build/attention_before.cu` too, at D = 1024 on
    that of `build/attention_bwd_chunked_before.cu` and at D = 512 in f32 on
    that of `build/attention_bwd_before.cu`, where those files are there);
    then every attention
    backward call of each of two more steps against the plain version
    (`check_backward_calls`; in f32 its distance to float64 moves with the
    training state). Returns the launch counts of one step."""
    from image_matching_tpu_torch.models import SuperGlue, SuperPointBN
    from image_matching_tpu_torch.ops import _build
    from image_matching_tpu_torch.train.state import TrainState
    from image_matching_tpu_torch.train.superglue_trainer import SuperGluePairConfig, make_superglue_train_step

    label = f"D = {d} training ({dtype})"
    sp = SuperPointBN(d, compute_dtype=dtype, device=dev, seed=0)
    sg = SuperGlue(descriptor_dim=d, **WIDE_SG, gnn_layers=18, sinkhorn_iterations=100, compute_dtype=dtype, device=dev, seed=0)
    state = TrainState.create(sg, 1e-4)
    step = make_superglue_train_step(sg, sp, SuperGluePairConfig())
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):  # warm-up: cuDNN algorithm choice, allocator
        step(state, images, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    history = [step(state, images, gen)]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_attn = 2 * 18
    want = {"entry_conv": 1, **{wide_launch(name, d): n_attn for name in ("attention_lse", "attention_dq",
                                                                             "attention_dkdv")}}
    print(f"{label} launches per step: {launches}")
    check(launches == want, f"{label} launch counts {launches} != {want}")
    times = []
    for _ in range(WIDE_TRAIN_STEPS):
        t0 = time.perf_counter()
        history.append(step(state, images, gen))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sec = statistics.median(times)
    losses = [float(mm["loss"]) for mm in history]
    print(f"{label}: {1 / sec:.3f} steps/s ({sec * 1e3:.2f} ms per step of batch {images.shape[0]}, median of "
          f"{WIDE_TRAIN_STEPS} after 2 warm-up steps); peak memory {peak_gib:.3f} GiB; losses " + ", ".join(
              f"{x:.4f}" for x in losses) + "; TF32 off")
    for i, mm in enumerate(history):
        vals = {key: float(val) for key, val in mm.items()}
        check(all(math.isfinite(x) for x in vals.values()) and vals["skipped_nonfinite"] == 0,
              f"{label} step {i}: non-finite metrics or a skipped step {vals}")
    # the step's device time, and at the chunked width on the earlier chunked backward's build too
    fmt = lambda ms: "not measured (profiler events lost)" if ms is None else f"{ms:.3f} ms"
    line = f"{label}: device time per step (profiler, 2 steps) {fmt(device_ms(lambda: step(state, images, gen), 2, 1))}"
    if d == 4 * CHUNKED_ROW_WIDTH and EARLIER_ATTENTION_BWD_CHUNKED.exists():
        earlier = build_variants("attention_bwd_chunked", [("before", EARLIER_ATTENTION_BWD_CHUNKED, ())])["before"]
        before = with_attention_library("attention_bwd_chunked", earlier, lambda: step(state, images, gen))
        line += f"; on build/attention_bwd_chunked_before.cu {fmt(device_ms(before, 2, 1))}"
    if d == 512 and dtype == "float32" and EARLIER_ATTENTION_BWD.exists():  # heads of 128
        earlier = build_variants("attention_bwd", [("before", EARLIER_ATTENTION_BWD, ())])["before"]
        before = with_attention_library("attention_bwd", earlier, lambda: step(state, images, gen))
        line += f"; on build/attention_bwd_before.cu {fmt(device_ms(before, 2, 1))}"
    if EARLIER_ATTENTION.exists():
        earlier = build_variants("attention", [("before", EARLIER_ATTENTION, ())])["before"]
        before = with_attention_library("attention", earlier, lambda: step(state, images, gen))
        line += f"; on build/attention_before.cu {fmt(device_ms(before, 2, 1))}"
    print(line)
    for i in range(2):
        calls = []
        with recorded_backward_calls(torch, calls):
            step(state, images, gen)
        check_backward_calls(torch, calls, f"{label}, step {len(history) + 2 + i}", n_attn, getattr(torch, dtype))
        del calls
    check(all(torch.isfinite(p).all() for p in sg.parameters()), f"non-finite parameters after {label}")
    return launches


def run_wide_train_cli(torch, dev, smi: str, d: int, resume: bool):
    """`cli/train_superglue.py` in-process at its defaults (bf16) with
    --synthetic --descriptor_dim `d` --keypoint_encoder 32 64 128 256
    --gnn_layers `WIDE_CLI_LAYERS` (seeded SuperPoint and SuperGlue) for
    one epoch of `WIDE_TRAIN_STEPS` steps and, with `resume`, --resume for
    one more: launches per step, steps/s (median over the steps after the
    first), peak memory, finite losses, the checkpoints written and the
    step count continued."""
    import shutil

    from image_matching_tpu_torch.cli import train_superglue as cli
    from image_matching_tpu_torch.ops import _build

    run_dir = ROOT / "build" / f"train_superglue_d{d}"
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--synthetic", "--run_dir", str(run_dir), "--descriptor_dim", str(d), "--keypoint_encoder", "32", "64",
            "128", "256", "--gnn_layers", str(WIDE_CLI_LAYERS), "--epochs", "1", "--steps_per_epoch",
            str(WIDE_TRAIN_STEPS), "--log_interval", "2"]
    times, real_factory = [], cli.make_superglue_train_step

    def timed_factory(*args, **kwargs):
        step = real_factory(*args, **kwargs)

        def timed(state, images, gen):
            t0 = time.perf_counter()
            metrics = step(state, images, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return metrics
        return timed

    label = f"train_superglue CLI --descriptor_dim {d} --gnn_layers {WIDE_CLI_LAYERS}"
    want = {"entry_conv": 1, **{wide_launch(name, d): 2 * WIDE_CLI_LAYERS for name in ("attention_lse", "attention_dq",
                                                                                        "attention_dkdv")}}
    runs = {}
    with mock.patch.object(cli, "make_superglue_train_step", timed_factory):
        for run, extra in (("1 epoch", []), ("--resume, 1 epoch", ["--resume"]))[:2 if resume else 1]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            first = len(times)
            runs[run] = out = cli.main(argv + extra)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            steps = len(times) - first
            sec = statistics.median(times[first + 1:])
            per_step = {key: val / steps for key, val in launches.items()}
            print(f"{label} ({run}): steps {out['history'][0]['first_step']} -> {out['state'].step}; {1 / sec:.3f} "
                  f"steps/s (median over the {steps - 1} steps after the first, {sec * 1e3:.2f} ms; first step "
                  f"{times[first] * 1e3:.1f} ms); peak memory {peak:.3f} GiB; launches per step {per_step}; {smi}")
            for rec in out["logged"]:
                print("  " + ", ".join(f"{key} {val:.4f}" if isinstance(val, float) else f"{key} {val}"
                                       for key, val in rec.items()))
            check(per_step == want, f"{label} ({run}): launches per step {per_step} != {want}")
            check(steps == WIDE_TRAIN_STEPS and all(math.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0
                                                    for r in out["logged"]),
                  f"{label} ({run}): {steps} steps, or a loss is not finite or a step was skipped")
    ckpts = sorted((p.name for p in (run_dir / "checkpoints").iterdir()), key=lambda name: int(name.split(".")[0]))
    print(f"{label}: checkpoints {ckpts}")
    resumed = runs.get("--resume, 1 epoch")
    check(runs["1 epoch"]["state"].step == WIDE_TRAIN_STEPS
          and (resumed is None or (resumed["history"][0]["first_step"] == WIDE_TRAIN_STEPS
                                   and resumed["state"].step == 2 * WIDE_TRAIN_STEPS))
          and ckpts == [f"{k * WIDE_TRAIN_STEPS}.npz" for k in (1, 2)[:len(runs)]],
          f"{label}: the checkpoints or the resumed step count are wrong")


def run_wide_match_pair(torch, dev, smi: str, d: int):
    """`cli/match_pair.py --matcher superglue --descriptor_dim d` on the
    template and the first `WIDE_MATCH_PAIR_SOURCES` sources that
    `run_match_pair_cli` wrote, with seeded SuperPoint and SuperGlue
    weights: a run check, no quality claim. Wall s a pair (the CLI's own
    timer), launches (the forward kernel of the heads' width, 36 a pair),
    finite transforms."""
    import numpy as np

    root = ROOT / "build" / "match_pair"
    wide = root / f"d{d}"
    (wide / "src").mkdir(parents=True, exist_ok=True)
    for i in range(WIDE_MATCH_PAIR_SOURCES):
        (wide / "src" / f"s{i}.png").write_bytes((root / "src" / f"s{i}.png").read_bytes())
    records, launches, sec = _match_pair(torch, ["--template", str(root / "template.png"), "--source_dir",
                                                 str(wide / "src"), "--out", str(wide / "out"), "--matcher",
                                                 "superglue", "--descriptor_dim", str(d)])
    n = WIDE_MATCH_PAIR_SOURCES
    print(f"match_pair --matcher superglue --descriptor_dim {d} (seeded weights; a run check, no quality claim): "
          + "; ".join(f"{r['name']} {r['wall_s']:.4f} s, {r['matches']} matches, valid {r['valid']}" for r in records)
          + f"; wall s a pair median {statistics.median(r['wall_s'] for r in records):.4f}; whole run {sec:.1f} s; "
          f"launches {launches}; {smi}")
    want = {"entry_conv_h": 2 * n, wide_launch("attention", d): 36 * n, "sinkhorn": n}
    check(len(records) == n and launches == want and all(np.isfinite(r["transform"]).all() for r in records),
          f"match_pair --descriptor_dim {d}: {len(records)} records, launches {launches} != {want}, or a non-finite "
          "transform")


def run_wide_heads(torch, dev, smi: str, rows):
    """SuperGlue at descriptor_dim 512 and 1024 (`WIDE_DESCRIPTOR_DIMS`)
    through its entry points: `Matching` in bf16 and f32, training in bf16
    and f32, the training CLI (with a resume at 1024), and match_pair. Fills in the
    launches of `rows` (`time_wide_attention`): each kernel's count on its
    own path, the forwards per forward and the training kernels per step
    at the D whose heads are the row's width (128: D = 512, 256: D = 1024)."""
    import numpy as np

    rng = np.random.default_rng(12)
    images = torch.from_numpy(np.stack([texture(torch, rng, 240, 320) for _ in range(4)])[..., None]).to(dev)
    paths = {}
    for d in WIDE_DESCRIPTOR_DIMS:
        t0 = time.perf_counter()
        paths[d, ""] = run_wide_main_path(torch, dev, d, "bfloat16")
        paths[d, "_f32"] = run_wide_main_path(torch, dev, d, "float32")
        paths[d, "train"] = train_wide(torch, dev, images, d, "bfloat16")
        paths[d, "train_f32"] = train_wide(torch, dev, images, d, "float32")
        run_wide_train_cli(torch, dev, smi, d, resume=d == WIDE_DESCRIPTOR_DIMS[-1])
        run_wide_match_pair(torch, dev, smi, d)
        print(f"D = {d} phases: {time.perf_counter() - t0:.1f} s; {smi}")
    for row in rows:  # attention_lse_f32_dh256 -> the D = 1024 f32 step's attention_lse_dh256
        f32 = "_f32" in row["name"]
        name = row["name"].replace("_f32", "")
        d = 4 * int(name.rsplit("_dh", 1)[1])
        on_path = paths[d, ("train" if not name.startswith("attention_dh") else "") + ("_f32" if f32 else "")]
        row["launches"] = on_path.get(name, 0)
        check(row["launches"] == 36, f"{row['name']}: {row['launches']} launches on its D = {d} path")


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
            if "spill" in line or ("ptxas" in line and ("registers" in line or "Compiling" in line)):
                print(f"  [{name}] {line.strip()}")

    probe_lds(torch, dev)
    rng = np.random.default_rng(0)
    kernels = [check_entry_conv(torch, dev, rng), check_attention(torch, dev, rng),
               check_sinkhorn(torch, dev, rng)]
    wide_rows = time_wide_attention(torch, dev, rng, check_attention_head_dims(torch, dev, rng))
    if EARLIER_ATTENTION.exists():  # an earlier attention.cu, left there by hand to compare with
        compare_attention_builds(torch, dev, rng, [("before", EARLIER_ATTENTION, ())])
    launches = run_main_path(torch, dev)
    for kern in kernels:
        kern["launches"] = launches.get(kern["name"], 0)
    run_banked_weights(torch, dev)

    train_kernels = check_attention_training(torch, dev, rng)
    train_launches, f32_train_launches = run_training(torch, dev)
    for kern in train_kernels:
        kern["launches"] = train_launches.get(kern["name"], 0)
    kernels += train_kernels

    s2d_libs = s2d_entry_libs()
    s2d_kernels = [check_s2d_entry_conv(torch, dev, rng, s2d_libs), check_realign(torch, dev, rng)]
    s2d_f32, f32_fwd, f32_bwd = time_f32_kernels(torch, dev, rng, s2d_libs)
    f32_main_launches = run_f32_main_path(torch, dev)
    for kern in f32_fwd + f32_bwd:  # attention_dq_f32 -> the f32 step's attention_dq launches
        on_path = f32_main_launches if kern["name"] == "attention_f32" else f32_train_launches
        kern["launches"] = on_path.get(kern["name"][:-4], 0)
    reg_launches = run_registration(torch, dev, "bn", timed=True)
    run_registration(torch, dev, "vgg", timed=False)
    for kern in s2d_kernels:
        kern["launches"] = reg_launches.get(kern["name"], 0)
    s2d_f32["launches"] = run_f32_backbone(torch, dev, s2d_libs).get("s2d_entry_conv", 0)
    kernels += s2d_kernels + [s2d_f32] + f32_fwd + f32_bwd
    run_banked_registration(torch, dev)

    entry_h = check_entry_conv_h(torch, dev, rng)
    entry_h["launches"] = run_h_backbone(torch, dev).get("entry_conv_h", 0)
    kernels.append(entry_h)
    run_evaluation_cli(torch, dev)
    run_match_pair_cli(torch, dev, smi)
    run_wide_heads(torch, dev, smi, wide_rows)
    kernels += wide_rows
    run_train_superglue_cli(torch, dev, smi)
    run_train_superpoint_cli(torch, dev, smi)
    data_root, labels, _ = run_export_pseudo_cli(torch, dev, smi)
    run_retrain_superpoint_cli(torch, dev, smi, data_root, labels)
    run_classical_evaluation(torch, dev, smi)
    run_traditional_cli(torch, dev, smi)
    captured = run_sequence_cli(torch, dev, smi)
    run_native_loader(torch, dev, smi)
    run_chunked_export(torch, dev, smi)
    run_data_parallel(torch, dev, smi)
    run_model_parallel(torch, dev, smi, captured)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
