"""Profiling helpers — the counterpart of `image_matching_tpu/utils/profiler.py`:
a device trace on `torch.profiler`, a timer that waits for the card, and
the rough FLOP count of one SuperPoint + SuperGlue pair."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

from image_matching_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Trace the CPU and (where there is one) the card while the block runs;
    writes `<logdir>/trace.json`, a Chrome trace that Perfetto and
    TensorBoard's profile plugin open."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profile trace written to %s", path)


@contextlib.contextmanager
def timed(name: str, sync: bool = True) -> Iterator[None]:
    """Log the block's wall time in ms; with `sync`, the card's queued work
    is waited for before each clock read, so the time includes it."""
    if sync and torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    if sync and torch.cuda.is_available():
        torch.cuda.synchronize()
    log.info("%s: %.3f ms", name, (time.perf_counter() - t0) * 1e3)


def flops_estimate_matching(height: int, width: int, n_kpts: int, d: int = 256, layers: int = 18) -> float:
    """Rough FLOPs of one SP + SG pair (the JAX package's formula), for
    roofline sanity checks."""
    hw = height * width
    backbone = 2 * hw * 9 * (64 * 1 + 64 * 64) + 2 * (hw / 4) * 9 * 64 * 64
    backbone += 2 * (hw / 16) * 9 * (64 * 128 + 128 * 128)
    backbone += 2 * (hw / 64) * 9 * (128 * 128 * 2 + 128 * 256)
    heads = 2 * (hw / 64) * (256 * 65 + 256 * d)
    proj = layers * 2 * 4 * n_kpts * d * d * 2
    attn = layers * 2 * 2 * n_kpts * n_kpts * d * 2
    mlp = layers * 2 * 2 * n_kpts * (2 * d) * (2 * d) * 2
    return 2 * (backbone + heads) + proj + attn + mlp
