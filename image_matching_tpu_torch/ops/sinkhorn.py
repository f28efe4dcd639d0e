"""Log-domain Sinkhorn optimal transport with dustbins, masked.

The counterpart of `image_matching_tpu/ops/sinkhorn.py`
(`log_optimal_transport`, `extract_matches_from_transport`) and of
`ops/pallas/sinkhorn.py` (`fused_log_sinkhorn`). The dustbin assembly,
the masked marginals, `- norm` and the match extraction are plain torch;
the iteration loop is `log_sinkhorn`, which launches `csrc/sinkhorn.cu`
on a CUDA tensor and runs `log_sinkhorn_plain` on a CPU tensor.

The kernel has two routes, chosen from the shape by `sinkhorn_route`: where
the coupling fits in the shared memory of blocks that are all resident at
once, one cooperative launch keeps it on chip for the whole loop
("resident"); beyond that, each iteration streams it once through row bands
and merges the column sums in a second launch ("streamed").

Training (`log_optimal_transport(..., train=True)`) runs
`log_sinkhorn_scan` instead on every device: the counterpart of the JAX
package's `lax.scan` loop (`ops/sinkhorn.log_sinkhorn`), which is what
its trainer differentiates. The TPU kernel (`ops/pallas/sinkhorn.py`) is
inference-only and has no backward, so the port has no Sinkhorn kernel
for training either: the loop is plain torch ops that autograd records.
The CUDA kernel's wrapper raises under grad rather than return a result
that autograd cannot differentiate.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from image_matching_tpu_torch.ops import _build

BIG_NEG = -1e9

# the CUDA kernel's shapes (csrc/sinkhorn.cu)
STREAMED_ROWS = 16  # rows of a band in the streamed route, where they fit
ROW_MULTIPLE = 8    # the kernel takes a band's rows 8 at a time (CHUNK)
MERGE_SCRATCH = 16 * 32 * 8  # bytes of a block's merge scratch: 16 warps x 32 columns x (shift, sum)
_NOT_CO_RESIDENT = -1  # sinkhorn_f32's code for a resident grid that does not fit


def log_sinkhorn_plain(z, log_mu, log_nu, iters: int):
    """z (B, M, N), log_mu (B, M), log_nu (B, N) -> z + u + v after
    `iters` max-shifted logsumexp updates, in the TPU kernel's order."""
    z = z.float()
    u = torch.zeros_like(log_mu, dtype=torch.float32)
    v = torch.zeros_like(log_nu, dtype=torch.float32)
    for _ in range(iters):
        t = z + v[:, None, :]
        m = t.amax(dim=2, keepdim=True)
        u = log_mu - (m + torch.log(torch.exp(t - m).sum(dim=2, keepdim=True)))[..., 0]
        t = z + u[:, :, None]
        m = t.amax(dim=1, keepdim=True)
        v = log_nu - (m + torch.log(torch.exp(t - m).sum(dim=1, keepdim=True)))[:, 0]
    return z + u[:, :, None] + v[:, None, :]


def log_sinkhorn_scan(z, log_mu, log_nu, iters: int):
    """The differentiable loop of the JAX package's `log_sinkhorn`:
    u = log_mu - logsumexp(z + v), v = log_nu - logsumexp(z + u), from
    zeros, `iters` times; returns z + u + v."""
    z = z.float()
    u = torch.zeros_like(log_mu, dtype=torch.float32)
    v = torch.zeros_like(log_nu, dtype=torch.float32)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(z + u[:, :, None], dim=1)
    return z + u[:, :, None] + v[:, None, :]


class SinkhornRoute(NamedTuple):
    name: str   # "resident" or "streamed"
    rows: int   # rows of one batch element that a block holds in shared memory
    bands: int  # blocks per batch element: ceil(rows of z / rows)
    smem: int   # bytes of shared memory a block takes

    def launches(self, iters: int) -> int:
        """Launches of `csrc/sinkhorn.cu` kernels in one call (the streamed
        route's wrapper also zero-fills u and v)."""
        return 1 if self.name == "resident" else 2 * iters + 1


def _smem_bytes(rows: int, nc: int) -> int:
    return MERGE_SCRATCH + 4 * (rows * nc + 2 * rows + nc)  # the scratch, the rows of z, their u and log-sums, v


def sinkhorn_route(b: int, mr: int, nc: int, sms: int, smem_per_block: int) -> SinkhornRoute:
    """The kernel's route for a (b, mr, nc) coupling on a card with `sms`
    SMs and `smem_per_block` bytes of shared memory a block may opt in to.
    Resident: each batch element's rows are split over at most sms // b
    blocks, one an SM, so every block is resident at once, in bands of a
    multiple of ROW_MULTIPLE rows; it is taken when such a band fits.
    Streamed otherwise, with bands of up to STREAMED_ROWS rows."""
    per_element = sms // b
    if per_element >= 1:
        rows = -(-mr // per_element)
        rows = -(-rows // ROW_MULTIPLE) * ROW_MULTIPLE
        if _smem_bytes(rows, nc) <= smem_per_block:
            return SinkhornRoute("resident", rows, -(-mr // rows), _smem_bytes(rows, nc))
    rows = STREAMED_ROWS
    while rows > 1 and _smem_bytes(rows, nc) > smem_per_block:
        rows //= 2
    if _smem_bytes(rows, nc) > smem_per_block:
        raise ValueError(f"log_sinkhorn: a row of {nc} columns does not fit in {smem_per_block} bytes "
                         "of shared memory")
    return SinkhornRoute("streamed", rows, -(-mr // rows), _smem_bytes(rows, nc))


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple[int, int]:
    """(SM count, shared memory a block may opt in to) of CUDA device `index`."""
    fn = _build.library("sinkhorn").sinkhorn_device_limits
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        _build.check(fn(ctypes.byref(sms), ctypes.byref(smem)), "sinkhorn_device_limits")
    return sms.value, smem.value


def route_on(device, b: int, mr: int, nc: int) -> SinkhornRoute:
    """The route the kernel takes for a (b, mr, nc) coupling on `device`."""
    return sinkhorn_route(b, mr, nc, *device_limits(torch.device(device).index or 0))


def log_sinkhorn(z, log_mu, log_nu, iters: int):
    """Dispatch on the tensor's device: the CUDA kernel on the card (one
    launch a call on the resident route, 2 * iters + 1 on the streamed
    one), the plain loop on the CPU."""
    if z.device.type == "cpu":
        return log_sinkhorn_plain(z, log_mu, log_nu, iters)
    return _log_sinkhorn_cuda(z, log_mu, log_nu, iters)


def _log_sinkhorn_cuda(z, log_mu, log_nu, iters):
    if z.device.type != "cuda":
        raise ValueError(f"log_sinkhorn: unsupported device {z.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (z, log_mu, log_nu)):
        raise RuntimeError("log_sinkhorn: the CUDA kernel has no backward; train with "
                           "log_optimal_transport(..., train=True)")
    if z.dim() != 3:
        raise ValueError(f"log_sinkhorn: need (B, M, N), got {tuple(z.shape)}")
    b, m, n = z.shape
    for name, t, shape in (("z", z, (b, m, n)), ("log_mu", log_mu, (b, m)),
                           ("log_nu", log_nu, (b, n))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"log_sinkhorn: {name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != z.device or not t.is_contiguous():
            raise ValueError(f"log_sinkhorn: {name} must be contiguous on {z.device}")
    if iters < 0:
        raise ValueError("log_sinkhorn: iters must be >= 0")
    route = route_on(z.device, b, m, n)
    # the resident route keeps u and v in shared memory from zeros; the
    # streamed one reads them from these buffers
    fresh = torch.empty if route.name == "resident" else torch.zeros
    u = fresh((b, m), dtype=torch.float32, device=z.device)
    v = fresh((b, n), dtype=torch.float32, device=z.device)
    # (shift, sum) partials of the bands, by tiles of 32 columns
    part = torch.empty((b, -(-n // 32), route.bands, 32, 2), dtype=torch.float32, device=z.device)
    out = torch.empty_like(z)
    fn = _build.library("sinkhorn").sinkhorn_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_build.ptr(z), _build.ptr(log_mu), _build.ptr(log_nu), _build.ptr(u), _build.ptr(v),
             _build.ptr(part), _build.ptr(out), b, m, n, iters, route.rows, int(route.name == "resident"),
             _build.stream_ptr(z.device))
    if err == _NOT_CO_RESIDENT:
        raise RuntimeError(f"log_sinkhorn: the resident route's {b * route.bands} blocks of "
                           f"{route.smem} bytes cannot all be resident on {z.device} at once")
    _build.check(err, "sinkhorn")
    _build.LAUNCHES["sinkhorn"] += 1
    return out


def log_optimal_transport(scores, bin_score, iters: int = 100, mask0=None, mask1=None,
                          train: bool = False):
    """(B, M, N) scores + scalar dustbin score -> (B, M+1, N+1)
    log-coupling, scaled by the valid count as the reference's `Z - norm`.
    `train`: iterate with the differentiable `log_sinkhorn_scan` (the JAX
    trainer's scan) instead of `log_sinkhorn`."""
    scores = scores.float()
    b, m, n = scores.shape
    dev = scores.device
    if mask0 is None:
        mask0 = torch.ones((b, m), dtype=torch.bool, device=dev)
    if mask1 is None:
        mask1 = torch.ones((b, n), dtype=torch.bool, device=dev)
    ms = mask0.sum(-1).float()
    ns = mask1.sum(-1).float()

    alpha = bin_score.float().to(dev).reshape(())
    neg = torch.tensor(BIG_NEG, dtype=torch.float32, device=dev)
    pair_valid = mask0[:, :, None] & mask1[:, None, :]
    couplings = torch.empty((b, m + 1, n + 1), dtype=torch.float32, device=dev)
    couplings[:, :m, :n] = torch.where(pair_valid, scores, neg)
    couplings[:, :m, n] = torch.where(mask0, alpha, neg)
    couplings[:, m, :n] = torch.where(mask1, alpha, neg)
    couplings[:, m, n] = alpha

    norm = -torch.log(ms + ns)  # (B,)
    log_mu = torch.cat([torch.where(mask0, norm[:, None], neg),
                        (torch.log(ns.clamp_min(1e-12)) + norm)[:, None]], dim=-1)
    log_nu = torch.cat([torch.where(mask1, norm[:, None], neg),
                        (torch.log(ms.clamp_min(1e-12)) + norm)[:, None]], dim=-1)
    sinkhorn = log_sinkhorn_scan if train else log_sinkhorn
    z = sinkhorn(couplings, log_mu, log_nu, iters)
    return z - norm[:, None, None]


def extract_matches_from_transport(z, match_threshold: float, mask0=None, mask1=None):
    """Mutual-max + threshold extraction on the (B, M+1, N+1)
    log-coupling. Returns (matches0, matches1, scores0, scores1)."""
    inner = z[:, :-1, :-1]
    m, n = inner.shape[-2], inner.shape[-1]
    if mask0 is not None:
        inner = inner.masked_fill(~mask0[:, :, None], BIG_NEG)
    if mask1 is not None:
        inner = inner.masked_fill(~mask1[:, None, :], BIG_NEG)
    max0, indices0 = inner.max(dim=-1)
    indices1 = inner.argmax(dim=-2)
    arange0 = torch.arange(m, device=z.device)
    arange1 = torch.arange(n, device=z.device)
    mutual0 = torch.gather(indices1, 1, indices0) == arange0
    mutual1 = torch.gather(indices0, 1, indices1) == arange1

    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    mscores0 = torch.where(mutual0, torch.exp(max0), zero)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, indices1), zero)
    valid0 = mutual0 & (mscores0 > match_threshold)
    if mask0 is not None:
        valid0 = valid0 & mask0
    valid1 = mutual1 & torch.gather(valid0, 1, indices1)
    if mask1 is not None:
        valid1 = valid1 & mask1
    minus1 = torch.tensor(-1, dtype=indices0.dtype, device=z.device)
    matches0 = torch.where(valid0, indices0, minus1).int()
    matches1 = torch.where(valid1, indices1, minus1).int()
    return matches0, matches1, mscores0, mscores1
