"""Log-domain Sinkhorn optimal transport with dustbins, masked.

The counterpart of `image_matching_tpu/ops/sinkhorn.py`
(`log_optimal_transport`, `extract_matches_from_transport`) and of
`ops/pallas/sinkhorn.py` (`fused_log_sinkhorn`). The dustbin assembly,
the masked marginals, `- norm` and the match extraction are plain torch;
the iteration loop is `log_sinkhorn`, which launches `csrc/sinkhorn.cu`
on a CUDA tensor and runs `log_sinkhorn_plain` on a CPU tensor.

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

import torch

from image_matching_tpu_torch.ops import _build

BIG_NEG = -1e9


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


def log_sinkhorn(z, log_mu, log_nu, iters: int):
    """Dispatch on the tensor's device: the CUDA kernels on the card (one
    call = 2 * iters + 1 launches), the plain loop on the CPU."""
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
    u = torch.zeros((b, m), dtype=torch.float32, device=z.device)
    v = torch.zeros((b, n), dtype=torch.float32, device=z.device)
    out = torch.empty_like(z)
    fn = _build.library("sinkhorn").sinkhorn_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(
        fn(_build.ptr(z), _build.ptr(log_mu), _build.ptr(log_nu), _build.ptr(u),
           _build.ptr(v), _build.ptr(out), b, m, n, iters, _build.stream_ptr(z.device)),
        "sinkhorn",
    )
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
