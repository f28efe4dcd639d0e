"""Masked multi-head attention on packed heads: q (B, N, H*dh), k/v
(B, M, H*dh), key mask (B, M) bool -> (B, N, H*dh).

The counterpart of the forward kernels of
`image_matching_tpu/ops/pallas/attention.py` (`attention_onepass_heads`,
`attention_onepass`, `flash_attention`) and of the einsum path of
`models/superglue.MultiHeadedAttention`. On the card one hand-written
kernel (`csrc/attention.cu`) serves every key count, K=1024 included;
its logits and softmax are f32 on chip, which is the JAX semantics at
`logits_dtype="float32"`. The JAX package's `logits_dtype="bfloat16"`
only narrows how the einsum path stores logits in device memory, which
the kernel never does, so the kernel ignores it. The plain version, used
for CPU tensors, honours it both ways so that CPU parity holds at either
setting.
"""
from __future__ import annotations

import ctypes
import math

import torch

from image_matching_tpu_torch.ops import _build

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64)


def attention_plain(q, k, v, key_mask=None, num_heads: int = 4,
                    logits_dtype: str = "float32"):
    """Einsum attention with the JAX package's numerics: f32 logits from
    the compute-dtype inputs, or (logits_dtype="bfloat16") a pre-scaled
    q and logits rounded to bf16; softmax in f32; probabilities in the
    compute dtype for the value product."""
    b, n, dt = q.shape
    m = k.shape[1]
    dh = dt // num_heads
    qh = q.reshape(b, n, num_heads, dh)
    kh = k.reshape(b, m, num_heads, dh)
    vh = v.reshape(b, m, num_heads, dh)
    if logits_dtype == "bfloat16":
        qs = qh * torch.tensor(1.0 / math.sqrt(dh), dtype=q.dtype)
        logits = torch.einsum("bnhd,bmhd->bhnm", qs.float(), kh.float()).to(torch.bfloat16)
    else:
        logits = torch.einsum("bnhd,bmhd->bhnm", qh.float(), kh.float()) / math.sqrt(dh)
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", probs, vh)
    return out.reshape(b, n, dt)


def attention(q, k, v, key_mask=None, num_heads: int = 4,
              logits_dtype: str = "float32"):
    """Dispatch on the tensors' device: the CUDA kernel on the card (any
    key count; `logits_dtype` has no effect there), the plain version on
    the CPU."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, key_mask, num_heads, logits_dtype)
    return _attention_cuda(q, k, v, key_mask, num_heads)


def _check_operand(name, t, ref, rows):
    if t.device != ref.device or t.dtype != ref.dtype:
        raise ValueError(f"attention: {name} is {t.dtype} on {t.device}, q is {ref.dtype} on {ref.device}")
    if t.dim() != 3 or t.shape[0] != ref.shape[0] or t.shape[2] != ref.shape[2]:
        raise ValueError(f"attention: {name} shape {tuple(t.shape)} does not fit q {tuple(ref.shape)}")
    if rows is not None and t.shape[1] != rows:
        raise ValueError(f"attention: {name} has {t.shape[1]} rows, expected {rows}")
    vec = 4  # the kernel moves 4 elements at a time
    if (t.stride(2) != 1 or t.stride(1) % vec or t.stride(0) % vec
            or t.data_ptr() % (vec * t.element_size())):
        raise ValueError(
            f"attention: {name} needs a contiguous, {vec}-element-aligned last dimension "
            f"(strides {t.stride()})"
        )


def _attention_cuda(q, k, v, key_mask, num_heads):
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention: dtype {q.dtype} not in (bfloat16, float32)")
    b, n, dt = q.shape
    m = k.shape[1]
    if dt % num_heads or dt // num_heads not in HEAD_DIMS:
        raise ValueError(f"attention: head dim {dt}/{num_heads} not in {HEAD_DIMS}")
    if n == 0 or m == 0:
        raise ValueError("attention: empty query or key set")
    _check_operand("q", q, q, None)
    _check_operand("k", k, q, None)
    _check_operand("v", v, q, m)
    if key_mask is not None:
        if (key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, m)
                or key_mask.device != q.device or not key_mask.is_contiguous()):
            raise ValueError("attention: key_mask must be a contiguous (B, M) bool tensor on q's device")
    dh = dt // num_heads
    out = torch.empty((b, n, dt), dtype=q.dtype, device=q.device)
    lib = _build.library("attention")
    fn = lib.attention_bf16 if q.dtype == torch.bfloat16 else lib.attention_f32
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = [vp, i64, i64] * 3 + [vp, vp] + [ctypes.c_int] * 5 + [ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    args = []
    for t in (q, k, v):
        args += [_build.ptr(t), t.stride(0), t.stride(1)]
    mask_ptr = _build.ptr(key_mask) if key_mask is not None else vp(None)
    _build.check(
        fn(*args, mask_ptr, _build.ptr(out), b, n, m, num_heads, dh,
           1.0 / math.sqrt(dh), _build.stream_ptr(q.device)),
        "attention",
    )
    _build.LAUNCHES["attention"] += 1
    return out
