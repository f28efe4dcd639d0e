"""Masked multi-head attention on packed heads: q (B, N, H*dh), k/v
(B, M, H*dh), key mask (B, M) bool -> (B, N, H*dh).

The counterpart of the forward kernels of
`image_matching_tpu/ops/pallas/attention.py` (`attention_onepass_heads`,
`attention_onepass`, `flash_attention`) and of the einsum path of
`models/superglue.MultiHeadedAttention`. On the card one hand-written
kernel (`csrc/attention.cu`) serves every key count, K=1024 included;
its logits and softmax are f32 on chip, which is the JAX semantics at
`logits_dtype="float32"`. The kernels take heads of 16, 32, 64 and 128
values, and every multiple of 128 above it (SuperGlue's 4 heads above
descriptor_dim 512): in bf16 `attention_mma` up to 32, `attention_wg` at 64
and `attention_wide` (wgmma fed by TMA) at 128 and 256; in f32
`attention_ffma` up to 128 and `attention_wide_3xtf32` at 256, its products
on the tensor cores as three TF32 products each, f32-accurate as f32
SDPA's are; the wider heads in chunks of 128 values (the chunked kernels;
f32 on plain FMAs). The backward's kernels take the same widths, in f32 on
plain FMAs up to 64 and as 3xTF32 from 128 up (`attention_backward`). Any other head is zero-padded to the next of those widths on its
way in (80 and 96 to 128, 160 and 200 to 256, 320 to 384) and cut back on
its way out, which is exact: zero columns add nothing to a score and give
zero output columns, and the scale stays 1/sqrt(dh) of the real head. The
kernels at 128 and above count their launches under their own names
(`launch_name`: `_dh128`, `_dh256`, ...), so that a run shows which width
it went through. The JAX
package's `logits_dtype="bfloat16"` only narrows how the einsum path
stores logits in device memory, which the kernel never does, so the
kernel ignores it. The plain version, used
for CPU tensors, honours it both ways so that CPU parity holds at either
setting.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from image_matching_tpu_torch.ops import _build

NEG_INF = -1e9
# The head widths the kernels take: HEAD_DIMS, and every multiple of CHUNK
# above them (the chunked kernels); those from 128 up count their launches apart
HEAD_DIMS = (16, 32, 64, 128)
CHUNK = 128


def kernel_width(dh: int) -> bool:
    """True when a kernel takes heads of exactly `dh` values."""
    return dh in HEAD_DIMS or (dh > CHUNK and dh % CHUNK == 0)


def padded_head_dim(dh: int) -> int:
    """The kernels' head width for heads of `dh` values: the narrowest of
    `HEAD_DIMS` that holds them, and above 128 the next multiple of 128."""
    for width in HEAD_DIMS:
        if dh <= width:
            return width
    return -(-dh // CHUNK) * CHUNK


def launch_name(name: str, width: int) -> str:
    """The key of `_build.LAUNCHES` that a kernel of wrapper `name`
    ("attention", "attention_lse", "attention_dq", "attention_dkdv") at head
    width `width` counts its launches under: `name`, or `name` + "_dh<width>"
    for the kernels at 128 and the chunked ones above it."""
    return f"{name}_dh{width}" if width >= CHUNK else name


def pad_heads(t, num_heads: int, width: int):
    """(B, N, H*dh) -> a new contiguous (B, N, H*width), every head
    zero-padded from dh to `width` values."""
    b, n, dt = t.shape
    return torch.nn.functional.pad(t.reshape(b, n, num_heads, dt // num_heads),
                                   (0, width - dt // num_heads)).reshape(b, n, num_heads * width)


def unpad_heads(t, num_heads: int, dh: int):
    """(B, N, H*width) -> (B, N, H*dh): the first dh values of every head."""
    b, n, dt = t.shape
    return t.reshape(b, n, num_heads, dt // num_heads)[..., :dh].reshape(b, n, num_heads * dh)


def attention_plain(q, k, v, key_mask=None, num_heads: int = 4,
                    logits_dtype: str = "float32"):
    """Einsum attention with the JAX package's numerics: f32 logits from
    the compute-dtype inputs, or (logits_dtype="bfloat16") a pre-scaled
    q and logits rounded to bf16; softmax in f32; probabilities in the
    compute dtype for the value product."""
    if logits_dtype != "bfloat16":
        return _softmax_v(_logits(q, k, key_mask, num_heads, NEG_INF), v, num_heads)
    b, n, dt = q.shape
    dh = dt // num_heads
    qs = q.reshape(b, n, num_heads, dh) * torch.tensor(1.0 / math.sqrt(dh), dtype=q.dtype)
    logits = torch.einsum("bnhd,bmhd->bhnm", qs.float(), _heads(k, num_heads)).to(torch.bfloat16)
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    return _softmax_v(logits, v, num_heads)


def _softmax_v(logits, v, num_heads):
    """Softmax of (B, H, N, M) logits in f32 (float64 for float64 logits),
    probabilities rounded to the compute dtype, times V: (B, N, H*dh)."""
    probs = torch.softmax(_widened(logits), dim=-1).to(v.dtype)
    b, m, dt = v.shape
    out = torch.einsum("bhnm,bmhd->bnhd", probs, v.reshape(b, m, num_heads, dt // num_heads))
    return out.reshape(b, -1, dt)


def _widened(t):
    """f32 of a compute-dtype tensor; float64 stays float64, so that the
    plain versions also give the exact references the checks hold f32 to."""
    return t if t.dtype == torch.float64 else t.float()


def _heads(t, num_heads):
    b, n, dt = t.shape
    return _widened(t).reshape(b, n, num_heads, dt // num_heads)


def _logits(q, k, key_mask, num_heads, masked_fill, scale=None):
    """f32 (B, H, N, M) logits of the compute-dtype inputs (float64 of
    float64 ones), scaled by
    `scale` (1/sqrt(dh) unless given), masked keys set to `masked_fill`
    (a float or a (B,) tensor)."""
    s = torch.einsum("bnhd,bmhd->bhnm", _heads(q, num_heads), _heads(k, num_heads))
    s = s / math.sqrt(q.shape[-1] // num_heads) if scale is None else s * scale
    if key_mask is None:
        return s
    if isinstance(masked_fill, torch.Tensor):
        return torch.where(key_mask[:, None, None, :], s, masked_fill.to(s.dtype).reshape(-1, 1, 1, 1))
    return s.masked_fill(~key_mask[:, None, None, :], masked_fill)  # no copy from the host


def _dead(key_mask):
    """(B,) True where a batch element has no valid key."""
    return ~key_mask.any(-1)


def attention_lse_plain(q, k, v, key_mask=None, num_heads: int = 4, scale=None):
    """The plain version of the forward with LSE: `attention_plain` at f32
    logits, and the f32 log-sum-exp of every row, (B, H, N), log(M) for a
    dead batch element. `scale` is the kernel's argument: 1/sqrt(dh)
    unless given."""
    s = _logits(q, k, key_mask, num_heads, NEG_INF, scale)
    lse = torch.logsumexp(s, dim=-1)
    if key_mask is not None:
        lse = torch.where(_dead(key_mask)[:, None, None], math.log(k.shape[1]), lse)
    return _softmax_v(s, v, num_heads), lse


def attention_backward_plain(q, k, v, key_mask, lse, dout, num_heads: int = 4, delta=None, scale=None):
    """FA2's backward in f32, the plain version of the dK/dV and dQ
    kernels: P = exp(S - lse) with masked logits at 0 in a dead element
    and -inf elsewhere, dP = dO V^T, delta = rowsum(P * dP) / rowsum(P),
    dS = P (dP - delta) * scale, 0 at masked keys; dQ = dS K, dK = dS^T Q,
    dV = P^T dO. Returns (dq, dk, dv) in the inputs' dtype and (B, ., H*dh)
    layout. A given `delta` (B, H, N) f32 replaces rowsum(P * dP), as when
    FA2 takes rowsum(dO * O) from the stored output. `scale` is the
    kernels' argument: 1/sqrt(dh) unless given."""
    b, n, dt = q.shape
    m = k.shape[1]
    scale = 1.0 / math.sqrt(dt // num_heads) if scale is None else scale
    fill = -math.inf if key_mask is None else torch.where(_dead(key_mask), 0.0, -math.inf)
    p = torch.exp(_logits(q, k, key_mask, num_heads, fill, scale) - lse[..., None])
    do = _heads(dout, num_heads)
    dp = torch.einsum("bnhd,bmhd->bhnm", do, _heads(v, num_heads))
    if delta is None:
        delta = (p * dp).sum(-1, keepdim=True) / p.sum(-1, keepdim=True)
    else:
        delta = delta[..., None]
    ds = p * (dp - delta) * scale
    if key_mask is not None:
        ds = ds.masked_fill(~key_mask[:, None, None, :], 0.0)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, _heads(k, num_heads))
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, _heads(q, num_heads))
    dv = torch.einsum("bhnm,bnhd->bmhd", p, do)
    return (dq.reshape(b, n, dt).to(q.dtype), dk.reshape(b, m, dt).to(k.dtype),
            dv.reshape(b, m, dt).to(v.dtype))


def attention_delta_plain(q, k, v, key_mask, lse, dout, num_heads: int = 4):
    """The plain version of the delta that the dQ kernel writes: (B, H, N)
    f32, rowsum(P * dP) / rowsum(P) over the valid keys with
    P = exp(S - lse) and dP = dO V^T, 0 for a row with no valid key. It
    equals the delta `attention_backward_plain` takes wherever a key
    carries dS."""
    p = torch.exp(_logits(q, k, key_mask, num_heads, -math.inf) - lse[..., None])
    dp = torch.einsum("bnhd,bmhd->bhnm", _heads(dout, num_heads), _heads(v, num_heads))
    den = p.sum(-1)
    return torch.where(den > 0, (p * dp).sum(-1) / den.clamp_min(1e-38), 0.0)


def attention_lse(q, k, v, key_mask=None, num_heads: int = 4):
    """Forward with LSE, dispatched on the device: `csrc/attention.cu`
    (LSE on; bf16: tensor cores; f32: `attention_ffma` and, above 256,
    `attention_ffma_chunked`, register-tiled on plain f32 FMAs, and at 256
    `attention_wide_3xtf32`, 3xTF32 products on the tensor cores) on the
    card, `attention_lse_plain` on the CPU. Returns (out (B, N, H*dh), lse
    (B, H, N) f32)."""
    if q.device.type == "cpu":
        return attention_lse_plain(q, k, v, key_mask, num_heads)
    return _attention_cuda(q, k, v, key_mask, num_heads, with_lse=True)


def attention_backward(q, k, v, key_mask, lse, dout, num_heads: int = 4):
    """(dq, dk, dv) of attention, dispatched on the device: the dQ and
    dK/dV kernels of `csrc/attention_bwd.cu` (heads above 128:
    `csrc/attention_bwd_chunked.cu`) on the card (bf16: tensor cores,
    above 128 `dq_chunked` and `dkdv_chunked`, thread block clusters of
    the chunk blocks that add their partial S and dP in f32; f32 up to
    128: `dq_ffma` and `dkdv_ffma`, register-tiled on plain f32 FMAs, full
    f32 throughout; f32 above 128: `dq_3xtf32_chunked` and
    `dkdv_3xtf32_chunked`, whose products run on the tensor cores as
    three TF32 products each, f32-accurate as f32 SDPA's are, with P, dS
    and every sum in f32), `attention_backward_plain` on the CPU.
    Both take delta as
    rowsum(P * dP) / rowsum(P) from the backward's own P and dP, so that
    every row of dS sums to 0 whatever the LSE's rounding, not as FA2's
    rowsum(dO * O), so they need no output: in bf16 the rounded O leaves
    every row's dS with a nonzero sum, a bias in dQ (`chip_smoke.py`
    measures it on a training step's calls)."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, key_mask, lse, dout, num_heads)
    return _attention_backward_cuda(q, k, v, key_mask, lse, dout, num_heads)


class AttentionFunction(torch.autograd.Function):
    """Differentiable masked multi-head attention: forward with LSE, FA2
    backward, each on the inputs' device (kernels on the card, plain
    versions on the CPU). The mask and the head count get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, num_heads):
        out, lse = attention_lse(q, k, v, key_mask, num_heads)
        ctx.save_for_backward(q, k, v, key_mask, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, key_mask, lse, dout, ctx.num_heads)
        return dq, dk, dv, None, None


def attention(q, k, v, key_mask=None, num_heads: int = 4,
              logits_dtype: str = "float32"):
    """Under grad, when q, k or v requires grad: `AttentionFunction` (f32
    logits). Otherwise dispatch on the tensors' device: the CUDA kernel on
    the card (any key count; `logits_dtype` has no effect there), the
    plain version on the CPU."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return AttentionFunction.apply(q, k, v, key_mask, num_heads)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, key_mask, num_heads, logits_dtype)
    return _attention_cuda(q, k, v, key_mask, num_heads)


def _check_operand(name, t, ref, rows, vec):
    if t.device != ref.device or t.dtype != ref.dtype:
        raise ValueError(f"attention: {name} is {t.dtype} on {t.device}, q is {ref.dtype} on {ref.device}")
    if t.dim() != 3 or t.shape[0] != ref.shape[0] or t.shape[2] != ref.shape[2]:
        raise ValueError(f"attention: {name} shape {tuple(t.shape)} does not fit q {tuple(ref.shape)}")
    if rows is not None and t.shape[1] != rows:
        raise ValueError(f"attention: {name} has {t.shape[1]} rows, expected {rows}")
    if (t.stride(2) != 1 or t.stride(1) % vec or t.stride(0) % vec
            or t.data_ptr() % (vec * t.element_size())):
        raise ValueError(
            f"attention: {name} needs a contiguous, {vec}-element-aligned last dimension "
            f"(strides {t.stride()})"
        )


def _head_dim(q, num_heads):
    """The real head dim of packed (B, N, H*dh) heads."""
    if q.dim() != 3 or q.shape[2] % num_heads:
        raise ValueError(f"attention: q shape {tuple(q.shape)} is not (B, N, {num_heads}*dh)")
    return q.shape[2] // num_heads


def _check_call(q, k, v, key_mask, num_heads):
    """Validate what the kernels take; returns (b, n, m, dh). The forward
    and backward kernels move 16 bytes at a time (`cp.async`), so every row
    of q, k and v starts on 16 bytes: 8 bf16 or 4 f32. The model's q, k, v (views of a fused projection, head dims
    of 16 and more) always qualify."""
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention: dtype {q.dtype} not in (bfloat16, float32)")
    vec = 16 // q.element_size()
    b, n, dt = q.shape
    m = k.shape[1]
    if dt % num_heads or not kernel_width(dt // num_heads):
        raise ValueError(f"attention: head dim {dt}/{num_heads} is neither in {HEAD_DIMS} nor a multiple of "
                         f"{CHUNK} above it")
    if n == 0 or m == 0:
        raise ValueError("attention: empty query or key set")
    _check_operand("q", q, q, None, vec)
    _check_operand("k", k, q, None, vec)
    _check_operand("v", v, q, m, vec)
    if key_mask is not None:
        if (key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, m)
                or key_mask.device != q.device or not key_mask.is_contiguous()):
            raise ValueError("attention: key_mask must be a contiguous (B, M) bool tensor on q's device")
    return b, n, m, dt // num_heads


def _qkv_args(q, k, v, key_mask):
    args = []
    for t in (q, k, v):
        args += [_build.ptr(t), t.stride(0), t.stride(1)]
    return args + [_build.ptr(key_mask) if key_mask is not None else ctypes.c_void_p(None)]


_QKV_TYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] * 3 + [ctypes.c_void_p]
_TAIL_TYPES = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


@functools.cache
def _launcher(library: str, symbol: str, pointers: int):
    """A launcher function of a kernel library, its signature (q, k, v with
    strides, the mask, `pointers` more tensors, the sizes, the scale, the
    stream) set once."""
    fn = getattr(_build.library(library), symbol)
    fn.argtypes = _QKV_TYPES + [ctypes.c_void_p] * pointers + _TAIL_TYPES
    fn.restype = ctypes.c_int
    return fn


def _suffix(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def _attention_cuda(q, k, v, key_mask, num_heads, with_lse=False):
    real_dh = _head_dim(q, num_heads)
    width = padded_head_dim(real_dh)
    if width != real_dh:  # a copy only for heads the kernels are not built for
        q, k, v = (pad_heads(t, num_heads, width) for t in (q, k, v))
    b, n, m, dh = _check_call(q, k, v, key_mask, num_heads)
    dt = num_heads * dh
    out = torch.empty((b, n, dt), dtype=q.dtype, device=q.device)
    args = _qkv_args(q, k, v, key_mask) + [_build.ptr(out)]
    name = "attention_lse" if with_lse else "attention"
    if with_lse:
        lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=q.device)
        args.append(_build.ptr(lse))
    fn = _launcher("attention", f"{name}_{_suffix(q.dtype)}", 2 if with_lse else 1)
    _build.check(fn(*args, b, n, m, num_heads, dh, 1.0 / math.sqrt(real_dh), _build.stream_ptr(q.device)), name)
    _build.LAUNCHES[launch_name(name, dh)] += 1
    if width != real_dh:
        out = unpad_heads(out, num_heads, real_dh)
    return (out, lse) if with_lse else out


def _attention_backward_cuda(q, k, v, key_mask, lse, dout, num_heads):
    real_dh = _head_dim(q, num_heads)
    if tuple(dout.shape) != tuple(q.shape):
        raise ValueError("attention backward: dout must be (B, N, H*dh) like q")
    dout = dout.to(q.dtype).contiguous()
    width = padded_head_dim(real_dh)
    if width != real_dh:  # a copy only for heads the kernels are not built for
        q, k, v, dout = (pad_heads(t, num_heads, width) for t in (q, k, v, dout))
    b, n, m, dh = _check_call(q, k, v, key_mask, num_heads)
    dt = num_heads * dh
    lse = lse.contiguous()
    delta = torch.empty((b, num_heads, n), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, n, dt), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, m, dt), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, m, dt), dtype=q.dtype, device=q.device)
    # the dQ kernel writes delta, which the dK/dV kernel reads
    scale = 1.0 / math.sqrt(real_dh)
    attention_backward_kernel("attention_dq", q, k, v, key_mask, dout, lse, delta, (dq,), num_heads, scale)
    attention_backward_kernel("attention_dkdv", q, k, v, key_mask, dout, lse, delta, (dk, dv), num_heads, scale)
    if width != real_dh:
        return tuple(unpad_heads(t, num_heads, real_dh) for t in (dq, dk, dv))
    return dq, dk, dv


def attention_backward_kernel(name, q, k, v, key_mask, dout, lse, delta, outs, num_heads, scale=None):
    """Launch one backward kernel of `csrc/attention_bwd.cu` (heads above
    128: `csrc/attention_bwd_chunked.cu`) on the card:
    "attention_dq" into outs = (dq,), which also writes delta, or
    "attention_dkdv" into (dk, dv), which reads the delta that the dQ
    kernel wrote. dout (B, N, H*dh) is contiguous in q's dtype; lse and
    delta are (B, H, N) f32; the outputs are contiguous in q's dtype.
    `scale` is the logits' scale, 1/sqrt(dh) unless given (heads
    zero-padded to a kernel's width keep the scale of their real dh)."""
    b, n, m, dh = _check_call(q, k, v, key_mask, num_heads)
    dt = num_heads * dh
    rows = {"attention_dkdv": (m, m), "attention_dq": (n,)}[name]
    if dout.dtype != q.dtype or tuple(dout.shape) != (b, n, dt) or not dout.is_contiguous():
        raise ValueError(f"{name}: dout must be a contiguous {q.dtype} {(b, n, dt)}")
    for t in (lse, delta):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, num_heads, n) or not t.is_contiguous():
            raise ValueError(f"{name}: lse and delta must be contiguous float32 {(b, num_heads, n)}")
    for t, r in zip(outs, rows, strict=True):
        if t.dtype != q.dtype or tuple(t.shape) != (b, r, dt) or not t.is_contiguous():
            raise ValueError(f"{name}: outputs must be contiguous {q.dtype} {(b, r, dt)}")
    library = "attention_bwd" if dh <= CHUNK else "attention_bwd_chunked"  # the chunked kernels build apart
    fn = _launcher(library, f"{name}_{_suffix(q.dtype)}", 3 + len(outs))
    args = _qkv_args(q, k, v, key_mask) + [_build.ptr(t) for t in (dout, lse, delta, *outs)]
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    _build.check(fn(*args, b, n, m, num_heads, dh, scale, _build.stream_ptr(q.device)), name)
    _build.LAUNCHES[launch_name(name, dh)] += 1
