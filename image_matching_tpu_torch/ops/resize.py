"""Linear image resizing as `jax.image.resize(x, shape, "linear")` does
it: one dense weight matrix per resized axis, built as JAX's
`compute_weight_mat` builds it (`jax/_src/image/scale.py`), and applied
by a product. Downscaling widens the triangle kernel by 1/scale (JAX's
default antialias), so a 1.2x ORB pyramid level is a low-pass filter and
not a bilinear sample: `F.interpolate(mode="bilinear")` agrees only when
upscaling.

The products run in full float32: TF32 stays off for them, as PyTorch's
default leaves it for matmuls (as `ops/ransac.py` notes).
"""
from __future__ import annotations

import functools

import torch

_EPS32 = 1.1920928955078125e-07  # float32 machine epsilon


@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)  # a plain tensor, whether first asked for inside inference mode or not
def _weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_in, n_out) float32 weights, computed on the CPU in JAX's float32
    arithmetic (per-column sums in input order) and put on `device` once."""
    scale = n_out / n_in
    inv_scale = torch.tensor(1.0 / scale, dtype=torch.float32)
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    # XLA contracts (i + 0.5) * inv_scale - 0.5 into one FMA: a float32
    # product is exact in float64, and so is the sum here, so one rounding
    # to float32 afterwards is the FMA's
    half = torch.arange(n_out, dtype=torch.float32) + 0.5
    sample_f = (half.double() * inv_scale.double() - 0.5).float()
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = torch.clamp_min(1.0 - x.abs(), 0.0)
    total = torch.cumsum(w, dim=0)[-1:]  # sequential, as XLA's reduce over the input axis
    w = torch.where(total.abs() > 1000.0 * _EPS32, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device).contiguous()


def resize_linear(x, shape):
    """x (..., H, W) float32 -> (..., h, w) = `jax.image.resize(x, (..., h,
    w), "linear")`. An axis whose size does not change is left as it is, as
    in JAX."""
    h, w = shape
    out = x.float()
    if out.shape[-1] != w:
        out = out @ _weights(out.shape[-1], w, out.device)
    if out.shape[-2] != h:
        out = _weights(out.shape[-2], h, out.device).t() @ out
    return out
