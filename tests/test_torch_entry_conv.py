"""Port's fused entry conv (plain version, CPU) vs the JAX package's
Pallas kernel `entry_h_fused_pallas` in interpret mode.

The TPU kernel emits the H-space-to-depth layout; `depth_to_space_h`
re-lays it to the direct layout the port emits. Both round the image and
the taps to bf16, accumulate in f32 and round once, so where the two f32
sums differ in their last bit they may round to neighbouring bf16
numbers: tolerance one bf16 step, 2^-7 relative to max(|y|, 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ops.pallas.entry_h import entry_h_fused_pallas
from image_matching_tpu.ops.s2d_conv import depth_to_space_h
from image_matching_tpu_torch.models.common import ConvBNReLU
from image_matching_tpu_torch.ops.entry_conv import entry_conv, fold_bn

CO = 64


def _inputs(b=2, h=32, w=128, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (b, h, w)).astype(np.float32)
    k = rng.normal(0, 0.3, (3, 3, 1, CO)).astype(np.float32)
    scale = rng.normal(1, 0.2, (CO,)).astype(np.float32)
    shift = rng.normal(0, 0.2, (CO,)).astype(np.float32)
    return img, k, scale, shift


def test_plain_matches_pallas_interpret_bf16():
    img, k, scale, shift = _inputs()
    ref = entry_h_fused_pallas(
        jnp.asarray(img, jnp.bfloat16), jnp.asarray(k),
        jnp.asarray(np.tile(scale, 2)), jnp.asarray(np.tile(shift, 2)),
        block_rows=8, interpret=True,
    )
    ref = np.asarray(depth_to_space_h(ref), np.float32)  # (B, H, W, co)
    got = entry_conv(torch.from_numpy(img).to(torch.bfloat16), torch.from_numpy(k),
                     torch.from_numpy(scale), torch.from_numpy(shift))
    assert got.shape == (2, CO, 32, 128) and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)) <= 2 ** -7


def test_plain_matches_pallas_interpret_bf16_second_shape():
    """B = 3, a larger image (48 x 256) and other weights: the same one-bf16-step hold."""
    img, k, scale, shift = _inputs(b=3, h=48, w=256, seed=5)
    ref = entry_h_fused_pallas(
        jnp.asarray(img, jnp.bfloat16), jnp.asarray(k),
        jnp.asarray(np.tile(scale, 2)), jnp.asarray(np.tile(shift, 2)),
        block_rows=8, interpret=True,
    )
    ref = np.asarray(depth_to_space_h(ref), np.float32)
    got = entry_conv(torch.from_numpy(img).to(torch.bfloat16), torch.from_numpy(k),
                     torch.from_numpy(scale), torch.from_numpy(shift))
    assert got.shape == (3, CO, 48, 256)
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)) <= 2 ** -7


def test_plain_f32_matches_numpy_oracle():
    # f32 end to end: only the order of the nine products differs
    img, k, scale, shift = _inputs(b=1, h=9, w=13, seed=1)
    pad = np.pad(img, ((0, 0), (1, 1), (1, 1)))
    acc = sum(pad[:, ky:ky + 9, kx:kx + 13, None] * k[ky, kx, 0]
              for ky in range(3) for kx in range(3))
    ref = np.maximum(acc * scale + shift, 0.0)
    got = entry_conv(torch.from_numpy(img), torch.from_numpy(k),
                     torch.from_numpy(scale), torch.from_numpy(shift))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_entry_matches_conv_bn_relu_layer(dtype):
    """ConvBNReLU.entry (the fold + fused pass) equals the same layer run
    as conv -> BN -> ReLU, on non-trivial running statistics."""
    torch.manual_seed(0)
    layer = ConvBNReLU(1, CO)
    with torch.no_grad():
        bn = layer.BatchNorm_0
        bn.weight.normal_(1, 0.2)
        bn.bias.normal_(0, 0.2)
        bn.running_mean.normal_(0, 0.5)
        bn.running_var.uniform_(0.5, 2.0)
        layer.Conv_0.bias.normal_(0, 0.2)
        # taps representable in bf16, so both sides see the same weights
        layer.Conv_0.weight.copy_(layer.Conv_0.weight.to(torch.bfloat16).float())
    img = torch.rand(2, 16, 24).to(dtype)
    with torch.no_grad():
        got = layer.entry(img).float()
        ref = layer(img[:, None].float(), torch.float32)
    # the layer chain computes in f32 here; the fused pass rounds to dtype
    # once: half a bf16 step
    tol = 1e-5 if dtype == torch.float32 else 2 ** -8
    assert torch.max((got - ref).abs() / ref.abs().clamp_min(1.0)) <= tol
    inv, shift = fold_bn(layer.Conv_0.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    torch.testing.assert_close(inv, bn.weight * torch.rsqrt(bn.running_var + 1e-5))
    assert shift.dtype == torch.float32
