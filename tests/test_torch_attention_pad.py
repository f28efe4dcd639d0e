"""Heads narrower than the kernels' widths, on the CPU.

The attention kernels are built for heads of 16, 32, 64 and 128 values,
and the chunked ones for every multiple of 128 above it. The card's
wrappers zero-pad any other head to the next of those widths (SuperGlue's
4 heads at descriptor_dim 320 and 384 have 80 and 96, at 640 and 1280
160 and 320, padded to 256 and 384), launch with the scale of the real
head, and cut the results back. These
tests show on the plain versions, which take the kernels' scale
argument, that the padding changes nothing: the same logits, LSE,
output and gradients, and zeros in the padded columns.
"""
import math

import numpy as np
import pytest
import torch

from image_matching_tpu_torch.ops.attention import (
    HEAD_DIMS,
    attention_backward_plain,
    attention_lse_plain,
    attention_plain,
    launch_name,
    pad_heads,
    padded_head_dim,
    unpad_heads,
)

HEADS = 4


def _inputs(dh, b=3, n=37, m=45, seed=0):
    rng = np.random.default_rng(seed)
    q, dout = (torch.from_numpy(rng.normal(size=(b, n, HEADS * dh)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, m, HEADS * dh)).astype(np.float32)) for _ in range(2))
    mask = torch.from_numpy(rng.uniform(size=(b, m)) < 0.7)
    mask[:, 0] = True
    mask[-1] = False  # a batch element with no valid key
    return q, k, v, mask, dout


def test_padded_head_dim():
    assert [padded_head_dim(d) for d in (1, 8, 16, 17, 24, 32, 33, 48, 64)] == [16, 16, 16, 32, 32, 32, 64, 64, 64]
    assert [padded_head_dim(d) for d in (65, 80, 96, 127, 128)] == [128] * 5
    assert padded_head_dim(HEAD_DIMS[-1]) == HEAD_DIMS[-1] == 128
    # D > 512 at 4 heads: C chunks of 128 values, C = ceil(dh / 128)
    assert [padded_head_dim(d) for d in (129, 160, 200, 256)] == [256] * 4
    assert [padded_head_dim(d) for d in (257, 320, 384, 385, 512, 1000)] == [384, 384, 384, 512, 512, 1024]
    assert [launch_name("attention_dq", w) for w in (64, 128, 256, 384)] == [
        "attention_dq", "attention_dq_dh128", "attention_dq_dh256", "attention_dq_dh384"]


@pytest.mark.parametrize("dh", [8, 24, 48, 80, 96, 160, 200, 320])
def test_zero_padded_heads_give_the_same_attention_and_gradients(dh):
    q, k, v, mask, dout = _inputs(dh)
    width = padded_head_dim(dh)
    scale = 1.0 / math.sqrt(dh)
    qp, kp, vp, doutp = (pad_heads(t, HEADS, width) for t in (q, k, v, dout))
    assert qp.shape[-1] == HEADS * width and qp.is_contiguous()
    # the padding is zeros and cuts back to the input
    assert not qp.reshape(*qp.shape[:2], HEADS, width)[..., dh:].any()
    assert torch.equal(unpad_heads(qp, HEADS, dh), q)

    # forward with LSE, as the padded kernel computes it
    out_p, lse_p = attention_lse_plain(qp, kp, vp, mask, HEADS, scale=scale)
    out, lse = attention_lse_plain(q, k, v, mask, HEADS)
    # the same f32 products plus zeros: equal up to summation order
    torch.testing.assert_close(lse_p, lse, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(unpad_heads(out_p, HEADS, dh), out, rtol=1e-6, atol=1e-6)
    assert not out_p.reshape(*out_p.shape[:2], HEADS, width)[..., dh:].any()
    torch.testing.assert_close(out, attention_plain(q, k, v, mask, HEADS), rtol=1e-6, atol=1e-6)

    # backward, as the padded kernels compute it
    got = attention_backward_plain(qp, kp, vp, mask, lse_p, doutp, HEADS, scale=scale)
    want = attention_backward_plain(q, k, v, mask, lse, dout, HEADS)
    for g, w in zip(got, want, strict=True):
        assert not g.reshape(*g.shape[:2], HEADS, width)[..., dh:].any()
        torch.testing.assert_close(unpad_heads(g, HEADS, dh), w, rtol=1e-5, atol=1e-6)
    # and the exact gradient, autograd of the einsum attention
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    exact = torch.autograd.grad(attention_plain(*qkv, mask, HEADS), qkv, dout)
    for g, e in zip(got, exact, strict=True):
        torch.testing.assert_close(unpad_heads(g, HEADS, dh), e, rtol=1e-4, atol=1e-5)
