"""Port's masked multi-head attention (plain version, CPU) vs the JAX
package: the Pallas one-pass packed-head kernel (interpreted on the CPU)
and the einsum oracle `attention_reference_heads`.

All in f32: the two sides differ only in summation order, so 1e-5.
Heads of 96 and 128 values (SuperGlue's 4 heads at descriptor_dim 384 and
512) take the JAX package's two routes: 128 packs into the Pallas kernel's
128 lanes, 96 folds to (B*H, N, dh) for its single-head kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ops.pallas.attention import (
    attention_onepass_heads,
    attention_reference_heads,
)
from image_matching_tpu_torch.ops.attention import attention

HEADS = 4


def _inputs(b, n, m, dh, seed, fully_masked_row=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, x, HEADS * dh)).astype(np.float32) for x in (n, m, m))
    mask = rng.uniform(size=(b, m)) < 0.7
    mask[:, 0] = True
    if fully_masked_row:
        mask[-1] = False
    return q, k, v, mask


def _port(q, k, v, mask, logits_dtype="float32"):
    t = lambda a: torch.from_numpy(a)
    return attention(t(q), t(k), t(v), t(mask), HEADS, logits_dtype).numpy()


# (N, M): beside the first two, shapes ragged across the card's 64-row tiles
# and across a split of the key tiles over 4 warpgroups (5 and 8 key tiles)
RAGGED = [(129, 257), (65, 450)]


@pytest.mark.parametrize("dh", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("n,m", [(40, 128), (100, 77)] + RAGGED)
def test_plain_matches_pallas_onepass_and_reference(dh, n, m):
    q, k, v, mask = _inputs(2, n, m, dh, seed=dh + n)
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    got = _port(q, k, v, mask)
    assert got.shape == (2, n, HEADS * dh)
    ref = np.asarray(attention_reference_heads(jq, jk, jv, jm, num_heads=HEADS))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(attention_onepass_heads(jq, jk, jv, jm, num_heads=HEADS))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_fully_masked_row_averages_values():
    # a batch element with no valid key: every logit is -1e9, so the
    # softmax is uniform and the output is the mean of V (the oracle's
    # semantics; the Pallas kernel pads keys to 128, so it is left out)
    q, k, v, mask = _inputs(2, 33, 50, 32, seed=3, fully_masked_row=True)
    got = _port(q, k, v, mask)
    ref = np.asarray(attention_reference_heads(*map(jnp.asarray, (q, k, v, mask)), num_heads=HEADS))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[-1], np.broadcast_to(v[-1].mean(0), got[-1].shape), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dh", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("n,m", RAGGED)
def test_plain_with_a_dead_element_matches_reference(dh, n, m):
    q, k, v, mask = _inputs(3, n, m, dh, seed=dh * n + m, fully_masked_row=True)
    got = _port(q, k, v, mask)
    ref = np.asarray(attention_reference_heads(*map(jnp.asarray, (q, k, v, mask)), num_heads=HEADS))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[-1], np.broadcast_to(v[-1].mean(0), got[-1].shape), rtol=1e-5, atol=1e-5)


def test_bf16_logits_close_to_f32_logits():
    # logits_dtype="bfloat16" only rounds the stored logits (q pre-scaled):
    # the result moves by about one bf16 rounding of a logit
    q, k, v, mask = _inputs(2, 64, 64, 32, seed=5)
    a = _port(q, k, v, mask, "float32")
    b = _port(q, k, v, mask, "bfloat16")
    assert 0 < np.max(np.abs(a - b)) < 5e-2
