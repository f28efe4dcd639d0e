"""The port's differentiable attention (`AttentionFunction`: forward with
LSE, FA2 backward; plain versions on the CPU) against the JAX package:
the Pallas forward-with-LSE and flash backward (interpreted on the CPU),
and `jax.vjp` of the einsum oracle `attention_reference_heads`.

All in f32, at heads of 16 to 384 values (96: the width the card pads to
128; 256 and 384: the chunked kernels' widths, 2 and 3 chunks of 128).
The two sides differ in summation order (and the Pallas backward takes
delta = rowsum(dO * O) where the port takes rowsum(P * dP) / rowsum(P),
equal in exact arithmetic): 2e-5 on outputs, LSE and gradients of O(1)
inputs.

A batch element with no valid key is held to the einsum oracle (output
mean(V), dV = sum dO / M, dQ = dK = 0), not to the Pallas flash kernel,
whose LSE rounds to -1e9 there and whose dS is not zeroed at masked keys:
flash comparisons cover the live elements only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ops.pallas.attention import (
    _auto_blocks,
    _flash_forward_with_lse,
    attention_reference_heads,
    flash_attention,
)
from image_matching_tpu_torch.ops.attention import (
    AttentionFunction,
    attention,
    attention_backward_plain,
    attention_delta_plain,
    attention_lse,
    attention_plain,
)

HEADS = 4
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(b, n, m, dh, seed, dead=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, x, HEADS * dh)).astype(np.float32) for x in (n, m, m))
    mask = rng.uniform(size=(b, m)) < 0.7
    mask[:, 0] = True
    if dead:
        mask[-1] = False
    g = rng.normal(size=(b, n, HEADS * dh)).astype(np.float32)
    return q, k, v, mask, g


def _fold(x, b, dh):
    """(B, N, H*dh) -> (B*H, N, dh), the Pallas kernels' layout."""
    return x.reshape(b, -1, HEADS, dh).transpose(0, 2, 1, 3).reshape(b * HEADS, -1, dh)


def _unfold(x, b, dh):
    return x.reshape(b, HEADS, -1, dh).transpose(0, 2, 1, 3).reshape(b, -1, HEADS * dh)


def _port_grads(q, k, v, mask, g):
    """Output and (dq, dk, dv) of sum(out * g) through `attention` under grad."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention(tq, tk, tv, torch.from_numpy(mask), HEADS)
    assert out.grad_fn is not None and "AttentionFunction" in type(out.grad_fn).__name__
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()


# (N, M) ragged across the card's 64-row tiles and across a split of the
# key tiles over 4 warpgroups (5 and 8 key tiles)
RAGGED_FORWARD = [(129, 257), (65, 450)]


@pytest.mark.parametrize("dh", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("n,m", [(40, 50), (70, 33)] + RAGGED_FORWARD)
def test_forward_lse_matches_pallas(dh, n, m):
    b = 2
    q, k, v, mask, _ = _inputs(b, n, m, dh, seed=dh + n)
    out, lse = attention_lse(*(torch.from_numpy(a) for a in (q, k, v, mask)), num_heads=HEADS)
    assert lse.shape == (b, HEADS, n) and lse.dtype == torch.float32
    bq, bk = _auto_blocks(n, m)
    ref_out, ref_lse = _flash_forward_with_lse(
        *(jnp.asarray(_fold(a, b, dh)) for a in (q, k, v)), jnp.repeat(jnp.asarray(mask), HEADS, 0),
        None, bq, bk)
    np.testing.assert_allclose(out.numpy(), _unfold(np.asarray(ref_out), b, dh), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, 0, :n].reshape(b, HEADS, n), **TOL)


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("dh", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("n,m", RAGGED_FORWARD)
def test_forward_lse_matches_oracle_logsumexp(dh, n, m, dead):
    # the output against the einsum oracle, the LSE against the logsumexp of
    # the oracle's masked logits; a dead element's LSE is log(M), the
    # logsumexp of its logits shifted to 0 (the oracle's own rounds to -1e9)
    b = 3
    q, k, v, mask, _ = _inputs(b, n, m, dh, seed=dh + 7 * n + m, dead=dead)
    out, lse = attention_lse(*(torch.from_numpy(a) for a in (q, k, v, mask)), num_heads=HEADS)
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(attention_reference_heads(jq, jk, jv, jm, num_heads=HEADS)),
                               **TOL)
    logits = jnp.einsum("bnhd,bmhd->bhnm", jq.reshape(b, n, HEADS, dh), jk.reshape(b, m, HEADS, dh)) / np.sqrt(dh)
    ref = np.asarray(jax.nn.logsumexp(jnp.where(jm[:, None, None, :], logits, -1e9), axis=-1))
    live = slice(0, b - 1) if dead else slice(0, b)
    np.testing.assert_allclose(lse.numpy()[live], ref[live], **TOL)
    if dead:
        np.testing.assert_allclose(lse.numpy()[-1], np.full((HEADS, n), np.log(m), np.float32), **TOL)


@pytest.mark.parametrize("dh", [16, 32, 96, 128, 256])
@pytest.mark.parametrize("n,m", [(40, 50), (70, 33)])
def test_gradients_match_pallas_flash_on_live_elements(dh, n, m):
    b = 2
    q, k, v, mask, g = _inputs(b, n, m, dh, seed=3 * dh + m)
    out, dq, dk, dv = _port_grads(q, k, v, mask, g)
    km = jnp.repeat(jnp.asarray(mask), HEADS, 0)
    gf = jnp.asarray(_fold(g, b, dh))
    ref_out, vjp = jax.vjp(lambda a, c, d: flash_attention(a, c, d, km),
                           *(jnp.asarray(_fold(a, b, dh)) for a in (q, k, v)))
    np.testing.assert_allclose(out, _unfold(np.asarray(ref_out), b, dh), **TOL)
    for got, ref in zip((dq, dk, dv), vjp(gf)):
        np.testing.assert_allclose(got, _unfold(np.asarray(ref), b, dh), **TOL)


@pytest.mark.parametrize("dh", [16, 32])
def test_plain_backward_with_fa2_delta_matches_pallas(dh):
    # given FA2's delta = rowsum(dO * O), the plain backward is the Pallas
    # flash backward's function
    b, n, m = 2, 40, 50
    q, k, v, mask, g = _inputs(b, n, m, dh, seed=7 * dh)
    tq, tk, tv, tmask, tg = map(torch.from_numpy, (q, k, v, mask, g))
    out, lse = attention_lse(tq, tk, tv, tmask, HEADS)
    delta = (out * tg).reshape(b, n, HEADS, dh).sum(-1).transpose(1, 2)
    got = attention_backward_plain(tq, tk, tv, tmask, lse, tg, HEADS, delta)
    km = jnp.repeat(jnp.asarray(mask), HEADS, 0)
    _, vjp = jax.vjp(lambda a, c, d: flash_attention(a, c, d, km),
                     *(jnp.asarray(_fold(a, b, dh)) for a in (q, k, v)))
    for have, ref in zip(got, vjp(jnp.asarray(_fold(g, b, dh)))):
        np.testing.assert_allclose(have.numpy(), _unfold(np.asarray(ref), b, dh), **TOL)


@pytest.mark.parametrize("dh", [16, 32, 96, 128, 256, 384])
@pytest.mark.parametrize("n,m", [(40, 50), (70, 33)])
def test_gradients_match_einsum_oracle_with_a_dead_element(dh, n, m):
    b = 3
    q, k, v, mask, g = _inputs(b, n, m, dh, seed=5 * dh + n, dead=True)
    out, dq, dk, dv = _port_grads(q, k, v, mask, g)
    ref_out, vjp = jax.vjp(
        lambda a, c, d: attention_reference_heads(a, c, d, jnp.asarray(mask), num_heads=HEADS),
        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out, np.asarray(ref_out), **TOL)
    for got, ref in zip((dq, dk, dv), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    # the dead element: uniform softmax, no gradient through the logits
    np.testing.assert_allclose(out[-1], np.broadcast_to(v[-1].mean(0), out[-1].shape), **TOL)
    np.testing.assert_allclose(dv[-1], np.broadcast_to(g[-1].sum(0) / m, dv[-1].shape), **TOL)
    assert not dq[-1].any() and not dk[-1].any()


# (N, M) that the card's 64-row tiles, split over 4 warpgroups with 2 tiles
# in flight each, leave ragged: both under one tile; exactly one tile;
# neither a multiple of the tile nor of the 8 tiles in flight; more query
# than key tiles
RAGGED = [(5, 9), (64, 64), (130, 257), (300, 70)]


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("n,m", RAGGED)
def test_gradients_match_einsum_oracle_at_ragged_shapes(n, m, dead):
    b, dh = 2, 16
    q, k, v, mask, g = _inputs(b, n, m, dh, seed=n + m, dead=dead)
    out, dq, dk, dv = _port_grads(q, k, v, mask, g)
    ref_out, vjp = jax.vjp(
        lambda a, c, d: attention_reference_heads(a, c, d, jnp.asarray(mask), num_heads=HEADS),
        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out, np.asarray(ref_out), **TOL)
    for got, ref in zip((dq, dk, dv), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("n,m", [(5, 9), (130, 257)])
def test_gradients_match_pallas_flash_at_ragged_shapes(n, m):
    b, dh = 2, 16
    q, k, v, mask, g = _inputs(b, n, m, dh, seed=2 * n + m)
    out, dq, dk, dv = _port_grads(q, k, v, mask, g)
    km = jnp.repeat(jnp.asarray(mask), HEADS, 0)
    ref_out, vjp = jax.vjp(lambda a, c, d: flash_attention(a, c, d, km),
                           *(jnp.asarray(_fold(a, b, dh)) for a in (q, k, v)))
    np.testing.assert_allclose(out, _unfold(np.asarray(ref_out), b, dh), **TOL)
    for got, ref in zip((dq, dk, dv), vjp(jnp.asarray(_fold(g, b, dh)))):
        np.testing.assert_allclose(got, _unfold(np.asarray(ref), b, dh), **TOL)


@pytest.mark.parametrize("n,m", [(40, 50), (130, 257), (300, 70)])
def test_delta_plain_matches_einsum_reference(n, m):
    # delta = rowsum(P * dP) / rowsum(P), the dQ kernel's second output. With
    # the oracle's exact softmax, rowsum(P) = 1 and rowsum(P * dP) =
    # rowsum(dO * O) of its f32 output, per head.
    b, dh = 3, 16
    q, k, v, mask, g = _inputs(b, n, m, dh, seed=n * m, dead=True)
    tq, tk, tv, tmask, tg = map(torch.from_numpy, (q, k, v, mask, g))
    _, lse = attention_lse(tq, tk, tv, tmask, HEADS)
    got = attention_delta_plain(tq, tk, tv, tmask, lse, tg, HEADS)
    assert got.shape == (b, HEADS, n) and got.dtype == torch.float32
    ref_out = attention_reference_heads(*map(jnp.asarray, (q, k, v, mask)), num_heads=HEADS)
    ref = (np.asarray(ref_out) * g).reshape(b, n, HEADS, dh).sum(-1).transpose(0, 2, 1)
    np.testing.assert_allclose(got.numpy()[:-1], ref[:-1], rtol=1e-5, atol=1e-5)
    assert not got[-1].any()  # no valid key: no row of dS to centre
    # and it is the delta that the plain backward takes by default
    with_delta = attention_backward_plain(tq, tk, tv, tmask, lse, tg, HEADS, got)
    default = attention_backward_plain(tq, tk, tv, tmask, lse, tg, HEADS)
    for a, r in zip(with_delta, default):
        np.testing.assert_allclose(a.numpy(), r.numpy(), **TOL)


@pytest.mark.parametrize("dead", [False, True])
def test_gradients_match_torch_autograd_of_plain(dead):
    b, n, m, dh = 3, 45, 60, 32
    q, k, v, mask, g = _inputs(b, n, m, dh, seed=11, dead=dead)
    out, dq, dk, dv = _port_grads(q, k, v, mask, g)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ref = attention_plain(tq, tk, tv, torch.from_numpy(mask), HEADS, "float32")
    (ref * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out, ref.detach().numpy(), **TOL)
    for got, want in zip((dq, dk, dv), (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(got, want.numpy(), **TOL)


def test_plain_backward_f32_stays_near_its_float64_run_at_depth():
    # The f32 plain backward is what the card's f32 dQ and dK/dV kernels are
    # held to (1e-4 of the largest entry) and what their own distance to
    # float64 is measured against (tests/test_torch_gpu.py). Here, at 2048
    # keys and queries, dq, dk and dv lie 8.8e-7, 6.8e-7 and 6.8e-7 of their
    # largest entry from the same function run in float64 on the CPU (0.6 to
    # 1.4e-6 over other seeds and shapes of 1024-2048 keys), so two f32
    # orders of these sums differ by a few 1e-6: 1e-5 here, and 1e-4 for a
    # kernel against the plain version, leave room for the order of the
    # sums, not for a wrong term.
    b, n, dh = 1, 2048, 32
    q, k, v, mask, g = _inputs(b, n, n, dh, seed=17)
    tq, tk, tv, tmask, tg = map(torch.from_numpy, (q, k, v, mask, g))
    _, lse = attention_lse(tq, tk, tv, tmask, HEADS)
    got = attention_backward_plain(tq, tk, tv, tmask, lse, tg, HEADS)
    q64, k64, v64, g64 = (t.double() for t in (tq, tk, tv, tg))
    _, lse64 = attention_lse(q64, k64, v64, tmask, HEADS)
    exact = attention_backward_plain(q64, k64, v64, tmask, lse64, g64, HEADS)
    for a, e in zip(got, exact, strict=True):
        assert a.dtype == torch.float32 and e.dtype == torch.float64
        assert (a.double() - e).abs().max() / e.abs().max() <= 1e-5


def test_no_mask_and_strided_views():
    # q/k/v as views of one fused projection, no mask
    b, n, dh = 2, 30, 16
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * HEADS * dh)).astype(np.float32)).requires_grad_()
    d = HEADS * dh
    out = AttentionFunction.apply(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], None, HEADS)
    out.square().sum().backward()
    ref_qkv = qkv.detach().clone().requires_grad_()
    ref = attention_plain(ref_qkv[..., :d], ref_qkv[..., d:2 * d], ref_qkv[..., 2 * d:], None, HEADS)
    ref.square().sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), **TOL)
    np.testing.assert_allclose(qkv.grad.numpy(), ref_qkv.grad.numpy(), **TOL)


def test_inference_path_outside_grad():
    # without grad, `attention` keeps the inference path: no autograd node
    q, k, v, mask, _ = _inputs(2, 20, 20, 16, seed=13)
    tq = torch.from_numpy(q).requires_grad_()
    with torch.no_grad():
        out = attention(tq, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mask), HEADS)
    assert out.grad_fn is None
