"""Port's 2x2 space-to-depth ops (plain versions, CPU) vs the JAX package:
`ops/s2d_conv.py` function by function, the s2d entry conv against the
Pallas kernel `entry_conv_pallas` in interpret mode, the realigning pool
against `maxpool_realign_pallas` in interpret mode, and the two
`autograd.Function`s' recompute backwards against `jax.vjp` of the XLA
formulations.

Tolerances. f32: both sides sum the same products in another order, 1e-5
relative to max(|y|, 1) for the short sums of the narrow cases, 1e-4 for
sums of 576 or more products (the backbone's widths, the backward). bf16:
both round the f32 sum once, so where the sums differ in their last bit
they may round to neighbouring bf16 numbers: one bf16 step, 2^-7 relative
to max(|y|, 1). Pools and
re-layouts move values and take maxima: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ops import s2d_conv as jax_s2d
from image_matching_tpu.ops.pallas.entry_conv import entry_conv_pallas
from image_matching_tpu.ops.pallas.realign import maxpool_realign_pallas
from image_matching_tpu_torch.ops import s2d_conv
from image_matching_tpu_torch.ops.realign import MaxpoolRealignFunction, maxpool_realign, pool_from_raw
from image_matching_tpu_torch.ops.s2d_entry import S2DEntryConvFunction, s2d_entry_conv, s2d_entry_route

SHAPES = [(1, 8), (8, 8), (8, 16)]


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)))


def _conv_inputs(ci, co, seed=0, b=2, h=16, w=24):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, ci)).astype(np.float32),
            rng.normal(0, 0.3, (3, 3, ci, co)).astype(np.float32))


def _to(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("ci,co", SHAPES)
def test_weight_rearrangements_match_jax(ci, co):
    _, w = _conv_inputs(ci, co)
    wt, wj = torch.from_numpy(w), jnp.asarray(w)
    np.testing.assert_array_equal(s2d_conv.s2d_kernel_all(wt).numpy(), np.asarray(jax_s2d.s2d_kernel_all(wj)))
    np.testing.assert_array_equal(s2d_conv.entry_kernel(wt).numpy(), np.asarray(jax_s2d.entry_kernel(wj)))
    for py in range(2):
        for px in range(2):
            np.testing.assert_array_equal(s2d_conv.s2d_kernel(wt, py, px).numpy(),
                                          np.asarray(jax_s2d.s2d_kernel(wj, py, px)))


def test_space_to_depth_round_trip_matches_jax():
    x, _ = _conv_inputs(8, 8)
    got = s2d_conv.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_s2d.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(s2d_conv.depth_to_space(got).numpy(), x)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2 ** -7)])
@pytest.mark.parametrize("ci,co", SHAPES)
def test_entry_conv_matches_pallas_interpret_and_xla(ci, co, dtype, tol):
    x, w = _conv_inputs(ci, co)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    xj, wj = jnp.asarray(x, jd), jnp.asarray(w, jd)
    got = s2d_entry_conv(_to(x, td), _to(w, td))  # the plain version: CPU tensors
    assert got.shape == (2, 8, 12, 4 * co) and got.dtype == td
    assert _rel_err(got.float().numpy(), entry_conv_pallas(xj, wj, block_rows=4, interpret=True)) <= tol
    assert _rel_err(got.float().numpy(), jax_s2d.conv3x3_s2d_entry(xj, wj)) <= tol


# the 2x2 backbone's three deep entry convs (ci -> co): K = 9 ci = 576 to 1152
BACKBONE_WIDTHS = [(64, 64), (64, 128), (128, 128)]


@pytest.mark.parametrize("ci,co", BACKBONE_WIDTHS)
def test_entry_conv_f32_at_backbone_widths_matches_pallas_interpret_and_xla(ci, co):
    """f32 at the widths the card's `s2d_entry_ffma` takes. Sums of 576-1152
    products in different f32 orders lie a few 1e-5 of max(|y|, 1) apart
    here, each as far from the float64 answer (the plain version, XLA and
    the Pallas interpreter alike), so these deep sums are held to 1e-4, the
    bound of the f32 backward's sums of ~1700 products below; the 1e-5
    above is for sums of at most 72."""
    x, w = _conv_inputs(ci, co, seed=9)
    got = s2d_entry_conv(torch.from_numpy(x), torch.from_numpy(w))  # the plain version: CPU tensors
    assert got.shape == (2, 8, 12, 4 * co) and got.dtype == torch.float32
    exact = torch.nn.functional.conv2d(torch.from_numpy(x).double().permute(0, 3, 1, 2),
                                       torch.from_numpy(w).double().permute(3, 2, 0, 1), padding=1)
    exact = s2d_conv.space_to_depth(exact.permute(0, 2, 3, 1)).numpy()
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    for ref in (entry_conv_pallas(xj, wj, block_rows=4, interpret=True), jax_s2d.conv3x3_s2d_entry(xj, wj), exact):
        assert _rel_err(got.numpy(), ref) <= 1e-4


@pytest.mark.parametrize("dtype,ci,co,symbol", [
    (torch.bfloat16, 16, 64, "s2d_entry_conv_bf16_wg"), (torch.bfloat16, 128, 128, "s2d_entry_conv_bf16_wg"),
    (torch.bfloat16, 32, 192, "s2d_entry_conv_bf16_wg"), (torch.bfloat16, 1, 64, "s2d_entry_conv_bf16_image"),
    (torch.bfloat16, 1, 128, "s2d_entry_conv_bf16_image"), (torch.bfloat16, 48, 64, "s2d_entry_conv_bf16_simt"),
    (torch.bfloat16, 64, 24, "s2d_entry_conv_bf16_simt"), (torch.bfloat16, 8, 64, "s2d_entry_conv_bf16_simt"),
    (torch.bfloat16, 1, 8, "s2d_entry_conv_bf16_simt"), (torch.float32, 64, 64, "s2d_entry_conv_f32_simt"),
    (torch.float32, 1, 64, "s2d_entry_conv_f32_simt"), (torch.float32, 3, 24, "s2d_entry_conv_f32_simt"),
])
def test_s2d_entry_route_table(dtype, ci, co, symbol):
    """bf16 goes to tensor cores where co is a multiple of 64 and ci is 1 or
    in `WG_CHANNELS`; f32 (whose products tensor cores would round to TF32)
    and every other width go to the SIMT entry."""
    assert s2d_entry_route(dtype, ci, co) == symbol


def test_entry_conv_is_conv_then_space_to_depth():
    x, w = _conv_inputs(8, 16, seed=1)
    direct = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                        torch.from_numpy(w).permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    got = s2d_conv.conv3x3_s2d_entry(torch.from_numpy(x), torch.from_numpy(w))
    assert _rel_err(got.numpy(), s2d_conv.space_to_depth(direct).numpy()) <= 1e-5


@pytest.mark.parametrize("extra_cols", [0, 3])
def test_raw_conv_realign_and_pool_match_jax(extra_cols):
    x, w = _conv_inputs(8, 16, seed=2)
    xs = np.array(jax_s2d.space_to_depth(jnp.asarray(x)))
    u_ref = jax_s2d.conv3x3_s2d_raw(jnp.asarray(xs), jnp.asarray(w), extra_cols=extra_cols)
    u = s2d_conv.conv3x3_s2d_raw(torch.from_numpy(xs), torch.from_numpy(w), extra_cols=extra_cols)
    assert u.shape == (2, 9, 13 + extra_cols, 64)
    assert _rel_err(u.numpy(), u_ref) <= 1e-5
    # the consumers, on the same U: exact
    uj = jnp.asarray(u.numpy())
    out_w = 12 if extra_cols else None
    np.testing.assert_array_equal(s2d_conv.maxpool2x2_s2d_from_raw(u, out_w).numpy(),
                                  np.asarray(jax_s2d.maxpool2x2_s2d_from_raw(uj, out_w)))
    if not extra_cols:
        np.testing.assert_array_equal(s2d_conv.realign(u).numpy(), np.asarray(jax_s2d.realign(uj)))
        assert _rel_err(s2d_conv.conv3x3_s2d(torch.from_numpy(xs), torch.from_numpy(w)).numpy(),
                        jax_s2d.conv3x3_s2d(jnp.asarray(xs), jnp.asarray(w))) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padded", [False, True])
def test_pool_matches_pallas_interpret(dtype, padded):
    rng = np.random.default_rng(3)
    h, w, c = 8, 10, 8
    u = rng.normal(size=(2, h + 1, w + 1 + (5 if padded else 0), 4 * c)).astype(np.float32)
    out_w = w if padded else None
    td = getattr(torch, dtype)
    ref = maxpool_realign_pallas(jnp.asarray(u, getattr(jnp, dtype)), out_w=out_w, block_rows=4, interpret=True)
    for fn in (maxpool_realign, pool_from_raw):
        got = fn(_to(u, td), out_w)
        assert got.shape == (2, h, w, c) and got.dtype == td
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_pool_equals_maxpool_of_realigned_u_and_carries_nan():
    rng = np.random.default_rng(4)
    u = torch.from_numpy(rng.normal(size=(1, 5, 7, 32)).astype(np.float32))
    pooled = s2d_conv.maxpool2x2_s2d(s2d_conv.realign(u))
    torch.testing.assert_close(maxpool_realign(u), pooled, rtol=0, atol=0)
    direct = s2d_conv.depth_to_space(s2d_conv.realign(u)).permute(0, 3, 1, 2)
    torch.testing.assert_close(pooled, torch.nn.functional.max_pool2d(direct, 2, 2).permute(0, 2, 3, 1),
                               rtol=0, atol=0)
    u[0, 2, 3, 8 + 1] = float("nan")  # group (0, 1) at U[2, 3]: output (2, 2), channel 1
    got = maxpool_realign(u)
    assert torch.isnan(got[0, 2, 2, 1]) and int(torch.isnan(got).sum()) == 1


def test_mm1x1_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5, 7, 4 * 8)).astype(np.float32)
    w = rng.normal(size=(8, 12)).astype(np.float32)
    bias = rng.normal(size=(12,)).astype(np.float32)
    got = s2d_conv.mm1x1_s2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias))
    ref = jax_s2d.mm1x1_s2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    assert got.shape == (2, 5, 7, 48)
    assert _rel_err(got.numpy(), ref) <= 1e-5
    assert _rel_err(s2d_conv.mm1x1_s2d(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                    jax_s2d.mm1x1_s2d(jnp.asarray(x), jnp.asarray(w))) <= 1e-5


@pytest.mark.parametrize("ci,co", SHAPES)
def test_entry_conv_backward_matches_jax_vjp(ci, co):
    x, w = _conv_inputs(ci, co, seed=6)
    g = np.random.default_rng(7).normal(size=(2, 8, 12, 4 * co)).astype(np.float32)
    _, vjp = jax.vjp(jax_s2d.conv3x3_s2d_entry, jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(g))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = s2d_entry_conv(xt, wt)
    assert isinstance(out.grad_fn, S2DEntryConvFunction._backward_cls)
    out.backward(torch.from_numpy(g))
    # f32 sums of up to 2 * 8 * 12 * 9 products in another order
    assert _rel_err(xt.grad.numpy(), dx_ref) <= 1e-4
    assert _rel_err(wt.grad.numpy(), dw_ref) <= 1e-4
    # only the input asks for a gradient: the kernel's gets none
    xt2 = torch.from_numpy(x).requires_grad_()
    s2d_entry_conv(xt2, torch.from_numpy(w)).backward(torch.from_numpy(g))
    assert _rel_err(xt2.grad.numpy(), dx_ref) <= 1e-4


@pytest.mark.parametrize("padded", [False, True])
def test_pool_backward_matches_jax_vjp(padded):
    rng = np.random.default_rng(8)
    h, w, c = 6, 9, 4
    u = rng.normal(size=(2, h + 1, w + 1 + (3 if padded else 0), 4 * c)).astype(np.float32)
    g = rng.normal(size=(2, h, w, c)).astype(np.float32)
    out_w = w if padded else None
    _, vjp = jax.vjp(lambda t: jax_s2d.maxpool2x2_s2d_from_raw(t, out_w), jnp.asarray(u))
    (du_ref,) = vjp(jnp.asarray(g))
    ut = torch.from_numpy(u).requires_grad_()
    out = maxpool_realign(ut, out_w)
    assert isinstance(out.grad_fn, MaxpoolRealignFunction._backward_cls)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ut.grad.numpy(), np.asarray(du_ref))
