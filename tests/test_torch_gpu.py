"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test asks the `cuda` fixture, which skips where
torch has no CUDA device. Run them on a machine with an H100 with
`python -m pytest tests/test_torch_gpu.py -m gpu -q`. TF32 is off, so
f32 references are full f32.
"""
import dataclasses
import math
from unittest import mock

import pytest
import torch

from image_matching_tpu_torch.models import Matching, MatchingConfig, SuperGlue, SuperPointBN
from image_matching_tpu_torch.ops import _build
from image_matching_tpu_torch.ops import attention as attention_ops
from image_matching_tpu_torch.ops.attention import (
    attention,
    attention_backward,
    attention_backward_plain,
    attention_delta_plain,
    attention_lse,
    attention_lse_plain,
    attention_plain,
    launch_name,
    padded_head_dim,
)
from image_matching_tpu_torch.ops.entry_conv import entry_conv, entry_conv_h, entry_conv_h_plain, entry_conv_plain
from image_matching_tpu_torch.ops.realign import maxpool_realign
from image_matching_tpu_torch.ops.s2d_conv import conv3x3_s2d_entry, maxpool2x2_s2d_from_raw, space_to_depth_h
from image_matching_tpu_torch.ops import s2d_entry as s2d_entry_ops
from image_matching_tpu_torch.ops.s2d_entry import s2d_entry_conv
from image_matching_tpu_torch.registration import build_registration_fn
from image_matching_tpu_torch.ops import sinkhorn as sinkhorn_ops
from image_matching_tpu_torch.ops.sinkhorn import log_optimal_transport, log_sinkhorn, log_sinkhorn_plain, route_on
from image_matching_tpu_torch.train.state import TrainState
from image_matching_tpu_torch.train.superglue_trainer import (
    SuperGluePairConfig,
    make_superglue_train_step,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_entry_conv_kernel(cuda, dtype):
    g = _gen()
    img = torch.rand(3, 37, 50, generator=g).to(cuda, dtype)
    w = (torch.randn(3, 3, 1, 64, generator=g) * 0.3).to(cuda)
    scale = (1 + 0.2 * torch.randn(64, generator=g)).to(cuda)
    shift = (0.2 * torch.randn(64, generator=g)).to(cuda)
    before = _build.LAUNCHES["entry_conv"]
    got = entry_conv(img, w, scale, shift)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["entry_conv"] == before + 1
    assert got.shape == (3, 64, 37, 50) and got.is_contiguous(memory_format=torch.channels_last)
    ref = entry_conv_plain(img, w, scale, shift)
    # same rounded inputs, f32 sums in another order, one final rounding
    # each: at most one bf16 step apart
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert ((got.float() - ref.float()).abs() / ref.float().abs().clamp_min(1)).max() <= tol


# (N, M) of the forward: the trainer's ragged case; ragged across the 64-row
# tiles and a split of the key tiles over 4 warpgroups (3 and 5 query
# tiles; 5 and 8 key tiles, none a multiple of the groups); both under one
# tile; exactly one tile; more query than key tiles; 18 key tiles for one
# query tile
FORWARD_SHAPES = [(70, 133), (129, 257), (65, 450), (5, 9), (64, 64), (300, 70), (50, 1100)]


@pytest.mark.parametrize("n,m", FORWARD_SHAPES)
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel(cuda, dh, dtype, n, m):
    # q, k, v as row-strided views of fused projections, as the model makes
    # them; one batch element with no valid key
    q, k, v, mask, _ = _attention_case(cuda, dh, dtype, n=n, m=m)
    count = launch_name("attention", dh)  # the kernels at 128 count apart
    before = _build.LAUNCHES[count]
    got = attention(q, k, v, mask, 4)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[count] == before + 1
    ref = attention_plain(q, k, v, mask, 4, "float32")
    # f32 logits on both sides; bf16 also rounds the probabilities on the
    # plain side, so the bf16 tolerance is a few bf16 steps
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got[-1].float(), v[-1].float().mean(0).expand_as(got[-1]), rtol=tol, atol=tol)
    # the warpgroups' partial results are merged in a fixed order: the same bits again
    assert torch.equal(got, attention(q, k, v, mask, 4))


def test_sinkhorn_kernel(cuda):
    g = _gen()
    z = torch.randn(2, 37, 53, generator=g).to(cuda)
    mu = torch.log_softmax(torch.randn(2, 37, generator=g), -1).to(cuda)
    nu = torch.log_softmax(torch.randn(2, 53, generator=g), -1).to(cuda)
    mu[0, 3] = -1e9  # a masked row
    got = log_sinkhorn(z, mu, nu, 20)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, log_sinkhorn_plain(z, mu, nu, 20), rtol=1e-5, atol=1e-4)


# (B, M, N) of the scores and the route their (B, M+1, N+1) coupling takes on an
# H100 SXM (132 SMs, 227 KB of shared memory a block): the headline, the
# banked model (B = 1), the CLI's default 1200 keypoints, a ragged case, and
# 2048 keypoints (beyond the blocks' shared memory)
SINKHORN_CASES = [((4, 1024, 1024), "resident"), ((1, 1024, 1024), "resident"), ((4, 1200, 1200), "resident"),
                  ((2, 36, 52), "resident"), ((2, 2048, 2048), "streamed")]


@pytest.mark.parametrize("shape,route", SINKHORN_CASES)
def test_sinkhorn_kernel_routes(cuda, shape, route):
    """`log_optimal_transport` through the kernel against the same through
    the plain loop, with masks as the model makes them and row 0 and column
    1 wholly masked: equal masked pattern, 1e-4 elsewhere (f32 sums in
    another order over 30 iterations), one launch, the same bits again."""
    b, m, n = shape
    g = _gen()
    scores = (3 * torch.randn(b, m, n, generator=g)).to(cuda)
    mask0 = (torch.rand(b, m, generator=g) < 0.9).to(cuda)
    mask1 = (torch.rand(b, n, generator=g) < 0.9).to(cuda)
    mask0[:, 0] = False
    mask1[:, 1] = False
    bin_score = torch.tensor(1.3, device=cuda)
    assert route_on(cuda, b, m + 1, n + 1).name == route
    before = _build.LAUNCHES["sinkhorn"]
    got = log_optimal_transport(scores, bin_score, 30, mask0, mask1)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sinkhorn"] == before + 1
    with mock.patch.object(sinkhorn_ops, "log_sinkhorn", sinkhorn_ops.log_sinkhorn_plain):
        ref = log_optimal_transport(scores, bin_score, 30, mask0, mask1)
    assert torch.equal(got > -1e8, ref > -1e8)
    assert bool((got[:, 0] < -1e8).all()) and bool((got[:, :, 1] < -1e8).all())
    real = (got > -1e8) & (ref > -1e8)
    assert (got - ref)[real].abs().max().item() <= 1e-4
    assert torch.equal(got, log_optimal_transport(scores, bin_score, 30, mask0, mask1))


@pytest.mark.parametrize("b,h,w", [(3, 37, 53), (1, 17, 5), (2, 9, 70), (1, 480, 640)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_entry_conv_kernel_ragged_tiles_and_borders(cuda, b, h, w, dtype):
    """Images that do not fill the kernel's 8 x 64 tiles, B = 1, and the
    border pixels (the conv's zero padding) on their own; the same bits
    again."""
    g = _gen()
    img = torch.rand(b, h, w, generator=g).to(cuda, dtype)
    k = (torch.randn(3, 3, 1, 64, generator=g) * 0.3).to(cuda)
    scale = (1 + 0.2 * torch.randn(64, generator=g)).to(cuda)
    shift = (0.2 * torch.randn(64, generator=g)).to(cuda)
    got = entry_conv(img, k, scale, shift)
    torch.cuda.synchronize()
    assert got.shape == (b, 64, h, w) and got.dtype == dtype
    ref = entry_conv_plain(img, k, scale, shift).float()
    rel = (got.float() - ref).abs() / ref.abs().clamp_min(1)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert rel.max() <= tol
    for border in (rel[:, :, 0], rel[:, :, -1], rel[:, :, :, 0], rel[:, :, :, -1]):
        assert border.max() <= tol
    assert torch.equal(got, entry_conv(img, k, scale, shift))


@pytest.mark.parametrize("b,h,w", [(3, 38, 53), (1, 2, 5), (2, 96, 200), (1, 480, 640)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_entry_conv_h_kernel(cuda, b, h, w, dtype):
    """The alignedH output: against its plain version (tolerances as the
    direct layout's), equal bit for bit to `space_to_depth_h` of the direct
    kernel's output, the same bits again, one launch counted."""
    g = _gen()
    img = torch.rand(b, h, w, generator=g).to(cuda, dtype)
    k = (torch.randn(3, 3, 1, 64, generator=g) * 0.3).to(cuda)
    scale = (1 + 0.2 * torch.randn(64, generator=g)).to(cuda)
    shift = (0.2 * torch.randn(64, generator=g)).to(cuda)
    before = _build.LAUNCHES["entry_conv_h"]
    got = entry_conv_h(img, k, scale, shift)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["entry_conv_h"] == before + 1
    assert got.shape == (b, h // 2, w, 128) and got.dtype == dtype and got.is_contiguous()
    ref = entry_conv_h_plain(img, k, scale, shift).float()
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert ((got.float() - ref).abs() / ref.abs().clamp_min(1)).max() <= tol
    assert torch.equal(got, space_to_depth_h(entry_conv(img, k, scale, shift).permute(0, 2, 3, 1)))
    assert torch.equal(got, entry_conv_h(img, k, scale, shift))
    with pytest.raises(ValueError, match="even height"):
        entry_conv_h(img[:, :-1].contiguous(), k, scale, shift)
    with pytest.raises(RuntimeError, match="no backward"):
        entry_conv_h(img, k.clone().requires_grad_(), scale, shift)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    img = torch.rand(2, 8, 8, device=cuda, dtype=torch.float16)
    w = torch.zeros(3, 3, 1, 64, device=cuda)
    with pytest.raises(TypeError):
        entry_conv(img, w, torch.ones(64, device=cuda), torch.zeros(64, device=cuda))
    # every head width runs, zero-padded to one the kernels take; their own launcher takes only
    # those (a head of 200 is not one), and in bf16 only rows that start on 16 bytes
    q = torch.zeros(1, 4, 4 * 256, device=cuda, dtype=torch.bfloat16)
    lse, delta = torch.zeros(1, 4, 4, device=cuda), torch.zeros(1, 4, 4, device=cuda)
    narrow = q[..., :4 * 200]
    with pytest.raises(ValueError, match="head dim 800/4 is neither"):
        attention_ops.attention_backward_kernel("attention_dq", narrow, narrow, narrow, None, narrow.contiguous(), lse,
                                                delta, (torch.empty_like(narrow.contiguous()),), 4)
    wide = torch.zeros(1, 4, 4 * 256 + 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="8-element-aligned"):
        attention(q, wide[..., 4:-4], q, None, 4)
    with pytest.raises(ValueError):
        log_sinkhorn(torch.zeros(1, 3, 3, device=cuda, dtype=torch.float64),
                     torch.zeros(1, 3, device=cuda), torch.zeros(1, 3, device=cuda), 2)


def test_matching_runs_through_the_kernels(cuda):
    cfg = MatchingConfig(descriptor_dim=64, keypoint_encoder=(16, 32), gnn_layers=4,
                         sinkhorn_iterations=10, max_keypoints=128)
    model = Matching(cfg)
    g = _gen()
    a = torch.rand(2, 64, 96, 1, generator=g).to(cuda)
    b = torch.rand(2, 64, 96, 1, generator=g).to(cuda)
    _build.reset_launch_counts()
    out = model(a, b)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"entry_conv": 1, "attention": 8, "sinkhorn": 1}
    assert out["log_coupling"].shape == (2, 129, 129)
    assert torch.isfinite(out["log_coupling"]).all()


def _attention_case(cuda, dh, dtype, b=3, n=70, m=133, h=4):
    """q, k, v as row-strided views of fused projections; a mask with one
    batch element that has no valid key; an upstream gradient."""
    g = _gen()
    q = torch.randn(b, n, 3 * h * dh, generator=g).to(cuda, dtype)[..., h * dh:2 * h * dh]
    src = torch.randn(b, m, 2 * h * dh, generator=g).to(cuda, dtype)
    k, v = src[..., :h * dh], src[..., h * dh:]
    mask = torch.rand(b, m, generator=g) < 0.6
    mask[-1] = False
    dout = torch.randn(b, n, h * dh, generator=g).to(cuda, dtype)
    return q, k, v, mask.to(cuda), dout


@pytest.mark.parametrize("n,m", FORWARD_SHAPES)
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_forward_with_lse_kernel(cuda, dh, dtype, n, m):
    q, k, v, mask, _ = _attention_case(cuda, dh, dtype, n=n, m=m)
    count = launch_name("attention_lse", dh)
    before = _build.LAUNCHES[count]
    out, lse = attention_lse(q, k, v, mask, 4)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[count] == before + 1
    ref_out, ref_lse = attention_lse_plain(q, k, v, mask, 4)
    # f32 logits on both sides; the kernel's exponentials are the fast
    # approximations, and bf16 rounds the probabilities for the value
    # product on both sides in another order
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=2e-4 if dtype == torch.bfloat16 else 1e-5)
    torch.testing.assert_close(lse[-1], torch.full_like(lse[-1], math.log(k.shape[1])))
    again = attention_lse(q, k, v, mask, 4)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


# (B, N, M) of the bf16 forward at heads of 128 (`attention_wide<128>`): D = 512's
# inference and training shapes (256 and 128 blocks); ragged across the 64-row blocks
# and the ring, at fewer and more blocks than an H100 has SMs; over 2048 keys at both
WIDE_128_CASES = [(4, 1024, 1024), (4, 512, 512), (2, 129, 257), (2, 200, 1100), (3, 1000, 1100), (2, 70, 2100),
                  (2, 1100, 2100)]


@pytest.mark.parametrize("b,n,m", WIDE_128_CASES)
def test_attention_forward_bf16_at_128(cuda, b, n, m):
    """The bf16 forward at heads of 128, with and without LSE: against the
    plain versions (3e-2; the LSE 2e-4), the dead element's mean of V and
    log M, one launch each under the `_dh128` names, two runs
    bit-identical."""
    q, k, v, mask, _ = _attention_case(cuda, 128, torch.bfloat16, b=b, n=n, m=m)
    before = dict(_build.LAUNCHES)
    out = attention(q, k, v, mask, 4)
    out_lse, lse = attention_lse(q, k, v, mask, 4)
    torch.cuda.synchronize()
    for name in ("attention", "attention_lse"):
        count = launch_name(name, 128)
        assert _build.LAUNCHES[count] == before.get(count, 0) + 1
    ref_out, ref_lse = attention_lse_plain(q, k, v, mask, 4)
    for got in (out, out_lse):
        torch.testing.assert_close(got.float(), ref_out.float(), rtol=3e-2, atol=3e-2)
        torch.testing.assert_close(got[-1].float(), v[-1].float().mean(0).expand_as(got[-1]), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=2e-4)
    torch.testing.assert_close(lse[-1], torch.full_like(lse[-1], math.log(m)))
    again = (attention(q, k, v, mask, 4), *attention_lse(q, k, v, mask, 4))
    assert all(torch.equal(a, c) for a, c in zip((out, out_lse, lse), again, strict=True))


# (B, N, M): deep f32 forward cases, 2048 queries over 2048 keys and over a
# ragged 2000 (neither a multiple of a block's 2 x 64 keys in flight)
F32_DEEP_FORWARD = [(2, 2048, 2048), (2, 2048, 2000)]


@pytest.mark.parametrize("b,n,m", F32_DEEP_FORWARD)
@pytest.mark.parametrize("dh", [16, 32, 64, 128, 160, 256, 384])
def test_attention_forward_f32_deep_sums(cuda, dh, b, n, m):
    """The f32 forward (`attention_ffma`; at 160, zero-padded, and 256
    `attention_wide_3xtf32`, its products 3xTF32; at 384 the chunked
    `attention_ffma_chunked`), with and without LSE, over 2048
    keys: against the plain f32 version (1e-5, the LSE too) and against the
    same function in float64, no further from it than twice the plain f32
    version's own distance (sums of that many products in f32 lie ~1e-7 of
    the largest entry from float64, in any order); the dead element's mean
    of V and log(M); two runs bit-identical."""
    q, k, v, mask, _ = _attention_case(cuda, dh, torch.float32, b=b, n=n, m=m)
    out, lse = attention_lse(q, k, v, mask, 4)
    out_inf = attention(q, k, v, mask, 4)
    ref, ref_lse = attention_lse_plain(q, k, v, mask, 4)
    exact, exact_lse = attention_lse_plain(q.double(), k.double(), v.double(), mask, 4)
    for got, plain, ex in ((out, ref, exact), (out_inf, ref, exact), (lse, ref_lse, exact_lse)):
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
        assert (got.double() - ex).abs().max() <= 2 * (plain.double() - ex).abs().max()
    torch.testing.assert_close(out[-1], v[-1].mean(0).expand_as(out[-1]), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse[-1], torch.full_like(lse[-1], math.log(m)), rtol=1e-5, atol=1e-5)
    again, again_lse = attention_lse(q, k, v, mask, 4)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)
    assert torch.equal(out_inf, attention(q, k, v, mask, 4))


def _assert_backward_close(got, ref, dtype):
    """bf16 rounds P for dV's tensor-core product (f32 on the plain side),
    and dS enters dQ and dK as a bf16 part plus its residue: at most a few
    bf16 steps of the largest gradient entry. f32: f32-accurate (above 128
    the products are 3xTF32). Returns the tolerance."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for a, r in zip(got, ref, strict=True):
        assert a.dtype == dtype and a.shape == r.shape and a.is_contiguous()
        assert ((a.float() - r.float()).abs().max() / r.float().abs().max()) <= tol
    return tol


# (N, M): the trainer's ragged case; both under one 64-row tile; exactly one
# tile; neither a multiple of the tile nor of a block's 2 x 4 tiles in
# flight; more query than key tiles; 18 key tiles for one query tile
BACKWARD_SHAPES = [(70, 133), (5, 9), (64, 64), (130, 257), (300, 70), (50, 1100)]


@pytest.mark.parametrize("n,m", BACKWARD_SHAPES)
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_backward_kernels(cuda, dh, dtype, n, m):
    q, k, v, mask, dout = _attention_case(cuda, dh, dtype, n=n, m=m)
    _, lse = attention_lse_plain(q, k, v, mask, 4)
    before = dict(_build.LAUNCHES)
    got = attention_backward(q, k, v, mask, lse, dout, 4)
    torch.cuda.synchronize()
    for name in ("attention_dkdv", "attention_dq"):
        count = launch_name(name, dh)
        assert _build.LAUNCHES[count] == before.get(count, 0) + 1
    tol = _assert_backward_close(got, attention_backward_plain(q, k, v, mask, lse, dout, 4), dtype)
    dq, dk, dv = got
    # the dead element: dQ = dK = 0, dV = sum(dO) / M
    assert not dq[-1].float().any() and not dk[-1].float().any()
    torch.testing.assert_close(dv[-1].float(), (dout[-1].float().sum(0) / k.shape[1]).expand_as(dv[-1]),
                               rtol=tol, atol=tol)
    # the sums have a fixed order: a second run gives the same bits
    again = attention_backward(q, k, v, mask, lse, dout, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True))


# (B, N, H, dh): deep f32 cases, a D = 256 training run's heads over 1024 keys
# (one dead batch element) and D = 128's over 2048; D = 512's over 1024 and its
# training shape (a dead element); the kernels with 3xTF32 products above 128:
# D = 1024's training heads over 512 keys (a dead element) and heads of 512 over 1024
F32_DEEP_BACKWARD = [(2, 1024, 4, 64), (1, 2048, 4, 32), (2, 1024, 4, 128), (4, 512, 4, 128), (2, 512, 4, 256),
                     (1, 1024, 2, 512)]


@pytest.mark.parametrize("b,n,h,dh", F32_DEEP_BACKWARD)
def test_attention_backward_kernels_f32_deep_sums(cuda, b, n, h, dh):
    """The f32 dQ and dK/dV kernels over 512-2048 keys and queries, against
    float64 autograd of the plain attention: no further from it than twice
    the plain f32 version's own distance (sums of that many products in f32
    lie ~1e-6 of the largest entry from float64, in any order:
    tests/test_torch_attention_grad.py); two runs bit-identical; the dead
    element's dQ = dK = 0 and dV = sum(dO) / M."""
    q, k, v, mask, dout = _attention_case(cuda, dh, torch.float32, b=b, n=n, m=n, h=h)
    if b == 1:  # the one batch element is live
        mask = (torch.rand(1, n, generator=torch.Generator().manual_seed(1)) < 0.6).to(cuda)
    _, lse = attention_lse(q, k, v, mask, h)
    got = attention_backward(q, k, v, mask, lse, dout, h)
    plain = attention_backward_plain(q, k, v, mask, lse, dout, h)
    qkv = [t.double().requires_grad_() for t in (q, k, v)]
    exact = torch.autograd.grad(attention_plain(*qkv, mask, h, "float32"), qkv, dout.double())
    for a, p, e in zip(got, plain, exact, strict=True):
        scale = e.abs().max()
        assert (a.double() - e).abs().max() / scale <= 2 * (p.double() - e).abs().max() / scale
    again = attention_backward(q, k, v, mask, lse, dout, h)
    assert all(torch.equal(a, c) for a, c in zip(got, again, strict=True))
    if b > 1:
        dq, dk, dv = got
        assert not dq[-1].any() and not dk[-1].any()
        torch.testing.assert_close(dv[-1], (dout[-1].sum(0) / n).expand_as(dv[-1]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m", [(70, 133), (130, 257)])
@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_backward_kernels_without_a_mask(cuda, dtype, dh, n, m):
    q, k, v, _, dout = _attention_case(cuda, dh, dtype, n=n, m=m)
    _, lse = attention_lse_plain(q, k, v, None, 4)
    got = attention_backward(q, k, v, None, lse, dout, 4)
    _assert_backward_close(got, attention_backward_plain(q, k, v, None, lse, dout, 4), dtype)


@pytest.mark.parametrize("n,m", [(70, 133), (50, 1100)])
@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_dq_kernel_writes_delta(cuda, dtype, dh, n, m):
    # delta is the dQ kernel's second output, which the dK/dV kernel reads
    q, k, v, mask, dout = _attention_case(cuda, dh, dtype, n=n, m=m)
    _, lse = attention_lse_plain(q, k, v, mask, 4)
    delta = torch.full((q.shape[0], 4, n), float("nan"), device=cuda)
    attention_ops.attention_backward_kernel("attention_dq", q, k, v, mask, dout, lse, delta,
                                            (torch.empty_like(dout),), 4)
    ref = attention_delta_plain(q, k, v, mask, lse, dout, 4)
    # f32 sums of the same products in another order
    assert ((delta - ref).abs().max() / ref.abs().max()) <= 1e-4
    assert not delta[-1].any()  # no valid key: no row of dS to centre


@pytest.mark.parametrize("n,m", [(70, 2100), (2100, 70)])
def test_attention_backward_f32_at_128_over_many_tiles(cuda, n, m):
    """The f32 kernels at 128 (3xTF32 products) over more than 2048 keys
    or queries, ragged on every tile: against the plain version (1e-4 of
    the largest entry) and no further from float64 autograd than twice the
    plain f32 version's own distance; the dead element's dQ = dK = 0 and
    dV = sum(dO) / M; two runs bit-identical."""
    q, k, v, mask, dout = _attention_case(cuda, 128, torch.float32, b=2, n=n, m=m)
    _, lse = attention_lse(q, k, v, mask, 4)
    got = attention_backward(q, k, v, mask, lse, dout, 4)
    plain = attention_backward_plain(q, k, v, mask, lse, dout, 4)
    _assert_backward_close(got, plain, torch.float32)
    qkv = [t.double().requires_grad_() for t in (q, k, v)]
    exact = torch.autograd.grad(attention_plain(*qkv, mask, 4, "float32"), qkv, dout.double())
    for a, p, e in zip(got, plain, exact, strict=True):
        assert (a.double() - e).abs().max() <= 2 * (p.double() - e).abs().max()
    dq, dk, dv = got
    assert not dq[-1].any() and not dk[-1].any()
    torch.testing.assert_close(dv[-1], (dout[-1].sum(0) / m).expand_as(dv[-1]), rtol=1e-5, atol=1e-5)
    again = attention_backward(q, k, v, mask, lse, dout, 4)
    assert all(torch.equal(a, c) for a, c in zip(got, again, strict=True))


@pytest.mark.parametrize("dh", [8, 24, 48, 80, 96])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernels_at_head_dims_they_are_not_built_for(cuda, dh, dtype):
    """Heads of 8, 24, 48, 80 and 96 values run zero-padded to 16, 32, 64
    and 128 at the scale of the real dh: forward, forward with LSE and both
    backward kernels against the plain versions at the built widths'
    tolerances."""
    q, k, v, mask, dout = _attention_case(cuda, dh, dtype)
    before = dict(_build.LAUNCHES)
    out = attention(q, k, v, mask, 4)
    out_lse, lse = attention_lse(q, k, v, mask, 4)
    grads = attention_backward(q, k, v, mask, lse, dout, 4)
    torch.cuda.synchronize()
    for name in ("attention", "attention_lse", "attention_dq", "attention_dkdv"):
        count = launch_name(name, padded_head_dim(dh))
        assert _build.LAUNCHES[count] == before.get(count, 0) + 1
    ref_out, ref_lse = attention_lse_plain(q, k, v, mask, 4)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    for got in (out, out_lse):
        assert got.shape == q.shape and got.is_contiguous()
        torch.testing.assert_close(got.float(), ref_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=2e-4 if dtype == torch.bfloat16 else 1e-5)
    _assert_backward_close(grads, attention_backward_plain(q, k, v, mask, lse, dout, 4), dtype)


# (N, M): ragged across the 64-row tiles; both under one tile; 18 key tiles for one query tile
CHUNKED_SHAPES = [(70, 133), (5, 9), (50, 1100)]
# (dh, N, M): every width on those shapes; D = 1024's training shape; at 256, shapes
# ragged across the forward's 64-row blocks (one row past two blocks, and over 18 key
# tiles) and D = 1024's inference shape; 8 chunks, the backward's largest cluster (8 blocks of
# one chunk each); and 10 chunks, more than a cluster of 8 blocks holds (the backward's
# blocks own 2 chunks each), ragged and across several tiles of each side
CHUNKED_CASES = ([(dh, n, m) for dh in (160, 256, 384, 512) for n, m in CHUNKED_SHAPES]
                 + [(256, 512, 512), (256, 129, 257), (256, 200, 1100), (256, 1024, 1024), (1024, 70, 133),
                    (1280, 70, 133), (1280, 130, 257)])


@pytest.mark.parametrize("dh,n,m", CHUNKED_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernels_in_chunks_of_128(cuda, dh, dtype, n, m):
    """Heads above 128 values run through the wide kernels (160 zero-padded
    to 256; the forwards at 256 `attention_wide` in bf16 and
    `attention_wide_3xtf32` in f32, the rest chunked):
    the forward, the forward with LSE and the backward
    against the plain versions at the tolerances of the widths up to 128,
    one launch each under the padded width's name; the dead element's dQ =
    dK = 0; the delta the dQ kernel writes; two runs bit-identical."""
    q, k, v, mask, dout = _attention_case(cuda, dh, dtype, n=n, m=m)
    before = dict(_build.LAUNCHES)
    out = attention(q, k, v, mask, 4)
    out_lse, lse = attention_lse(q, k, v, mask, 4)
    grads = attention_backward(q, k, v, mask, lse, dout, 4)
    torch.cuda.synchronize()
    for name in ("attention", "attention_lse", "attention_dq", "attention_dkdv"):
        count = launch_name(name, padded_head_dim(dh))
        assert _build.LAUNCHES[count] == before.get(count, 0) + 1
    ref_out, ref_lse = attention_lse_plain(q, k, v, mask, 4)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    for got in (out, out_lse):
        assert got.shape == q.shape and got.is_contiguous()
        torch.testing.assert_close(got.float(), ref_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=2e-4 if dtype == torch.bfloat16 else 1e-5)
    _assert_backward_close(grads, attention_backward_plain(q, k, v, mask, lse, dout, 4), dtype)
    assert not grads[0][-1].float().any() and not grads[1][-1].float().any()
    if dh % 128 == 0:  # the kernels' own width: delta as the dK/dV kernel reads it
        delta = torch.full((q.shape[0], 4, n), float("nan"), device=cuda)
        attention_ops.attention_backward_kernel("attention_dq", q, k, v, mask, dout, lse, delta,
                                                (torch.empty_like(dout),), 4)
        ref = attention_delta_plain(q, k, v, mask, lse, dout, 4)
        assert ((delta - ref).abs().max() / ref.abs().max()) <= 1e-4
    again = (attention(q, k, v, mask, 4), *attention_lse(q, k, v, mask, 4), *attention_backward(q, k, v, mask, lse,
                                                                                                dout, 4))
    assert all(torch.equal(a, b) for a, b in zip((out, out_lse, lse, *grads), again, strict=True))


@pytest.mark.parametrize("dh", [32, 64])
def test_attention_forward_rejects_rows_off_16_bytes(cuda, dh):
    # the bf16 kernels copy 16 bytes at a time: a view that starts 4 elements in is refused
    q, k, v, mask, _ = _attention_case(cuda, dh, torch.bfloat16)
    wide = torch.zeros(k.shape[0], k.shape[1], k.shape[2] + 8, dtype=k.dtype, device=cuda)
    for fn in (attention, attention_lse):
        with pytest.raises(ValueError, match="8-element-aligned"):
            fn(q, k, wide[..., 4:-4], mask, 4)


def test_attention_backward_rejects_rows_off_16_bytes(cuda):
    # the bf16 kernels copy 16 bytes at a time: a view that starts 4 elements in is refused
    q, k, v, mask, dout = _attention_case(cuda, 32, torch.bfloat16)
    wide = torch.zeros(k.shape[0], k.shape[1], k.shape[2] + 8, dtype=k.dtype, device=cuda)
    _, lse = attention_lse_plain(q, k, v, mask, 4)
    with pytest.raises(ValueError, match="8-element-aligned"):
        attention_backward(q, wide[..., 4:-4], v, mask, lse, dout, 4)


def test_attention_function_under_grad_uses_the_kernels(cuda):
    q, k, v, mask, dout = _attention_case(cuda, 32, torch.bfloat16)
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    _build.reset_launch_counts()
    out = attention(q, k, v, mask, 4)
    out.backward(dout)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"attention_lse": 1, "attention_dkdv": 1, "attention_dq": 1}
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in (q, k, v))


def test_kernels_without_backward_raise_under_grad(cuda):
    img = torch.rand(2, 8, 8, device=cuda, requires_grad=True)
    w = torch.zeros(3, 3, 1, 64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        entry_conv(img, w, torch.ones(64, device=cuda), torch.zeros(64, device=cuda))
    z = torch.zeros(1, 3, 3, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        log_sinkhorn(z, torch.zeros(1, 3, device=cuda), torch.zeros(1, 3, device=cuda), 2)
    with torch.no_grad():
        entry_conv(img, w, torch.ones(64, device=cuda), torch.zeros(64, device=cuda))


def test_train_step_runs_through_the_kernels(cuda):
    layers = 2
    sp = SuperPointBN(64, compute_dtype="bfloat16", seed=0)
    sg = SuperGlue(64, (16, 32), gnn_layers=layers, sinkhorn_iterations=10,
                   compute_dtype="bfloat16", seed=1)
    state = TrainState.create(sg, 1e-3)
    step = make_superglue_train_step(sg, sp, SuperGluePairConfig(max_keypoints=64))
    images = torch.rand(2, 64, 96, 1, generator=_gen()).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    _build.reset_launch_counts()
    metrics = step(state, images, gen)
    torch.cuda.synchronize()
    n = 2 * layers  # two sides per layer
    assert dict(_build.LAUNCHES) == {"entry_conv": 1, "attention_lse": n, "attention_dkdv": n,
                                     "attention_dq": n}
    assert metrics["skipped_nonfinite"] == 0 and torch.isfinite(metrics["loss"])
    assert state.step == 1


def test_train_step_backward_calls_match_plain(cuda):
    # each attention backward of a bf16 train step, on the model's own
    # inputs, against the plain version
    layers = 2
    sp = SuperPointBN(64, compute_dtype="bfloat16", seed=0)
    sg = SuperGlue(64, (16, 32), gnn_layers=layers, sinkhorn_iterations=10,
                   compute_dtype="bfloat16", seed=1)
    step = make_superglue_train_step(sg, sp, SuperGluePairConfig(max_keypoints=64))
    images = torch.rand(2, 64, 96, 1, generator=_gen()).to(cuda)
    calls, real = [], attention_ops.attention_backward

    def record(*args):
        calls.append(tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args))
        return real(*args)

    with mock.patch.object(attention_ops, "attention_backward", record):
        step(TrainState.create(sg, 1e-3), images, torch.Generator(device=cuda).manual_seed(0))
    assert len(calls) == 2 * layers
    for args in calls:
        got = attention_backward(*args)
        _assert_backward_close(got, attention_backward_plain(*args), torch.bfloat16)
        # and the exact gradient of the call, autograd of the plain
        # attention on the f32 upcast of its inputs: same direction
        q, k, v, mask, _, dout, h = args
        qkv = [t.float().requires_grad_() for t in (q, k, v)]
        exact = torch.autograd.grad(attention_plain(*qkv, mask, h, "float32"), qkv, dout.float())
        for a, e in zip(got, exact, strict=True):
            a = a.float().flatten()
            assert (a @ e.flatten()) / (a.norm() * e.norm()) >= 0.99


# (ci, co, B, H, W, dtype): the 2x2 backbone's four entry convs at 480x640 (one
# image each), then the paths the table does not reach: 16-channel inputs on
# tensor cores, maps that no tile divides (the wgmma kernel's 4 x 16 pixels,
# the image kernel's 16 x 64) at every input width of the tensor-core
# routes and both output widths, SIMT in bf16 and f32
S2D_ENTRY_CASES = [
    (1, 64, 1, 480, 640, torch.bfloat16), (64, 64, 1, 240, 320, torch.bfloat16),
    (64, 128, 1, 120, 160, torch.bfloat16), (128, 128, 2, 60, 80, torch.bfloat16),
    (16, 64, 2, 22, 36, torch.bfloat16), (8, 8, 2, 14, 10, torch.bfloat16),
    (8, 16, 3, 38, 50, torch.float32), (1, 64, 2, 30, 26, torch.float32),
    (128, 128, 1, 60, 80, torch.bfloat16), (1, 64, 2, 22, 36, torch.bfloat16),
    (1, 128, 3, 38, 50, torch.bfloat16), (16, 128, 1, 60, 80, torch.bfloat16),
    (64, 64, 3, 38, 50, torch.bfloat16), (64, 128, 2, 22, 36, torch.bfloat16),
    (128, 64, 3, 38, 50, torch.bfloat16), (32, 64, 1, 14, 18, torch.bfloat16),
    # the register-tiled SIMT kernel (s2d_entry_ffma): f32 at every input width
    # up to 16 and every output width on ragged maps (its tiles are 4 or 8 rows
    # by 32 columns by 64 channels; ci = 3 and 5 stage no whole 16 bytes), and
    # bf16 at widths the tensor-core routes do not take
    (3, 8, 3, 38, 50, torch.float32), (3, 64, 2, 22, 36, torch.float32),
    (8, 24, 2, 30, 26, torch.float32), (8, 128, 1, 14, 18, torch.float32),
    (16, 24, 3, 38, 50, torch.float32), (16, 128, 2, 22, 36, torch.float32),
    (5, 16, 2, 10, 12, torch.float32), (1, 24, 1, 14, 18, torch.float32),
    (48, 64, 2, 22, 36, torch.bfloat16), (64, 24, 3, 38, 50, torch.bfloat16),
    (3, 128, 2, 30, 26, torch.bfloat16),
]


@pytest.mark.parametrize("ci,co,b,h,w,dtype", S2D_ENTRY_CASES)
def test_s2d_entry_conv_kernel(cuda, ci, co, b, h, w, dtype):
    g = _gen()
    x = torch.randn(b, h, w, ci, generator=g).to(cuda, dtype)
    k = (torch.randn(3, 3, ci, co, generator=g) * 0.3).to(cuda, dtype)
    before = _build.LAUNCHES["s2d_entry_conv"]
    got = s2d_entry_conv(x, k)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["s2d_entry_conv"] == before + 1
    assert got.shape == (b, h // 2, w // 2, 4 * co) and got.dtype == dtype and got.is_contiguous()
    ref = conv3x3_s2d_entry(x, k)
    # the same products summed in f32 in another order, rounded once: at
    # most one step of the type apart
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert ((got.float() - ref.float()).abs() / ref.float().abs().clamp_min(1)).max() <= tol
    # every sum has a fixed order: a second run gives the same bits
    assert torch.equal(got, s2d_entry_conv(x, k))


# (ci, co, B, H, W): f32 sums of 9 ci >= 288 products. The 2x2 backbone's three
# deep entry convs at 480x640 (one or two images), then ragged maps at every
# output width
S2D_ENTRY_F32_DEEP_CASES = [
    (64, 64, 1, 240, 320), (64, 128, 1, 120, 160), (128, 128, 2, 60, 80),
    (32, 8, 3, 38, 50), (32, 64, 2, 30, 26), (64, 24, 3, 38, 50), (64, 128, 2, 22, 36),
    (128, 8, 1, 14, 18), (128, 24, 2, 22, 36), (128, 64, 3, 38, 50),
]


@pytest.mark.parametrize("ci,co,b,h,w", S2D_ENTRY_F32_DEEP_CASES)
def test_s2d_entry_conv_f32_deep_sums(cuda, ci, co, b, h, w):
    """f32 through `s2d_entry_ffma` where sums are long. Two f32 orders of
    sums of 576-1152 products lie up to ~3e-5 of max(|y|, 1) apart (cuDNN's
    own f32 result lies that far from the float64 answer), so these are held
    to 1e-4, as chip_smoke.py holds the backbone's f32 shapes; products of
    inputs rounded to TF32's 10-bit mantissas would not meet it."""
    g = _gen()
    x = torch.randn(b, h, w, ci, generator=g).to(cuda)
    k = (torch.randn(3, 3, ci, co, generator=g) * 0.3).to(cuda)
    before = _build.LAUNCHES["s2d_entry_conv"]
    got = s2d_entry_conv(x, k)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["s2d_entry_conv"] == before + 1
    assert got.shape == (b, h // 2, w // 2, 4 * co) and got.is_contiguous()
    ref = conv3x3_s2d_entry(x, k)
    assert ((got - ref).abs() / ref.abs().clamp_min(1)).max() <= 1e-4
    assert torch.equal(got, s2d_entry_conv(x, k))  # a fixed order of sums


@pytest.mark.parametrize("ci,co,symbol", [(1, 64, "s2d_entry_conv_bf16_image"), (1, 128, "s2d_entry_conv_bf16_image"),
                                          (16, 64, "s2d_entry_conv_bf16_wg"), (128, 128, "s2d_entry_conv_bf16_wg"),
                                          (8, 64, "s2d_entry_conv_bf16_simt"), (1, 8, "s2d_entry_conv_bf16_simt"),
                                          (48, 64, "s2d_entry_conv_bf16_simt"), (64, 24, "s2d_entry_conv_bf16_simt"),
                                          (1, 64, "s2d_entry_conv_f32_simt"), (1, 24, "s2d_entry_conv_f32_simt"),
                                          (16, 64, "s2d_entry_conv_f32_simt"), (8, 128, "s2d_entry_conv_f32_simt")])
def test_s2d_entry_conv_routes(cuda, ci, co, symbol):
    """bf16 goes to the tensor cores where co is a multiple of 64: the image
    conv (ci = 1, its 9 taps padded to 16) and wgmma at 16-128 channels;
    other widths, and f32 at every width, go to the SIMT entry."""
    dtype = torch.float32 if "_f32_" in symbol else torch.bfloat16
    g = _gen()
    x = torch.randn(2, 30, 26, ci, generator=g).to(cuda, dtype)
    k = (torch.randn(3, 3, ci, co, generator=g) * 0.3).to(cuda, dtype)
    with mock.patch.object(s2d_entry_ops, "_entry", wraps=s2d_entry_ops._entry) as entry:
        got = s2d_entry_conv(x, k)
    torch.cuda.synchronize()
    assert [c.args[1] for c in entry.call_args_list] == [symbol]
    ref = conv3x3_s2d_entry(x, k)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert ((got.float() - ref.float()).abs() / ref.float().abs().clamp_min(1)).max() <= tol


# (B, H, W, C, extra columns, dtype): the 2x2 backbone's three pools at 480x640,
# then a U widened by extra_cols and odd sizes
REALIGN_CASES = [
    (1, 240, 320, 64, 0, torch.bfloat16), (1, 120, 160, 64, 0, torch.bfloat16),
    (2, 60, 80, 128, 0, torch.bfloat16), (2, 13, 9, 8, 3, torch.bfloat16),
    (3, 7, 11, 4, 0, torch.float32), (2, 6, 5, 12, 6, torch.float32),
]


@pytest.mark.parametrize("b,h,w,c,extra,dtype", REALIGN_CASES)
def test_realign_kernel(cuda, b, h, w, c, extra, dtype):
    u = torch.randn(b, h + 1, w + 1 + extra, 4 * c, generator=_gen()).to(cuda, dtype)
    u[0, 1, 1, 2 * c] = float("nan")  # group (1, 0) at U[1, 1]: output (0, 1), channel 0
    out_w = w if extra else None
    before = _build.LAUNCHES["realign"]
    got = maxpool_realign(u, out_w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["realign"] == before + 1
    assert got.shape == (b, h, w, c) and got.dtype == dtype
    ref = maxpool2x2_s2d_from_raw(u, out_w)
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)  # a max rounds nothing
    assert torch.isnan(got[0, 0, 1, 0]) and int(torch.isnan(got).sum()) == 1


def test_s2d_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 8, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="even"):
        s2d_entry_conv(x[:, :7], torch.zeros(3, 3, 8, 8, device=cuda))
    with pytest.raises(ValueError, match="multiple of 8"):
        s2d_entry_conv(x, torch.zeros(3, 3, 8, 12, device=cuda))
    with pytest.raises(ValueError):
        s2d_entry_conv(x, torch.zeros(3, 3, 8, 8, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        s2d_entry_conv(x.half(), torch.zeros(3, 3, 8, 8, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        maxpool_realign(torch.zeros(1, 5, 4 * 8, 5, device=cuda).transpose(2, 3))
    with pytest.raises(ValueError, match="multiple"):
        maxpool_realign(torch.zeros(1, 5, 5, 4 * 6, device=cuda))
    with pytest.raises(ValueError, match="no .* output"):
        maxpool_realign(torch.zeros(1, 5, 5, 4 * 8, device=cuda), out_w=5)


def test_s2d_functions_under_grad(cuda):
    """Forward through the kernels, backward by autograd of the plain
    versions: the same gradients as the plain versions' own."""
    g = _gen()
    x = torch.randn(2, 12, 16, 16, generator=g).to(cuda).requires_grad_()
    k = (torch.randn(3, 3, 16, 8, generator=g) * 0.3).to(cuda).requires_grad_()
    _build.reset_launch_counts()
    u = torch.nn.functional.pad(s2d_entry_conv(x, k), (0, 0, 0, 1, 0, 1))  # (2, 7, 9, 32): a stand-in U
    out = maxpool_realign(u)
    dout = torch.randn(out.shape, generator=g).to(cuda)
    out.backward(dout)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"s2d_entry_conv": 1, "realign": 1}
    xr, kr = x.detach().clone().requires_grad_(), k.detach().clone().requires_grad_()
    ref = maxpool2x2_s2d_from_raw(torch.nn.functional.pad(conv3x3_s2d_entry(xr, kr), (0, 0, 0, 1, 0, 1)))
    ref.backward(dout)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    # the pool may pick another of two taps that differ by rounding: compare the sums
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(k.grad, kr.grad, rtol=1e-3, atol=1e-3)


def test_detect_called_directly_runs_on_the_card(cuda):
    """`Matching.detect` outside `forward`, parameters requiring grad (as
    registration calls it): the entry conv kernel has no backward, so
    `detect` brings its own inference mode."""
    model = Matching(MatchingConfig(descriptor_dim=64, keypoint_encoder=(16, 32), gnn_layers=2, max_keypoints=64))
    assert all(p.requires_grad for p in model.parameters()) and torch.is_grad_enabled()
    _build.reset_launch_counts()
    kp = model.detect(torch.rand(2, 64, 96, 1, generator=_gen()).to(cuda))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"entry_conv": 1}
    assert kp.desc.shape == (2, 64, 64) and kp.desc.is_inference()


@pytest.mark.parametrize("backbone", ["bn", "vgg"])
def test_registration_runs_through_the_s2d_kernels(cuda, backbone):
    cfg = MatchingConfig(descriptor_dim=64, keypoint_encoder=(16, 32), gnn_layers=2, sinkhorn_iterations=10,
                         max_keypoints=128, compute_dtype="float32", backbone=backbone, s2d_backbone=True,
                         s2d_layout="2x2")
    model = Matching(cfg)
    plain = Matching(dataclasses.replace(cfg, s2d_backbone=False))
    plain.load_state_dict(model.state_dict(), strict=True)
    g = _gen()
    a, b = (torch.rand(2, 64, 96, 1, generator=g).to(cuda) for _ in range(2))
    register = build_registration_fn(model, matcher="superglue", ransac_model="homography", num_hypotheses=64)
    _build.reset_launch_counts()
    res = register(a, b, torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"s2d_entry_conv": 8, "realign": 6, "attention": 4, "sinkhorn": 1}
    assert res.fit.matrix.shape == (2, 3, 3) and res.warped.shape == a.shape
    with torch.inference_mode():
        got, ref = model.superpoint(a), plain.superpoint(a)
    # f32, TF32 off: the same network with sums in another order
    for key in ("semi", "desc_map"):
        torch.testing.assert_close(got[key], ref[key], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backbone", ["bn", "vgg"])
def test_registration_runs_through_the_h_layout(cuda, backbone, dtype):
    """The JAX package's default layout: one alignedH entry conv per detect,
    the rest library ops; the H backbone against the plain one on the same
    weights (f32: sums in another order; bf16: roundings at other places
    through a dozen layers, a few bf16 steps of the largest entry)."""
    cfg = MatchingConfig(descriptor_dim=64, keypoint_encoder=(16, 32), gnn_layers=2, sinkhorn_iterations=10,
                         max_keypoints=128, compute_dtype=dtype, backbone=backbone, s2d_backbone=True)
    assert cfg.s2d_layout == "h"
    model = Matching(cfg)
    plain = Matching(dataclasses.replace(cfg, s2d_backbone=False))
    plain.load_state_dict(model.state_dict(), strict=True)
    g = _gen()
    a, b = (torch.rand(2, 64, 96, 1, generator=g).to(cuda) for _ in range(2))
    register = build_registration_fn(model, matcher="superglue", ransac_model="homography", num_hypotheses=64)
    _build.reset_launch_counts()
    res = register(a, b, torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"entry_conv_h": 2, "attention": 4, "sinkhorn": 1}
    assert res.fit.matrix.shape == (2, 3, 3) and bool(torch.isfinite(res.fit.matrix).all())
    with torch.inference_mode():
        got, ref = model.superpoint(a), plain.superpoint(a)
    tol = 1e-3 if dtype == "float32" else 5e-2
    for key in ("semi", "desc_map"):
        assert (got[key] - ref[key]).abs().max() <= tol * ref[key].abs().max()
