"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test asks the `cuda` fixture, which skips where
torch has no CUDA device. Run them on a machine with an H100 with
`python -m pytest tests/test_torch_gpu.py -m gpu -q`. TF32 is off, so
f32 references are full f32.
"""
import pytest
import torch

from image_matching_tpu_torch.models import Matching, MatchingConfig
from image_matching_tpu_torch.ops import _build
from image_matching_tpu_torch.ops.attention import attention, attention_plain
from image_matching_tpu_torch.ops.entry_conv import entry_conv, entry_conv_plain
from image_matching_tpu_torch.ops.sinkhorn import log_sinkhorn, log_sinkhorn_plain

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


@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel(cuda, dh, dtype):
    g = _gen()
    b, n, m, h = 3, 70, 133, 4
    # q, k, v as row-strided views of fused projections, as the model makes them
    q = torch.randn(b, n, 3 * h * dh, generator=g).to(cuda, dtype)[..., h * dh:2 * h * dh]
    src = torch.randn(b, m, 2 * h * dh, generator=g).to(cuda, dtype)
    k, v = src[..., :h * dh], src[..., h * dh:]
    mask = torch.rand(b, m, generator=g) < 0.6
    mask[-1] = False  # a batch element with no valid key
    mask = mask.to(cuda)
    got = attention(q, k, v, mask, h)
    torch.cuda.synchronize()
    ref = attention_plain(q, k, v, mask, h, "float32")
    # f32 logits on both sides; bf16 also rounds the probabilities on the
    # plain side, so the bf16 tolerance is a few bf16 steps
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


def test_sinkhorn_kernel(cuda):
    g = _gen()
    z = torch.randn(2, 37, 53, generator=g).to(cuda)
    mu = torch.log_softmax(torch.randn(2, 37, generator=g), -1).to(cuda)
    nu = torch.log_softmax(torch.randn(2, 53, generator=g), -1).to(cuda)
    mu[0, 3] = -1e9  # a masked row
    got = log_sinkhorn(z, mu, nu, 20)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, log_sinkhorn_plain(z, mu, nu, 20), rtol=1e-5, atol=1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    img = torch.rand(2, 8, 8, device=cuda, dtype=torch.float16)
    w = torch.zeros(3, 3, 1, 64, device=cuda)
    with pytest.raises(TypeError):
        entry_conv(img, w, torch.ones(64, device=cuda), torch.zeros(64, device=cuda))
    q = torch.zeros(1, 4, 4 * 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attention(q, q, q, None, 4)
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
