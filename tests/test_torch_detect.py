"""Port's heatmap -> keypoints chain vs the JAX package: flatten_detection,
simple_nms, detect_keypoints (tiled top-k and flat fallback) and
sample_descriptors, on the same inputs.

NMS, masking and the tiled top-k are comparisons and a stable sort, so
they are held exact, ties included (both sides keep equal scores in tile
order). The flat fallback's top-k may order exact ties differently from
`lax.top_k`, so it is compared as sets of (x, y, score).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.geometry.labels import flatten_detection as jax_flatten
from image_matching_tpu.ops.detect import detect_keypoints as jax_detect
from image_matching_tpu.ops.nms import simple_nms as jax_nms
from image_matching_tpu.ops.sampling import describe_keypoints as jax_describe
from image_matching_tpu.ops.sampling import sample_descriptors as jax_sample
from image_matching_tpu.structs import Keypoints as JaxKeypoints
from image_matching_tpu_torch.geometry.labels import flatten_detection
from image_matching_tpu_torch.ops.detect import detect_keypoints
from image_matching_tpu_torch.ops.nms import simple_nms
from image_matching_tpu_torch.ops.sampling import describe_keypoints, sample_descriptors
from image_matching_tpu_torch.structs import Keypoints


def _heatmap(seed, b=2, hc=8, wc=12):
    """A bf16 detector heatmap from random logits, as the model makes it
    (bf16 quantisation leaves many exact ties). The two softmaxes may
    round a value to neighbouring bf16 numbers, so the port's is held
    to one bf16 step and the JAX one is handed to both detectors."""
    rng = np.random.default_rng(seed)
    semi = rng.normal(0, 2, (b, hc, wc, 65)).astype(np.float32)
    ref = jax_flatten(jnp.asarray(semi), 8, dtype=jnp.bfloat16)[..., 0]
    got = flatten_detection(torch.from_numpy(semi), 8)[..., 0]
    assert got.dtype == torch.bfloat16 and got.shape == (b, hc * 8, wc * 8)
    ref32 = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref32, rtol=2 ** -7, atol=0)
    return torch.from_numpy(ref32).to(torch.bfloat16), ref


def test_nms_identical():
    got, ref = _heatmap(0)
    np.testing.assert_array_equal(simple_nms(got, 4).float().numpy(),
                                  np.asarray(jax_nms(ref, 4), np.float32))


@pytest.mark.parametrize("k", [16, 60])
def test_tiled_topk_identical(k):
    got_h, ref_h = _heatmap(1)
    got = detect_keypoints(got_h, k, threshold=0.01)
    ref = jax_detect(ref_h, k, threshold=0.01)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(ref.xy))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))
    assert got.mask.sum() > 0


def test_flat_fallback_same_sets():
    got_h, ref_h = _heatmap(2)
    # radius 2 < 3 takes the flat top-k
    got = detect_keypoints(got_h, 40, threshold=0.01, nms_radius=2)
    ref = jax_detect(ref_h, 40, threshold=0.01, nms_radius=2)
    for bi in range(2):
        as_set = lambda xy, s, m: {(float(x), float(y), float(v)) for (x, y), v, ok in zip(xy, s, m) if ok}
        g = as_set(got.xy[bi].numpy(), got.score[bi].numpy(), got.mask[bi].numpy())
        r = as_set(np.asarray(ref.xy[bi]), np.asarray(ref.score[bi]), np.asarray(ref.mask[bi]))
        # the K-th place may hold one of several tied scores: compare the
        # sets above the smallest selected score, and that score's count
        cut = min(v for *_, v in r)
        assert {p for p in g if p[2] > cut} == {p for p in r if p[2] > cut}
        assert len(g) == len(r)


def test_sample_descriptors_matches():
    rng = np.random.default_rng(3)
    desc_map = rng.normal(size=(2, 6, 9, 16)).astype(np.float32)
    # in-range, edge and outside-the-cell-grid positions
    xy = rng.uniform(-4, 76, (2, 50, 2)).astype(np.float32)
    got = sample_descriptors(torch.from_numpy(xy), torch.from_numpy(desc_map), 8).numpy()
    ref = np.asarray(jax_sample(jnp.asarray(xy), jnp.asarray(desc_map), 8))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_describe_keypoints_matches():
    # sampled descriptors attached to a keypoint set, masked slots zeroed
    rng = np.random.default_rng(4)
    desc_map = rng.normal(size=(2, 6, 9, 16)).astype(np.float32)
    arrays = dict(xy=rng.uniform(0, (72, 48), (2, 30, 2)).astype(np.float32),  # inside the 48 x 72 image
                  score=rng.uniform(size=(2, 30)).astype(np.float32),
                  mask=np.arange(30)[None] < np.array([[30], [19]]),
                  desc=np.zeros((2, 30, 16), np.float32))
    got = describe_keypoints(Keypoints(**{n: torch.from_numpy(a) for n, a in arrays.items()}),
                             torch.from_numpy(desc_map), 8)
    ref = jax_describe(JaxKeypoints(**{n: jnp.asarray(a) for n, a in arrays.items()}), jnp.asarray(desc_map), 8)
    np.testing.assert_allclose(got.desc.numpy(), np.asarray(ref.desc), rtol=1e-5, atol=1e-6)
    assert not got.desc[1, 19:].any() and got.desc[1, :19].abs().sum(-1).min() > 0
    for name in ("xy", "score", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
