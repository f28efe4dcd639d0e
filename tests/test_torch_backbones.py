"""Port's SuperPoint backbones (CPU: the kernels' plain versions) vs the
JAX package on the same inputs and weights: `SuperPointBN` through the
2x2 space-to-depth path, `SuperPointVGG` plain and 2x2, the banked
weights loaded strictly into the 2x2 `SuperPointBN`, and the subpixel
postprocess.

f32 throughout. The s2d path and the plain path compute the same network
with sums in another order: 1e-4 on `semi` / `desc_map` after a dozen
layers, as between the two packages' plain paths.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.models.superpoint import SuperPointBN as JaxSuperPointBN
from image_matching_tpu.models.superpoint import SuperPointVGG as JaxSuperPointVGG
from image_matching_tpu.models.superpoint import superpoint_postprocess as jax_postprocess
from image_matching_tpu.ops import sampling as jax_sampling
from image_matching_tpu.utils.weights import flatten_tree
from image_matching_tpu_torch.models import Matching, MatchingConfig, SuperPointBN, SuperPointVGG
from image_matching_tpu_torch.models.superpoint import superpoint_postprocess
from image_matching_tpu_torch.ops import _build, sampling
from image_matching_tpu_torch.weights import (
    load_jax_params,
    load_magicleap_superpoint,
    load_npz,
    params_from_jax,
    params_to_jax,
)

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


def _perturb(variables, seed):
    """Non-trivial biases, BN statistics and affines."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape).astype(np.float32))
        if name in ("mean", "bias"):
            return jnp.asarray(rng.normal(0, 0.1, x.shape).astype(np.float32))
        if name == "scale":
            return jnp.asarray(rng.normal(1, 0.1, x.shape).astype(np.float32))
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _images(seed, b=2, h=48, w=64):
    return np.random.default_rng(seed).uniform(0, 1, (b, h, w, 1)).astype(np.float32)


def _assert_outputs_close(got, ref, tol=1e-4):
    for key in ("semi", "desc_map"):
        assert got[key].shape == ref[key].shape and got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=tol, atol=tol)


def test_superpoint_bn_2x2_matches_jax_and_plain_path():
    img = _images(0)
    jm = JaxSuperPointBN(descriptor_dim=32, s2d=True, s2d_layout="2x2")
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(img)), 1)
    ref = jm.apply(v, jnp.asarray(img))
    tm = SuperPointBN(32, device="cpu", s2d=True, s2d_layout="2x2")
    load_jax_params(tm, flatten_tree(v))
    plain = SuperPointBN(32, device="cpu")
    plain.load_state_dict(tm.state_dict(), strict=True)  # same names either way
    with torch.no_grad():
        got, got_plain = tm(torch.from_numpy(img)), plain(torch.from_numpy(img))
    _assert_outputs_close(got, ref)
    _assert_outputs_close(got, {k: x.numpy() for k, x in got_plain.items()})


def test_superpoint_bn_2x2_takes_other_sizes_on_the_plain_path():
    img = _images(1, b=1, h=40, w=56)  # divisible by 8, not by 16
    tm = SuperPointBN(32, device="cpu", s2d=True, s2d_layout="2x2")
    plain = SuperPointBN(32, device="cpu")
    plain.load_state_dict(tm.state_dict(), strict=True)
    with torch.no_grad():
        got, ref = tm(torch.from_numpy(img)), plain(torch.from_numpy(img))
    torch.testing.assert_close(got["semi"], ref["semi"], rtol=0, atol=0)


@pytest.mark.parametrize("cls", [SuperPointBN, SuperPointVGG])
def test_h_layout_is_not_ported(cls):
    """What the layout argument takes: "h" (the default, as in JAX) and
    "2x2" build; another layout raises; without s2d the layout is not
    looked at. The H layout's numbers are held in `test_torch_s2dh.py`."""
    assert cls(32, device="cpu", s2d=True).s2d_layout == "h"
    assert cls(32, device="cpu", s2d=True, s2d_layout="2x2").s2d_layout == "2x2"
    with pytest.raises(ValueError, match="unknown s2d_layout"):
        cls(32, device="cpu", s2d=True, s2d_layout="w")
    cls(32, device="cpu", s2d=False, s2d_layout="w")
    model = Matching(MatchingConfig(gnn_layers=2, s2d_backbone=True), device="cpu")
    assert model.superpoint.s2d_layout == "h"
    with pytest.raises(ValueError, match="unknown s2d_layout"):
        Matching(MatchingConfig(gnn_layers=2, s2d_backbone=True, s2d_layout="w"), device="cpu")


@pytest.mark.parametrize("s2d", [False, True])
def test_superpoint_vgg_matches_jax(s2d):
    img = _images(2)
    jm = JaxSuperPointVGG(descriptor_dim=32, s2d=s2d, s2d_layout="2x2")
    v = _perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(img)), 3)
    ref = jm.apply(v, jnp.asarray(img))
    tm = SuperPointVGG(32, device="cpu", s2d=s2d, s2d_layout="2x2")
    load_jax_params(tm, flatten_tree(v))
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    _assert_outputs_close(got, ref)


def test_vgg_tree_maps_both_ways_and_takes_the_magicleap_names():
    img = _images(3)
    jm = JaxSuperPointVGG(descriptor_dim=32, s2d=False)
    flat = flatten_tree(_perturb(jm.init(jax.random.PRNGKey(2), jnp.asarray(img)), 4))
    tm = SuperPointVGG(32, device="cpu")
    load_jax_params(tm, flat)
    back = params_to_jax(tm.state_dict())
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))
    # an official checkpoint's state_dict: same names, torch layouts, maybe a "module." prefix
    state = {f"module.{k}": v.numpy() for k, v in params_from_jax(flat).items()}
    assert "module.conv1a.weight" in state and state["module.conv1a.weight"].shape == (64, 1, 3, 3)
    other = SuperPointVGG(32, device="cpu", seed=5)
    load_magicleap_superpoint(other, state)
    for k, t in tm.state_dict().items():
        torch.testing.assert_close(other.state_dict()[k], t, rtol=0, atol=0)


def test_banked_weights_load_strictly_into_the_2x2_backbone():
    tm = SuperPointBN(128, device="cpu", s2d=True, s2d_layout="2x2")
    load_npz(tm, str(WEIGHTS / "sp_photo.npz"))
    plain = SuperPointBN(128, device="cpu")
    load_npz(plain, str(WEIGHTS / "sp_photo.npz"))
    img = torch.from_numpy(_images(4, b=1, h=64, w=80))
    _build.reset_launch_counts()
    with torch.no_grad():
        got, ref = tm(img), plain(img)
    assert not _build.LAUNCHES  # CPU tensors take the plain versions and count nothing
    _assert_outputs_close(got, {k: x.numpy() for k, x in ref.items()})


def test_subpixel_pieces_match_jax():
    rng = np.random.default_rng(5)
    heat = rng.uniform(0, 1, (2, 24, 32)).astype(np.float32)
    xy = rng.uniform(-1, 33, (2, 20, 2)).astype(np.float32)  # some patches leave the image
    np.testing.assert_allclose(sampling.extract_patches(torch.from_numpy(heat), torch.from_numpy(xy)).numpy(),
                               np.asarray(jax_sampling.extract_patches(jnp.asarray(heat), jnp.asarray(xy))),
                               rtol=1e-6, atol=1e-6)
    patches = rng.normal(size=(2, 20, 5, 5)).astype(np.float32)
    np.testing.assert_allclose(sampling.soft_argmax_2d(torch.from_numpy(patches)).numpy(),
                               np.asarray(jax_sampling.soft_argmax_2d(jnp.asarray(patches))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        sampling.refine_keypoints_subpixel(torch.from_numpy(heat[..., None]), torch.from_numpy(xy)).numpy(),
        np.asarray(jax_sampling.refine_keypoints_subpixel(jnp.asarray(heat[..., None]), jnp.asarray(xy))),
        rtol=1e-5, atol=1e-5)


def test_subpixel_postprocess_matches_jax():
    img = _images(6)
    jm = JaxSuperPointBN(descriptor_dim=32, s2d=False)
    v = _perturb(jm.init(jax.random.PRNGKey(3), jnp.asarray(img)), 7)
    dense = jm.apply(v, jnp.asarray(img))
    ref = jax_postprocess(dense, 64, threshold=0.01, subpixel=True)
    got = superpoint_postprocess({k: torch.from_numpy(np.array(x)) for k, x in dense.items()}, 64,
                                 threshold=0.01, subpixel=True)
    coarse = superpoint_postprocess({k: torch.from_numpy(np.array(x)) for k, x in dense.items()}, 64,
                                    threshold=0.01)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    # the same bf16 heatmap on both sides; exp / log / softmax in f32 in another order
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(ref.xy), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.desc.numpy(), np.asarray(ref.desc), rtol=1e-4, atol=1e-5)
    moved = (got.xy - coarse.xy).abs().amax(-1)[got.mask]
    assert moved.max() > 0 and moved.max() <= 2.0  # refined, and inside the 5x5 patch


@pytest.mark.parametrize("s2d", [False, True])
def test_detect_called_directly_runs_in_inference_mode(s2d):
    """`Matching.detect` outside `forward`, with parameters that require
    grad, as registration calls it: it brings its own inference mode (on
    the card the entry conv kernel has no backward and raises under grad)."""
    cfg = MatchingConfig(descriptor_dim=32, keypoint_encoder=(8,), gnn_layers=2, max_keypoints=32,
                         compute_dtype="float32", s2d_backbone=s2d, s2d_layout="2x2")
    model = Matching(cfg, device="cpu")
    assert all(p.requires_grad for p in model.parameters()) and torch.is_grad_enabled()
    kp = model.detect(torch.from_numpy(_images(8)))
    assert kp.desc.shape == (2, 32, 32) and kp.desc.is_inference() and not kp.desc.requires_grad
    out = model.match_keypoints(kp, kp, (48, 64), (48, 64))
    assert out["log_coupling"].is_inference()
