"""Port's models (plain CPU path) vs the JAX package on the same inputs and
the same weights (JAX init, statistics and norm affines perturbed, then
`flatten_tree` -> `load_jax_params`).

Every JAX knob that selects an implementation or a layout is pinned:
`s2d=False` / `s2d_backbone=False`, `attention_impl="einsum"`,
`sinkhorn_impl="scan"`, `logits_dtype` both ways, f32 compute. In f32 the
two sides differ only in summation order: 1e-4 on network outputs after
a dozen layers, identical keypoints and matches. Where logits are stored
in bf16, a logit may round to the neighbouring bf16 number on one side,
so the log-coupling is held to 2e-2 and 98% of the matches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.models.matching import Matching as JaxMatching
from image_matching_tpu.models.matching import MatchingConfig as JaxConfig
from image_matching_tpu.models.superglue import SuperGlue as JaxSuperGlue
from image_matching_tpu.models.superpoint import SuperPointBN as JaxSuperPointBN
from image_matching_tpu.models.superpoint import superpoint_postprocess as jax_postprocess
from image_matching_tpu.structs import Keypoints as JaxKeypoints
from image_matching_tpu.utils.weights import flatten_tree
from image_matching_tpu_torch.models import Matching, MatchingConfig, SuperGlue, SuperPointBN
from image_matching_tpu_torch.models.superpoint import superpoint_postprocess
from image_matching_tpu_torch.structs import Keypoints
from image_matching_tpu_torch.weights import load_jax_params


def _perturb(variables, seed):
    """Non-trivial BN statistics and affines so the folds are exercised."""
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
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)


def test_superpoint_outputs_and_keypoints():
    img = _images(0)
    jm = JaxSuperPointBN(descriptor_dim=32, s2d=False)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(img)), 1)
    ref = jm.apply(v, jnp.asarray(img))
    tm = SuperPointBN(32, device="cpu")
    load_jax_params(tm, flatten_tree(v))
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    for key in ("semi", "desc_map"):
        assert got[key].shape == ref[key].shape and got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4)

    # postprocess on the same dense outputs: identical keypoints
    kref = jax_postprocess(ref, 64, threshold=0.01)
    kgot = superpoint_postprocess({k: torch.from_numpy(np.array(x)) for k, x in ref.items()}, 64, threshold=0.01)
    np.testing.assert_array_equal(kgot.mask.numpy(), np.asarray(kref.mask))
    np.testing.assert_array_equal(kgot.xy.numpy(), np.asarray(kref.xy))
    np.testing.assert_allclose(kgot.desc.numpy(), np.asarray(kref.desc), rtol=1e-5, atol=1e-6)
    assert kgot.mask.sum() > 0


def _keypoints(seed, b=2, k=24, d=32, n_valid=(24, 17)):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(4, 60, (b, k, 2)).astype(np.float32)
    mask = np.arange(k)[None] < np.asarray(n_valid)[:, None]
    score = (rng.uniform(0.1, 1, (b, k)) * mask).astype(np.float32)
    desc = rng.normal(size=(b, k, d)).astype(np.float32)
    desc = desc / np.linalg.norm(desc, axis=-1, keepdims=True) * mask[..., None]
    arrays = dict(xy=xy, score=score, mask=mask, desc=desc)
    return (JaxKeypoints(**{n: jnp.asarray(a) for n, a in arrays.items()}),
            Keypoints(**{n: torch.from_numpy(a) for n, a in arrays.items()}))


@pytest.mark.parametrize("logits_dtype", ["float32", "bfloat16"])
def test_superglue_matches_einsum_path(logits_dtype):
    kw = dict(descriptor_dim=32, keypoint_encoder=(8, 16), gnn_layers=4,
              sinkhorn_iterations=20, match_threshold=0.01)
    j0, t0 = _keypoints(1)
    j1, t1 = _keypoints(2, n_valid=(20, 24))
    jm = JaxSuperGlue(**kw, attention_impl="einsum", sinkhorn_impl="scan", logits_dtype=logits_dtype)
    v = _perturb(jm.init(jax.random.PRNGKey(3), j0, j1, (48, 64), (48, 64)), 4)
    ref = jm.apply(v, j0, j1, (48, 64), (48, 64))
    tm = SuperGlue(**kw, logits_dtype=logits_dtype, device="cpu")
    load_jax_params(tm, flatten_tree(v))
    with torch.no_grad():
        got = tm(t0, t1, (48, 64), (48, 64))
    z_ref = np.asarray(ref["log_coupling"])
    tol = 1e-4 if logits_dtype == "float32" else 2e-2
    np.testing.assert_allclose(got["log_coupling"].numpy(), z_ref, rtol=tol, atol=tol)
    same = (got["matches0"].numpy() == np.asarray(ref["matches0"])).mean()
    assert same == 1.0 if logits_dtype == "float32" else same >= 0.98
    assert (got["matches0"] >= 0).sum() > 0


def test_matching_end_to_end():
    kw = dict(descriptor_dim=32, keypoint_encoder=(8, 16), gnn_layers=2,
              sinkhorn_iterations=20, max_keypoints=48, keypoint_threshold=0.01,
              match_threshold=0.01, compute_dtype="float32", logits_dtype="float32")
    img0, img1 = _images(5), _images(6)
    jm = JaxMatching(JaxConfig(**kw, s2d_backbone=False, attention_impl="einsum", sinkhorn_impl="scan"))
    v = _perturb(jm.init(jax.random.PRNGKey(7), jnp.asarray(img0), jnp.asarray(img1)), 8)
    ref = jm.apply(v, jnp.asarray(img0), jnp.asarray(img1))
    tm = Matching(MatchingConfig(**kw), device="cpu")
    load_jax_params(tm, flatten_tree(v))
    got = tm(torch.from_numpy(img0), torch.from_numpy(img1))
    for side in ("keypoints0", "keypoints1"):
        for f in dataclasses.fields(Keypoints):
            g, r = getattr(got[side], f.name), getattr(ref[side], f.name)
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
        assert got[side].mask.sum() > 10
    np.testing.assert_allclose(got["log_coupling"].numpy(), np.asarray(ref["log_coupling"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["matches0"].numpy(), np.asarray(ref["matches0"]))
    np.testing.assert_array_equal(got["matches1"].numpy(), np.asarray(ref["matches1"]))
