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

bf16 compute, both packages' default, is held apart (see
`test_bf16_forward_held_to_jax_bf16`): the port's bf16 result is held to
JAX's by how far bf16 moves JAX from its own f32 result.
"""
import dataclasses
from pathlib import Path

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.geometry.warp import warp_image as jax_warp_image
from image_matching_tpu.models import MODEL_REGISTRY as JAX_MODEL_REGISTRY
from image_matching_tpu.models import get_model as jax_get_model
from image_matching_tpu.models.matching import Matching as JaxMatching
from image_matching_tpu.models.matching import MatchingConfig as JaxConfig
from image_matching_tpu.models.superglue import SuperGlue as JaxSuperGlue
from image_matching_tpu.models.superpoint import SuperPointBN as JaxSuperPointBN
from image_matching_tpu.models.superpoint import superpoint_postprocess as jax_postprocess
from image_matching_tpu.structs import Keypoints as JaxKeypoints
from image_matching_tpu.utils.weights import flatten_tree, load_npz_into
from image_matching_tpu_torch.models import MODEL_REGISTRY, Matching, MatchingConfig, SuperGlue, SuperPointBN, get_model
from image_matching_tpu_torch.models.superpoint import superpoint_postprocess
from image_matching_tpu_torch.structs import Keypoints
from image_matching_tpu_torch.weights import load_jax_params, load_npz

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


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


# ---------------------------------------------------------------- bf16 compute

def _textured(seed, h, w):
    """Blocky multi-scale noise plus rectangles: corners and blobs for the
    trained detector."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for cell, amp in ((16, 0.5), (8, 0.3), (4, 0.2)):
        small = rng.uniform(0, 1, (h // cell + 2, w // cell + 2)).astype(np.float32)
        img += amp * np.kron(small, np.ones((cell, cell), np.float32))[:h, :w]
    for _ in range(30):
        y0, x0 = rng.integers(0, h - 12), rng.integers(0, w - 12)
        img[y0:y0 + rng.integers(5, 24), x0:x0 + rng.integers(5, 24)] = rng.uniform(0, 1)
    return (img - img.min()) / (img.max() - img.min())


def _pixel_share(a, b):
    """Share of b's valid keypoints (first image) that a has at the same pixel."""
    sa = {tuple(x) for x, m in zip(a.xy[0].tolist(), a.mask[0].tolist()) if m}
    sb = {tuple(x) for x, m in zip(b.xy[0].tolist(), b.mask[0].tolist()) if m}
    return len(sa & sb) / len(sb)


# XLA's default lets a result the JAX code rounds to bf16 stay in f32
# where the next op reads it in f32 ("excess precision"), which on the CPU
# skips many of the roundings of a bf16 forward. The bf16 reference is
# compiled without it, so it rounds where the JAX code says.
STRICT_BF16 = {"xla_allow_excess_precision": False}


def _fused_entry(next_fun, args, kwargs, context):
    """flax interceptor: the backbone's first ConvBNReLU (`inc`) as the
    JAX package's fused entry kernel (`ops/pallas/entry_h.py`) computes
    it, conv of the rounded image and taps summed in f32, bias and batch
    norm as one f32 affine, ReLU, one rounding, in place of the plain
    chain's conv, bias add and batch norm, each rounded. The port's plain
    backbone runs its first layer so (`ConvBNReLU.entry`, the fused entry
    kernel on the card); in f32 the two are the same function."""
    mod = context.module
    if context.method_name != "__call__" or tuple(mod.path[-2:]) != ("inc", "ConvBNReLU_0"):
        return next_fun(*args, **kwargs)
    p, stats = mod.variables["params"], mod.variables["batch_stats"]["BatchNorm_0"]
    taps = p["Conv_0"]["kernel"].astype(mod.dtype).astype(jnp.float32)
    acc = jax.lax.conv_general_dilated(args[0].astype(jnp.float32), taps, (1, 1), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       precision=jax.lax.Precision.HIGHEST)
    inv = p["BatchNorm_0"]["scale"] * jax.lax.rsqrt(stats["var"] + 1e-5)
    shift = (p["Conv_0"]["bias"] - stats["mean"]) * inv + p["BatchNorm_0"]["bias"]
    return jnp.maximum(acc * inv + shift, 0.0).astype(mod.dtype)


def _jax_jit(fn):
    """jit with STRICT_BF16, tracing under `_fused_entry`."""
    def traced(*args):
        with flax_nn.intercept_methods(_fused_entry):
            return fn(*args)
    return jax.jit(traced, compiler_options=STRICT_BF16)


# For each distance d below: d(port bf16, JAX bf16) <= C_JAX[d] * d(JAX bf16,
# JAX f32) and d(port bf16, port f32) <= C_SELF[d] * d(JAX bf16, JAX f32).
# Measured on the CPU, as ratios to d(JAX bf16, JAX f32): port to JAX
# semi_max 0.27, semi_moved 0.17, z 0.47, kp 0.38, m0 0.73; port to port
# f32 0.98, 1.00, 0.96, 1.38, 1.43. The port run under another order of its
# f32 sums (its bf16 products taken as f32 products, rounded once) landed
# 0.24, -, 0.47, 0.61, 0.11 from itself: the port-to-JAX distances are the
# noise of that order. The earlier probe in `ROADMAP.md` (Queue C) gave
# semi 0.125 against 0.32-0.37 (0.39). semi_moved is the sensitive one: a
# rounding that one side adds or drops (the port's conv bias added before
# the conv's rounding, or JAX's plain first layer against the port's fused
# one) moves 0.52-0.59 of it. kp and m0 count a few items at a cut (one
# keypoint of the top 256 is 0.005, one match 0.009): JAX's f32 conv in
# `_fused_entry` alone, moving SuperGlue's input keypoints, moved m0's
# ratios from 0.45 to 0.73 and 0.99 to 1.43, so both are held looser.
C_JAX = dict(semi_max=0.5, semi_moved=0.3, z=0.6, kp=1.0, m0=1.0)
C_SELF = dict(semi_max=1.25, semi_moved=1.25, z=1.25, kp=2.0, m0=2.0)


def test_bf16_forward_held_to_jax_bf16():
    """One SuperPoint + SuperGlue forward in bf16 on both sides, banked
    weights (`sp_photo` / `sg_photo`, D = 128), a textured 96x128 pair and
    its warp, held to JAX's bf16 result (STRICT_BF16, `_fused_entry`) by
    how far bf16 moves JAX from its own f32 result (C_JAX, C_SELF above).
    Distances: semi's largest difference (semi_max) and the share of its
    entries whose bf16 values differ (semi_moved); the share of keypoints
    at other pixels (kp); the log-coupling's median difference (z) and the
    share of matches that differ (m0), SuperGlue run on the JAX f32
    keypoints on every side and dtype."""
    h, w = 96, 128
    gt = np.array([[0.98, -0.05, 4.0], [0.04, 1.01, -3.0], [5e-5, -3e-5, 1.0]], np.float32)
    img0 = _textured(13, h, w)[None, :, :, None]
    img1 = np.array(jax_warp_image(jnp.asarray(img0), jnp.linalg.inv(jnp.asarray(gt))[None]))
    kw = dict(descriptor_dim=128, keypoint_encoder=(32, 64, 128), sinkhorn_iterations=30, match_threshold=0.1,
              max_keypoints=256, logits_dtype="float32")
    jm = JaxMatching(JaxConfig(**kw, compute_dtype="float32", s2d_backbone=False, attention_impl="einsum",
                               sinkhorn_impl="scan"))
    template = jm.init(jax.random.PRNGKey(0), jnp.asarray(img0), jnp.asarray(img1))
    variables = {c: {name: load_npz_into({c2: template[c2][name] for c2 in template}, str(WEIGHTS / npz))[c]
                     for name, npz in (("superpoint", "sp_photo.npz"), ("superglue", "sg_photo.npz"))}
                 for c in template}
    jf = _jax_jit(jm.apply)(variables, jnp.asarray(img0), jnp.asarray(img1))
    # SuperGlue's second run takes JAX f32's keypoints on every side and dtype
    kp = [jf["keypoints0"], jf["keypoints1"]]
    tkp = [Keypoints(**{f.name: torch.from_numpy(np.array(getattr(k, f.name))) for f in dataclasses.fields(Keypoints)})
           for k in kp]
    x0, x1 = torch.from_numpy(img0), torch.from_numpy(img1)
    res = {}
    for dt in ("float32", "bfloat16"):
        cfg = dict(kw, compute_dtype=dt)
        jm = JaxMatching(JaxConfig(**cfg, s2d_backbone=False, attention_impl="einsum", sinkhorn_impl="scan"))
        run = _jax_jit(jm.apply)
        semi = _jax_jit(lambda v, x: jm.apply(v, x, method=lambda m, x: m.superpoint(x)["semi"]))
        tm = Matching(MatchingConfig(**cfg), device="cpu")
        load_npz(tm.superpoint, str(WEIGHTS / "sp_photo.npz"))
        load_npz(tm.superglue, str(WEIGHTS / "sg_photo.npz"))
        with torch.no_grad():
            tsemi = tm.superpoint(x0)["semi"].float().numpy()
        jout, tout = run(variables, jnp.asarray(img0), jnp.asarray(img1)), tm(x0, x1)
        jsg, tsg = run(variables, jnp.asarray(img0), jnp.asarray(img1), *kp), tm(x0, x1, *tkp)
        res["j", dt] = dict(semi=np.asarray(semi(variables, jnp.asarray(img0)), np.float32), kp=jout["keypoints0"],
                            z=np.asarray(jsg["log_coupling"], np.float32), m0=np.asarray(jsg["matches0"]))
        res["p", dt] = dict(semi=tsemi, kp=tout["keypoints0"], z=tsg["log_coupling"].float().numpy(),
                            m0=tsg["matches0"].numpy())
    valid = res["j", "float32"]["z"] > -1e8  # log-coupling entries of real keypoints
    bf16 = lambda a: torch.tensor(a).bfloat16()

    def dists(a, b):
        a, b = res[a], res[b]
        both = (a["m0"] >= 0) | (b["m0"] >= 0)
        return dict(semi_max=np.abs(a["semi"] - b["semi"]).max(),
                    semi_moved=(bf16(a["semi"]) != bf16(b["semi"])).float().mean().item(),
                    kp=1 - _pixel_share(a["kp"], b["kp"]),
                    z=np.median(np.abs(a["z"] - b["z"])[valid]),
                    m0=(a["m0"] != b["m0"])[both].mean())

    assert (res["p", "float32"]["m0"] == res["j", "float32"]["m0"]).all()
    pj, jj, pp = (dists(("p", "bfloat16"), ("j", "bfloat16")), dists(("j", "bfloat16"), ("j", "float32")),
                  dists(("p", "bfloat16"), ("p", "float32")))
    # bf16 moved JAX's result: the bounds are not vacuous
    assert jj["semi_max"] > 0.1 and jj["semi_moved"] > 0.5 and jj["kp"] > 0.02 and jj["z"] > 0.05 and jj["m0"] > 0.02
    for key in C_JAX:
        assert pj[key] <= C_JAX[key] * jj[key], (key, pj[key], jj[key])
        assert pp[key] <= C_SELF[key] * jj[key], (key, pp[key], jj[key])
    assert (res["p", "bfloat16"]["m0"] >= 0).sum() > 50


@pytest.mark.parametrize("name", ["superpoint_bn", "superpoint_vgg", "superglue"])
def test_get_model_names_the_jax_registry_models(name):
    # the same names; each model built by name carries the JAX model's parameters
    assert set(MODEL_REGISTRY) == set(JAX_MODEL_REGISTRY)
    jm = jax_get_model(name, descriptor_dim=32)
    tm = get_model(name, descriptor_dim=32, device="cpu")
    assert type(tm).__name__ == type(jm).__name__ == MODEL_REGISTRY[name].__name__
    if name == "superglue":
        jm = jax_get_model(name, descriptor_dim=32, keypoint_encoder=(8, 16), gnn_layers=2)
        tm = get_model(name, descriptor_dim=32, keypoint_encoder=(8, 16), gnn_layers=2, device="cpu")
        j0, _ = _keypoints(1)
        variables = jm.init(jax.random.PRNGKey(0), j0, j0, (48, 64), (48, 64))
    else:
        variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(_images(0)))
    load_jax_params(tm, flatten_tree(variables))  # strict: every name and shape
