"""Port's registration path (CPU) vs the JAX package: the descriptor
matchers, the RANSAC pieces and whole estimators on the sample indices
JAX draws, `corner_error`, and the path as a whole: detect -> SuperGlue
-> homography RANSAC on one textured pair through the 2x2 space-to-depth
backbone, with the banked weights.

Every JAX knob that selects an implementation is pinned
(`attention_impl="einsum"`, `sinkhorn_impl="scan"`, both `logits_dtype`
knobs f32, f32 compute). The two packages' random generators differ, so
JAX's own sample indices (`_sample_indices(key, ...)`) are fed to the
port's `*_from_indices` functions.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu import evaluation as jax_evaluation
from image_matching_tpu import registration as jax_registration
from image_matching_tpu.geometry.warp import warp_image as jax_warp_image
from image_matching_tpu.models.matching import Matching as JaxMatching
from image_matching_tpu.models.matching import MatchingConfig as JaxConfig
from image_matching_tpu.ops import matching as jax_matching
from image_matching_tpu.ops import ransac as jax_ransac
from image_matching_tpu.structs import MatchResult as JaxMatchResult
from image_matching_tpu.utils.weights import load_npz_into
from image_matching_tpu_torch import registration
from image_matching_tpu_torch.evaluation import EvalPair, corner_error, evaluate_pipeline
from image_matching_tpu_torch.geometry import homography
from image_matching_tpu_torch.models import Matching, MatchingConfig
from image_matching_tpu_torch.ops import matching, ransac
from image_matching_tpu_torch.structs import MatchResult, RobustFit
from image_matching_tpu_torch.weights import load_npz

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- matchers

def _descriptors(seed, b=2, n0=40, n1=48, d=32, shared=25):
    """Unit descriptors of two sets that share `shared` noisy points, in
    shuffled order, with some slots masked."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(b, shared, d))
    d0 = np.concatenate([base + 0.15 * rng.normal(size=base.shape), rng.normal(size=(b, n0 - shared, d))], 1)
    d1 = np.concatenate([base + 0.15 * rng.normal(size=base.shape), rng.normal(size=(b, n1 - shared, d))], 1)
    d0 = np.stack([x[rng.permutation(n0)] for x in d0])
    d1 = np.stack([x[rng.permutation(n1)] for x in d1])
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)
    mask0 = np.arange(n0)[None] < np.array([n0, n0 - 6])[:b, None]
    mask1 = np.arange(n1)[None] < np.array([n1 - 5, n1])[:b, None]
    return unit(d0), unit(d1), mask0, mask1


def _assert_match_results_equal(got: MatchResult, ref: JaxMatchResult, inverse: bool = True):
    np.testing.assert_array_equal(got.matches0.numpy(), np.asarray(ref.matches0))
    np.testing.assert_allclose(got.scores0.numpy(), np.asarray(ref.scores0), rtol=1e-5, atol=1e-6)
    assert got.matches0.dtype == torch.int32 and (got.matches0 >= 0).sum() > 0
    if inverse:  # defined where every column is claimed at most once
        np.testing.assert_array_equal(got.matches1.numpy(), np.asarray(ref.matches1))
        np.testing.assert_allclose(got.scores1.numpy(), np.asarray(ref.scores1), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cross_check", [True, False])
def test_match_ratio_mutual_matches_jax(cross_check):
    d0, d1, m0, m1 = _descriptors(0)
    ref = jax_matching.match_ratio_mutual(*map(jnp.asarray, (d0, d1, m0, m1)), ratio=0.8, cross_check=cross_check)
    got = matching.match_ratio_mutual(*map(_t, (d0, d1, m0, m1)), ratio=0.8, cross_check=cross_check)
    _assert_match_results_equal(got, ref, inverse=cross_check)


def test_match_mutual_nn_matches_jax():
    d0, d1, m0, m1 = _descriptors(1)
    ref = jax_matching.match_mutual_nn(*map(jnp.asarray, (d0, d1, m0, m1)), max_dist=0.9)
    got = matching.match_mutual_nn(*map(_t, (d0, d1, m0, m1)), max_dist=0.9)
    _assert_match_results_equal(got, ref)
    unbounded = matching.match_mutual_nn(*map(_t, (d0, d1, m0, m1)))
    assert (unbounded.matches0 >= 0).sum() >= (got.matches0 >= 0).sum()


def test_ratio_gate_matches_jax():
    d0, d1, m0, m1 = _descriptors(2)
    base = jax_matching.match_mutual_nn(*map(jnp.asarray, (d0, d1, m0, m1)))
    ref = jax_matching.ratio_gate_matches(base, *map(jnp.asarray, (d0, d1, m0, m1)), gate=0.8)
    tbase = MatchResult(*(_t(getattr(base, f.name)) for f in dataclasses.fields(MatchResult)))
    got = matching.ratio_gate_matches(tbase, *map(_t, (d0, d1, m0, m1)), gate=0.8)
    _assert_match_results_equal(got, ref)
    assert (got.matches0 >= 0).sum() < (tbase.matches0 >= 0).sum()  # the gate dropped some


def test_match_hamming_matches_jax():
    rng = np.random.default_rng(3)
    bits0 = rng.integers(0, 256, (2, 30, 32), dtype=np.uint8)
    bits1 = bits0[:, rng.permutation(30)].copy()
    bits1[:, :, 0] ^= rng.integers(0, 4, (2, 30), dtype=np.uint8)  # a few flipped bits
    m0 = np.arange(30)[None] < np.array([30, 22])[:, None]
    m1 = np.arange(30)[None] < np.array([27, 30])[:, None]
    ref = jax_matching.match_hamming(*map(jnp.asarray, (bits0, bits1, m0, m1)))
    got = matching.match_hamming(*map(_t, (bits0, bits1, m0, m1)))
    _assert_match_results_equal(got, ref)


def test_pairwise_sqdist_and_gather_match_jax():
    d0, d1, m0, m1 = _descriptors(4)
    np.testing.assert_allclose(matching.pairwise_sqdist(_t(d0), _t(d1)).numpy(),
                               np.asarray(jax_matching.pairwise_sqdist(jnp.asarray(d0), jnp.asarray(d1))),
                               rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(5)
    xy0, xy1 = rng.uniform(0, 64, (2, 40, 2)).astype(np.float32), rng.uniform(0, 64, (2, 48, 2)).astype(np.float32)
    res = jax_matching.match_mutual_nn(*map(jnp.asarray, (d0, d1, m0, m1)))
    tres = MatchResult(*(_t(getattr(res, f.name)) for f in dataclasses.fields(MatchResult)))
    for g, r in zip(matching.gather_matched_points(_t(xy0), _t(xy1), tres),
                    jax_matching.gather_matched_points(jnp.asarray(xy0), jnp.asarray(xy1), res)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------- RANSAC

GT_SIM = np.array([[0.95, -0.12, 7.0], [0.12, 0.95, -4.0]], np.float32)
GT_HOM = np.array([[1.02, -0.08, 5.0], [0.06, 0.97, -3.0], [1.5e-4, -1e-4, 1.0]], np.float32)


def _apply(mat, pts):
    if mat.shape == (2, 3):
        return pts @ mat[:, :2].T + mat[:, 2]
    hom = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1) @ mat.T
    return hom[:, :2] / hom[:, 2:3]


def _correspondences(gt, seed, n=96, n_valid=80, outliers=25):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    p1 = (_apply(gt, p0) + rng.normal(0, 0.4, (n, 2))).astype(np.float32)
    p1[:outliers] = rng.uniform(0, 200, (outliers, 2))
    valid = np.arange(n) < n_valid
    weights = rng.uniform(0.2, 1.0, n).astype(np.float32)
    weights[:outliers] *= 0.3
    return p0, p1, valid, weights


def test_ransac_pieces_match_jax():
    rng = np.random.default_rng(6)
    s0, s1 = rng.uniform(0, 100, (7, 2, 2)).astype(np.float32), rng.uniform(0, 100, (7, 2, 2)).astype(np.float32)
    np.testing.assert_allclose(ransac.similarity_from_2pts(_t(s0), _t(s1)).numpy(),
                               np.asarray(jax_ransac.similarity_from_2pts(jnp.asarray(s0), jnp.asarray(s1))),
                               rtol=1e-4, atol=1e-4)
    for gt, fit, jfit in ((GT_SIM, ransac.fit_similarity_lsq, jax_ransac.fit_similarity_lsq),
                          (GT_HOM, ransac.fit_homography_lsq, jax_ransac.fit_homography_lsq)):
        p0, p1, _, w = _correspondences(gt, 7, outliers=0)
        ref = np.asarray(jfit(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(w)))
        np.testing.assert_allclose(fit(_t(p0), _t(p1), _t(w)).numpy(), ref, rtol=1e-4, atol=1e-4)
        assert corner_error(ref, gt, 200, 200) < 0.5  # and both recover the transform (0.4 px noise)
        # batched, where the JAX package uses vmap
        both = fit(_t(np.stack([p0, p0[::-1]])), _t(np.stack([p1, p1[::-1]])), _t(np.stack([w, w[::-1]])))
        np.testing.assert_allclose(both[1].numpy(), ref, rtol=1e-3, atol=1e-3)
    res = rng.uniform(0, 100, (5, 40)).astype(np.float32)
    valid = rng.uniform(size=40) < 0.8
    inl, score = ransac.consensus(_t(res), _t(valid), 7.0)
    jinl, jscore = jax_ransac._consensus(jnp.asarray(res), jnp.asarray(valid), 7.0)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-5)


def _assert_fits_equal(got: RobustFit, ref, gt):
    assert bool(got.valid) and bool(ref.valid)
    np.testing.assert_allclose(got.matrix.numpy(), np.asarray(ref.matrix), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers) >= 50
    assert corner_error(got.matrix.numpy(), gt, 200, 200) < 1.0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("model", ["similarity", "homography"])
def test_ransac_from_jax_indices_matches_jax(model, weighted):
    gt, k = (GT_SIM, 2) if model == "similarity" else (GT_HOM, 4)
    p0, p1, valid, w = _correspondences(gt, 8)
    wj = jnp.asarray(w) if weighted else None
    key = jax.random.PRNGKey(9)
    idx = np.asarray(jax_ransac._sample_indices(key, jnp.asarray(valid), 256, k, wj))
    jfn = jax_ransac.ransac_similarity if model == "similarity" else jax_ransac.ransac_homography
    ref = jfn(key, jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid), threshold=3.0,
              num_hypotheses=256, weights=wj)
    fn = ransac.ransac_similarity_from_indices if model == "similarity" else ransac.ransac_homography_from_indices
    got = fn(_t(idx), _t(p0), _t(p1), _t(valid), threshold=3.0, weights=_t(w) if weighted else None)
    _assert_fits_equal(got, ref, gt)


@pytest.mark.parametrize("model", ["similarity", "homography"])
def test_ransac_draws_its_own_samples_and_refuses_too_few(model):
    gt, fn = (GT_SIM, ransac.ransac_similarity) if model == "similarity" else (GT_HOM, ransac.ransac_homography)
    p0, p1, valid, w = _correspondences(gt, 10)
    gen = torch.Generator().manual_seed(0)
    # a batch of two problems: the second has too few valid matches
    few = valid & (np.arange(len(valid)) >= 77)  # 3 valid ones: slots 77-79
    fit = fn(gen, _t(np.stack([p0, p0])), _t(np.stack([p1, p1])), _t(np.stack([valid, few])),
             threshold=3.0, num_hypotheses=256, weights=_t(np.stack([w, w])))
    assert fit.valid.tolist() == [True, False]
    assert corner_error(fit.matrix[0].numpy(), gt, 200, 200) < 1.0
    identity = np.eye(3, dtype=np.float32)[:fit.matrix.shape[-2]]
    np.testing.assert_array_equal(fit.matrix[1].numpy(), identity)
    assert int(fit.num_inliers[1]) == 0 and not fit.inliers[1].any()
    idx = ransac.sample_indices(gen, _t(np.stack([valid, few])), 64, 4, _t(np.stack([w, w])))
    assert idx.shape == (2, 64, 4) and bool(_t(few)[idx[1]].all())  # samples come from valid slots only
    none = ransac.sample_indices(gen, torch.zeros(5, dtype=torch.bool), 8, 2)
    assert none.shape == (8, 2)  # no valid slot: drawn uniformly, no error


# ---------------------------------------------------------------- geometry, evaluation

def test_homography_helpers_match_jax():
    from image_matching_tpu.geometry import homography as jh

    rng = np.random.default_rng(11)
    pts = rng.uniform(-5, 70, (3, 9, 2)).astype(np.float32)
    for name in ("normalize_points", "denormalize_points", "points_in_bounds"):
        np.testing.assert_allclose(getattr(homography, name)(_t(pts), 48, 64).numpy(),
                                   np.asarray(getattr(jh, name)(jnp.asarray(pts), 48, 64)), rtol=1e-6, atol=1e-6)
    for to_norm in (False, True):
        np.testing.assert_allclose(homography.scale_homography(_t(GT_HOM), 48, 64, to_norm).numpy(),
                                   np.asarray(jh.scale_homography(jnp.asarray(GT_HOM), 48, 64, to_norm)),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(homography.identity_homography().numpy(), np.eye(3, dtype=np.float32))
    # a degenerate 4-point sample raises by default and gives NaN when asked
    src = np.zeros((1, 4, 2), np.float32)
    with pytest.raises(RuntimeError):
        homography.homography_from_4pts(_t(src), _t(src))
    assert torch.isnan(homography.homography_from_4pts(_t(src), _t(src), check=False)[0, 0, 0])


def test_registration_helpers_match_jax():
    np.testing.assert_array_equal(registration.affine_to_homography(_t(GT_SIM)).numpy(),
                                  np.asarray(jax_registration.affine_to_homography(jnp.asarray(GT_SIM))))
    for mat in (GT_SIM, GT_HOM):
        np.testing.assert_allclose(registration.rescale_transform(_t(mat), 0.5).numpy(),
                                   np.asarray(jax_registration.rescale_transform(jnp.asarray(mat), 0.5)),
                                   rtol=1e-6, atol=1e-6)
    for gt in (GT_SIM, GT_HOM):
        p0, p1, valid, _ = _correspondences(gt, 12, outliers=0)
        inl = np.arange(len(valid)) % 3 > 0
        fit = RobustFit(_t(gt), _t(inl), _t(np.array(inl.sum())), _t(np.array(True)))
        jfit = jax_ransac.RobustFit(jnp.asarray(gt), jnp.asarray(inl), jnp.asarray(inl.sum()), jnp.asarray(True))
        got = registration.reprojection_error(fit, _t(p0), _t(p1), _t(valid))
        ref = jax_registration.reprojection_error(jfit, jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-4)
        assert 0.1 < float(got) < 1.5  # the 0.4 px noise


@pytest.mark.parametrize("est,gt", [(GT_SIM, GT_HOM), (GT_HOM, GT_SIM), (GT_SIM, GT_SIM + 0.01), (GT_HOM, GT_HOM * 2)])
def test_corner_error_matches_the_cv2_version(est, gt):
    ref = jax_evaluation.corner_error(est, gt, 240, 320)  # OpenCV's perspectiveTransform
    assert corner_error(est, gt, 240, 320) == pytest.approx(ref, rel=1e-5, abs=1e-5)


def test_corner_error_by_hand():
    shift = np.array([[1, 0, 3.0], [0, 1, 4.0]], np.float32)
    assert corner_error(shift, np.eye(3, dtype=np.float32), 100, 200) == pytest.approx(5.0)


# ---------------------------------------------------------------- the path as a whole

def _textured(rng, h, w):
    """Smooth multi-scale noise plus rectangles: corners and blobs for a
    trained detector."""
    img = np.zeros((h, w), np.float32)
    for cell, amp in ((16, 0.5), (8, 0.3), (4, 0.2)):
        small = rng.uniform(0, 1, (h // cell + 2, w // cell + 2)).astype(np.float32)
        big = np.kron(small, np.ones((cell, cell), np.float32))[:h, :w]
        img += amp * big
    for _ in range(30):
        y0, x0 = rng.integers(0, h - 12), rng.integers(0, w - 12)
        img[y0:y0 + rng.integers(5, 24), x0:x0 + rng.integers(5, 24)] = rng.uniform(0, 1)
    return (img - img.min()) / (img.max() - img.min())


@pytest.fixture(scope="module")
def registered_pair():
    """One textured 96x128 pair related by a known homography, registered
    by the JAX package and by the port (same banked weights, 2x2 s2d
    backbone, SuperGlue matcher, homography RANSAC, JAX's sample indices)."""
    h, w, k, hyp = 96, 128, 128, 256
    gt = np.array([[0.98, -0.05, 4.0], [0.04, 1.01, -3.0], [5e-5, -3e-5, 1.0]], np.float32)
    img0 = _textured(np.random.default_rng(13), h, w)[None, :, :, None]
    img1 = np.array(jax_warp_image(jnp.asarray(img0), jnp.linalg.inv(jnp.asarray(gt))[None]))
    kw = dict(descriptor_dim=128, keypoint_encoder=(32, 64, 128), sinkhorn_iterations=30, match_threshold=0.1,
              max_keypoints=k, compute_dtype="float32", logits_dtype="float32", backbone="bn",
              s2d_backbone=True, s2d_layout="2x2")
    reg_kw = dict(matcher="superglue", ransac_model="homography", ransac_threshold=3.0,
                  num_hypotheses=hyp, min_match_count=8, produce_warp=True)

    jm = JaxMatching(JaxConfig(**kw, attention_impl="einsum", sinkhorn_impl="scan"))
    template = jm.init(jax.random.PRNGKey(0), jnp.asarray(img0), jnp.asarray(img1))
    variables = {
        "params": {"superpoint": load_npz_into({c: template[c]["superpoint"] for c in template},
                                               str(WEIGHTS / "sp_photo.npz"))["params"],
                   "superglue": load_npz_into({c: template[c]["superglue"] for c in template},
                                              str(WEIGHTS / "sg_photo.npz"))["params"]},
        "batch_stats": {"superpoint": load_npz_into({c: template[c]["superpoint"] for c in template},
                                                    str(WEIGHTS / "sp_photo.npz"))["batch_stats"],
                        "superglue": load_npz_into({c: template[c]["superglue"] for c in template},
                                                   str(WEIGHTS / "sg_photo.npz"))["batch_stats"]},
    }
    key = jax.random.PRNGKey(1)
    ref = jax.jit(jax_registration.build_registration_fn(jm, **reg_kw))(
        variables, jnp.asarray(img0), jnp.asarray(img1), key)
    # the samples JAX drew: one key per batch element, weights = confidences
    _, _, valid = jax.vmap(jax_matching.gather_matched_points)(ref.kpts0.xy, ref.kpts1.xy, ref.matches)
    weights = jnp.where(ref.matches.matches0 >= 0, ref.matches.scores0, 0.0)
    keys = jax.random.split(key, 1)
    idx = np.stack([np.asarray(jax_ransac._sample_indices(keys[i], valid[i], hyp, 4, weights[i]))
                    for i in range(1)])

    tm = Matching(MatchingConfig(**kw), device="cpu")
    load_npz(tm.superpoint, str(WEIGHTS / "sp_photo.npz"))
    load_npz(tm.superglue, str(WEIGHTS / "sg_photo.npz"))
    register = registration.build_registration_fn(tm, **reg_kw)
    got = register(_t(img0), _t(img1), indices=_t(idx))
    return dict(gt=gt, ref=ref, got=got, register=register, img0=img0, img1=img1, shape=(h, w))


def test_registration_keypoints_and_matches_equal_jax(registered_pair):
    got, ref = registered_pair["got"], registered_pair["ref"]
    for side in ("kpts0", "kpts1"):
        g, r = getattr(got, side), getattr(ref, side)
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(r.mask))
        np.testing.assert_array_equal(g.xy.numpy(), np.asarray(r.xy))
        np.testing.assert_allclose(g.desc.numpy(), np.asarray(r.desc), rtol=1e-4, atol=1e-4)
        assert int(g.mask.sum()) >= 40
    np.testing.assert_array_equal(got.matches.matches0.numpy(), np.asarray(ref.matches.matches0))
    np.testing.assert_allclose(got.matches.scores0.numpy(), np.asarray(ref.matches.scores0), rtol=1e-3, atol=1e-4)
    assert int(got.matches.num_matches()[0]) >= 20


def test_registration_fit_within_005px_of_jax(registered_pair):
    got, ref, gt = registered_pair["got"], registered_pair["ref"], registered_pair["gt"]
    h, w = registered_pair["shape"]
    assert bool(got.fit.valid[0]) and bool(ref.fit.valid[0])
    err = corner_error(got.fit.matrix[0].numpy(), gt, h, w)
    err_ref = corner_error(np.asarray(ref.fit.matrix[0]), gt, h, w)
    assert abs(err - err_ref) <= 0.05 and err < 3.0
    np.testing.assert_array_equal(got.fit.inliers.numpy(), np.asarray(ref.fit.inliers))
    # image 0 warped into image 1's frame: the same picture as JAX's, and close to image 1
    np.testing.assert_allclose(got.warped.numpy(), np.asarray(ref.warped), atol=2e-2)
    inside = got.warped.numpy()[0, 12:-12, 12:-12, 0]
    assert np.abs(inside - registered_pair["img1"][0, 12:-12, 12:-12, 0]).mean() < 0.05


def test_evaluate_pipeline_on_the_pair(registered_pair):
    p = registered_pair
    pair = EvalPair(p["img0"][0], p["img1"][0], p["gt"])
    gen = torch.Generator().manual_seed(3)
    out = evaluate_pipeline(p["register"], [pair, pair], gen, per_pair=True)
    assert out["n_pairs"] == 2 and out["success_rate"] == 1.0 and out["fit_valid_rate"] == 1.0
    assert out["median_corner_err_px"] < 3.0 and out["mean_matches"] >= 20
    assert len(out["per_pair"]) == 2 and out["per_pair"][0]["inliers"] >= 8


def test_ratio_matcher_and_similarity_model_run(registered_pair):
    """The other matcher and model, with the sg_ratio_gate: they run and
    give a sane fit on the same pair (a near-similarity)."""
    p = registered_pair
    tm = Matching(MatchingConfig.self_trained_128(), device="cpu")  # plain backbone, default knobs
    tm = Matching(dataclasses.replace(tm.config, max_keypoints=128, compute_dtype="float32"), device="cpu")
    load_npz(tm.superpoint, str(WEIGHTS / "sp_photo.npz"))
    load_npz(tm.superglue, str(WEIGHTS / "sg_photo.npz"))
    gen = torch.Generator().manual_seed(4)
    for kw in (dict(matcher="ratio", ratio=0.9), dict(matcher="superglue", sg_ratio_gate=0.95)):
        reg = registration.build_registration_fn(tm, ransac_threshold=3.0, num_hypotheses=256,
                                                 min_match_count=8, produce_warp=False, **kw)
        res = reg(_t(p["img0"]), _t(p["img1"]), gen)
        assert res.warped is None and bool(res.fit.valid[0]) and res.fit.matrix.shape == (1, 2, 3)
        assert corner_error(res.fit.matrix[0].numpy(), p["gt"], *p["shape"]) < 5.0
    with pytest.raises(ValueError, match="torch.Generator"):
        reg(_t(p["img0"]), _t(p["img1"]))  # neither a generator nor sample indices
    with pytest.raises(ValueError, match="unknown matcher"):
        registration.build_registration_fn(tm, matcher="flann")
