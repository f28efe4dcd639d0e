"""The port's evaluation (`imgproc.py`, the pair makers of `evaluation.py`,
`cli/evaluate.py`) against OpenCV and the JAX package, on the CPU.

`cv2` is imported here only, to hold the numpy image ops to it; the port
never imports it. Tolerances:

  * resize, blur, both warps, `get_perspective_transform`: within 1e-5 of
    `cv2` (float32 sums in another order; the warps follow OpenCV 5's float32
    arithmetic and come out equal);
  * `circle`, `fill_poly` of the convex 4-gons the makers draw (inside the
    image or leaving it) and of polygons inside the image, `line` of
    thickness 1-3: equal on every pixel;
  * the pair makers against the JAX package's, at 96x128: the ground-truth
    matrices to 1e-6 (the perspective solve in float64 by another LU), the
    images within 1e-4 on at least 99.5% of their pixels;
  * the CLI against the JAX package's `evaluate_pipeline` on the same pairs
    and weights, f32, the H layout: the same keypoints and matches, as sets
    of points (see `_same_points`), corner errors within 0.1 px a pair (the
    two RANSACs draw other samples), the same success count.
"""
import json
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu import evaluation as jax_evaluation
from image_matching_tpu.models.matching import Matching as JaxMatching
from image_matching_tpu.models.matching import MatchingConfig as JaxConfig
from image_matching_tpu.registration import build_registration_fn as jax_build_registration_fn
from image_matching_tpu.utils.weights import load_npz_into
from image_matching_tpu_torch import evaluation, imgproc
from image_matching_tpu_torch.cli import evaluate as cli
from image_matching_tpu_torch.registration import build_registration_fn
from test_torch_features import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "weights"


# ---------------------------------------------------------------- image ops

@pytest.mark.parametrize("src,dst", [((10, 12), (128, 96)), ((9, 12), (640, 480)), ((17, 22), (320, 240))])
def test_resize_cubic_matches_cv2(src, dst):
    g = np.random.default_rng(0).uniform(0, 1, src).astype(np.float32)
    ref = cv2.resize(g, dst, interpolation=cv2.INTER_CUBIC)
    got = imgproc.resize(g, dst)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("sigma", [0.8, 1.0, 1.5, 2.0, 128 / 24, 640 / 24])
def test_gaussian_blur_matches_cv2(sigma):
    h, w = (480, 640) if sigma > 20 else (96, 128)
    img = np.random.default_rng(1).uniform(0, 1, (h, w)).astype(np.float32)
    assert np.abs(imgproc.gaussian_blur(img, sigma) - cv2.GaussianBlur(img, (0, 0), sigma)).max() <= 1e-5


def test_warps_and_perspective_transform_match_cv2():
    rng = np.random.default_rng(2)
    for h, w in ((96, 128), (240, 320)):
        img = rng.uniform(0, 1, (h, w)).astype(np.float32)
        for _ in range(4):
            ang, sc, (tx, ty) = rng.uniform(-0.25, 0.25), rng.uniform(0.9, 1.1), rng.uniform(-24, 24, 2)
            c, s = np.cos(ang) * sc, np.sin(ang) * sc
            cx, cy = w / 2, h / 2
            mat = np.float32([[c, -s, tx + cx - c * cx + s * cy], [s, c, ty + cy - s * cx - c * cy]])
            assert np.abs(imgproc.warp_affine(img, mat, (w, h)) - cv2.warpAffine(img, mat, (w, h))).max() <= 1e-5
            corners = np.float32([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]])
            dst = corners @ mat[:, :2].T + mat[:, 2] + rng.uniform(-20, 20, (4, 2)).astype(np.float32)
            hom = cv2.getPerspectiveTransform(corners, dst)
            assert np.abs(imgproc.get_perspective_transform(corners, dst) - hom).max() <= 1e-5
            got = imgproc.warp_perspective(img, hom, (w, h))
            assert np.abs(got - cv2.warpPerspective(img, hom, (w, h))).max() <= 1e-5


def _rotated_rect(rng, w, h):
    """The makers' occluding rectangle (`photo_texture`), as int32 points."""
    x0, y0 = rng.uniform([0, 0], [w - 20, h - 20])
    wid, hei = rng.uniform(12, w / 3), rng.uniform(12, h / 3)
    pts = np.array([[x0, y0], [x0 + wid, y0], [x0 + wid, y0 + hei], [x0, y0 + hei]], np.float32)
    ang = rng.uniform(0, np.pi)
    c, s = np.cos(ang), np.sin(ang)
    ctr = pts.mean(0)
    return ((pts - ctr) @ np.array([[c, -s], [s, c]], np.float32).T + ctr).astype(np.int32)


def _draw_both(h, w, cv2_draw, port_draw):
    a, b = np.zeros((h, w), np.float32), np.zeros((h, w), np.float32)
    cv2_draw(a)
    port_draw(b)
    return int((a != b).sum()), int((a != 0).sum())


def test_fill_poly_equals_cv2_on_every_pixel():
    rng = np.random.default_rng(3)
    leaving, painted = 0, 0
    for t in range(600):
        h, w = ((96, 128), (64, 64), (480, 640))[t % 3]
        pts = _rotated_rect(rng, w, h)
        leaving += not ((pts >= 0).all() and (pts[:, 0] < w).all() and (pts[:, 1] < h).all())
        diff, n = _draw_both(h, w, lambda im: cv2.fillPoly(im, [pts], 0.5),
                             lambda im: imgproc.fill_poly(im, pts, 0.5))
        assert diff == 0, pts.tolist()
        painted += n
    assert leaving > 50 and painted > 0
    for _ in range(300):  # any polygon inside the image, self-intersecting ones too
        pts = rng.integers(0, 64, (int(rng.integers(3, 9)), 2)).astype(np.int32)
        diff, _ = _draw_both(64, 80, lambda im: cv2.fillPoly(im, [pts], 1.0), lambda im: imgproc.fill_poly(im, pts, 1.0))
        assert diff == 0, pts.tolist()


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_line_equals_cv2_on_every_pixel(thickness):
    rng = np.random.default_rng(4 + thickness)
    for t in range(200):
        h, w = (96, 128) if t % 2 else (480, 640)
        p0, p1 = (tuple(rng.uniform([0, 0], [w, h]).astype(int)) for _ in range(2))
        diff, n = _draw_both(h, w, lambda im: cv2.line(im, p0, p1, 0.3, thickness),
                             lambda im: imgproc.line(im, p0, p1, 0.3, thickness))
        assert diff == 0 and n > 0, (p0, p1)


def test_filled_circle_equals_cv2_on_every_pixel():
    rng = np.random.default_rng(8)
    for t in range(300):
        h, w = (96, 128) if t % 2 else (480, 640)
        c = tuple(rng.uniform([16, 16], [w - 16, h - 16]).astype(int))
        r = int(rng.uniform(0, 40))  # the makers' radii are 2-23; larger ones leave the image
        diff, n = _draw_both(h, w, lambda im: cv2.circle(im, c, r, 0.7, -1), lambda im: imgproc.circle(im, c, r, 0.7))
        assert diff == 0 and n > 0, (c, r)


# ---------------------------------------------------------------- pair makers

@pytest.mark.parametrize("kw", [
    dict(texture="photo"),
    dict(texture="blobs"),
    dict(texture="noise"),
    dict(texture="photo", gt_model="perspective", max_perspective=48.0),
    dict(texture="photo", photo_asym=True),
    dict(texture="blobs", gt_model="perspective", max_perspective=24.0, photo_asym=True),
])
def test_pair_makers_draw_the_jax_makers_numbers(kw):
    ref = jax_evaluation.make_eval_pairs(np.random.default_rng(7), 3, 96, 128, max_shift=48.0, **kw)
    got = evaluation.make_eval_pairs(np.random.default_rng(7), 3, 96, 128, max_shift=48.0, **kw)
    for g, r in zip(got, ref):
        assert g.gt_matrix.shape == r.gt_matrix.shape and g.gt_matrix.dtype == np.float32
        assert np.abs(g.gt_matrix - r.gt_matrix).max() <= 1e-6
        for a, b in ((g.template, r.template), (g.source, r.source)):
            assert a.shape == b.shape == (96, 128, 1) and a.dtype == np.float32
            assert (np.abs(a - b) <= 1e-4).mean() >= 0.995


# ---------------------------------------------------------------- the CLI

CPU_ARGS = ["--device", "cpu", "--n_pairs", "3", "--height", "240", "--width", "320", "--max_keypoints", "256",
            "--sp_checkpoint", str(WEIGHTS / "sp_photo.npz"), "--sg_checkpoint", str(WEIGHTS / "sg_photo.npz"),
            "--per_pair"]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX CLI's model at f32 with the H layout and the banked weights,
    its pairs (the JAX makers) and its per-config results."""
    args = cli.parse_args(CPU_ARGS)
    pairs = jax_evaluation.make_eval_pairs(np.random.default_rng(args.seed), args.n_pairs, args.height, args.width,
                                           max_angle=args.max_angle, max_shift=args.max_shift, texture=args.texture,
                                           gt_model=args.gt, max_perspective=args.max_perspective)
    cfg = JaxConfig(backbone="bn", descriptor_dim=128, max_keypoints=args.max_keypoints, keypoint_threshold=0.005,
                    subpixel=True, keypoint_encoder=(32, 64, 128), sinkhorn_iterations=30, match_threshold=0.1,
                    s2d_backbone=True, s2d_layout="h", compute_dtype="float32", logits_dtype="float32",
                    attention_impl="einsum", sinkhorn_impl="scan")
    jm = JaxMatching(cfg)
    ex = jnp.zeros((1, args.height, args.width, 1))
    template = jax.jit(jm.init)(jax.random.PRNGKey(0), ex, ex)
    loaded = {name: load_npz_into({c: template[c][name] for c in template}, str(WEIGHTS / npz))
              for name, npz in (("superpoint", "sp_photo.npz"), ("superglue", "sg_photo.npz"))}
    variables = {c: {name: loaded[name][c] for name in loaded} for c in template}
    fns, results = {}, {}
    for name in ("sp", "spsg"):
        fns[name] = jax.jit(jax_build_registration_fn(
            jm, matcher="ratio" if name == "sp" else "superglue", ransac_model="similarity",
            ransac_threshold=7.0, min_match_count=8, produce_warp=False))
        results[name] = jax_evaluation.evaluate_pipeline(
            lambda t, s, k, fn=fns[name]: fn(variables, t, s, k), pairs, jax.random.PRNGKey(args.seed + 1),
            5.0, batched=True, per_pair=True)
    return dict(args=args, pairs=pairs, fns=fns, variables=variables, results=results)


def _same_points(a, b, tol=5e-3):
    """Two sets of points (rows), equal up to `tol` (px) and in any order.
    The heatmap is bf16 on both sides, so keypoints tie at equal scores and
    one f32 sum's last bit orders their slots; the subpixel refinement's
    softmax sums in another order (1e-4 and 1e-5 relative, as in
    test_torch_backbones.py::test_subpixel_postprocess_matches_jax)."""
    if len(a) != len(b):
        return False
    d = np.abs(a[:, None] - b[None]).max(-1)
    return bool((d.min(1) <= tol).all() and (d.min(0) <= tol).all())


def test_cli_matches_jax_evaluation(jax_side):
    args = jax_side["args"]
    pairs = cli.make_pairs(args)
    for g, r in zip(pairs, jax_side["pairs"]):
        assert np.abs(g.gt_matrix - r.gt_matrix).max() <= 1e-6
    model = cli.build_model(args, compute_dtype="float32", logits_dtype="float32")
    assert model.config.s2d_backbone and model.config.s2d_layout == "h"
    results = cli.evaluate_configs(model, pairs, args)
    for name in ("sp", "spsg"):
        got, ref = results[name], jax_side["results"][name]
        assert set(got) == set(ref) | {"wall_s_total"}
        # the same keypoints and matches on every pair
        register = build_registration_fn(model, matcher="ratio" if name == "sp" else "superglue",
                                         ransac_model="similarity", ransac_threshold=7.0, min_match_count=8,
                                         produce_warp=False)
        for i, p in enumerate(pairs):
            t, s = torch.from_numpy(p.template)[None], torch.from_numpy(p.source)[None]
            res = register(t, s, torch.Generator().manual_seed(0))
            jr = jax_side["fns"][name](jax_side["variables"], jnp.asarray(t.numpy()), jnp.asarray(s.numpy()),
                                       jax.random.PRNGKey(0))
            points = {}
            for pkg, r in (("port", res), ("jax", jr)):
                xy0, xy1 = np.asarray(r.kpts0.xy[0]), np.asarray(r.kpts1.xy[0])
                m0 = np.asarray(r.matches.matches0[0])
                points[pkg] = (xy0[np.asarray(r.kpts0.mask[0])], xy1[np.asarray(r.kpts1.mask[0])],
                               np.concatenate([xy0[m0 >= 0], xy1[m0[m0 >= 0]]], axis=1))
            for a, b in zip(points["port"], points["jax"]):  # keypoints of each image, matched pairs
                assert _same_points(a, b)
            assert got["per_pair"][i]["matches"] == ref["per_pair"][i]["matches"] >= 50
        errs = [(a["corner_err_px"], b["corner_err_px"]) for a, b in zip(got["per_pair"], ref["per_pair"])]
        assert all(a is not None and b is not None and abs(a - b) <= 0.1 for a, b in errs), errs
        assert round(got["success_rate"] * got["n_pairs"]) == round(ref["success_rate"] * ref["n_pairs"]) == 3


def test_cli_main_at_its_defaults_writes_the_jax_clis_json(tmp_path):
    """bf16, the H layout, similarity RANSAC and the JAX CLI's default
    configs (sift, orb, sp, spsg) on one small pair; the JSON has the keys
    of the JAX CLI's own output."""
    out = tmp_path / "eval.json"
    results = cli.main(["--device", "cpu", "--n_pairs", "1", "--height", "96", "--width", "128", "--max_keypoints",
                        "128", "--sp_checkpoint", str(WEIGHTS / "sp_photo.npz"), "--sg_checkpoint",
                        str(WEIGHTS / "sg_photo.npz"), "--out", str(out)])
    written = json.loads(out.read_text())
    jax_keys = {k: set(v) for name in ("EVAL_reference_regime.json", "EVAL_classical_photo.json")
                for k, v in json.loads((ROOT / name).read_text()).items()}
    assert list(written) == ["sift", "orb", "sp", "spsg"] and written == json.loads(json.dumps(results))
    for name, res in written.items():
        assert set(res) == jax_keys[name]
        assert res["n_pairs"] == 1
        if name in ("sp", "spsg"):
            assert res["fit_valid_rate"] == 1.0
