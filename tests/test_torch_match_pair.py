"""The port's registration CLI and what it needs (`cli/match_pair.py`,
`utils/viz.py`, `weights.load_magicleap_superglue`,
`train/checkpoint.load_submodule_checkpoints`) against the JAX package,
on the CPU.

Tolerances:
  * the official SuperGlue state dict (synthetic, with the official names)
    loaded by `load_magicleap_superglue` against the JAX package's
    `convert_superglue` fed the same dict: the same `log_coupling` in f32
    within 1e-4;
  * `make_matching_plot` / `draw_keypoints`: the canvas of the JAX package's
    plots; every pixel further than 2 px from a mark equal (OpenCV's
    anti-aliased marks, which the JAX package draws, are not reproduced);
  * the CLI against the JAX CLI on the same PNG files and the banked npz
    weights (which the JAX package wrote with `save_npz`), both matchers,
    f32 compute on both sides: each pair's corner error against the known
    shift within 0.1 px of the JAX CLI's (the tolerance of
    `test_torch_evaluate.py`; the two RANSACs draw other samples). The
    pairs are registered at 240x320 (480x640 files, `--resize_scale 0.5`):
    at 96x96 SuperGlue with the banked weights matches mostly wrongly
    (10-22 of ~50 matches within 2 px on pure shifts, fits 4-80 px off in
    both packages), so there a transform is decided by the samples RANSAC
    happens to draw. At 240x320 both CLIs fit within 0.1-1.7 px and agree
    within 0.011 px (measured over three textures).
"""
import functools
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from image_matching_tpu.cli import match_pair as jax_cli
from image_matching_tpu.models.matching import MatchingConfig as JaxConfig
from image_matching_tpu.models.superglue import SuperGlue as JaxSuperGlue
from image_matching_tpu.utils import viz as jax_viz
from image_matching_tpu.utils.torch_convert import convert_superglue
from image_matching_tpu_torch import evaluation, imgproc
from image_matching_tpu_torch.cli import match_pair as cli
from image_matching_tpu_torch.models import SuperGlue
from image_matching_tpu_torch.models.matching import MatchingConfig
from image_matching_tpu_torch.utils import viz
from image_matching_tpu_torch.weights import load_magicleap_superglue

from test_torch_convert import build_torch_superglue_state
from test_torch_train import _keypoint_pair

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


# ---------------------------------------------------------------- official SuperGlue weights

@pytest.mark.parametrize("prefix", ["", "module."])
def test_load_magicleap_superglue_matches_jax_convert(prefix):
    state = {prefix + k: v for k, v in build_torch_superglue_state(d=64, layers=4, kenc=(32, 64)).items()}
    kw = dict(descriptor_dim=64, keypoint_encoder=(32, 64), gnn_layers=4, sinkhorn_iterations=20)
    variables = convert_superglue({k: v.numpy() for k, v in state.items()}, gnn_layers=4)
    jm = JaxSuperGlue(**kw, attention_impl="einsum", sinkhorn_impl="scan", logits_dtype="float32")
    tm = SuperGlue(**kw, device="cpu")
    load_magicleap_superglue(tm, state)
    (j0, t0), (j1, t1) = _keypoint_pair(3, d=64)
    ref = jm.apply(variables, j0, j1, (48, 64), (48, 64))
    with torch.no_grad():
        got = tm(t0, t1, (48, 64), (48, 64))
    np.testing.assert_allclose(got["log_coupling"].numpy(), np.asarray(ref["log_coupling"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["matches0"].numpy(), np.asarray(ref["matches0"]))
    assert np.ptp(np.asarray(ref["log_coupling"])) > 1.0  # not a constant coupling
    with pytest.raises(KeyError):  # strict: a missing layer is an error
        load_magicleap_superglue(SuperGlue(**{**kw, "gnn_layers": 6}, device="cpu"), state)


# ---------------------------------------------------------------- plots

def _far_from(shape, segments, dots, dot_radius):
    """Pixels further than 2 px from every segment and every filled dot."""
    ys, xs = np.mgrid[:shape[0], :shape[1]].astype(np.float64)
    far = np.ones(shape[:2], bool)
    for (x0, y0), (x1, y1) in segments:
        d = np.array([x1 - x0, y1 - y0], np.float64)
        t = np.clip(((xs - x0) * d[0] + (ys - y0) * d[1]) / max(d @ d, 1e-9), 0, 1)
        far &= np.hypot(xs - x0 - t * d[0], ys - y0 - t * d[1]) > 2
    for x, y in dots:
        far &= np.hypot(xs - x, ys - y) > dot_radius + 2
    return far


def test_matching_plot_matches_jax_away_from_the_marks():
    rng = np.random.default_rng(0)
    im0, im1 = rng.uniform(0, 1, (60, 80, 1)).astype(np.float32), rng.uniform(0, 1, (52, 70, 1)).astype(np.float32)
    xy0, xy1 = rng.uniform(0, 78, (40, 2)).astype(np.float32), rng.uniform(0, 50, (40, 2)).astype(np.float32)
    xy0[:, 1] = np.minimum(xy0[:, 1], 58)
    m0 = np.where(rng.uniform(size=40) < 0.3, rng.integers(0, 40, 40), -1)
    scores = rng.uniform(0, 1, 40).astype(np.float32)
    ref = jax_viz.make_matching_plot(im0, im1, xy0, xy1, m0, scores)
    got = viz.make_matching_plot(im0, im1, xy0, xy1, m0, scores)
    assert got.shape == ref.shape == (60, 80 + 70 + 10, 3) and got.dtype == ref.dtype == np.uint8
    segments, dots = [], []
    for i, j in enumerate(m0):
        if j >= 0:
            p0, p1 = np.round(xy0[i]), np.round(xy1[j]) + [80 + 10, 0]
            segments.append((p0, p1))
            dots += [p0, p1]
    far = _far_from(got.shape, segments, dots, 2)
    assert far.mean() > 0.5 and (m0 >= 0).sum() >= 8
    np.testing.assert_array_equal(got[far], ref[far])
    assert (got != ref).any(axis=-1)[~far].mean() < 0.9  # the marks themselves are drawn too

    kp = viz.draw_keypoints(im0, xy0, mask=scores > 0.5)
    kp_ref = jax_viz.draw_keypoints(im0, xy0, mask=scores > 0.5)
    far = _far_from(kp.shape, [], np.round(xy0[scores > 0.5]), 3)
    assert kp.shape == kp_ref.shape and np.array_equal(kp[far], kp_ref[far])


def test_save_image_writes_what_cv2_reads(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    viz.save_image(str(tmp_path / "a.png"), img)
    assert np.array_equal(cv2.imread(str(tmp_path / "a.png")), img)


# ---------------------------------------------------------------- the CLI

SHIFTS = [(32, 32), (-24, 40), (40, -16)]  # px at full resolution, template -> source
H, W = 480, 640


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    """A 480x640 photo-texture template and its shifts, as PNG files; the CLI
    registers them at 240x320 (`--resize_scale 0.5`)."""
    root = tmp_path_factory.mktemp("pairs")
    (root / "src").mkdir()
    img = imgproc.gaussian_blur(evaluation.photo_texture(np.random.default_rng(1), H, W), 1.0)
    imgproc.imwrite_png(str(root / "template.png"), (img * 255).astype(np.uint8))
    gts = []
    for i, (tx, ty) in enumerate(SHIFTS):
        mat = np.float32([[1, 0, tx], [0, 1, ty]])
        src = np.clip(imgproc.warp_affine(img, mat, (W, H)), 0, 1)
        imgproc.imwrite_png(str(root / "src" / f"s{i}.png"), (src * 255).astype(np.uint8))
        gts.append(mat)
    return root, gts


def _args(root, matcher, out):
    return ["--template", str(root / "template.png"), "--source_dir", str(root / "src"), "--out", str(out),
            "--matcher", matcher, "--resize_scale", "0.5", "--sp_checkpoint", str(WEIGHTS / "sp_photo.npz"),
            "--sg_checkpoint", str(WEIGHTS / "sg_photo.npz")]


@pytest.mark.parametrize("matcher", ["ratio", "superglue"])
def test_cli_matches_the_jax_cli(pair_files, tmp_path, monkeypatch, matcher):
    root, gts = pair_files
    f32 = dict(compute_dtype="float32", logits_dtype="float32")
    monkeypatch.setattr(jax_cli, "MatchingConfig",
                        functools.partial(JaxConfig, **f32, attention_impl="einsum", sinkhorn_impl="scan"))
    monkeypatch.setattr(cli, "MatchingConfig", functools.partial(MatchingConfig, **f32))
    monkeypatch.setattr(sys, "argv", ["match_pair", *_args(root, matcher, tmp_path / "jax")])
    jax_cli.main()
    records = cli.main([*_args(root, matcher, tmp_path / "port"), "--device", "cpu"])
    assert [r["name"] for r in records] == ["s0", "s1", "s2"]
    for i, (rec, gt) in enumerate(zip(records, gts)):
        ref = np.loadtxt(tmp_path / "jax" / f"s{i}_transform.txt")
        got = np.loadtxt(tmp_path / "port" / f"s{i}_transform.txt")
        assert got.shape == ref.shape == (2, 3) and np.array_equal(got, rec["transform"].astype(np.float64))
        e_ref, e_got = (evaluation.corner_error(m, gt, H, W) for m in (ref, got))
        assert abs(e_got - e_ref) <= 0.1, (matcher, i, e_got, e_ref)
        assert rec["valid"] and rec["matches"] >= 100 and e_got < 4.0
        for kind in ("matches", "warped"):
            ours, theirs = (cv2.imread(str(tmp_path / pkg / f"s{i}_{kind}.png")) for pkg in ("port", "jax"))
            assert ours.shape == theirs.shape


def test_cli_at_its_defaults(pair_files, tmp_path):
    """bf16 and the H layout, the JAX CLI's defaults, through the superglue matcher."""
    root, gts = pair_files
    records = cli.main([*_args(root, "superglue", tmp_path), "--device", "cpu"])
    for i, (rec, gt) in enumerate(zip(records, gts)):
        assert rec["valid"] and np.isfinite(rec["transform"]).all() and rec["wall_s"] > 0
        assert evaluation.corner_error(rec["transform"], gt, H, W) < 4.0  # 2 px at the model's scale
        assert cv2.imread(str(tmp_path / f"s{i}_matches.png")).shape == (240, 320 + 10 + 320, 3)
        assert cv2.imread(str(tmp_path / f"s{i}_warped.png"), cv2.IMREAD_UNCHANGED).shape == (240, 320)
    model = cli.build_model(cli.parse_args(_args(root, "ratio", tmp_path) + ["--device", "cpu"]))
    assert model.config.s2d_backbone and model.config.s2d_layout == "h" and model.config.compute_dtype == "bfloat16"
