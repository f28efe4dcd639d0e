"""The port's classical entry points — `cli/traditional.py`,
`cli/sequence.py` and `cli/evaluate.py --configs sift orb` — run
in-process on the CPU at small sizes beside the JAX package's CLIs on the
same inputs. The two packages draw their RANSAC samples from different
generators, so fits are compared by corner error. Tolerances:

  * traditional: the same files; each transform within 0.05 px of corner
    error of JAX's; the warped image (`imgproc.warp_affine` of the 8-bit
    template in float32, rounded) within 2 gray levels of cv2.warpAffine
    on uint8 (OpenCV's fixed-point weights) on >= 99% of its pixels;
  * sequence (--synthetic --ba, 6 frames): the JSON keys and the frames,
    stage and valid edges of JAX's; both ATEs within 0.01 px of JAX's;
  * evaluate (--configs sift orb, 2 pairs at 240x320): the JSON keys of
    JAX's (and of its record, `EVAL_classical_photo.json`); the same
    successes, per-pair corner errors within 0.05 px; the default configs
    are the JAX CLI's.
"""
import json
import math
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from image_matching_tpu_torch import imgproc
from image_matching_tpu_torch.cli import evaluate as port_evaluate
from image_matching_tpu_torch.cli import sequence as port_sequence
from image_matching_tpu_torch.cli import traditional as port_traditional
from image_matching_tpu_torch.evaluation import corner_error
from test_torch_features import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)

ROOT = Path(__file__).resolve().parents[1]


def _run_jax_cli(monkeypatch, main, argv):
    monkeypatch.setattr(sys, "argv", argv)
    return main()


def _texture(rng, h, w):
    img = imgproc.gaussian_blur(rng.uniform(0, 1, (h, w)).astype(np.float32), 1.5)
    return (img - img.min()) / (img.max() - img.min())


@pytest.fixture(scope="module")
def traditional_files(tmp_path_factory):
    """A 120x160 template and two sources warped by known similarities."""
    root = tmp_path_factory.mktemp("traditional")
    rng = np.random.default_rng(4)
    h, w = 120, 160
    tpl = _texture(rng, h, w)
    (root / "src").mkdir()
    imgproc.imwrite_png(str(root / "template.png"), (tpl * 255).astype(np.uint8))
    for i, (ang, tx, ty) in enumerate([(0.1, 5.0, -3.0), (-0.15, -4.0, 6.0)]):
        c, s = math.cos(ang), math.sin(ang)
        mat = np.float32([[c, -s, tx + w / 2 - c * w / 2 + s * h / 2], [s, c, ty + h / 2 - s * w / 2 - c * h / 2]])
        src = np.clip(imgproc.warp_affine(tpl, mat, (w, h)), 0, 1)
        imgproc.imwrite_png(str(root / "src" / f"s{i}.png"), (src * 255).astype(np.uint8))
    return root


@pytest.mark.parametrize("method", ["sift", "orb"])
def test_traditional_cli_writes_the_jax_clis_files(monkeypatch, traditional_files, method):
    from image_matching_tpu.cli.traditional import main as jax_main

    root = traditional_files
    outs = {pkg: root / f"out_{pkg}_{method}" for pkg in ("port", "jax")}
    argv = ["--template", str(root / "template.png"), "--source_dir", str(root / "src"), "--method", method,
            "--resize_scale", "1.0"]
    records = port_traditional.main(argv + ["--out", str(outs["port"]), "--device", "cpu"])
    _run_jax_cli(monkeypatch, jax_main, ["traditional", *argv, "--out", str(outs["jax"])])
    names = sorted(p.name for p in outs["jax"].iterdir())
    assert names == sorted(p.name for p in outs["port"].iterdir()) and len(names) == 6
    tpl = imgproc.imread_gray(str(root / "template.png"))
    for rec in records:
        got = np.loadtxt(outs["port"] / f"{rec['name']}_transform.txt")
        ref = np.loadtxt(outs["jax"] / f"{rec['name']}_transform.txt")
        assert rec["valid"] and np.allclose(got, rec["transform"], atol=1e-5)
        assert corner_error(got, ref, 120, 160) <= 0.05
        warped = imgproc.imread_gray(str(outs["port"] / f"{rec['name']}_warped.png"))
        want = cv2.warpAffine(tpl, got.astype(np.float32), (160, 120))
        assert warped.shape == want.shape
        assert np.mean(np.abs(warped.astype(int) - want.astype(int)) <= 2) >= 0.99
        plot = imgproc.imread_gray(str(outs["port"] / f"{rec['name']}_matches.png"))
        assert plot.shape == imgproc.imread_gray(str(outs["jax"] / f"{rec['name']}_matches.png")).shape


def test_traditional_warped_artifact_against_cv2_on_uint8():
    """`warp_template` against cv2.warpAffine on uint8 over a range of
    similarities: within 2 gray levels on >= 99% of the pixels."""
    rng = np.random.default_rng(5)
    tpl = _texture(rng, 240, 320)[..., None]
    u8 = (tpl[..., 0] * 255).astype(np.uint8)
    for _ in range(5):
        ang, sc = rng.uniform(-0.3, 0.3), rng.uniform(0.9, 1.1)
        mat = np.float32([[math.cos(ang) * sc, -math.sin(ang) * sc, rng.uniform(-20, 20)],
                          [math.sin(ang) * sc, math.cos(ang) * sc, rng.uniform(-20, 20)]])
        got = port_traditional.warp_template(tpl, mat, (320, 240))
        want = cv2.warpAffine(u8, mat, (320, 240))
        assert np.mean(np.abs(got.astype(int) - want.astype(int)) <= 2) >= 0.99


def test_sequence_cli_json_matches_the_jax_cli(monkeypatch, tmp_path, capsys):
    from image_matching_tpu.cli.sequence import main as jax_main

    argv = ["--synthetic", "--ba", "--n_frames", "6", "--iters", "150"]
    got = port_sequence.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port.json")])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _run_jax_cli(monkeypatch, jax_main, ["sequence", *argv, "--out", str(tmp_path / "jax.json")])
    ref = json.loads((tmp_path / "jax.json").read_text())
    written = json.loads((tmp_path / "port.json").read_text())
    assert set(written) == set(ref) and written == json.loads(json.dumps(got))
    assert printed == {k: v for k, v in written.items() if k != "trajectory"}
    for key in ("frames", "method", "stage", "valid_edges"):
        assert written[key] == ref[key], key
    assert np.asarray(written["trajectory"]).shape == (6, 4)
    for key in ("ate_pose_graph_px", "ate_bundle_adjusted_px"):
        assert written[key] < 0.1 and abs(written[key] - ref[key]) <= 0.01, key
    assert abs(written["num_tracks"] - ref["num_tracks"]) <= 0.05 * ref["num_tracks"]


def test_sequence_cli_needs_frames_and_reads_the_port_formats(tmp_path):
    with pytest.raises(SystemExit, match="frames_dir or --synthetic"):
        port_sequence.main(["--device", "cpu"])
    (tmp_path / "f").mkdir()
    (tmp_path / "f" / "a.jpg").write_bytes(b"\xff\xd8\xff\xe0 not decoded here")
    with pytest.raises(ValueError, match="imread_gray reads"):
        port_sequence.main(["--device", "cpu", "--frames_dir", str(tmp_path / "f")])


def test_evaluate_classical_configs_match_the_jax_cli(monkeypatch, tmp_path):
    from image_matching_tpu.cli.evaluate import main as jax_main
    from image_matching_tpu.cli.evaluate import parse_args as jax_parse_args

    monkeypatch.setattr(sys, "argv", ["evaluate"])
    assert port_evaluate.parse_args([]).configs == jax_parse_args().configs == ["sift", "orb", "sp", "spsg"]
    argv = ["--configs", "sift", "orb", "--n_pairs", "2", "--height", "240", "--width", "320", "--per_pair"]
    got = port_evaluate.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port.json")])
    _run_jax_cli(monkeypatch, jax_main, ["evaluate", *argv, "--out", str(tmp_path / "jax.json")])
    ref = json.loads((tmp_path / "jax.json").read_text())
    record = json.loads((ROOT / "EVAL_classical_photo.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(json.dumps(got))
    for name in ("sift", "orb"):
        assert set(got[name]) == set(ref[name]) == set(record[name]) | {"per_pair"}
        ok = lambda p: p["corner_err_px"] is not None and p["corner_err_px"] < 5.0  # noqa: E731
        assert [ok(p) for p in got[name]["per_pair"]] == [ok(p) for p in ref[name]["per_pair"]]
        assert sum(map(ok, got[name]["per_pair"])) >= 1
        for a, b in zip(got[name]["per_pair"], ref[name]["per_pair"]):
            if ok(a):
                assert abs(a["corner_err_px"] - b["corner_err_px"]) <= 0.05
