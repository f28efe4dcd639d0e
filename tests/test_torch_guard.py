"""Guards on the port: it and `chip_smoke.py` import no JAX, no JAX
package, no optax / orbax and no image library (the machine with the card
has none), and it never falls back to the CPU on its own."""
import ast
from pathlib import Path

import pytest
import torch

import image_matching_tpu_torch
from image_matching_tpu_torch.models import Matching, MatchingConfig, SuperGlue, SuperPointBN, SuperPointVGG
from image_matching_tpu_torch.models.tracker import tracker_init
from image_matching_tpu_torch.slam import tracks_to_ba_problem
from image_matching_tpu_torch.slam.sequence import register_sequence

PACKAGE = Path(image_matching_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "image_matching_tpu", "cv2", "PIL")
CHIP_SMOKE = PACKAGE.parent / "chip_smoke.py"


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    sources = sorted(PACKAGE.rglob("*.py"))
    assert len(sources) >= 10
    names = {str(p.relative_to(PACKAGE)) for p in sources}
    assert {"registration.py", "evaluation.py", "imgproc.py", "cli/evaluate.py", "ops/s2d_conv.py",
            "ops/s2d_entry.py", "ops/realign.py", "ops/matching.py", "ops/ransac.py", "cli/match_pair.py",
            "cli/train_superglue.py", "data/datasets.py", "data/photometric.py", "train/checkpoint.py",
            "utils/viz.py", "cli/train_superpoint.py", "cli/export_pseudo.py", "export.py", "data/pipeline.py",
            "data/synthetic_device.py", "losses/detector.py", "losses/descriptor.py", "losses/subpixel.py",
            "train/superpoint_trainer.py", "ops/resize.py", "ops/topk.py", "features/__init__.py",
            "features/sift.py", "features/orb.py", "features/_brief_table.py", "features/registration.py",
            "models/tracker.py", "slam/__init__.py", "slam/cg.py", "slam/pose_graph.py",
            "slam/bundle_adjustment.py", "slam/sequence.py", "cli/traditional.py", "cli/sequence.py",
            "data/native_loader.py", "native_imloader.py", "parallel/__init__.py", "parallel/distributed.py", "parallel/mesh.py",
            "parallel/collectives.py", "parallel/sharding.py", "parallel/ring_attention.py",
            "parallel/sharded_sinkhorn.py", "parallel/context_parallel.py", "parallel/pipeline.py",
            "utils/config.py", "utils/profiler.py"} <= names
    for path in sources + [CHIP_SMOKE]:
        for mod in _imported_modules(ast.parse(path.read_text(), str(path))):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path.name} imports {mod}"


@pytest.mark.parametrize("build", [
    lambda: Matching(MatchingConfig(gnn_layers=2)),
    lambda: SuperPointBN(64),
    lambda: SuperGlue(64, (16,), gnn_layers=2),
    lambda: SuperPointVGG(64),
    lambda: Matching(MatchingConfig(gnn_layers=2, backbone="vgg", s2d_backbone=True, s2d_layout="2x2")),
    lambda: Matching(MatchingConfig(gnn_layers=2, s2d_backbone=True, s2d_layout="h")),
    lambda: SuperPointVGG(64, s2d=True, s2d_layout="h"),
    lambda: tracker_init(4, 16, 8),
    lambda: tracks_to_ba_problem([(0, [(0, 1.0, 2.0), (1, 1.5, 2.5)])], 2, 8),
    lambda: register_sequence(None, [], strides=(1,)),
])
def test_default_device_is_cuda_and_raises_without_it(monkeypatch, build):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


@pytest.mark.parametrize("cli", ["match_pair", "train_superglue", "train_superpoint", "export_pseudo", "traditional",
                                 "sequence"])
def test_clis_raise_without_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path, cli):
    import importlib

    main = importlib.import_module(f"image_matching_tpu_torch.cli.{cli}").main
    files = ["--template", str(tmp_path / "t.png"), "--source_dir", str(tmp_path), "--out", str(tmp_path / "out")]
    argv = {"match_pair": files, "traditional": files,
            "export_pseudo": ["--data_root", str(tmp_path), "--out", str(tmp_path / "out")],
            "sequence": ["--frames_dir", str(tmp_path / "frames"), "--out", str(tmp_path / "t.json")]}.get(
        cli, ["--synthetic", "--run_dir", str(tmp_path / "run")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    if cli in ("match_pair", "export_pseudo", "traditional", "sequence"):
        with pytest.raises(FileNotFoundError):  # past the device, to the missing template / image directory
            main(argv + ["--device", "cpu"])
    else:
        assert main(argv + ["--device", "cpu", *TINY_TRAINING[cli]])["state"].step == 1


TINY_TRAINING = {
    "train_superglue": ["--epochs", "1", "--steps_per_epoch", "1", "--batch_size", "1", "--height", "32", "--width",
                        "32", "--descriptor_dim", "16", "--keypoint_encoder", "8", "--gnn_layers", "2",
                        "--sinkhorn_iterations", "3", "--max_keypoints", "16"],
    "train_superpoint": ["--train_iter", "1", "--batch_size", "1", "--height", "32", "--width", "32",
                         "--descriptor_dim", "16"],
}


def test_cpu_on_request():
    model = Matching(MatchingConfig(gnn_layers=2, max_keypoints=16), device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
