"""Guards on the port: it imports no JAX, no JAX package and no OpenCV
(the machine with the card has none), and it never falls back to the CPU
on its own."""
import ast
from pathlib import Path

import pytest
import torch

import image_matching_tpu_torch
from image_matching_tpu_torch.models import Matching, MatchingConfig, SuperGlue, SuperPointBN, SuperPointVGG

PACKAGE = Path(image_matching_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "image_matching_tpu", "cv2")


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
            "ops/s2d_entry.py", "ops/realign.py", "ops/matching.py", "ops/ransac.py"} <= names
    for path in sources:
        for mod in _imported_modules(ast.parse(path.read_text(), str(path))):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(PACKAGE)} imports {mod}"


@pytest.mark.parametrize("build", [
    lambda: Matching(MatchingConfig(gnn_layers=2)),
    lambda: SuperPointBN(64),
    lambda: SuperGlue(64, (16,), gnn_layers=2),
    lambda: SuperPointVGG(64),
    lambda: Matching(MatchingConfig(gnn_layers=2, backbone="vgg", s2d_backbone=True, s2d_layout="2x2")),
    lambda: Matching(MatchingConfig(gnn_layers=2, s2d_backbone=True, s2d_layout="h")),
    lambda: SuperPointVGG(64, s2d=True, s2d_layout="h"),
])
def test_default_device_is_cuda_and_raises_without_it(monkeypatch, build):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_cpu_on_request():
    model = Matching(MatchingConfig(gnn_layers=2, max_keypoints=16), device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
