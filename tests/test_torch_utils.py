"""The port's utilities (`utils/config.py`, `utils/profiler.py`,
`utils/viz.draw_tracks` / `heatmap_overlay`) against the JAX package's
and OpenCV, on the CPU.

Tolerances: the YAML configs, the FLOP count, the colour tables,
`addWeighted`'s blend and the heatmap overlay exactly. `draw_tracks`
draws OpenCV's 8-connected lines where the JAX package draws
anti-aliased ones (`LINE_AA`), so it is held on the track pixels: each
pixel it paints is one the JAX stroke paints, in the track's colour, and
the JAX stroke reaches no pixel more than one pixel away from them.
"""
import json

import cv2
import numpy as np
import torch
import yaml
from scipy import ndimage

from image_matching_tpu.utils import config as jconfig
from image_matching_tpu.utils import profiler as jprofiler
from image_matching_tpu.utils import viz as jviz
from image_matching_tpu_torch.utils import config, profiler, viz

from test_torch_features import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)

DEFAULTS = {"model": {"name": "SuperPointNet", "params": {"dim": 128, "nms": 4}}, "lr": 1e-4, "tags": ["a", "b"]}


def test_config_round_trips_as_the_jax_ones(tmp_path):
    update = {"model": {"params": {"dim": 256}, "extra": {"k": 1}}, "lr": 3e-4, "tags": ["c"]}
    assert config.dict_update(DEFAULTS, update) == jconfig.dict_update(DEFAULTS, update)
    assert config.dict_update(DEFAULTS, update)["model"]["params"] == {"dim": 256, "nms": 4}
    assert DEFAULTS["model"]["params"]["dim"] == 128  # the defaults are not changed
    path = tmp_path / "c.yml"
    path.write_text(yaml.safe_dump(update))
    for defaults in (None, DEFAULTS):
        assert config.load_config(str(path), defaults) == jconfig.load_config(str(path), defaults)
    (tmp_path / "empty.yml").write_text("")
    assert config.load_config(str(tmp_path / "empty.yml")) == jconfig.load_config(str(tmp_path / "empty.yml")) == {}
    ours = config.snapshot_config(DEFAULTS, str(tmp_path / "port"))
    theirs = jconfig.snapshot_config(DEFAULTS, str(tmp_path / "jax"))
    assert open(ours).read() == open(theirs).read() and config.load_config(ours) == DEFAULTS


def test_profiler(tmp_path, caplog):
    for args in ((480, 640, 1024), (240, 320, 512, 128, 9)):
        assert profiler.flops_estimate_matching(*args) == jprofiler.flops_estimate_matching(*args)
    with profiler.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with caplog.at_level("INFO"), profiler.timed("block"):
        torch.ones(8).sum()
    assert any("block:" in r.getMessage() and r.getMessage().endswith(" ms") for r in caplog.records)


def test_colour_tables_and_blend_are_opencvs():
    np.testing.assert_array_equal(viz.JET_BGR, cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                                                                 cv2.COLORMAP_JET)[:, 0])
    hsv = np.stack([np.arange(180), np.full(180, 255), np.full(180, 255)], -1).astype(np.uint8)[None]
    np.testing.assert_array_equal(viz.HUE_BGR, cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)[0])
    # every pair of a gray image value and a table colour value, blended
    gray = np.repeat(np.arange(256, dtype=np.float32), 256).reshape(256, 256)[..., None] / 255.0
    heat = np.tile(np.arange(256, dtype=np.float32), (256, 1)) / 255.0
    base = np.repeat(np.clip(gray[..., 0] * 255.0, 0, 255).astype(np.uint8)[..., None], 3, -1)
    colour = viz.JET_BGR[np.clip(heat / (heat.max() + 1e-9) * 255.0, 0, 255).astype(np.uint8)]
    np.testing.assert_array_equal(viz.heatmap_overlay(gray, heat), cv2.addWeighted(base, 0.6, colour, 0.4, 0))


def test_heatmap_overlay_equals_the_jax_one():
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 1, (48, 64, 1)).astype(np.float32)
    for heat in (rng.uniform(0, 1, (48, 64)).astype(np.float32) ** 3, rng.uniform(0, 0.02, (48, 64, 1)),
                 np.zeros((48, 64), np.float32)):
        np.testing.assert_array_equal(viz.heatmap_overlay(image, heat), jviz.heatmap_overlay(image, heat))


def test_draw_tracks_holds_the_jax_track_pixels():
    rng = np.random.default_rng(1)
    image = rng.uniform(0.2, 0.8, (120, 160, 1)).astype(np.float32)
    tracks = [(int(t), [(f, float(rng.uniform(0, 159)), float(rng.uniform(0, 119))) for f in range(5)])
              for t in rng.integers(0, 1000, 8)]
    base = viz._to_bgr(image)
    for by_id in (True, False):
        got, want = viz.draw_tracks(image, tracks, by_id), jviz.draw_tracks(image, tracks, by_id)
        ours, theirs = (got != base).any(-1), (want != base).any(-1)
        assert ours.sum() > 500 and not (ours & ~theirs).any()
        assert not (theirs & ~ndimage.binary_dilation(ours, np.ones((3, 3), bool))).any()
        colours = {tuple(int(c) for c in viz.HUE_BGR[(t * 37) % 180]) if by_id else (0, 255, 0) for t, _ in tracks}
        assert {tuple(int(c) for c in px) for px in got[ours]} <= colours
    # one track on a 45 degree line: there the anti-aliased stroke is full weight on the port's pixels
    diag = [(3, [(0, 10.0, 10.0), (1, 60.0, 60.0)])]
    got, want = viz.draw_tracks(image, diag), jviz.draw_tracks(image, diag)
    ours = (got != base).any(-1)
    assert (got[ours] == want[ours]).all(-1).mean() >= 0.9
