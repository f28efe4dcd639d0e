"""The port's pseudo-label export and the two SuperPoint CLIs (`export.py`,
`cli/export_pseudo.py`, `cli/train_superpoint.py`) against the JAX
package, on the CPU, with the banked `weights/sp_synth.npz` (the cycle's
stage-1 output, which the JAX package wrote with `save_npz`).

Tolerances, f32 compute on both sides and JAX's homographies fed to the
port:
  * the aggregated heatmap within 1e-5; the keypoints the same set, their
    scores within 1e-5 and their refined xy within 1e-4 px (the soft-argmax
    sums in another order);
  * the export CLI against the JAX CLI on the same PNG files: each written
    npz the same number of rows, the same integer pixels, xy within 1e-4
    and scores within 1e-5 (every keypoint), rows in score order up to
    keypoints whose scores tie within that 1e-5 (the port's homography
    inverse is JAX's CPU arithmetic step for step: with `torch.linalg.inv`
    keypoints moved by up to 2.7e-4 px);
  * checkpoints: a port checkpoint of SuperPointBN read by the JAX
    package's `load_npz_into` into its TrainState tree, and the JAX
    package's `save_npz` of that tree restored by the port, both exact.
"""
import functools
import os
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_matching_tpu import export as jexport
from image_matching_tpu.cli import export_pseudo as jax_export_cli
from image_matching_tpu.geometry import homography as jh
from image_matching_tpu.models.superpoint import SuperPointBN as JaxSuperPointBN
from image_matching_tpu.train import create_train_state
from image_matching_tpu.utils.weights import flatten_tree, load_npz_into
from image_matching_tpu.utils.weights import save_npz as jax_save_npz
from image_matching_tpu_torch import export
from image_matching_tpu_torch.cli import export_pseudo as export_cli
from image_matching_tpu_torch.cli import train_superpoint as train_cli
from image_matching_tpu_torch.models import SuperPointBN
from image_matching_tpu_torch.train.checkpoint import CheckpointManager, load_weights
from image_matching_tpu_torch.train.state import TrainState
from image_matching_tpu_torch.weights import params_to_jax

from test_torch_features import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)

T = torch.from_numpy
SP_SYNTH = str(Path(__file__).resolve().parents[1] / "weights" / "sp_synth.npz")
H, W, N = 64, 96, 4


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@functools.lru_cache(maxsize=None)
def _jax_variables():
    jm = JaxSuperPointBN(descriptor_dim=128, dtype=jnp.float32)
    template = jax.jit(lambda k: jm.init(k, jnp.zeros((1, H, W, 1)), train=True))(jax.random.PRNGKey(0))
    return jm, load_npz_into(template, SP_SYNTH)


def _textured(seed, b, h=H, w=W):
    rng = np.random.default_rng(seed)
    imgs = [cv2.GaussianBlur(rng.uniform(0, 1, (h, w)).astype(np.float32), (0, 0), 2.0) for _ in range(b)]
    imgs = [(i - i.min()) / (i.max() - i.min()) for i in imgs]
    return np.stack(imgs)[..., None].astype(np.float32)


def jax_export_homographies(key, batch, h, w, cfg):
    """The homographies `export_pseudo_labels(key, ...)` samples, replayed
    from its key splits: (batch, N, 3, 3), warp 0 the identity."""
    sample = jax.jit(jh.sample_homography_batch, static_argnums=(1, 2, 3, 4))
    hs = [np.array(sample(k, cfg.num_homographies, h, w, cfg.homography)) for k in jax.random.split(key, batch)]
    hs = np.stack(hs)
    hs[:, 0] = np.eye(3, dtype=np.float32)
    return hs


def test_export_matches_jax_on_its_homographies():
    jm, variables = _jax_variables()
    images = _textured(0, 2)
    key = jax.random.PRNGKey(1)
    jcfg = jexport.ExportConfig(num_homographies=N, top_k=150)
    apply_fn = lambda views: jm.apply(variables, views)["semi"]
    ref_heat = jax.jit(lambda k, im: jax.vmap(lambda kk, i: jexport.homographic_adaptation_heatmap(
        kk, apply_fn, i, jcfg))(jax.random.split(k, 2), im))(key, jnp.asarray(images))
    ref = jax.jit(lambda k, im: jexport.export_pseudo_labels(k, apply_fn, im, jcfg))(key, jnp.asarray(images))

    model = SuperPointBN(128, device="cpu")
    load_weights(model, SP_SYNTH)
    pcfg = export.ExportConfig(num_homographies=N, top_k=150)
    hs = T(jax_export_homographies(key, 2, H, W, jcfg))
    apply = lambda views: model(views)["semi"]
    with torch.no_grad():
        heat = export.homographic_adaptation_heatmap(hs, apply, T(images), pcfg)
        got = export.export_pseudo_labels(hs, apply, T(images), pcfg)
    np.testing.assert_allclose(_np(heat), np.asarray(ref_heat), rtol=0, atol=1e-5)
    mask = _np(got.mask)
    np.testing.assert_array_equal(mask, np.asarray(ref.mask))
    assert 20 < mask.sum(1).min() and mask.sum(1).max() < 150  # a real set, not the whole capacity
    np.testing.assert_array_equal(np.round(_np(got.xy))[mask], np.round(np.asarray(ref.xy))[mask])
    np.testing.assert_allclose(_np(got.xy)[mask], np.asarray(ref.xy)[mask], rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(got.score), np.asarray(ref.score), rtol=0, atol=1e-5)
    assert (_np(got.xy)[mask] % 1 != 0).any()  # subpixel-refined

    # filter_counts: pixels seen by fewer warped views than asked are cleared
    fcfg = pcfg._replace(filter_counts=N)
    with torch.no_grad():
        filtered = export.homographic_adaptation_heatmap(hs, apply, T(images), fcfg)
    jf = jax.jit(lambda im: jexport.homographic_adaptation_heatmap(key, apply_fn, im, jcfg._replace(
        filter_counts=N)))(jnp.asarray(images[0]))
    hs0 = np.array(jh.sample_homography_batch(key, N, H, W, jcfg.homography))  # one image: its key unsplit
    hs0[0] = np.eye(3)
    hs0 = T(hs0)[None]
    with torch.no_grad():
        f0 = export.homographic_adaptation_heatmap(hs0, apply, T(images[:1]), fcfg)
    np.testing.assert_allclose(_np(f0[0]), np.asarray(jf), rtol=0, atol=1e-5)
    assert (_np(filtered) == 0).sum() > (_np(heat) == 0).sum()
    # the generator's own draws: warp 0 the identity, seeded
    own = export.draw_export_homographies(torch.Generator().manual_seed(0), 2, H, W, pcfg)
    assert own.shape == (2, N, 3, 3) and torch.equal(own[:, 0], torch.eye(3).expand(2, 3, 3))
    assert torch.equal(own, export.draw_export_homographies(torch.Generator().manual_seed(0), 2, H, W, pcfg))


def test_invert_homography_equals_jax_bit_for_bit():
    """An exported keypoint moves by up to 3e-4 px with the last bit of the
    views' inverse homographies, so the port's inverse is JAX's CPU
    arithmetic exactly: on the export's homographies and on general
    matrices (every pivot order), batched and single."""
    cfg = jexport.ExportConfig(num_homographies=20)
    hs = jax_export_homographies(jax.random.PRNGKey(4), 10, 240, 320, cfg).reshape(-1, 3, 3)
    general = np.random.default_rng(0).standard_normal((500, 3, 3)).astype(np.float32)
    for m in (hs, general):
        np.testing.assert_array_equal(_np(export.invert_homography(T(m))), np.array(jh.invert_homography(m)))
    np.testing.assert_array_equal(_np(export.invert_homography(T(general[7]))), np.array(jnp.linalg.inv(general[7])))


def test_chunked_export_equals_one_call(monkeypatch):
    """The views go through the model in chunks of `VIEW_PIXELS_PER_CALL`
    (here shrunk to 3 views of 240x320, so 2 images x 4 warps take 3 calls
    of 3, 3 and 2): the same heatmaps, keypoints and scores as one call."""
    model = SuperPointBN(128, device="cpu")
    load_weights(model, SP_SYNTH)
    images = T(_textured(6, 2, 240, 320))
    cfg = export.ExportConfig(num_homographies=N, top_k=300)
    hs = export.draw_export_homographies(torch.Generator().manual_seed(2), 2, 240, 320, cfg)
    calls = []

    def apply(views):
        calls.append(len(views))
        return model(views)["semi"]

    assert export.VIEW_PIXELS_PER_CALL == 400 * 240 * 320  # under the entry conv's 2^31 / 64 pixels
    with torch.no_grad():
        whole = export.export_pseudo_labels(hs, apply, images, cfg)
        monkeypatch.setattr(export, "VIEW_PIXELS_PER_CALL", 3 * 240 * 320 + 1)
        chunked = export.export_pseudo_labels(hs, apply, images, cfg)
    assert calls == [8, 3, 3, 2]
    assert 20 < int(whole.mask.sum(1).min())
    for field in ("xy", "score", "mask"):
        assert torch.equal(getattr(chunked, field), getattr(whole, field)), field


# ---------------------------------------------------------------- checkpoints across packages

def _jax_sp_state():
    jm = JaxSuperPointBN(descriptor_dim=32, dtype=jnp.float32)
    st = create_train_state(jax.random.PRNGKey(2), jm, (jnp.zeros((1, H, W, 1)),), tx=optax.adam(1e-3),
                            init_kwargs={"train": True})
    rng = np.random.default_rng(3)
    st = st.apply_gradients(jax.tree_util.tree_map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
                                                   st.params))
    stats = jax.tree_util.tree_map(lambda s: jnp.asarray(rng.uniform(0.5, 2, s.shape), jnp.float32), st.batch_stats)
    return st.replace(batch_stats=stats)


def _payload(st):
    return {"params": st.params, "batch_stats": st.batch_stats, "opt_state": st.opt_state, "step": st.step}


def test_checkpoints_interchange_with_jax(tmp_path):
    jst = _jax_sp_state()
    jax_save_npz(str(tmp_path / "1.npz"), _payload(jst))
    state = TrainState.create(SuperPointBN(32, device="cpu", seed=5), 1e-3)
    CheckpointManager(str(tmp_path)).restore(state)
    want = flatten_tree(_payload(jst))
    have = params_to_jax(state.module.state_dict())
    assert state.step == 1 and any(k.startswith("batch_stats::") for k in have)
    assert all(np.array_equal(have[k], want[k]) for k in have)
    # and back: the port's checkpoint fills the JAX TrainState's tree, running statistics included
    with torch.no_grad():
        state.module.bnDb.running_var.mul_(1.5)
    CheckpointManager(str(tmp_path / "port")).save(state)
    restored = flatten_tree(load_npz_into(_payload(jst), str(tmp_path / "port" / "1.npz")))
    have = params_to_jax(state.module.state_dict())
    assert all(np.array_equal(restored[k], have[k]) for k in have)
    np.testing.assert_array_equal(restored["batch_stats::bnDb::var"], want["batch_stats::bnDb::var"] * 1.5)
    for k in (k for k in want if k.startswith("opt_state")):
        np.testing.assert_array_equal(restored[k], want[k], err_msg=k)


# ---------------------------------------------------------------- the CLIs

TRAIN_ARGS = ["--device", "cpu", "--batch_size", "2", "--height", str(H), "--width", str(W),
              "--descriptor_dim", "32", "--tensorboard_interval", "1", "--validation_interval", "2"]


def _write_pngs(directory, n, seed, h=H, w=W):
    os.makedirs(directory, exist_ok=True)
    for i, img in enumerate(_textured(seed, n, h, w)):
        cv2.imwrite(os.path.join(directory, f"im_{i}.png"), (img[..., 0] * 255).astype(np.uint8))


def test_train_cli_checkpoints_resumes_and_warm_starts(tmp_path):
    run = ["--synthetic", "--run_dir", str(tmp_path / "sp"), "--save_interval", "2"]
    out = train_cli.main([*TRAIN_ARGS, *run, "--train_iter", "4"])
    ckpt = tmp_path / "sp" / "checkpoints"
    assert sorted(p.name for p in ckpt.iterdir()) == ["2.npz", "4.npz"] and out["state"].step == 4
    assert [r["step"] for r in out["logged"]] == [1, 2, 3, 4] and [r["step"] for r in out["history"]] == [2, 4]
    assert all(np.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0 and 0 <= r["precision"] <= 1
               for r in out["logged"])
    assert set(out["history"][0]) == {"step", "loss", "loss_det", "loss_det_warp", "loss_desc", "positive_dist",
                                      "negative_dist"}
    resumed = train_cli.main([*TRAIN_ARGS, *run, "--train_iter", "6", "--resume"])
    assert resumed["state"].step == 6 and resumed["logged"][0]["step"] == 5
    assert sorted(p.name for p in ckpt.iterdir()) == ["2.npz", "4.npz", "6.npz"]
    # a checkpoint warm-starts a new run (params and running statistics, step 0)
    snap = SuperPointBN(32, device="cpu")
    load_weights(snap, str(ckpt / "6.npz"))
    warm = train_cli.main([*TRAIN_ARGS, "--synthetic", "--run_dir", str(tmp_path / "warm"), "--train_iter", "1",
                           "--init_weights", str(ckpt / "6.npz"), "--learning_rate", "1e-6"])
    assert warm["state"].step == 1
    moved = {k: (v - snap.state_dict()[k]).abs().max().item() for k, v in warm["state"].module.state_dict().items()}
    assert max(v for k, v in moved.items() if not k.endswith(("running_mean", "running_var"))) < 1e-5
    # the host's synthetic dataset
    host = train_cli.main([*TRAIN_ARGS, "--synthetic", "--host_data", "--run_dir", str(tmp_path / "host"),
                           "--train_iter", "1"])
    assert host["state"].step == 1 and np.isfinite(host["logged"][0]["loss"])


def _run_jax_cli(argv):
    old = sys.argv
    sys.argv = ["export_pseudo", *argv]
    try:
        jax_export_cli.main()
    finally:
        sys.argv = old


def test_export_cli_matches_jax_and_feeds_the_retrain(tmp_path, monkeypatch):
    data = tmp_path / "data"
    _write_pngs(data / "train", 3, 4)
    _write_pngs(data / "val", 2, 5)  # a full batch: a split smaller than a batch yields none
    argv = ["--data_root", str(data), "--checkpoint", SP_SYNTH, "--height", str(H), "--width", str(W),
            "--batch_size", "2", "--num_homographies", str(N), "--seed", "3"]
    # f32 on both sides; the port fed the JAX CLI's homographies
    monkeypatch.setattr(jax_export_cli, "SuperPointBN",
                        lambda descriptor_dim, dtype: JaxSuperPointBN(descriptor_dim=descriptor_dim, dtype=jnp.float32))
    _run_jax_cli([*argv, "--out", str(tmp_path / "jax")])
    monkeypatch.setattr(export_cli, "SuperPointBN",
                        lambda d, compute_dtype, **kw: SuperPointBN(d, compute_dtype="float32", **kw))
    keys = iter([])

    def replay(gen, batch, h, w, cfg):
        nonlocal keys
        return T(jax_export_homographies(next(keys), batch, h, w, jexport.ExportConfig(num_homographies=N)))

    def jax_batch_keys(seed, n_batches):
        key, out = jax.random.PRNGKey(seed), []
        for _ in range(n_batches):
            key, k = jax.random.split(key)
            out.append(k)
        return iter(out)

    monkeypatch.setattr(export, "draw_export_homographies", replay)
    keys = jax_batch_keys(3, 2)
    got = export_cli.main([*argv, "--device", "cpu", "--out", str(tmp_path / "port"), "--viz"])
    assert [b["images"] for b in got["batches"]] == [2, 1] and len(got["written"]) == 3
    for name in ("im_0", "im_1", "im_2"):
        ref = np.load(tmp_path / "jax" / "train" / f"{name}.npz")["pts"]
        have = np.load(tmp_path / "port" / "train" / f"{name}.npz")["pts"]
        assert have.shape == ref.shape and have.shape[1] == 3 and len(have) > 20, (have.shape, ref.shape)
        # rows are in score order, and two keypoints whose scores tie within
        # the score tolerance may come in either order (measured: a pair
        # 5e-8 apart in the port and 2.2e-7 in JAX swapped places, under one
        # torch thread too, and JAX's own eager and jitted runs swap them
        # too); so the rows are matched by their integer pixels, and only
        # such ties may move
        hi, ri = (np.lexsort(np.round(a[:, 1::-1]).T) for a in (have, ref))
        np.testing.assert_array_equal(np.round(have[hi, :2]), np.round(ref[ri, :2]))
        moved = (np.round(have[:, :2]) != np.round(ref[:, :2])).any(1)
        np.testing.assert_allclose(have[moved, 2], ref[moved, 2], rtol=0, atol=1e-5)
        np.testing.assert_allclose(have[hi, :2], ref[ri, :2], rtol=0, atol=1e-4)
        np.testing.assert_allclose(have[hi, 2], ref[ri, 2], rtol=0, atol=1e-5)
        assert (tmp_path / "port" / "train" / f"{name}_viz.png").exists()

    # the cycle's stage 3: retrain on the exported labels, warm-started from the snapshot
    keys = jax_batch_keys(3, 1)
    export_cli.main([*argv, "--device", "cpu", "--out", str(tmp_path / "port"), "--task", "val"])
    retrain = train_cli.main(["--device", "cpu", "--batch_size", "2", "--height", str(H), "--width", str(W),
                              "--data_root", str(data), "--labels", str(tmp_path / "port"), "--run_dir",
                              str(tmp_path / "sp3"), "--train_iter", "2", "--save_interval", "2",
                              "--tensorboard_interval", "1", "--validation_interval", "2",
                              "--init_weights", SP_SYNTH])
    assert retrain["state"].step == 2 and all(np.isfinite(r["loss"]) for r in retrain["logged"])
    assert CheckpointManager(str(tmp_path / "sp3" / "checkpoints")).latest_step() == 2
    # a directory of the port's checkpoints is a checkpoint too; orbax directories raise
    keys = jax_batch_keys(3, 3)
    common = ["--data_root", str(data), "--height", str(H), "--width", str(W), "--num_homographies", str(N),
              "--device", "cpu"]
    export_cli.main([*common, "--checkpoint", str(tmp_path / "sp3" / "checkpoints"), "--out", str(tmp_path / "port3")])
    assert len(os.listdir(tmp_path / "port3" / "train")) == 3
    (tmp_path / "orbax" / "5").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        export_cli.main([*common, "--checkpoint", str(tmp_path / "orbax"), "--out", str(tmp_path / "x")])
