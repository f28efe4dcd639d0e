"""The port's datasets and photometric augmentation (`data/datasets.py`,
`data/photometric.py`) against the JAX package's, on the CPU.

Tolerances:
  * `SyntheticShapesDataset`: the same seed gives the same points, exactly,
    and images equal on at least 0.999 of their pixels. Pixels could differ
    only on edge columns of general polygons that leave the image, where
    `imgproc.fill_poly` and OpenCV 5's fillPoly may still disagree; none
    differs on the 100 samples here (nor on 200 at 240x320, measured once);
  * `SSHIDataset` on the same PNG files: equal arrays (the decoder and the
    area resize are exact);
  * photometric: each op's apply step, fed the numbers the JAX op draws
    from its key (replayed here from the key splits of
    `image_matching_tpu/data/photometric.py`), within 1e-6 of the JAX op,
    and the six ops with the clip (`_augment_one`, and the batch) too.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.data import datasets as jax_datasets
from image_matching_tpu.data import photometric as jp
from image_matching_tpu_torch.data import datasets, photometric

T = torch.from_numpy


# ---------------------------------------------------------------- datasets

def test_synthetic_shapes_match_jax():
    differing = []
    for seed in range(50):
        ref = jax_datasets.SyntheticShapesDataset(60, 80, max_points=48, seed=seed)
        got = datasets.SyntheticShapesDataset(60, 80, max_points=48, seed=seed)
        for _ in range(2):  # the second sample continues the same generator
            r, g = ref.sample(), got.sample()
            np.testing.assert_array_equal(g["points"], r["points"])
            np.testing.assert_array_equal(g["points_mask"], r["points_mask"])
            assert g["image"].dtype == r["image"].dtype == np.float32 and g["image"].shape == (60, 80, 1)
            differing.append(int((g["image"] != r["image"]).sum()))
    share = sum(differing) / (len(differing) * 60 * 80)
    assert share <= 1e-3, (share, differing)
    assert sum(d > 0 for d in differing) <= 5


def test_synthetic_shapes_batches_and_registry():
    ds = datasets.get_dataset("synthetic_shapes", height=32, width=48, seed=3)
    batch = next(ds.batches(3))
    assert batch["image"].shape == (3, 32, 48, 1) and batch["points"].shape == (3, 64, 2)
    assert batch["points_mask"].dtype == bool and batch["points_mask"].any()


def _write_images(directory, rng, n, h, w):
    directory.mkdir()
    for i in range(n):
        img = cv2.GaussianBlur(rng.uniform(0, 255, (h, w)).astype(np.uint8), (5, 5), 0)
        cv2.imwrite(str(directory / f"s{i}.png"), img if i % 2 else np.dstack([img, img[::-1], 255 - img]))
    (directory / "notes.txt").write_text("not an image")


@pytest.mark.parametrize("scale", [0.5, 0.25, 1 / 3, 1.0])
def test_sshi_dataset_equals_jax(tmp_path, scale):
    rng = np.random.default_rng(0)
    _write_images(tmp_path / "src", rng, 3, 90, 124)
    template = tmp_path / "template.png"
    cv2.imwrite(str(template), rng.integers(0, 256, (90, 124), dtype=np.uint8))
    ref = jax_datasets.SSHIDataset(str(template), str(tmp_path / "src"), scale)
    got = datasets.SSHIDataset(str(template), str(tmp_path / "src"), scale)
    assert len(got) == len(ref) == 3
    for i in range(3):
        r, g = ref[i], got[i]
        assert g["name"] == r["name"] == f"s{i}"
        for key in ("source_orig", "source", "template"):
            assert g[key].dtype == np.float32
            np.testing.assert_array_equal(g[key], r[key])


def test_allss_dataset_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    _write_images(tmp_path / "train", rng, 5, 70, 90)
    labels = tmp_path / "labels" / "train"
    labels.mkdir(parents=True)
    for i in range(5):
        np.savez(labels / f"s{i}.npz", pts=rng.uniform(0, 60, (10 + i, 3)).astype(np.float32))
    kw = dict(labels_dir=str(tmp_path / "labels"), resize=(48, 64), max_points=12)
    ref = jax_datasets.ALLSSDataset(str(tmp_path), "train", **kw)
    got = datasets.ALLSSDataset(str(tmp_path), "train", **kw)
    for _, rb, gb in zip(range(5), ref.batches(2, seed=4), got.batches(2, seed=4)):  # two passes, reshuffled
        assert gb["names"] == rb["names"]
        for key in ("image", "points", "points_mask"):
            np.testing.assert_array_equal(gb[key], rb[key])


def test_load_gray_raises_on_unreadable_files(tmp_path):
    cv2.imwrite(str(tmp_path / "a.tif"), np.zeros((8, 8), np.uint8), [cv2.IMWRITE_TIFF_COMPRESSION, 5])
    with pytest.raises(ValueError, match="reads 8-bit PNG"):
        datasets._load_gray(str(tmp_path / "a.tif"))
    with pytest.raises(FileNotFoundError):
        datasets._load_gray(str(tmp_path / "missing.png"))


# ---------------------------------------------------------------- photometric

CFG = jp.PhotometricConfig()


def jax_photometric_draws(key, shape, cfg=CFG):
    """The numbers `_augment_one(key, img, cfg)` draws, replayed from its
    key splits, as one image's port draws."""
    h, w = shape[:2]
    k = jax.random.split(key, 6)
    k_noise = jax.random.split(k[2])
    k_speckle = jax.random.split(k[3], 3)
    k_motion = jax.random.split(k[4])
    k_shade = jax.random.split(k[5], 7)
    u = lambda kk, lo, hi, s=(): jax.random.uniform(kk, s, minval=lo, maxval=hi)
    vals = dict(
        brightness=u(k[0], -cfg.max_abs_brightness, cfg.max_abs_brightness),
        contrast=u(k[1], *cfg.contrast_range),
        noise_std=u(k_noise[0], *cfg.gaussian_noise_std_range),
        noise=jax.random.normal(k_noise[1], shape),
        speckle_prob=u(k_speckle[0], *cfg.speckle_prob_range),
        speckle_u=jax.random.uniform(k_speckle[1], shape),
        speckle_salt=jax.random.uniform(k_speckle[2], shape) > 0.5,
        motion_kernel=jax.random.randint(k_motion[0], (), 0, 4),
        motion_apply=jax.random.uniform(k_motion[1], ()) > 0.5,
        shade=jnp.stack([u(k_shade[0], 0.0, float(w)), u(k_shade[1], 0.0, float(h)), u(k_shade[2], w * 0.1, w * 0.5),
                         u(k_shade[3], h * 0.1, h * 0.5), u(k_shade[4], 0.0, jnp.pi),
                         u(k_shade[5], *cfg.shade_transparency_range)]),
        shade_apply=jax.random.uniform(k_shade[6], ()) < cfg.shade_prob,
    )
    return {name: torch.from_numpy(np.array(v))[None] for name, v in vals.items()}, k


def _stack(draws):
    return photometric.PhotometricDraws(**{f: torch.cat([d[f] for d in draws]) for f in photometric.PhotometricDraws._fields})


def _image(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.uniform(0, 1, (h, w)).astype(np.float32), (5, 5), 0)[..., None]


def _ops_cases():
    """Each of the six ops with its draws, at several keys so that the
    motion kernels and the applied / skipped branches all occur."""
    return [
        ("brightness", jp._random_brightness, lambda x, d: photometric.apply_brightness(x, d["brightness"])),
        ("contrast", jp._random_contrast, lambda x, d: photometric.apply_contrast(x, d["contrast"])),
        ("gaussian_noise", jp._gaussian_noise,
         lambda x, d: photometric.apply_gaussian_noise(x, d["noise_std"], d["noise"])),
        ("speckle", jp._speckle_noise,
         lambda x, d: photometric.apply_speckle(x, d["speckle_prob"], d["speckle_u"], d["speckle_salt"])),
        ("motion_blur", jp._motion_blur,
         lambda x, d: photometric.apply_motion_blur(x, d["motion_kernel"], d["motion_apply"], CFG.motion_blur_max_ksize)),
        ("additive_shade", jp._additive_shade,
         lambda x, d: photometric.apply_additive_shade(x, d["shade"], d["shade_apply"], CFG.shade_kernel_size)),
    ]


@pytest.mark.parametrize("index", range(6), ids=[c[0] for c in _ops_cases()])
def test_each_op_matches_jax_on_its_draws(index):
    name, jax_op, port_apply = _ops_cases()[index]
    seen = set()
    for seed in range(12):
        img = _image(seed)
        draws, keys = jax_photometric_draws(jax.random.PRNGKey(seed), img.shape)
        speckle_cfg = CFG._replace(speckle_prob_range=(0.2, 0.4)) if name == "speckle" else CFG
        if name == "speckle":  # a probability that replaces pixels in a small image
            draws["speckle_prob"] = torch.from_numpy(np.array(
                jax.random.uniform(jax.random.split(keys[3], 3)[0], (), minval=0.2, maxval=0.4)))[None]
        ref = np.asarray(jax.jit(jax_op, static_argnums=2)(keys[index], jnp.asarray(img), speckle_cfg))
        got = port_apply(T(img)[None], draws)[0].numpy()
        assert got.shape == ref.shape and got.dtype == np.float32
        assert np.abs(got - ref).max() <= 1e-6, (name, seed, np.abs(got - ref).max())
        seen.add((int(draws["motion_kernel"]), bool(draws["motion_apply"]), bool(draws["shade_apply"])))
        assert name != "speckle" or (got != img).any()
    if name == "motion_blur":
        assert {k for k, a, _ in seen if a} == {0, 1, 2, 3}
    if name == "additive_shade":
        assert {s for _, _, s in seen} == {True, False}


def test_motion_kernels_match_jax():
    for k in (3, 5):
        np.testing.assert_array_equal(photometric.motion_kernels(k).numpy(), np.asarray(jp._motion_kernels(k)))


def test_augment_matches_jax_one_and_batched():
    key = jax.random.PRNGKey(11)
    images = np.stack([_image(s) for s in range(4)])
    ref = np.asarray(jp.photometric_augment(key, jnp.asarray(images), CFG))
    draws = [jax_photometric_draws(k, images.shape[1:])[0] for k in jax.random.split(key, 4)]
    got = photometric.apply_photometric(T(images), _stack(draws), CFG).numpy()
    assert np.abs(got - ref).max() <= 1e-6
    one = np.asarray(jax.jit(jp._augment_one, static_argnums=2)(jax.random.split(key, 4)[1], jnp.asarray(images[1]), CFG))
    assert np.abs(got[1] - one).max() <= 1e-6
    assert np.abs(got - images).max() > 0.05  # the ops did change the images


def test_disabled_augment_is_the_identity_and_draws_are_seeded():
    images = T(np.stack([_image(s) for s in range(2)]))
    off = photometric.PhotometricConfig(enable=False)
    gen = torch.Generator().manual_seed(0)
    assert photometric.photometric_augment(gen, images, off) is images
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(0).get_state())  # nothing drawn
    a = photometric.photometric_augment(torch.Generator().manual_seed(5), images)
    b = photometric.photometric_augment(torch.Generator().manual_seed(5), images)
    assert torch.equal(a, b) and a.min() >= 0 and a.max() <= 1 and not torch.equal(a, images)
    d = photometric.draw_photometric(torch.Generator().manual_seed(1), (64, 8, 8, 1))
    assert (d.brightness.abs() <= CFG.max_abs_brightness).all() and set(d.motion_kernel.tolist()) == {0, 1, 2, 3}
    assert (d.shade[:, 2] >= 0.8).all() and (d.shade[:, 2] <= 4).all() and d.shade_apply.float().mean() > 0.5
