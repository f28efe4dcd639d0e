"""The port's SuperPoint training data (`geometry/labels.py`,
`geometry/warp.py`, `data/synthetic_device.py`, `data/pipeline.py`)
against the JAX package's, on the CPU, with seeded numpy inputs and JAX's
own random draws replayed from its key splits.

Tolerances:
  * integer-valued results (scattered labels, dustbin cells of binary
    maps, nearest warps, eroded and valid masks, synthetic point masks)
    are exact;
  * one f32 op chain (soft labels, splats, the Gaussian label blur) within
    1e-6 absolute, its rounding differences;
  * bilinear warps of random images through a homography within 1e-4:
    the two packages' homography products round the source coordinates a
    few ulp apart (7.6e-6 px at 64 px), times gradients of up to 1 a pixel;
    so the heatmap aggregation and the warped-pair images;
  * synthetic corners within 1e-4 px (cos / sin of two libraries may differ
    in the last place) and images equal on at least 0.999 of the pixels (a
    pixel on a shape's edge may fall either way after such a difference);
  * the warped-pair batch from JAX's homographies and photometric draws:
    labels within 1e-5, images within 1e-4 (the warp), masks exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.data import pipeline as jpipe
from image_matching_tpu.data import synthetic_device as jsyn
from image_matching_tpu.geometry import homography as jh
from image_matching_tpu.geometry import labels as jl
from image_matching_tpu.geometry import warp as jw
from image_matching_tpu_torch.data import pipeline, synthetic_device
from image_matching_tpu_torch.data.photometric import PhotometricDraws
from image_matching_tpu_torch.geometry import labels, warp

from test_torch_data import jax_photometric_draws

T = torch.from_numpy


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _homographies(seed, b, h, w, **kw):
    cfg = jh.HomographyConfig(patch_ratio=0.8, allow_artifacts=True, **kw)
    return np.array(jh.sample_homography_batch(jax.random.PRNGKey(seed), b, h, w, cfg))


# ---------------------------------------------------------------- labels

def test_labels_2d_to_3d_matches_jax():
    rng = np.random.default_rng(0)
    hard = (rng.uniform(size=(2, 32, 48, 1)) < 0.02).astype(np.float32)
    hard[0, :8, :8, 0] = 0.0  # an empty cell
    hard[0, 8:16, :8, 0] = 0.0
    hard[0, 9, 1, 0] = hard[0, 12, 5, 0] = hard[0, 14, 7, 0] = 1.0  # a cell of three points
    soft = np.clip(hard + rng.uniform(0, 0.3, hard.shape) * (rng.uniform(size=hard.shape) < 0.1), 0, 1)
    soft = soft.astype(np.float32)
    for maps in (hard, soft):
        ref = np.asarray(jl.labels_2d_to_3d(jnp.asarray(maps)))
        got = _np(labels.labels_2d_to_3d(T(maps)))
        assert got.shape == (2, 4, 6, 65)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    got = _np(labels.labels_2d_to_3d(T(hard)))
    assert got[0, 0, 0, 64] == 1.0 and got[0, 1, 0, 64] == 0.0 and np.isclose(got[0, 1, 0, :64].max(), 1 / 3)
    np.testing.assert_array_equal(_np(labels.space_to_depth(T(soft))), np.asarray(jl.space_to_depth(jnp.asarray(soft))))
    np.testing.assert_array_equal(_np(labels.depth_to_space(labels.space_to_depth(T(soft)))), soft)


def _points(seed, b=2, k=40, h=32, w=48):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-3, [w + 2, h + 2], (b, k, 2)).astype(np.float32)
    xy[:, :6] = np.round(xy[:, :6]) + 0.5  # pixel halves: round half to even
    xy[:, 6:9] = xy[:, 3:6]  # repeated points
    xy[:, 9:11] = [10.0, 12.0]  # a repeated integer point: its splat clips at 1
    mask = rng.uniform(size=(b, k)) < 0.8
    mask[:, 9:11] = True
    return xy, mask


def test_scatter_and_splat_match_jax():
    xy, mask = _points(1)
    ref = np.stack([np.asarray(jl.scatter_points(jnp.asarray(p), jnp.asarray(m), 32, 48)) for p, m in zip(xy, mask)])
    got = _np(labels.scatter_points(T(xy), T(mask), 32, 48))
    np.testing.assert_array_equal(got, ref)
    assert set(np.unique(got)) == {0.0, 1.0}
    ref = np.stack([np.asarray(jl.splat_points_bilinear(jnp.asarray(p), jnp.asarray(m), 32, 48))
                    for p, m in zip(xy, mask)])
    got = _np(labels.splat_points_bilinear(T(xy), T(mask), 32, 48))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got.max() == 1.0  # repeated points clip


def test_combine_heatmaps_matches_jax():
    rng = np.random.default_rng(2)
    hs = _homographies(3, 4, 32, 48)
    heat = rng.uniform(0, 1, (4, 32, 48, 1)).astype(np.float32)
    masks = np.array(jw.compute_valid_mask(jnp.asarray(np.linalg.inv(hs)), 32, 48))[..., None]
    ref = np.asarray(jl.combine_heatmaps(jnp.asarray(heat), jnp.asarray(hs), jnp.asarray(masks)))
    got = labels.combine_heatmaps(T(heat), T(hs), T(masks))
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=1e-4)
    # leading dims are independent images
    two = labels.combine_heatmaps(T(np.stack([heat, heat[::-1]])), T(np.stack([hs, hs[::-1]])),
                                  T(np.stack([masks, masks[::-1]])))
    np.testing.assert_allclose(_np(two[0]), _np(got), atol=1e-6)
    np.testing.assert_allclose(_np(two[1]), _np(got), atol=1e-5)


# ---------------------------------------------------------------- warp

def test_nearest_warp_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (3, 32, 48, 2)).astype(np.float32)
    h_inv = np.linalg.inv(_homographies(4, 3, 32, 48)).astype(np.float32)
    h_inv[0] = np.array([[1, 0, 0.5], [0, 1, -1.5], [0, 0, 1]], np.float32)  # pixel halves
    ref = np.asarray(jw.warp_image(jnp.asarray(img), jnp.asarray(h_inv), mode="nearest"))
    got = _np(warp.warp_image(T(img), T(h_inv), mode="nearest"))
    np.testing.assert_array_equal(got, ref)
    ref = np.asarray(jw.warp_image(jnp.asarray(img), jnp.asarray(h_inv)))
    np.testing.assert_allclose(_np(warp.warp_image(T(img), T(h_inv))), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("radius", [0, 1, 3])
def test_erode_mask_matches_jax(radius):
    rng = np.random.default_rng(radius)
    mask = (rng.uniform(size=(2, 24, 40)) < 0.9).astype(np.float32)
    mask[0, :, :6] = 1.0  # a full border column
    mask[1, 10:14, 10:30] = 0.0
    np.testing.assert_array_equal(_np(warp.disk_kernel(max(radius, 1))), np.asarray(jw.disk_kernel(max(radius, 1))))
    ref = np.asarray(jw.erode_mask(jnp.asarray(mask), radius))
    got = _np(warp.erode_mask(T(mask), radius))
    np.testing.assert_array_equal(got, ref)
    ones = np.ones((1, 16, 20), np.float32)
    np.testing.assert_array_equal(_np(warp.erode_mask(T(ones), radius)), np.asarray(jw.erode_mask(jnp.asarray(ones), radius)))
    if radius:
        assert got.sum() < mask.sum()
        assert (got[0, :, :radius - 1] == 0).all() if radius > 1 else True  # the border erodes


@pytest.mark.parametrize("radius", [0, 3])
def test_compute_valid_mask_matches_jax(radius):
    h_inv = np.linalg.inv(_homographies(5, 3, 32, 48)).astype(np.float32)
    ref = np.asarray(jw.compute_valid_mask(jnp.asarray(h_inv), 32, 48, radius))
    got = warp.compute_valid_mask(T(h_inv), 32, 48, radius)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), ref)
    assert 0 < ref.mean() < 1
    np.testing.assert_array_equal(_np(warp.compute_valid_mask(T(h_inv[1]), 32, 48, radius)), ref[1])


# ---------------------------------------------------------------- synthetic shapes on the device

def jax_synthetic_draws(key, batch, h, w):
    """The numbers `synthetic_batch(key, batch, h, w)` draws, replayed from
    its key splits as a port `SyntheticDraws`."""
    margin, rmax = max(4, min(h, w) // 8), min(h, w) * 0.2
    lo, hi = jnp.array([margin, margin], jnp.float32), jnp.array([w - margin, h - margin], jnp.float32)
    rows = []
    for k in jax.random.split(key, batch):
        k_bg, k_kind, k_shape = jax.random.split(k, 3)
        kp, kl, kc = jax.random.split(k_shape, 6), jax.random.split(k_shape, 3), jax.random.split(k_shape, 5)
        u = jax.random.uniform
        rows.append(dict(
            background=u(k_bg, (), maxval=0.3), kind=jax.random.randint(k_kind, (), 0, 3),
            n_polys=jax.random.randint(kp[0], (), 1, 4), n_verts=jax.random.randint(kp[1], (3,), 3, 7),
            centers=u(kp[2], (3, 2), minval=lo, maxval=hi), radii=u(kp[3], (3, 6), minval=rmax * 0.3, maxval=rmax),
            angles=u(kp[4], (3, 6), maxval=2 * jnp.pi), poly_shades=u(kp[5], (3,), minval=0.4, maxval=1.0),
            n_lines=jax.random.randint(kl[0], (), 2, 8),
            ends=u(kl[1], (7, 2, 2), minval=jnp.stack([lo, lo]), maxval=jnp.stack([hi, hi])),
            line_shades=u(kl[2], (7,), minval=0.4, maxval=1.0),
            rows=jax.random.randint(kc[0], (), 3, 6), cols=jax.random.randint(kc[1], (), 3, 6),
            cell=u(kc[2], (), minval=min(h, w) / 16, maxval=min(h, w) / 8),
            corner=jnp.stack([u(kc[3], ()), u(kc[4], ())]),
            board_shades=u(jax.random.fold_in(k_shape, 7), (5, 5), minval=0.6, maxval=1.0),
        ))
    stack = {name: np.stack([np.asarray(r[name]) for r in rows]) for name in rows[0]}
    return synthetic_device.SyntheticDraws(**{n: T(v.astype(np.int64) if v.dtype.kind == "i" else v)
                                              for n, v in stack.items()})


def test_synthetic_batch_matches_jax_on_its_draws():
    h, w, b = 64, 96, 24
    kinds = set()
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        ref = jsyn.synthetic_batch(key, b, h, w)
        draws = jax_synthetic_draws(key, b, h, w)
        got = synthetic_device.rasterise_synthetic(draws, h, w)
        kinds |= set(draws.kind.tolist())
        np.testing.assert_array_equal(_np(got["points_mask"]), np.asarray(ref["points_mask"]))
        m = np.asarray(ref["points_mask"])
        np.testing.assert_allclose(_np(got["points"])[m], np.asarray(ref["points"])[m], rtol=0, atol=1e-4)
        same = (_np(got["image"]) == np.asarray(ref["image"])).mean()
        assert got["image"].shape == (b, h, w, 1) and same >= 0.999, same
    assert kinds == {0, 1, 2}


def test_synthetic_draws_cover_the_ranges():
    gen = torch.Generator().manual_seed(0)
    d = synthetic_device.draw_synthetic(gen, 256, 64, 96)
    assert set(d.kind.tolist()) == {0, 1, 2} and set(d.n_verts.flatten().tolist()) == {3, 4, 5, 6}
    assert set(d.n_lines.tolist()) == set(range(2, 8)) and set(d.rows.tolist()) == {3, 4, 5}
    assert (d.background < 0.3).all() and (d.board_shades >= 0.6).all()
    assert (d.centers[..., 0] >= 8).all() and (d.centers[..., 0] <= 88).all()
    batch = synthetic_device.synthetic_batch(torch.Generator().manual_seed(1), 8, 64, 96)
    again = synthetic_device.synthetic_batch(torch.Generator().manual_seed(1), 8, 64, 96)
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    assert batch["image"].min() >= 0 and batch["image"].max() <= 1 and batch["points_mask"].any(dim=1).all()
    one = synthetic_device.synthetic_sample(torch.Generator().manual_seed(1), 64, 96)
    assert one["image"].shape == (64, 96, 1) and one["points"].shape == (64, 2)
    with pytest.raises(ValueError, match="too small"):
        synthetic_device.synthetic_batch(gen, 1, 64, 96, max_points=20)


# ---------------------------------------------------------------- the warped-pair batch

def _jax_pair_draws(key, shape, cfg):
    """The homographies and photometric draws of `make_warped_pair_batch(key, ...)`."""
    k_h, k_aug0, k_aug1 = jax.random.split(key, 3)
    hs = np.array(jh.sample_homography_batch(k_h, shape[0], shape[1], shape[2], cfg.homography))
    photo = []
    for k_aug in (k_aug0, k_aug1):
        per_image = [jax_photometric_draws(k, shape[1:])[0] for k in jax.random.split(k_aug, shape[0])]
        photo.append(PhotometricDraws(**{f: torch.cat([d[f] for d in per_image]) for f in PhotometricDraws._fields}))
    return pipeline.WarpedPairDraws(T(hs), tuple(photo))


@pytest.mark.parametrize("sigma,augment", [(0.2, True), (0.0, False)])
def test_warped_pair_batch_matches_jax_on_its_draws(sigma, augment):
    h, w, b = 48, 64, 2
    key = jax.random.PRNGKey(7)
    src = jsyn.synthetic_batch(jax.random.PRNGKey(8), b, h, w)
    jcfg = jpipe.WarpedPairConfig(gaussian_label_sigma=sigma)
    ref = jpipe.make_warped_pair_batch(key, src["image"], src["points"], src["points_mask"], jcfg, augment)
    pcfg = pipeline.WarpedPairConfig(gaussian_label_sigma=sigma)
    draws = _jax_pair_draws(key, (b, h, w, 1), jcfg)
    if not augment:
        draws = draws._replace(photometric=None)
    got = pipeline.warped_pair_from_draws(draws, T(np.array(src["image"])), T(np.array(src["points"])),
                                          T(np.array(src["points_mask"])), pcfg)
    assert set(got) == set(ref)
    for name in ("valid_mask", "warped_valid_mask"):
        np.testing.assert_array_equal(_np(got[name]), np.asarray(ref[name]), err_msg=name)
    for name, tol in (("image", 1e-5), ("labels_2d", 1e-5), ("warped_image", 1e-4), ("warped_labels", 1e-5),
                      ("homographies", 1e-6)):  # JAX's sampler, jitted and not, 2e-7 apart
        np.testing.assert_allclose(_np(got[name]), np.asarray(ref[name]), rtol=0, atol=tol, err_msg=name)
    assert got["labels_2d"].max() == 1.0 and 0 < _np(got["warped_valid_mask"]).mean() < 1
    if sigma > 0:  # soft labels around each point
        assert ((_np(got["labels_2d"]) > 0) & (_np(got["labels_2d"]) < 1)).any()
    # the generator's own draws: seeded, and the identity without augmentation
    gen_batch = pipeline.make_warped_pair_batch(torch.Generator().manual_seed(3), T(np.array(src["image"])),
                                                T(np.array(src["points"])), T(np.array(src["points_mask"])), pcfg,
                                                augment)
    assert torch.equal(gen_batch["image"], T(np.array(src["image"]))) != augment
