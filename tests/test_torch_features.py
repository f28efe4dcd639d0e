"""The port's classical features (`ops/resize.py`, `ops/topk.py`,
`features/{sift,orb,registration}.py`) against the JAX package's, on the
CPU, on the same inputs. Tolerances:

  * `resize_linear` against `jax.image.resize(..., "linear")`: within 1e-6
    (XLA contracts the sample positions into FMAs, which the port
    reproduces; what remains are other float32 roundings in the weights'
    normalisation and the products' sum order);
  * SIFT stage by stage, each stage fed JAX's own intermediate: gaussian
    layers and DoG within 1e-6; the octave's candidates the same set, with
    layer equal and xy within 1e-4; orientation histograms within 1e-5 of
    max(|h|, 1), peaks and descriptors within 1e-5;
  * SIFT whole: >= 0.98 of JAX's valid keypoints have a port keypoint
    within 1e-3 px, and of those >= 0.98 a descriptor within 1e-3 and all
    within 0.05 (measured: all within 3.9e-4); scores within 1e-4 relative. Not the 1e-4 / 1e-5 of the stages: the pyramid's
    blurs (`sift.separable_filter`) sum their 9-19 taps in another order
    than XLA's convolution (one or two float32 steps a layer, 4.2e-7 at
    most, as the stage test shows), DoG layers subtract close values, and
    the quadratic refinement's 3x3 solve amplifies that to ~2.6e-4 px in
    keypoint position, which the descriptor windows then sample (measured
    with a library convolution in the port: 3.1e-4 on descriptors, 1.02e-5
    relative on scores); a rare keypoint whose secondary-orientation or
    edge test sits on the boundary changes its slots;
  * ORB: level 0's FAST map and its top-k order equal bit for bit on an
    8-bit image with tied scores; the BRIEF table and the scaled, clipped
    pattern bit for bit; whole ORB >= 0.98 keypoints identical, descriptors
    within 2 bits on those;
  * the classical register functions, fed the sample indices JAX draws
    from its key: ORB the same keypoints and matches slot for slot, SIFT
    the same as point sets up to the boundary keypoints above (>= 0.99 of
    each side's keypoints, >= 0.98 of the matched pairs), and for both the
    fit within 1e-3 px of corner error of JAX's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_matching_tpu.features.orb as jorb
import image_matching_tpu.features.sift as jsift
from image_matching_tpu.evaluation import corner_error
from image_matching_tpu.features.registration import build_classical_registration_fn as jax_build
from image_matching_tpu.ops import ransac as jax_ransac
from image_matching_tpu_torch import imgproc
from image_matching_tpu_torch.features import orb, sift
from image_matching_tpu_torch.features.registration import build_classical_registration_fn
from image_matching_tpu_torch.ops.resize import resize_linear
from image_matching_tpu_torch.ops.topk import topk_lower_index_first

H, W = 128, 160


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work. Under the suite's
    six xdist workers, torch's default of one OpenMP thread a core makes
    every small op of these pipelines wait on oversubscribed thread teams:
    measured on 8 cores, six processes registering one SIFT pair 3 times
    took 809 s each with 8 threads and 1.6 s with 1."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def textured(seed, h=H, w=W, sigma=1.5):
    """Smoothed uniform noise stretched to [0, 1]: blobs at every scale."""
    img = imgproc.gaussian_blur(np.random.default_rng(seed).uniform(0, 1, (h, w)).astype(np.float32), sigma)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


def eight_bit(img):
    return (np.round(img * 255) / 255).astype(np.float32)


def similar_pair(seed):
    """A textured image and the same image warped by a known similarity."""
    img = textured(seed)
    ang, sc = 0.15, 1.05
    c, s = math.cos(ang) * sc, math.sin(ang) * sc
    cx, cy = W / 2, H / 2
    mat = np.float32([[c, -s, 6 + cx - c * cx + s * cy], [s, c, -4 + cy - s * cx - c * cy]])
    return img, np.clip(imgproc.warp_affine(img, mat, (W, H)), 0, 1).astype(np.float32), mat


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize("level", [-1, 1, 2, 3, 4, 5, 6, 7])
def test_resize_linear_matches_jax(level):
    img = textured(0)
    shape = (2 * H, 2 * W) if level < 0 else (int(round(H / 1.2 ** level)), int(round(W / 1.2 ** level)))
    ref = np.asarray(jax.image.resize(jnp.asarray(img), shape, "linear"))
    got = resize_linear(_t(img)[None], shape)[0].numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6


def test_resize_linear_antialiases_downscales():
    """A 1.2x downscale is a widened triangle filter: a bilinear sample
    (F.interpolate) of a one-pixel checkerboard differs from it."""
    img = (np.indices((60, 60)).sum(0) % 2).astype(np.float32)
    got = resize_linear(_t(img)[None], (50, 50))[0].numpy()
    bilinear = torch.nn.functional.interpolate(_t(img)[None, None], (50, 50), mode="bilinear")[0, 0].numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (50, 50), "linear"))
    assert np.abs(got - ref).max() <= 1e-6 and np.abs(bilinear - ref).max() > 0.1


def test_topk_keeps_lax_top_k_order_among_ties():
    x = np.array([[0.5, 1.0, 0.5, -1.0, 1.0, 0.0, -0.0, 0.5, 0.0, -1.0]], np.float32)
    for k in (1, 4, 7, 10):
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
        v, i = topk_lower_index_first(_t(x), k)
        assert np.array_equal(i.numpy(), np.asarray(ref_i)) and np.array_equal(v.numpy(), np.asarray(ref_v))


# ---------------------------------------------------------------- SIFT, stage by stage

@pytest.fixture(scope="module")
def jax_sift_stages():
    """JAX's octave 0 of one image: the doubled image, the gaussian layers,
    the DoG stack, its keypoints, the gradient stacks, histograms, peaks."""
    cfg = jsift.SIFTConfig()
    s = cfg.scales_per_octave
    sig = [cfg.sigma0 * 2.0 ** (i / s) for i in range(s + 3)]
    img = textured(1)

    @jax.jit
    def stages(im):
        up = jax.image.resize(im, (2 * H, 2 * W), "linear")
        gs = [jsift._blur(up, math.sqrt(cfg.sigma0 ** 2 - 1.0))]
        for i in range(1, s + 3):
            gs.append(jsift._blur(gs[-1], math.sqrt(sig[i] ** 2 - sig[i - 1] ** 2)))
        dogs = jnp.stack([gs[i + 1] - gs[i] for i in range(s + 2)])
        kps = jsift._octave_keypoints(dogs, cfg, cfg.per_octave_cap)
        g = jnp.stack(gs[1:s + 1], -1)
        gx = (jnp.roll(g, -1, 1) - jnp.roll(g, 1, 1)) / 2.0
        gy = (jnp.roll(g, -1, 0) - jnp.roll(g, 1, 0)) / 2.0
        gmag, gori = jnp.sqrt(gx * gx + gy * gy), jnp.arctan2(gy, gx)
        xf, yf, layer, xi_s = kps[:4]
        sel = jax.nn.one_hot(jnp.clip(layer - 1, 0, s - 1), s)
        scl = cfg.sigma0 * jnp.power(2.0, (layer.astype(jnp.float32) + xi_s) / s)
        hist = jsift._orientation_histograms(gmag, gori, xf, yf, sel, scl)
        th1, th2, has2 = jsift._orientation_peaks(hist, cfg.ori_peak_ratio)
        desc = jsift._descriptor(gmag, gori, xf, yf, sel, th1, scl, cfg)
        return dict(up=up, gs=jnp.stack(gs), dogs=dogs, kps=kps, gmag=gmag, gori=gori, scl=scl, hist=hist,
                    peaks=(th1, th2, has2), desc=desc)

    out = jax.device_get(stages(jnp.asarray(img)))
    return dict(out, sigmas=sig, cfg=sift.SIFTConfig())


def test_sift_pyramid_and_dog_match_jax(jax_sift_stages):
    j = jax_sift_stages
    cfg, sig, s = j["cfg"], j["sigmas"], j["cfg"].scales_per_octave
    assert np.abs(resize_linear(_t(textured(1))[None], (2 * H, 2 * W))[0].numpy() - j["up"]).max() <= 1e-6
    layers = [sift._blur(_t(j["up"])[None], math.sqrt(cfg.sigma0 ** 2 - 1.0))]
    for i in range(1, s + 3):  # each layer from JAX's previous one
        layers.append(sift._blur(_t(j["gs"][i - 1])[None], math.sqrt(sig[i] ** 2 - sig[i - 1] ** 2)))
    got = torch.cat(layers).numpy()
    assert np.abs(got - j["gs"]).max() <= 1e-6
    assert np.abs((got[1:] - got[:-1]) - j["dogs"]).max() <= 1e-6


def test_sift_octave_keypoints_fed_jax_dogs(jax_sift_stages):
    j = jax_sift_stages
    got = [a[0].numpy() for a in sift._octave_keypoints(_t(j["dogs"])[None], j["cfg"], 512)]
    ref = [np.asarray(a) for a in j["kps"]]
    vj, vt = ref[5], got[5]
    assert vj.sum() > 200 and np.array_equal(vj, vt)
    assert np.array_equal(ref[2][vj], got[2][vt])  # layers
    for i in (0, 1, 3):  # x, y, sigma offset
        assert np.abs(ref[i][vj] - got[i][vt]).max() <= 1e-4
    assert np.abs(ref[4][vj] - got[4][vt]).max() <= 1e-5  # |D^|


def test_sift_orientations_and_descriptors_fed_jax_inputs(jax_sift_stages):
    j = jax_sift_stages
    s = j["cfg"].scales_per_octave
    xf, yf, layer = (_t(a)[None] for a in j["kps"][:3])
    valid = np.asarray(j["kps"][5])
    gmag_s, gori_s = (_t(j[k])[None] for k in ("gmag", "gori"))
    got_m, got_o = sift._gradients([_t(a)[None] for a in j["gs"]], s)
    assert np.abs(got_m.numpy() - gmag_s.numpy()).max() <= 1e-6
    assert np.abs(got_o.numpy() - gori_s.numpy()).max() <= 1e-5
    lsel, scl = (layer.long() - 1).clamp(0, s - 1), _t(j["scl"])[None]
    hist = sift._orientation_histograms(gmag_s, gori_s, xf, yf, lsel, scl)[0].numpy()
    assert np.abs(hist - j["hist"]).max() <= 1e-5 * max(1.0, np.abs(j["hist"]).max())
    th1, th2, has2 = (a[0].numpy() for a in sift._orientation_peaks(_t(j["hist"])[None], 0.8))
    assert np.array_equal(has2, np.asarray(j["peaks"][2]))
    assert np.abs(th1 - j["peaks"][0]).max() <= 1e-5 and np.abs(th2 - j["peaks"][1]).max() <= 1e-5
    desc = sift._descriptor(gmag_s, gori_s, xf, yf, lsel, _t(j["peaks"][0])[None], scl, j["cfg"])[0].numpy()
    assert np.abs(desc - j["desc"])[valid].max() <= 1e-5


# ---------------------------------------------------------------- SIFT whole, ORB whole

@pytest.fixture(scope="module")
def whole_sift():
    img = textured(1)
    return jax.device_get(jsift.sift_detect_and_describe(jnp.asarray(img))), sift.sift_detect_and_describe(
        _t(img)[None, :, :, None])


def _shared(ref_xy, got_xy, tol=1e-3):
    """For each row of ref_xy, whether got_xy has a row within tol (px)."""
    return np.abs(ref_xy[:, None] - got_xy[None]).max(-1).min(1) <= tol


def test_sift_whole_matches_jax(whole_sift):
    ref, got = whole_sift
    mj, mt = np.asarray(ref.mask), got.mask[0].numpy()
    assert mj.sum() > 400 and abs(int(mt.sum()) - int(mj.sum())) <= 0.02 * mj.sum()
    xj, xt = np.asarray(ref.xy)[mj], got.xy[0].numpy()[mt]
    assert _shared(xj, xt).mean() >= 0.98
    # a keypoint with two orientations fills two slots at one position: pair
    # each JAX slot with the port slot at its position whose descriptor is closest
    dj, dt = np.asarray(ref.desc)[mj], got.desc[0].numpy()[mt]
    sj, st = np.asarray(ref.score)[mj], got.score[0].numpy()[mt]
    desc_err, score_err = [], []
    for i in np.nonzero(_shared(xj, xt))[0]:
        cand = np.nonzero(np.abs(xt - xj[i]).max(-1) <= 1e-3)[0]
        best = cand[np.abs(dt[cand] - dj[i]).max(-1).argmin()]
        desc_err.append(np.abs(dt[best] - dj[i]).max())
        score_err.append(abs(st[best] - sj[i]) / sj[i])
    assert np.mean(np.asarray(desc_err) <= 1e-3) >= 0.98 and np.max(desc_err) <= 0.05
    assert np.max(score_err) <= 1e-4


def test_sift_batch_gives_each_image_its_own_result():
    imgs = np.stack([textured(2, 96, 128), textured(3, 96, 128)])
    batch = sift.sift_detect_and_describe(_t(imgs)[..., None])
    for i in range(2):
        one = sift.sift_detect_and_describe(_t(imgs[i])[None])
        assert torch.equal(batch.mask[i], one.mask[0]) and torch.allclose(batch.xy[i], one.xy[0], atol=1e-5)
        assert torch.allclose(batch.desc[i], one.desc[0], atol=1e-5)


def test_fast_score_and_level_topk_bit_for_bit():
    img = eight_bit(textured(4))
    cfg = orb.ORBConfig()
    ref = np.asarray(jax.jit(lambda x: jorb.fast_score(x, jorb.ORBConfig()))(jnp.asarray(img)))
    got = orb.fast_score(_t(img)[None], cfg)[0].numpy()
    assert (ref > 0).sum() > 50 and np.array_equal(ref.view(np.int32), got.view(np.int32))
    # ties among the corner scores (8-bit differences) and the zeros order the top-k
    nms = np.asarray(jax.jit(lambda x: jax.lax.top_k(x.reshape(-1), 300))(jnp.asarray(ref))[1])
    vals = ref.reshape(-1)[nms]
    assert len(np.unique(vals[vals > 0])) < (vals > 0).sum()  # ties are there
    assert np.array_equal(topk_lower_index_first(_t(got).reshape(1, -1), 300)[1][0].numpy(), nms)


def test_brief_table_and_pattern_bit_for_bit():
    from image_matching_tpu_torch.features import _brief_table

    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (256, 2, 2)))
    assert ref.dtype == np.float32 and np.array_equal(_brief_table.unit_normals().view(np.int32), ref.view(np.int32))
    pat = np.asarray(jorb._brief_pattern(jorb.ORBConfig()))
    got = orb.brief_pattern(orb.ORBConfig(), torch.device("cpu")).numpy()
    assert np.array_equal(got.view(np.int32), pat.view(np.int32))


@pytest.mark.parametrize("field", [dict(pattern_seed=8), dict(n_tests=128)])
def test_other_brief_patterns_are_refused(field):
    cfg = orb.ORBConfig(**field)
    with pytest.raises(ValueError, match="pattern_seed=7 and n_tests=256"):
        orb.orb_detect_and_describe(torch.zeros(1, 64, 64, 1), cfg)
    with pytest.raises(ValueError, match="pattern_seed=7 and n_tests=256"):
        build_classical_registration_fn("orb", orb_config=cfg)


def test_orb_whole_matches_jax():
    img = eight_bit(textured(4))
    ref = jax.device_get(jorb.orb_detect_and_describe(jnp.asarray(img)))
    got = orb.orb_detect_and_describe(_t(img)[None, :, :, None])
    mj = np.asarray(ref.mask)
    assert mj.sum() > 200 and got.desc.dtype == torch.uint8 and got.desc.shape == (1, 512, 32)
    same = np.all(np.asarray(ref.xy) == got.xy[0].numpy(), -1) & mj & got.mask[0].numpy()
    assert same.sum() >= 0.98 * mj.sum()
    bits = np.unpackbits(np.asarray(ref.desc), axis=-1) != np.unpackbits(got.desc[0].numpy(), axis=-1)
    assert bits.sum(-1)[same].max() <= 2


def test_orb_batch_gives_each_image_its_own_result():
    imgs = np.stack([eight_bit(textured(5, 96, 128)), eight_bit(textured(6, 96, 128))])
    batch = orb.orb_detect_and_describe(_t(imgs))
    for i in range(2):
        one = orb.orb_detect_and_describe(_t(imgs[i])[None])
        assert torch.equal(batch.xy[i], one.xy[0]) and torch.equal(batch.desc[i], one.desc[0])


# ---------------------------------------------------------------- registration

@pytest.mark.parametrize("method", ["sift", "orb"])
def test_classical_register_matches_jax_on_its_draws(method):
    """ORB: the same keypoints and matches slot for slot. SIFT: the same as
    point sets up to a keypoint or two, since a keypoint whose convergence
    or edge test sits on a float32 boundary of the pyramid (see the module
    docstring) can go either way (here 1 of 563, in the second image); the
    replayed samples then pick matches one slot apart, and the fits still
    agree within 1e-3 px."""
    img0, img1, gt = similar_pair(7)
    if method == "orb":
        img0, img1 = eight_bit(img0), eight_bit(img1)
    key = jax.random.PRNGKey(3)
    jr = jax.device_get(jax.jit(jax_build(method))(jnp.asarray(img0[..., None]), jnp.asarray(img1[..., None]), key))
    valid = jnp.asarray(jr.matches.matches0 >= 0)
    idx = _t(np.asarray(jax_ransac._sample_indices(key, valid, 512, 2)))[None]
    got = build_classical_registration_fn(method)(_t(img0)[None, :, :, None], _t(img1)[None, :, :, None],
                                                  indices=idx)
    m0 = np.asarray(jr.matches.matches0)
    pairs = {}
    for pkg, r, sel in (("jax", jr, lambda a: np.asarray(a)), ("port", got, lambda a: a[0].numpy())):
        xy0, xy1, mm = sel(r.kpts0.xy), sel(r.kpts1.xy), sel(r.matches.matches0)
        pairs[pkg] = np.concatenate([xy0[mm >= 0], xy1[mm[mm >= 0]]], axis=1)
    if method == "orb":
        for side in ("kpts0", "kpts1"):
            kj, kt = getattr(jr, side), getattr(got, side)
            assert np.array_equal(np.asarray(kj.mask), kt.mask[0].numpy())
            assert np.array_equal(np.asarray(kj.xy), kt.xy[0].numpy())
        assert np.array_equal(m0, got.matches.matches0[0].numpy())
    else:
        for side in ("kpts0", "kpts1"):
            kj, kt = getattr(jr, side), getattr(got, side)
            xj, xt = np.asarray(kj.xy)[np.asarray(kj.mask)], kt.xy[0].numpy()[kt.mask[0].numpy()]
            assert abs(len(xj) - len(xt)) <= 2 and _shared(xj, xt).mean() >= 0.99 and _shared(xt, xj).mean() >= 0.99
        assert _shared(pairs["jax"], pairs["port"]).mean() >= 0.98
    assert (m0 >= 0).sum() >= 100 and abs(len(pairs["jax"]) - len(pairs["port"])) <= 2
    assert bool(jr.fit.valid) and bool(got.fit.valid[0])
    assert corner_error(got.fit.matrix[0].numpy(), np.asarray(jr.fit.matrix), H, W) <= 1e-3
    assert corner_error(got.fit.matrix[0].numpy(), gt, H, W) < 1.0


def test_classical_register_draws_from_a_generator_and_needs_one():
    img0, img1, gt = similar_pair(8)
    register = build_classical_registration_fn("sift", ransac_model="homography")
    res = register(_t(img0)[None, :, :, None], _t(img1)[None, :, :, None], torch.Generator().manual_seed(0))
    assert res.fit.matrix.shape == (1, 3, 3) and bool(res.fit.valid[0]) and res.warped is None
    assert corner_error(res.fit.matrix[0].numpy(), gt, H, W) < 1.0
    with pytest.raises(ValueError, match="Generator"):
        register(_t(img0)[None, :, :, None], _t(img1)[None, :, :, None])
