"""The port's SuperPoint training (the conv batch norm's training branch,
`SuperPointBN(train=True)`, `losses/{detector,descriptor,subpixel}.py`,
`train/metrics.py`, `train/superpoint_trainer.py`) against the JAX
package on the CPU, on the same seeded inputs and weights, with JAX's own
random draws replayed from its key splits.

Everything runs in f32 but one bf16 step (`test_bf16_gradients_held_to_jax_bf16`,
the training CLI's compute dtype), held to JAX's bf16 gradients by how far
bf16 moves each package from its own f32 gradients, as SuperGlue's are in
`test_torch_train.py`. Tolerances:
  * one f32 op chain (batch norm, a loss on given maps) within 1e-5
    relative, its rounding differences; the metrics' counts exactly;
  * a SuperPoint forward in training within 1e-4 of the largest output
    (convolutions summed in another order, compounded), its running
    statistics within 1e-5;
  * one train step: the loss and each metric within 1e-5 relative, the
    running statistics within 1e-5, and Adam's update held as
    `test_torch_train.py` holds SuperGlue's (rtol 1e-3 where the gradient
    stands above rounding noise, the parameters within 2 lr elsewhere);
    the evaluation step on JAX's updated state (carried across by the
    weight conversion) within 1e-4 absolute.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from image_matching_tpu.data import pipeline as jpipe
from image_matching_tpu.data import synthetic_device as jsyn
from image_matching_tpu.losses import descriptor as jdesc
from image_matching_tpu.losses import detector as jdet
from image_matching_tpu.losses import subpixel as jsub
from image_matching_tpu.models.superpoint import SuperPointBN as JaxSuperPointBN
from image_matching_tpu.train import create_train_state
from image_matching_tpu.train import metrics as jmetrics
from image_matching_tpu.train import superpoint_trainer as jtrainer
from image_matching_tpu.utils.weights import flatten_tree
from image_matching_tpu_torch.losses import descriptor, detector, subpixel
from image_matching_tpu_torch.models import SuperPointBN, common, superpoint
from image_matching_tpu_torch.models.common import BatchNorm
from image_matching_tpu_torch.train import metrics, superpoint_trainer
from image_matching_tpu_torch.train.state import TrainState
from image_matching_tpu_torch.weights import load_jax_params, params_to_jax

from test_torch_features import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_train import STRICT_BF16, _perturb

T = torch.from_numpy
H, W, B, D = 64, 64, 2, 32
LR = 1e-3


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------- batch norm

def test_conv_batch_norm_training_matches_flax():
    rng = np.random.default_rng(0)
    xs = [rng.normal(3.0, 2.0, (2, 6, 10, 5)).astype(np.float32) for _ in range(2)]
    jm = nn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jnp.float32)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0])), 1)
    tm = BatchNorm(5, dim=1)
    load_jax_params(tm, flatten_tree(v))
    apply = jax.jit(lambda v, x: jm.apply(v, x, mutable=["batch_stats"]))
    for x in xs:  # the second call starts from the statistics the first moved
        ref, state = apply(v, jnp.asarray(x))
        v = {"params": v["params"], **state}
        got = tm(T(x).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(tm.running_mean), np.asarray(state["batch_stats"]["mean"]), rtol=1e-5)
        np.testing.assert_allclose(_np(tm.running_var), np.asarray(state["batch_stats"]["var"]), rtol=1e-5)
    # a constant channel: E[x^2] - E[x]^2 rounds below 0 and is clipped, not a NaN
    const = np.full((2, 5, 4, 4), 7.3, np.float32)
    assert torch.isfinite(tm(T(const), train=True)).all() and (tm.running_var >= 0).all()


@functools.lru_cache(maxsize=None)
def _jax_superpoint(dtype, seed):
    jm = JaxSuperPointBN(descriptor_dim=D, dtype=getattr(jnp, dtype))
    return jm, _perturb(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 1)), train=True), seed + 1)


def _superpoint_pair(dtype="float32", seed=0):
    """JAX and port SuperPointBN (D = 32) on the same perturbed weights; a
    fresh port model each call."""
    jm, v = _jax_superpoint(dtype, seed)
    tm = SuperPointBN(D, compute_dtype=dtype, device="cpu")
    load_jax_params(tm, flatten_tree(v))
    return jm, v, tm


def test_superpoint_training_forward_matches_jax():
    jm, v, tm = _superpoint_pair()
    image = np.random.default_rng(1).uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    ref, state = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(image))
    got = tm(T(image), train=True)
    for name in ("semi", "desc_map"):
        scale = np.abs(np.asarray(ref[name])).max()
        np.testing.assert_allclose(_np(got[name]) / scale, np.asarray(ref[name]) / scale, atol=1e-4, err_msg=name)
    have = params_to_jax(tm.state_dict())
    for key, want in flatten_tree(state).items():
        np.testing.assert_allclose(have[key], want, rtol=1e-5, atol=1e-6, err_msg=key)
    # training never takes an s2d layout; inference leaves the statistics alone
    s2d = SuperPointBN(D, device="cpu", s2d=True)
    s2d.load_state_dict(tm.state_dict())
    np.testing.assert_allclose(_np(s2d(T(image), train=True)["semi"]), _np(tm(T(image), train=True)["semi"]),
                               rtol=1e-5, atol=1e-5)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    with torch.no_grad():
        tm(T(image))
    assert all(torch.equal(before[k], t) for k, t in tm.state_dict().items())


# ---------------------------------------------------------------- losses

def _maps(seed, b=B, hc=8, wc=8, d=D):
    rng = np.random.default_rng(seed)
    desc = rng.normal(size=(2, b, hc, wc, d)).astype(np.float32)
    return desc / np.linalg.norm(desc, axis=-1, keepdims=True)


def test_detector_loss_with_partial_masks_matches_jax():
    rng = np.random.default_rng(2)
    semi = rng.normal(0, 2, (B, 4, 6, 65)).astype(np.float32)
    labels = (rng.uniform(size=(B, 32, 48, 1)) < 0.03).astype(np.float32)
    labels[1] = np.clip(labels[1] + rng.uniform(0, 0.5, labels[1].shape) * (rng.uniform(size=labels[1].shape) < 0.1),
                        0, 1)
    valid = np.ones((B, 32, 48, 1), np.float32)
    valid[0, :5] = 0.0  # a partly valid row of cells
    valid[1, :, 40:] = 0.0
    for mask in (valid, np.zeros_like(valid)):
        ref = float(jdet.detector_loss(jnp.asarray(semi), jnp.asarray(labels), jnp.asarray(mask)))
        got = float(detector.detector_loss(T(semi), T(labels), T(mask)))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(_np(detector.cell_mask_from_2d(T(valid))),
                                  np.asarray(jdet.cell_mask_from_2d(jnp.asarray(valid))))


def jax_descriptor_draws(key, b, hc, wc, m, nn_):
    """The numbers `sparse_descriptor_loss(key, ...)` draws, replayed from
    its key splits as a port `DescriptorDraws`."""
    n = hc * wc
    rows = []
    for k in jax.random.split(key, b):
        k_sel, k_neg, k_sign, k_mag = jax.random.split(k, 4)
        select = jax.random.uniform(k_sel, (n,)) if m <= n else jax.random.gumbel(k_sel, (m, n))
        rows.append([select, jax.random.randint(k_neg, (m, nn_, 2), 0, jnp.array([wc, hc])),
                     jax.random.uniform(k_sign, (m, nn_)), jax.random.normal(k_mag, (m, nn_))])
    cols = [np.stack([np.asarray(r[i]) for r in rows]) for i in range(4)]
    return descriptor.DescriptorDraws(T(cols[0]), T(cols[1].astype(np.int64)), T(cols[2]), T(cols[3]))


def _pair_homographies(seed, b=B, h=H, w=W):
    from image_matching_tpu.geometry import homography as jh

    cfg = jpipe.WarpedPairConfig().homography
    return np.array(jh.sample_homography_batch(jax.random.PRNGKey(seed), b, h, w, cfg))


@pytest.mark.parametrize("m,nn_", [(40, 12), (150, 20)], ids=["top_k", "categorical"])
def test_sparse_descriptor_loss_matches_jax_on_its_draws(m, nn_):
    d0, d1 = _maps(3)
    hs = _pair_homographies(4)
    key = jax.random.PRNGKey(5)
    ref = jdesc.sparse_descriptor_loss(key, jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(hs),
                                       num_matching_attempts=m, num_masked_non_matches_per_match=nn_)
    draws = jax_descriptor_draws(key, B, 8, 8, m, nn_)
    assert draws.select.dim() == (2 if m <= 64 else 3)
    got = descriptor.sparse_descriptor_loss(draws, T(d0), T(d1), T(hs))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)
    assert float(got[1]) > 0 and float(got[2]) > 0
    np.testing.assert_allclose(_np(descriptor.homography_to_cell_frame(T(hs))),
                               np.asarray(jax.vmap(jdesc.homography_to_cell_frame)(jnp.asarray(hs))), rtol=1e-6)
    # the generator's own draws have the shapes and ranges of JAX's
    own = descriptor.draw_descriptor_loss(torch.Generator().manual_seed(0), B, 8, 8, m, nn_)
    assert all(a.shape == b_.shape for a, b_ in zip(own, draws)) and own.negatives.max() < 8
    assert torch.isfinite(descriptor.sparse_descriptor_loss(own, T(d0), T(d1), T(hs))[0])


def test_subpixel_losses_match_jax():
    rng = np.random.default_rng(6)
    heat = rng.uniform(0, 1, (B, 32, 40, 1)).astype(np.float32) ** 4
    xy = np.round(rng.uniform(-2, 42, (B, 20, 2))).astype(np.float32)  # some near and past the border
    residuals = rng.uniform(-0.5, 0.5, (B, 20, 2)).astype(np.float32)
    mask = rng.uniform(size=(B, 20)) < 0.7
    res_map = rng.normal(0, 0.3, (B, 32, 40, 2)).astype(np.float32)
    args = (jnp.asarray(xy), jnp.asarray(residuals), jnp.asarray(mask))
    targs = (T(xy), T(residuals), T(mask))
    for p in (5, 7):
        np.testing.assert_allclose(float(subpixel.subpixel_loss(*targs, T(heat), p)),
                                   float(jsub.subpixel_loss(*args, jnp.asarray(heat), p)), rtol=1e-5)
    np.testing.assert_allclose(float(subpixel.subpixel_loss_no_argmax(*targs, T(res_map))),
                               float(jsub.subpixel_loss_no_argmax(*args, jnp.asarray(res_map))), rtol=1e-5)


def test_detector_precision_recall_matches_jax():
    rng = np.random.default_rng(7)
    semi = rng.normal(0, 3, (B, 4, 6, 65)).astype(np.float32)
    semi[..., 64] += 2.0
    labels = (rng.uniform(size=(B, 32, 48, 1)) < 0.05).astype(np.float32)
    ref = jmetrics.detector_precision_recall(jnp.asarray(semi), jnp.asarray(labels))
    got = metrics.detector_precision_recall(T(semi), T(labels))
    for k in ("precision", "recall"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)
    assert 0 < float(got["precision"]) < 1 and 0 < float(got["recall"]) < 1
    pred, lab = rng.uniform(size=(30,)) < 0.5, rng.uniform(size=(30,)) < 0.5
    ref = jmetrics.precision_recall(jnp.asarray(pred), jnp.asarray(lab))
    got = metrics.precision_recall(T(pred), T(lab))
    assert all(float(got[k]) == float(ref[k]) for k in ref)


# ---------------------------------------------------------------- one train step

LOSS_KW = dict(num_matching_attempts=100, num_masked_non_matches_per_match=10)


@functools.lru_cache(maxsize=None)
def _jax_batch(seed):
    src = jsyn.synthetic_batch(jax.random.PRNGKey(seed), B, H, W)
    return jpipe.make_warped_pair_batch(jax.random.PRNGKey(seed + 1), src["image"], src["points"], src["points_mask"])


def _batch(seed):
    """One JAX-made training batch (synthetic shapes, warped pair) and the
    same arrays as fresh torch tensors."""
    jb = _jax_batch(seed)
    return jb, {k: T(np.array(v)) for k, v in jb.items()}


def _jax_state(jm, v, tx):
    state = create_train_state(jax.random.PRNGKey(0), jm, (jnp.zeros((1, H, W, 1)),), tx=tx,
                               init_kwargs={"train": True})
    return state.replace(params=v["params"], batch_stats=v["batch_stats"])


def test_train_step_matches_jax():
    jm, v, tm = _superpoint_pair()
    jb, tb = _batch(8)
    key = jax.random.PRNGKey(9)
    jcfg = jtrainer.SuperPointLossConfig(**LOSS_KW)
    state = _jax_state(jm, v, optax.adam(LR))
    new_state, want = jtrainer.make_superpoint_train_step(jm, jcfg, donate=False)(state, jb, key)

    tstate = TrainState.create(tm, LR)
    draws = jax_descriptor_draws(key, B, H // 8, W // 8, 100, 10)
    got = superpoint_trainer.train_on_batch(tstate, tb, draws, superpoint_trainer.SuperPointLossConfig(**LOSS_KW))
    assert tstate.step == 1 and got["skipped_nonfinite"] == 0 == int(want["skipped_nonfinite"])
    assert set(got) == set(want)
    for k in ("loss", "loss_det", "loss_det_warp", "loss_desc", "positive_dist", "negative_dist"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    old, new = flatten_tree(state.variables), flatten_tree(new_state.variables)
    have = params_to_jax(tm.state_dict())
    grads = params_to_jax({n: p.grad for n, p in tm.named_parameters()})
    big = {k: np.abs(g) > 1e-3 * max(np.abs(x).max() for x in grads.values()) for k, g in grads.items()}
    assert sum(b.sum() for b in big.values()) > 0.3 * sum(b.size for b in big.values())
    for k in new:
        if not k.startswith("params"):
            np.testing.assert_allclose(have[k], new[k], rtol=1e-5, atol=1e-6, err_msg=k)
            continue
        np.testing.assert_allclose((have[k] - old[k])[big[k]], (new[k] - old[k])[big[k]],
                                   rtol=1e-3, atol=1e-3 * LR, err_msg=k)
        np.testing.assert_allclose(have[k], new[k], atol=2 * LR, err_msg=k)

    # the eval step: inference, the same loss on JAX's updated state (carried
    # across by the weight conversion), nothing moved
    jeval = jtrainer.make_superpoint_eval_step(jm, jcfg)(new_state, jb, key)
    em = SuperPointBN(D, compute_dtype="float32", device="cpu")
    load_jax_params(em, new)
    before = {k: t.clone() for k, t in em.state_dict().items()}
    teval = superpoint_trainer.make_superpoint_eval_step(em, superpoint_trainer.SuperPointLossConfig(**LOSS_KW))
    with pytest.MonkeyPatch.context() as mp:  # feed the eval step JAX's draws
        mp.setattr(superpoint_trainer, "draw_superpoint_loss", lambda gen, batch, cfg: draws)
        ev = teval(TrainState.create(em, LR), tb, torch.Generator())
    assert all(torch.equal(before[k], t) for k, t in em.state_dict().items())
    for k in jeval:  # one state on both sides: measured 9.5e-7 (the loss); two updated states gave 6.5e-4
        np.testing.assert_allclose(float(ev[k]), float(jeval[k]), rtol=0, atol=1e-4, err_msg=k)


def test_nonfinite_loss_reverts_the_whole_state():
    _, _, tm = _superpoint_pair(seed=3)
    _, tb = _batch(10)
    cfg = superpoint_trainer.SuperPointLossConfig(**LOSS_KW)
    state = TrainState.create(tm, LR)
    step = superpoint_trainer.make_superpoint_train_step(tm, cfg)
    assert step(state, tb, torch.Generator().manual_seed(0))["skipped_nonfinite"] == 0
    snapshot = {k: t.clone() for k, t in tm.state_dict().items()}
    moments = {n: {k: t.clone() for k, t in state.optimizer.state[p].items()} for n, p in tm.named_parameters()}
    count = state.optimizer.param_groups[0]["count"]
    bad = dict(tb, image=tb["image"].clone())
    bad["image"][0, 5, 5, 0] = float("nan")
    got = step(state, bad, torch.Generator().manual_seed(1))
    assert got["skipped_nonfinite"] == 1 and not torch.isfinite(got["loss"])
    assert state.step == 1 and state.optimizer.param_groups[0]["count"] == count
    assert all(torch.equal(snapshot[k], t) for k, t in tm.state_dict().items())
    for n, p in tm.named_parameters():
        assert all(torch.equal(moments[n][k], t) for k, t in state.optimizer.state[p].items()), n
    # and the next good batch trains on
    assert step(state, tb, torch.Generator().manual_seed(2))["skipped_nonfinite"] == 0 and state.step == 2
    with pytest.raises(ValueError, match="another module"):
        superpoint_trainer.make_superpoint_train_step(SuperPointBN(D, device="cpu"), cfg)(state, tb, torch.Generator())


def _port_gradients(dtype, conv2d=None):
    """The port's side of `_gradients`; `conv2d` replaces the model's conv
    (another sum order of the same roundings)."""
    _, _, tm = _superpoint_pair(dtype)
    _, tb = _batch(11)
    draws = jax_descriptor_draws(jax.random.PRNGKey(12), B, H // 8, W // 8, 100, 10)
    with pytest.MonkeyPatch.context() as mp:
        if conv2d is not None:
            mp.setattr(common, "conv2d", conv2d)
            mp.setattr(superpoint, "conv2d", conv2d)
        loss, _ = superpoint_trainer.superpoint_loss_fn(tm, tb, draws,
                                                        superpoint_trainer.SuperPointLossConfig(**LOSS_KW))
        loss.backward()
    return {k: np.asarray(g, np.float32) for k, g in params_to_jax({n: p.grad for n, p in tm.named_parameters()}).items()}


def _gradients(dtype):
    """One training forward and backward of SuperPointBN (D = 32, perturbed
    weights) in `dtype` on both sides, on the same batch and draws: the JAX
    gradients and the port's, each a flat dict of f32 arrays."""
    jm, v, _ = _superpoint_pair(dtype)
    jb, _ = _batch(11)
    key = jax.random.PRNGKey(12)
    jcfg = jtrainer.SuperPointLossConfig(**LOSS_KW)

    def loss_fn(params):
        return jtrainer.superpoint_loss_fn(params, v["batch_stats"], jm, jb, key, jcfg, True)[0]

    grads = jax.jit(jax.grad(loss_fn), compiler_options=STRICT_BF16)(v["params"])
    want = {k: np.asarray(g, np.float32) for k, g in flatten_tree({"params": grads}).items()}
    return want, _port_gradients(dtype)


def _conv2d_f32_sums(x, conv, dtype):
    """`models/common.conv2d` with the conv summed by an f32 conv of the
    same rounded inputs, its output rounded to the compute dtype: the same
    roundings in another order of sums."""
    y = F.conv2d(x.to(dtype).float(), conv.weight.to(dtype).float(), padding=conv.padding).to(dtype)
    return y.add_(conv.bias.to(dtype)[:, None, None])


def test_bf16_gradients_held_to_jax_bf16():
    """The scheme of `test_torch_train.test_bf16_gradients_held_to_jax_bf16`,
    for d = 1 - cosine of all gradients as one vector and d = the largest
    entry's difference over the largest f32 entry, with the bound that
    SuperPoint's training batch norms allow:
      * d(port bf16, port f32) <= 1.25 d(JAX bf16, JAX f32), SuperGlue's
        bound: bf16 moves the port no further than it moves JAX (measured
        1.0 and 0.70);
      * d(port bf16, JAX bf16) <= 0.6 d(JAX bf16, JAX f32) (measured 0.44
        and 0.57), not SuperGlue's 0.1: ten batch norms on batch statistics
        amplify a one-step bf16 difference of a conv output, so the order
        of the convs' f32 sums alone moves the port's bf16 gradients by more
        than 0.1 d(JAX bf16, JAX f32) in the largest entry (its bf16 convs
        against f32 convs of the same rounded inputs, rounded after:
        measured 0.185 in the largest entry and 0.098 in cosine, the same
        under 1 and 8 torch threads; checked here to exceed 0.1 and 0.05),
        where SuperGlue's dense layers differ from JAX's by under 0.01 of it.
    The conv biases ahead of a batch norm are held apart: their exact
    gradient is 0, and JAX's bf16 sums their cotangents in bf16 (0.94 of
    the largest f32 entry in inc's first conv) where torch sums in f32;
    the port's stay within 0.01 of the largest f32 entry (measured 0.006)."""
    jf, pf = _gradients("float32")
    jb, pb = _gradients("bfloat16")
    assert set(pb) == set(jb) == set(jf)
    scale = max(np.abs(jf[k]).max() for k in jf)
    biases = [k for k in jf if k.endswith("bias") and ("Conv_0" in k or k.split("::")[1].startswith("conv"))]
    keys = sorted(set(jf) - set(biases))
    assert len(biases) == 12

    def dists(a, b):
        va, vb = (np.concatenate([g[k].ravel() for k in keys]) for g in (a, b))
        return np.array([1 - va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)),
                         max(np.abs(a[k] - b[k]).max() for k in keys) / scale])

    # the common f32 gradients: the batch norms, whose statistics at B = 2
    # come from as few as 128 values a channel, amplify the rounding of f32
    # sums in another order (measured 4.9e-4 of the largest entry, in
    # down2's first conv; SuperGlue's stay under 1e-4)
    assert (dists(pf, jf) <= [1e-6, 1e-3]).all(), dists(pf, jf)
    pj, jj, pp = dists(pb, jb), dists(jb, jf), dists(pb, pf)
    assert (jj > [1e-3, 0.05]).all(), jj  # JAX's bf16 did round: the bounds are not vacuous
    assert (pj <= 0.6 * jj).all(), (pj, jj)
    assert (pp <= 1.25 * jj).all(), (pp, jj)
    order = dists(pb, _port_gradients("bfloat16", _conv2d_f32_sums))
    assert (order > [0.05, 0.1] * jj).all(), (order, jj)  # why SuperGlue's 0.1 is out of reach here
    assert max(np.abs(pb[k]).max() for k in biases) / scale <= 0.01
