"""The port's training CLI and what it needs (`train/state.py` schedules
and clip, `train/superglue_trainer.py` with photometric corruption and
subpixel keypoints, `train/checkpoint.py`, `cli/train_superglue.py`)
against the JAX package, on the CPU.

Tolerances:
  * the learning rate of each step, and a small SuperGlue's parameters
    after N updates, against the optax chain the JAX CLI builds (warmup,
    cosine decay, global-norm clip on and off, the clip active in some
    cases): within 1e-6 relative (f32 Adam in another order of operations);
  * pair generation with photometric corruption and subpixel keypoints,
    given JAX's homographies and photometric draws: the same keypoint
    masks and ground truth, keypoints within 1e-4 px (the subpixel
    softmax sums in another order), descriptors and images within 1e-4;
  * checkpoints: a save / restore round trip is exact, and so is restoring
    a file the JAX package's `save_npz` wrote; the update after either
    matches within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_matching_tpu.data import photometric as jp
from image_matching_tpu.geometry import homography as jh
from image_matching_tpu.models.superglue import SuperGlue as JaxSuperGlue
from image_matching_tpu.train import create_train_state
from image_matching_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from image_matching_tpu.train.superglue_trainer import SuperGluePairConfig as JaxPairConfig
from image_matching_tpu.utils.weights import flatten_tree, load_npz_into
from image_matching_tpu.utils.weights import save_npz as jax_save_npz
from image_matching_tpu_torch.cli import train_superglue as cli
from image_matching_tpu_torch.data.photometric import PhotometricConfig, PhotometricDraws
from image_matching_tpu_torch.models import SuperGlue
from image_matching_tpu_torch.train.checkpoint import CheckpointManager, load_submodule_checkpoints
from image_matching_tpu_torch.train.state import TrainState
from image_matching_tpu_torch.train.superglue_trainer import SuperGluePairConfig, generate_pair_from_homographies
from image_matching_tpu_torch.weights import load_jax_params, params_from_jax, params_to_jax

from test_torch_data import jax_photometric_draws
from test_torch_train import SG_KW, _images, _keypoint_pair, _superpoint_pair, jax_generate_pair

T = torch.from_numpy
LR = 1e-3


def _jax_chain(lr, warmup_steps=0, cosine_decay_steps=0, grad_clip=0.0):
    """The optax chain of `image_matching_tpu/cli/train_superglue.py:149-159`."""
    if warmup_steps > 0:
        sched = optax.linear_schedule(0.0, lr, warmup_steps)
    elif cosine_decay_steps > 0:
        sched = optax.cosine_decay_schedule(lr, cosine_decay_steps, alpha=0.1)
    else:
        sched = lr
    tx = optax.adam(sched)
    if grad_clip > 0:
        tx = optax.chain(optax.clip_by_global_norm(grad_clip), tx)
    return tx, sched


CHAINS = [  # (warmup, cosine, clip, gradient scale): the clip binds where scale * sqrt(#params) > clip
    (3, 0, 0.0, 1.0),
    (0, 4, 0.0, 1.0),
    (0, 0, 1.0, 1.0),
    (3, 4, 0.5, 1.0),
    (0, 4, 1e4, 1.0),
    (0, 0, 0.0, 1.0),
]


@pytest.mark.parametrize("warmup,cosine,clip,_", CHAINS)
def test_learning_rate_schedule_matches_optax(warmup, cosine, clip, _):
    _, sched = _jax_chain(LR, warmup, cosine, clip)
    state = TrainState.create(torch.nn.Linear(2, 2), LR, warmup_steps=warmup, cosine_decay_steps=cosine, grad_clip=clip)
    for count in range(12):
        want = float(sched(count)) if callable(sched) else sched
        np.testing.assert_allclose(state.lr_at(count), want, rtol=1e-6, atol=1e-12)
    if warmup:
        assert state.lr_at(0) == 0.0  # the first update has lr 0
    elif cosine:
        np.testing.assert_allclose(state.lr_at(100), LR / 10, rtol=1e-6)


def _synthetic_grads(flat, rng, scale):
    return {k: (rng.normal(0, scale, v.shape)).astype(np.float32) for k, v in flat.items()}


@pytest.mark.parametrize("warmup,cosine,clip,scale", CHAINS)
def test_updates_match_the_optax_chain(warmup, cosine, clip, scale):
    sg = SuperGlue(**SG_KW, device="cpu", seed=3)
    params = params_to_jax(dict(sg.named_parameters()))
    tx, _ = _jax_chain(LR, warmup, cosine, clip)
    ref, opt_state = {k: jnp.asarray(v) for k, v in params.items()}, None
    opt_state = tx.init(ref)
    state = TrainState.create(sg, LR, warmup_steps=warmup, cosine_decay_steps=cosine, grad_clip=clip)
    rng = np.random.default_rng(0)
    names = dict(sg.named_parameters())
    clipped = []
    for _ in range(7):
        g = _synthetic_grads(params, rng, scale)
        clipped.append(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g.values())) >= clip > 0)
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, ref)
        ref = optax.apply_updates(ref, upd)
        for name, t in params_from_jax(g).items():
            names[name].grad = t
        state.apply_gradients()
        have = params_to_jax(dict(sg.named_parameters()))
        for k in ref:
            np.testing.assert_allclose(have[k], np.asarray(ref[k]), rtol=1e-6, atol=1e-9, err_msg=k)
    assert state.step == 7
    assert all(clipped) if clip in (1.0, 0.5) else not any(clipped)  # the clip binds in those cases only


def test_clip_does_not_add_an_epsilon():
    p = torch.nn.Parameter(torch.zeros(4))
    state = TrainState.create(torch.nn.ParameterList([p]), 1.0, grad_clip=2.0)
    g = torch.tensor([3.0, 4.0, 0.0, 0.0])  # norm 5 -> scaled by exactly 2 / 5
    p.grad = g.clone()
    from image_matching_tpu_torch.train.state import clip_by_global_norm
    clip_by_global_norm([p.grad], 2.0)
    want = np.asarray(optax.clip_by_global_norm(2.0).update(jnp.asarray(g.numpy()), optax.EmptyState())[0])
    assert np.array_equal(p.grad.numpy(), want)
    p.grad = torch.tensor([1.0, 0.0, 0.0, 0.0])  # under the norm: unchanged
    clip_by_global_norm([p.grad], 2.0)
    assert p.grad.tolist() == [1.0, 0.0, 0.0, 0.0] and state.grad_clip == 2.0


# ---------------------------------------------------------------- pair generation

def test_generate_pair_with_photometric_and_subpixel_matches_jax():
    jm, v, tm = _superpoint_pair()
    images = _images(2)
    photo = jp.PhotometricConfig(enable=True)
    jcfg = JaxPairConfig(max_keypoints=32, keypoint_threshold=0.0, subpixel=True, photometric=photo)
    pcfg = SuperGluePairConfig(max_keypoints=32, keypoint_threshold=0.0, subpixel=True,
                               photometric=PhotometricConfig(enable=True))
    key = jax.random.PRNGKey(3)
    k_hom, k_aug0, k_aug1 = jax.random.split(key, 3)
    hs = jh.sample_homography_batch(k_hom, 2, 48, 64, jcfg.homography)
    draws = []
    for k_aug in (k_aug0, k_aug1):
        per_image = [jax_photometric_draws(k, images.shape[1:])[0] for k in jax.random.split(k_aug, 2)]
        draws.append(PhotometricDraws(**{f: torch.cat([d[f] for d in per_image]) for f in PhotometricDraws._fields}))
    rk0, rk1, rgt0, rgt1, rwarped = jax_generate_pair(key, jm, v, jnp.asarray(images), jcfg)
    k0, k1, gt0, gt1, warped = generate_pair_from_homographies(T(np.array(hs)), tm, T(images), pcfg, draws)
    assert warped.shape == (2, 48, 64, 1) and np.abs(warped.numpy() - np.asarray(rwarped)).max() <= 1e-4
    for got, ref in ((k0, rk0), (k1, rk1)):
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
        np.testing.assert_allclose(got.xy.numpy(), np.asarray(ref.xy), atol=1e-4)
        assert (got.xy.numpy() % 1 != 0).any()  # subpixel-refined
        np.testing.assert_allclose(got.desc.numpy(), np.asarray(ref.desc), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(gt0.numpy(), np.asarray(rgt0))
    np.testing.assert_array_equal(gt1.numpy(), np.asarray(rgt1))
    with pytest.raises(ValueError, match="PhotometricDraws"):
        generate_pair_from_homographies(T(np.array(hs)), tm, T(images), pcfg)


# ---------------------------------------------------------------- checkpoints

def _trained_state(seed, steps, **chain):
    sg = SuperGlue(**SG_KW, device="cpu", seed=seed)
    state = TrainState.create(sg, LR, **chain)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        for name, t in params_from_jax(_synthetic_grads(params_to_jax(dict(sg.named_parameters())), rng, 1.0)).items():
            dict(sg.named_parameters())[name].grad = t
        state.apply_gradients()
    return state


def _moments(state):
    return {n: (s["mu"].clone(), s["nu"].clone())
            for n, p in state.module.named_parameters() for s in [state.optimizer.state[p]]}


@pytest.mark.parametrize("chain", [dict(warmup_steps=2, grad_clip=1.0), dict(cosine_decay_steps=3), {}])
def test_checkpoint_round_trip(tmp_path, chain):
    state = _trained_state(0, 3, **chain)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None and mgr.save(state) == 3 and mgr.latest_step() == 3
    fresh = TrainState.create(SuperGlue(**SG_KW, device="cpu", seed=9), LR, **chain)
    mgr.restore(fresh)
    assert fresh.step == 3
    for k, v in state.module.state_dict().items():
        assert torch.equal(fresh.module.state_dict()[k], v), k
    want, have = _moments(state), _moments(fresh)
    assert all(torch.equal(a, b) for n in want for a, b in zip(want[n], have[n]))
    g = _synthetic_grads(params_to_jax(dict(state.module.named_parameters())), np.random.default_rng(5), 1.0)
    for st in (state, fresh):
        for name, t in params_from_jax(g).items():
            dict(st.module.named_parameters())[name].grad = t.clone()
        st.apply_gradients()
    for k, v in state.module.state_dict().items():
        np.testing.assert_allclose(fresh.module.state_dict()[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-9)
    other = TrainState.create(SuperGlue(**SG_KW, device="cpu"), LR, grad_clip=0.0 if chain.get("grad_clip") else 1.0)
    with pytest.raises(KeyError, match="optimizer chain"):
        mgr.restore(other)


def test_checkpoint_keeps_the_newest(tmp_path):
    state = _trained_state(1, 0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in range(1, 5):
        state.step = step
        mgr.save(state)
    assert mgr.all_steps() == [3, 4] and sorted(p.name for p in tmp_path.iterdir()) == ["3.npz", "4.npz"]


def _jax_state(chain):
    (j0, _), (j1, _) = _keypoint_pair(1)
    tx, _ = _jax_chain(LR, chain.get("warmup_steps", 0), chain.get("cosine_decay_steps", 0), chain.get("grad_clip", 0))
    st = create_train_state(jax.random.PRNGKey(4), JaxSuperGlue(**SG_KW), (j0, j1, (48, 64), (48, 64)), tx=tx,
                            init_kwargs={"train": True})
    rng = np.random.default_rng(2)
    for _ in range(2):
        st = st.apply_gradients(jax.tree_util.tree_map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
                                                       st.params))
    return st


def _payload(st):
    return {"params": st.params, "batch_stats": st.batch_stats, "opt_state": st.opt_state, "step": st.step}


@pytest.mark.parametrize("chain", [dict(warmup_steps=3, grad_clip=1.0), {}])
def test_checkpoints_interchange_with_jax_save_npz(tmp_path, chain):
    jst = _jax_state(chain)
    jax_save_npz(str(tmp_path / "2.npz"), _payload(jst))
    state = TrainState.create(SuperGlue(**SG_KW, device="cpu", seed=7), LR, **chain)
    CheckpointManager(str(tmp_path)).restore(state)
    assert state.step == 2
    have, want = params_to_jax(state.module.state_dict()), flatten_tree({"params": jst.params,
                                                                       "batch_stats": jst.batch_stats})
    assert set(have) == set(want) and all(np.array_equal(have[k], want[k]) for k in want)
    # one more update on both sides
    g = jax.tree_util.tree_map(lambda p: jnp.asarray(np.random.default_rng(8).normal(size=p.shape), jnp.float32),
                               jst.params)
    jst = jst.apply_gradients(g)
    for name, t in params_from_jax(flatten_tree({"params": g})).items():
        dict(state.module.named_parameters())[name].grad = t
    state.apply_gradients()
    have, want = params_to_jax(dict(state.module.named_parameters())), flatten_tree({"params": jst.params})
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)
    # and back: the port's checkpoint fills the JAX TrainState's tree
    CheckpointManager(str(tmp_path / "port")).save(state)
    restored = load_npz_into(_payload(jst), str(tmp_path / "port" / "3.npz"))
    for k, v in flatten_tree(restored).items():
        np.testing.assert_allclose(v, flatten_tree(_payload(jst))[k], rtol=1e-6, atol=1e-9, err_msg=k)


def test_orbax_directories_raise(tmp_path):
    jst = _jax_state({})
    JaxCheckpointManager(str(tmp_path / "orbax")).save(jst, wait=True)
    with pytest.raises(ValueError, match="npz"):
        CheckpointManager(str(tmp_path / "orbax"))
    model = type("M", (), {"config": None, "superglue": None})()
    with pytest.raises(ValueError, match="orbax"):
        load_submodule_checkpoints(model, None, sg_checkpoint=str(tmp_path / "orbax"))


# ---------------------------------------------------------------- the CLI

CLI_ARGS = ["--synthetic", "--device", "cpu", "--steps_per_epoch", "2", "--batch_size", "2", "--height", "64",
            "--width", "64", "--descriptor_dim", "32", "--keypoint_encoder", "16", "32", "--gnn_layers", "2",
            "--sinkhorn_iterations", "5", "--max_keypoints", "64", "--log_interval", "1"]


def test_cli_writes_checkpoints_and_resumes(tmp_path):
    run = ["--run_dir", str(tmp_path / "run"), "--photometric", "--subpixel", "--warmup_steps", "3",
           "--grad_clip", "1.0"]
    out = cli.main([*CLI_ARGS, *run, "--epochs", "2"])
    ckpt = tmp_path / "run" / "checkpoints"
    assert sorted(p.name for p in ckpt.iterdir()) == ["2.npz", "4.npz"]
    assert [h["last_step"] for h in out["history"]] == [2, 4] and len(out["logged"]) == 4
    assert all(np.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0 for r in out["logged"])
    resumed = cli.main([*CLI_ARGS, *run, "--epochs", "1", "--resume"])
    assert resumed["state"].step == 6 and resumed["history"][0]["first_step"] == 4
    assert sorted(p.name for p in ckpt.iterdir()) == ["2.npz", "4.npz", "6.npz"]
    # a trainer checkpoint warm-starts a new run, whose step starts at 0
    warm = cli.main([*CLI_ARGS, "--run_dir", str(tmp_path / "warm"), "--epochs", "1", "--init_weights",
                     str(ckpt / "6.npz")])
    assert warm["history"][0]["first_step"] == 0 and warm["state"].step == 2
