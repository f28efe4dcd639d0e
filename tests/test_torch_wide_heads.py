"""SuperGlue with heads wider than 64 values, the port against the JAX
package on the same parameters (`load_jax_params`, which maps them with
`params_from_jax`), on the CPU.

SuperGlue has 4 heads, so descriptor_dim 384, 512, 640 and 1024 give heads
of 96, 128, 160 and 256: on the card 128 has kernels of its own and 96 is
zero-padded to them, 256 runs through the chunked kernels (2 chunks of 128)
and 160 is zero-padded to them; on the CPU the port runs its plain
attention at every width. The JAX side runs its Pallas one-pass kernel
interpreted (128 packs into its 128 lanes; 96, 160 and 256 fold to single
heads, `_onepass_forward`) in f32, and its einsum path in bf16 and under
grad. 2 GNN layers, 64 keypoint slots, a 20-iteration Sinkhorn.

Tolerances: f32 forwards differ only in summation order: the log-coupling
within 1e-4 and equal matches, as `test_torch_models.py` holds D = 32. A
bf16 forward is held to JAX's bf16 forward by how far bf16 moves JAX from
its own f32 result on the same inputs (at most that far, in the
log-coupling's median difference and the share of matched slots that
differ). The f32 training step's gradients are held to the JAX package's
gradients of the same step run in float64 (its exact values), within
1e-5 of the largest entry: at D = 512 JAX's own f32 gradients lie 6.4e-4
of the largest entry from those exact values on the CPU, the port's f32
ones 1.7e-6, so the two f32 runs are not held to each other; the port is
also held to lie no further from the exact values than JAX's f32 run.

The keypoints come from seed 1, except at D = 640 (`KEYPOINT_SEED`): the
gradient there is held to a reference that f32 rounding does not decide.
With seeds 1, 2 and 4 at D = 640 one input of a GNN ReLU lies within about
1e-6 of 0 (seed 1: layer 0's MLP, point 25, channel 1097, -1.2e-6 in a
float64 run of the port), where the loss has a kink: its one-sided
derivatives differ by up to 2.2e-3 of the largest gradient entry, and each
package's f32 rounding picks a side (seed 1: the port's f32 gradients lie
2.2e-3 from JAX's float64 ones and JAX's f32 ones 1.1e-6; seed 2: both
1.6e-3; seed 4: the port 6.8e-4, JAX 1.9e-6). The port run in float64 is
its own function's derivative there (central differences along the gap
converge to the mean of the two sides' values, and along random directions
to its gradient within 1e-9). Seed 3 has no such unit (the port 1.4e-6,
JAX's f32 1.6e-6), and its forward matches 12 slots (seed 1's matches 10,
and the forward test asks for more than 10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.losses import superglue_loss as jl
from image_matching_tpu.models.superglue import SuperGlue as JaxSuperGlue
from image_matching_tpu.structs import Keypoints as JaxKeypoints
from image_matching_tpu.utils.weights import flatten_tree
from image_matching_tpu_torch.losses.superglue_loss import superglue_nll_loss
from image_matching_tpu_torch.models import SuperGlue
from image_matching_tpu_torch.structs import Keypoints
from image_matching_tpu_torch.weights import load_jax_params, params_to_jax

SG_KW = dict(keypoint_encoder=(32, 64, 128, 256), gnn_layers=2, sinkhorn_iterations=20, match_threshold=0.01)
SHAPE = (48, 64)
K = 64
# XLA would keep results the JAX code rounds to bf16 in f32 where the next op
# reads f32; the bf16 reference is compiled to round where the code says
STRICT_BF16 = {"xla_allow_excess_precision": False}
KEYPOINT_SEED = {640: 3}  # the keypoints' seed by descriptor_dim, 1 elsewhere (see above)


def _perturb(variables, seed):
    """Non-trivial batch-norm statistics and affines."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape).astype(np.float32))
        if name in ("mean", "bias"):
            return jnp.asarray(rng.normal(0, 0.1, x.shape).astype(np.float32))
        if name == "scale":
            return jnp.asarray(rng.normal(1, 0.1, x.shape).astype(np.float32))
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _keypoint_pair(seed, d, b=2):
    """Two masked keypoint sets of K slots with unit descriptors of d values,
    about half of set 1 within a pixel of a point of set 0; JAX and port
    Keypoints of both."""
    rng = np.random.default_rng(seed)
    xy0 = rng.uniform(4, 60, (b, K, 2)).astype(np.float32)
    xy1 = rng.uniform(4, 60, (b, K, 2)).astype(np.float32)
    near = rng.uniform(size=(b, K)) < 0.5
    xy1[near] = xy0[:, ::-1][near] + rng.uniform(-1, 1, (near.sum(), 2)).astype(np.float32)
    sides = []
    for xy, n_valid in ((xy0, (K, K - 13)), (xy1, (K - 7, K))):
        mask = np.arange(K)[None] < np.asarray(n_valid)[:, None]
        score = (rng.uniform(0.1, 1, (b, K)) * mask).astype(np.float32)
        desc = rng.normal(size=(b, K, d)).astype(np.float32)
        desc = desc / np.linalg.norm(desc, axis=-1, keepdims=True) * mask[..., None]
        arrays = dict(xy=xy, score=score, mask=mask, desc=desc)
        sides.append((JaxKeypoints(**{n: jnp.asarray(a) for n, a in arrays.items()}),
                      Keypoints(**{n: torch.from_numpy(a) for n, a in arrays.items()})))
    return sides


def _models(d, jax_dtype="float32", impl="onepass"):
    jm = JaxSuperGlue(descriptor_dim=d, **SG_KW, attention_impl=impl, sinkhorn_impl="scan",
                      logits_dtype="float32", dtype=getattr(jnp, jax_dtype))
    (j0, _), (j1, _) = _keypoint_pair(1, d)
    variables = _perturb(jm.init(jax.random.PRNGKey(3), j0, j1, SHAPE, SHAPE), 4)
    return jm, variables


def _port(d, variables, dtype):
    tm = SuperGlue(descriptor_dim=d, **SG_KW, compute_dtype=dtype, device="cpu")
    load_jax_params(tm, flatten_tree(variables))
    return tm


@pytest.mark.parametrize("d", [384, 512, 640, 1024])
def test_f32_forward_matches_jax_pallas(d):
    (j0, t0), (j1, t1) = _keypoint_pair(KEYPOINT_SEED.get(d, 1), d)
    jm, v = _models(d)
    ref = jax.jit(lambda v, a, b: jm.apply(v, a, b, SHAPE, SHAPE))(v, j0, j1)
    with torch.no_grad():
        got = _port(d, v, "float32")(t0, t1, SHAPE, SHAPE)
    np.testing.assert_allclose(got["log_coupling"].numpy(), np.asarray(ref["log_coupling"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["matches0"].numpy(), np.asarray(ref["matches0"]))
    assert (got["matches0"] >= 0).sum() > 10


def _distance(a, b, valid):
    """(median |log-coupling difference| over real keypoint pairs, share of
    the slots matched on either side whose matches0 differ)."""
    z = np.median(np.abs(a[0] - b[0])[valid])
    both = (a[1] >= 0) | (b[1] >= 0)
    return z, (a[1] != b[1])[both].mean()


def _bf16_forward_held_to_jax_bf16(d):
    (j0, t0), (j1, t1) = _keypoint_pair(1, d)
    res = {}
    for dtype in ("float32", "bfloat16"):
        jm, v = _models(d, dtype, impl="einsum")
        out = jax.jit(lambda v, a, b: jm.apply(v, a, b, SHAPE, SHAPE), compiler_options=STRICT_BF16)(v, j0, j1)
        res["jax", dtype] = (np.asarray(out["log_coupling"], np.float32), np.asarray(out["matches0"]))
        with torch.no_grad():
            got = _port(d, v, dtype)(t0, t1, SHAPE, SHAPE)
        res["port", dtype] = (got["log_coupling"].float().numpy(), got["matches0"].numpy())
    valid = res["jax", "float32"][0] > -1e8
    np.testing.assert_array_equal(res["port", "float32"][1], res["jax", "float32"][1])
    moved = _distance(res["jax", "bfloat16"], res["jax", "float32"], valid)
    apart = _distance(res["port", "bfloat16"], res["jax", "bfloat16"], valid)
    assert moved[0] > 0 and moved[1] > 0  # bf16 moved JAX: the bound is not vacuous
    assert apart[0] <= moved[0] and apart[1] <= moved[1], (apart, moved)
    assert (res["port", "bfloat16"][1] >= 0).sum() > 10


def test_bf16_forward_held_to_jax_bf16():
    _bf16_forward_held_to_jax_bf16(512)


def test_bf16_forward_held_to_jax_bf16_d1024():
    _bf16_forward_held_to_jax_bf16(1024)  # heads of 256 values: the chunked kernels' width on the card


def _jax_step_gradients(d, j0, j1, gt0, gt1, dtype):
    """Loss and flat f32 / float64 gradients of one JAX training forward and
    backward (einsum attention, f32 logits) of `_models(d)` in `dtype`."""
    _, v = _models(d, impl="einsum")
    jm = JaxSuperGlue(descriptor_dim=d, **SG_KW, attention_impl="einsum", sinkhorn_impl="scan",
                      logits_dtype="float32", dtype=getattr(jnp, dtype))
    cast = lambda x: jnp.asarray(np.asarray(x), dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x
    v, j0, j1 = (jax.tree_util.tree_map(cast, t) for t in (v, j0, j1))

    def loss_fn(params, batch_stats):
        out, _ = jm.apply({"params": params, "batch_stats": batch_stats}, j0, j1, SHAPE, SHAPE,
                          train=True, mutable=["batch_stats"])
        return jl.superglue_nll_loss(out["log_coupling"], gt0, gt1, j0.mask, j1.mask)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"], v["batch_stats"])
    return float(loss), {k: np.asarray(g, np.float64) for k, g in flatten_tree({"params": grads}).items()}


def _f32_training_gradients_match_jax(d):
    (j0, t0), (j1, t1) = _keypoint_pair(KEYPOINT_SEED.get(d, 1), d)
    gt0, gt1 = jl.make_gt_matches(j0.xy, j1.xy, j0.mask, j1.mask, 3.0)
    assert int(jnp.sum(gt0 < K)) > 20
    _, v = _models(d, impl="einsum")
    tm = _port(d, v, "float32")
    got = tm(t0, t1, SHAPE, SHAPE, train=True)
    tloss = superglue_nll_loss(got["log_coupling"], torch.from_numpy(np.array(gt0)), torch.from_numpy(np.array(gt1)),
                               t0.mask, t1.mask)
    tloss.backward()
    have = {k: np.asarray(g, np.float64) for k, g in params_to_jax({n: p.grad for n, p in tm.named_parameters()}).items()}
    loss32, jax32 = _jax_step_gradients(d, j0, j1, gt0, gt1, "float32")
    with jax.enable_x64(True):
        loss64, exact = _jax_step_gradients(d, j0, j1, gt0, gt1, "float64")
    assert next(iter(exact.values())).dtype == np.float64 and set(have) == set(exact) == set(jax32)
    np.testing.assert_allclose(float(tloss.detach()), loss64, rtol=1e-5)
    np.testing.assert_allclose(loss32, loss64, rtol=1e-5)
    # relative to the largest entry: the biases ahead of a batch norm have a
    # gradient of 0 in exact arithmetic, so the f32 runs hold rounding noise there
    scale = max(np.abs(g).max() for g in exact.values())
    dist = lambda grads: max(np.abs(grads[k] - exact[k]).max() for k in exact) / scale
    for key in exact:
        np.testing.assert_allclose(have[key] / scale, exact[key] / scale, atol=1e-5, err_msg=key)
    assert dist(have) <= dist(jax32)


def test_f32_training_gradients_match_jax():
    _f32_training_gradients_match_jax(512)


def test_f32_training_gradients_match_jax_d640():
    _f32_training_gradients_match_jax(640)  # heads of 160 values: zero-padded to 256 on the card


def _step_gradients(d, dtype):
    """One training forward and backward of `_models(d)` (einsum attention,
    f32 logits, f32 parameters) computing in `dtype` on both sides, JAX
    compiled with STRICT_BF16: the JAX gradients and the port's, each a
    flat dict of f32 arrays."""
    (j0, t0), (j1, t1) = _keypoint_pair(1, d)
    gt0, gt1 = jl.make_gt_matches(j0.xy, j1.xy, j0.mask, j1.mask, 3.0)
    jm, v = _models(d, dtype, impl="einsum")

    def loss_fn(params, batch_stats):
        out, _ = jm.apply({"params": params, "batch_stats": batch_stats}, j0, j1, SHAPE, SHAPE, train=True,
                          mutable=["batch_stats"])
        return jl.superglue_nll_loss(out["log_coupling"], gt0, gt1, j0.mask, j1.mask)

    grads = jax.jit(jax.grad(loss_fn), compiler_options=STRICT_BF16)(v["params"], v["batch_stats"])
    tm = _port(d, v, dtype)
    got = tm(t0, t1, SHAPE, SHAPE, train=True)
    superglue_nll_loss(got["log_coupling"], torch.from_numpy(np.array(gt0)), torch.from_numpy(np.array(gt1)),
                       t0.mask, t1.mask).backward()
    want = {k: np.asarray(g, np.float32) for k, g in flatten_tree({"params": grads}).items()}
    have = {k: np.asarray(g, np.float32) for k, g in params_to_jax({n: p.grad for n, p in tm.named_parameters()}).items()}
    return want, have


def test_bf16_training_gradients_held_to_jax_bf16_d1024():
    """The bf16 training step at heads of 256 values, the width of the
    chunked backward kernels on the card, held to JAX's bf16 step by the
    measures of `test_torch_train.test_bf16_gradients_held_to_jax_bf16`: with
    d = (1 - cosine of the gradients as one vector, the largest entry's
    difference over the largest f32 entry) and d(JAX bf16, JAX f32) how far
    bf16 moves JAX's gradients, over the live leaves,
      * d(port bf16, port f32) <= 1.25 d(JAX bf16, JAX f32): bf16 moves the
        port no further than it moves JAX (measured 1.005 and 1.014);
      * d(port bf16, JAX bf16) <= (0.15, 0.5) d(JAX bf16, JAX f32)
        (measured 0.114-0.116 and 0.108-0.257 with 1, 2, 4 and the default
        CPU threads).
    The D = 32 test's 0.1 is below this step's own noise: the port's bf16
    step at another thread count, which changes only the order of the f32
    sums in its matmuls, lies up to (0.067, 0.169) of d(JAX bf16, JAX f32)
    from its default run, the largest entry always in the keypoint
    encoder's first kernel. The bounds still fail a dropped rounding: with
    the residual stream kept in f32 the port reads (0.185, 0.257).
    Dead leaves, whose exact gradient is 0 (the biases ahead of a batch
    norm, and the key, value and merge biases, which softmax and a batch
    norm cancel), are those where JAX's f32 gradient is below 1e-5 of the
    largest entry (at most 6.1e-7; the smallest live leaf reads 3.2e-3).
    Both bf16 steps hold rounding noise there, and JAX's is the larger: its
    compiled CPU code sums a bf16 bias cotangent in bf16, one rounding a
    row, where the port rounds the f32 sum once (0.10 of the largest entry
    against 0.006 in the encoder's first bias). So the dead leaves are held
    to lie no further from 0 in the port than in JAX."""
    jf, pf = _step_gradients(1024, "float32")
    jb, pb = _step_gradients(1024, "bfloat16")
    assert set(pf) == set(pb) == set(jb) == set(jf)
    scale = max(np.abs(g).max() for g in jf.values())
    live = sorted(k for k, g in jf.items() if np.abs(g).max() > 1e-5 * scale)
    dead = sorted(set(jf) - set(live))
    assert len(live) == 37 and len(dead) == 12, (len(live), len(dead))

    def dists(a, b):
        va, vb = (np.concatenate([g[k].ravel() for k in live]).astype(np.float64) for g in (a, b))
        return np.array([1 - va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)),
                         max(np.abs(a[k] - b[k]).max() for k in live) / scale])

    pj, jj, pp = dists(pb, jb), dists(jb, jf), dists(pb, pf)
    assert (jj > [1e-3, 0.05]).all(), jj  # JAX's bf16 did round: the bounds are not vacuous
    assert (pp <= 1.25 * jj).all(), (pp, jj)
    assert (pj <= [0.15, 0.5] * jj).all(), (pj, jj)
    assert max(np.abs(pb[k]).max() for k in dead) <= max(np.abs(jb[k]).max() for k in dead)
