"""The port's context parallelism (`parallel/ring_attention.py`,
`sharded_sinkhorn.py`, `context_parallel.py`) on gloo ranks on the CPU,
against the JAX package's sharded functions on its 8-device CPU mesh and
the port's unsharded functions; and the drift guard of the context-parallel
and pipelined forwards. Each parity test is one spawn of the ranks
(`torch_mesh_workers.context_worker`).

Tolerances:
  * ring attention (single head, as JAX's; and 4 packed heads against the
    port's unsharded attention), with a padded element whose keys leave
    whole blocks dead and a wholly dead element: within 1e-5 of
    max(|y|, 1) of JAX's ring and of the unsharded attention (f32 sums of
    another order);
  * the sharded Sinkhorn: JAX's own test's rtol 1e-4, atol 1e-5 against
    JAX's sharded Sinkhorn; batched, against the port's unsharded loop;
  * context-parallel SuperGlue (4 layers, D = 32, K = 32 over 4 ranks, full
    and padded masks): matches0 / matches1 equal to JAX's context-parallel
    forward and to the port's unsharded forward, scores within 1e-5.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

from image_matching_tpu.models.superglue import SuperGlue as JaxSuperGlue
from image_matching_tpu.parallel.context_parallel import make_context_parallel_superglue as jax_cp
from image_matching_tpu.parallel.mesh import make_mesh as jax_mesh
from image_matching_tpu.parallel.ring_attention import make_ring_attention as jax_ring
from image_matching_tpu.parallel.sharded_sinkhorn import make_sharded_log_optimal_transport as jax_ot
from image_matching_tpu.structs import Keypoints as JaxKeypoints
from image_matching_tpu.utils.weights import flatten_tree
from image_matching_tpu_torch.models import SuperGlue
from image_matching_tpu_torch.parallel import mesh as pmesh
from image_matching_tpu_torch.parallel.context_parallel import make_context_parallel_superglue
from image_matching_tpu_torch.parallel.pipeline import make_pipelined_superglue
from image_matching_tpu_torch.weights import params_from_jax
from test_torch_features import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from torch_mesh_workers import context_worker, keypoints, spawn

TOL = 1e-5
SHAPE = (64, 64)


def kpt_arrays(rng, b, k, d, n_valid=None):
    """`tests/test_models.make_kpts` in numpy: (xy, score, mask, desc), K - n_valid padded slots."""
    n_valid = k if n_valid is None else n_valid
    mask = np.zeros((b, k), bool)
    mask[:, :n_valid] = True
    desc = rng.normal(size=(b, k, d)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return {"xy": rng.uniform(8, 56, (b, k, 2)).astype(np.float32),
            "score": (rng.uniform(0.1, 1.0, (b, k)) * mask).astype(np.float32),
            "mask": mask, "desc": desc * mask[..., None]}


def jax_kpts(a):
    return JaxKeypoints(**{k: jnp.asarray(v) for k, v in a.items()})


def perturbed_superglue(kw, seed, a0, a1):
    """A JAX SuperGlue's variables with non-trivial batch-norm statistics
    and affines (so that every one of them matters), and the port's state
    dict of them."""
    model = JaxSuperGlue(**kw, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), jax_kpts(a0), jax_kpts(a1), SHAPE, SHAPE)
    rng = np.random.default_rng(seed + 1)

    def leaf(path, x):
        name = str(path[-1].key)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape).astype(np.float32))
        if name in ("mean", "bias"):
            return jnp.asarray(rng.normal(0, 0.1, x.shape).astype(np.float32))
        if name == "scale":
            return jnp.asarray(rng.normal(1, 0.1, x.shape).astype(np.float32))
        return x

    variables = jax.tree_util.tree_map_with_path(leaf, variables)
    return variables, params_from_jax(flatten_tree(variables))


def _ring_cases():
    rng = np.random.default_rng(0)
    b, n, d = 3, 64, 32
    q, k, v = (rng.normal(size=(b, n, d)).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, n), bool)
    mask[0] = rng.uniform(size=n) > 0.3  # scattered keys
    mask[1, :20] = True  # padded: the keys of the later blocks all dead
    # mask[2]: no valid key at all
    heads = [rng.normal(size=(2, n, 4 * 8)).astype(np.float32) for _ in range(3)]
    hmask = np.ones((2, n), bool)
    hmask[1, 40:] = False
    return {"single head": (q, k, v, mask, 1), "4 packed heads": (*heads, hmask, 4)}


CP_KW = dict(gnn_layers=4, sinkhorn_iterations=25, match_threshold=0.01)  # random weights: low scores


@functools.cache
def _jax_cp():
    """JAX's context-parallel forward over 4 devices, jitted: compiled once for both cases."""
    cp = jax_cp(jax_mesh({"context": 4}, jax.devices()[:4]), **CP_KW)
    return jax.jit(lambda v, k0, k1: cp(v, k0, k1, SHAPE, SHAPE))


def _superglue_case(n_valid0, n_valid1):
    kw = dict(descriptor_dim=32, keypoint_encoder=(16, 32), **CP_KW)
    rng = np.random.default_rng(1)
    a0, a1 = kpt_arrays(rng, 2, 32, 32, n_valid0), kpt_arrays(rng, 2, 32, 32, n_valid1)
    variables, state = perturbed_superglue(kw, 2, a0, a1)
    ref = _jax_cp()(variables, jax_kpts(a0), jax_kpts(a1))
    return (dict(kw, compute_dtype="float32"), state, a0, a1, SHAPE, CP_KW), [np.asarray(r) for r in ref]


@pytest.mark.parametrize("world", [2, 4])
def test_context_parallel_paths_over_gloo_ranks(tmp_path, world):
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    cases = _ring_cases()
    ring = jax_ring(jax_mesh({"context": 8}))
    jax_out = {name: np.asarray(ring(*(jnp.asarray(x) for x in c[:4]))) for name, c in cases.items() if c[4] == 1}
    inputs = {"ring": {name: (t(q), t(k), t(v), t(m), h) for name, (q, k, v, m, h) in cases.items()}}
    if world == 4:
        rng = np.random.default_rng(2)
        m, n, iters = 64, 48, 50
        z = rng.normal(size=(m, n)).astype(np.float32)
        mu, nu = np.full((m,), -np.log(m), np.float32), np.full((n,), -np.log(n), np.float32)
        jax_z = np.asarray(jax_ot(jax_mesh({"context": 4}, jax.devices()[:4]), iters=iters)(
            jnp.asarray(z), jnp.asarray(mu), jnp.asarray(nu)))
        zb = rng.normal(size=(3, m, n)).astype(np.float32)
        mub = np.log(rng.dirichlet(np.ones(m), 3)).astype(np.float32)
        nub = np.log(rng.dirichlet(np.ones(n), 3)).astype(np.float32)
        inputs["sinkhorn"] = (t(z), t(mu), t(nu), iters)
        inputs["sinkhorn batched"] = (t(zb), t(mub), t(nub))
        sg_cases = {"full masks": _superglue_case(None, None), "padded masks": _superglue_case(20, 26)}
        inputs["superglue"] = {name: c[0] for name, c in sg_cases.items()}
    torch.save(inputs, tmp_path / "inputs.pt")
    ranks = spawn(context_worker, world, tmp_path)

    for r in ranks:
        for name, (q, k, v, mask, heads) in cases.items():
            got, whole = r[f"ring {name}"].numpy(), r[f"ring {name} unsharded"].numpy()
            scale = max(np.abs(whole).max(), 1.0)
            assert np.abs(got - whole).max() <= TOL * scale, name
            if name in jax_out:
                assert np.abs(got - jax_out[name]).max() <= TOL * scale, name
                # the wholly dead element: the mean of V over all N keys, as JAX's ring gives
                np.testing.assert_allclose(got[2], np.broadcast_to(v[2].mean(0), got[2].shape), atol=TOL)
        if world == 4:
            np.testing.assert_allclose(r["sinkhorn"].numpy(), jax_z, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(r["sinkhorn batched"].numpy(), r["sinkhorn batched unsharded"].numpy(),
                                       rtol=1e-4, atol=1e-5)
            for name, (_, ref) in sg_cases.items():
                got = [x.numpy() for x in r[f"cp {name}"]]
                whole = [x.numpy() for x in r[f"cp {name} unsharded"]]
                for want in (ref, whole):
                    np.testing.assert_array_equal(got[0], want[0], err_msg=name)
                    np.testing.assert_array_equal(got[1], want[1], err_msg=name)
                    np.testing.assert_allclose(got[2], want[2], atol=TOL, err_msg=name)
                    np.testing.assert_allclose(got[3], want[3], atol=TOL, err_msg=name)
                assert (got[0] >= 0).sum() > 0, name


# ---------------------------------------------------------------- drift guard

class _Reads(TorchFunctionMode):
    """Records which of the watched tensors any torch function reads."""

    def __init__(self, watched: dict):
        super().__init__()
        self.names = {id(t): name for name, t in watched.items()}
        self.read = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for x in tree_flatten((args, kwargs))[0]:
            if isinstance(x, torch.Tensor) and id(x) in self.names:
                self.read.add(self.names[id(x)])
        return func(*args, **kwargs)


@pytest.mark.parametrize("layers", [2, 18])
def test_sharded_forwards_read_every_superglue_parameter(layers):
    """The counterpart of `tests/test_cp_drift.py`: every parameter and
    batch statistic of the port's `SuperGlue` is read by the
    context-parallel forward and by the pipelined forward (each on a
    one-rank axis here), so a parameter that the model gains or renames
    and these forwards miss fails with its name."""
    d, k = 64, 16
    sg = SuperGlue(descriptor_dim=d, keypoint_encoder=(32, d), gnn_layers=layers, sinkhorn_iterations=5,
                   compute_dtype="float32", device="cpu").eval()
    rng = np.random.default_rng(0)
    a = kpt_arrays(rng, 2, k, d)
    kp = keypoints(a)
    watched = dict(sg.named_parameters())
    watched.update(sg.named_buffers())
    assert any(re.search(r"running_(mean|var)$", n) for n in watched)
    forwards = {
        "context-parallel": make_context_parallel_superglue(pmesh.make_mesh({"context": 1}, "cpu"), gnn_layers=layers,
                                                            sinkhorn_iterations=5),
        "pipelined": make_pipelined_superglue(pmesh.make_mesh({"pipe": 1}, "cpu"), gnn_layers=layers,
                                              sinkhorn_iterations=5, num_microbatches=2),
    }
    for label, fn in forwards.items():
        with _Reads(watched) as reads:
            fn(sg, kp, kp, SHAPE, SHAPE)
        unread = sorted(set(watched) - reads.read)
        assert not unread, f"SuperGlue parameters and statistics the {label} forward does not read: {unread}"
