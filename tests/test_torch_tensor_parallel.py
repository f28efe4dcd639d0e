"""The port's tensor parallelism (`parallel/sharding.py`, the model axis of
`parallel/mesh.py`) on the CPU: the split of every SuperGlue parameter
against the JAX package's `superglue_param_sharding`, and one training step
on gloo ranks (a data x model mesh of 4 ranks, a model axis of 2) against
the one-process step (`torch_mesh_workers.tp_worker`, one spawn a mesh).

The split: JAX's P(None, "model") on a flax kernel (in, out) is the torch
weight's (out, in) dim 0, P("model", None) its dim 1; the column-parallel
layers' biases and the batch norm after the MLP's first layer, which JAX
leaves replicated (GSPMD handles them), are split with those layers'
output columns.

Tolerances (`tests/test_torch_parallel.py`'s scheme for a sharded step,
whose sums run in another order): losses, metrics, running statistics and
Adam's moments within 1e-5 (of the largest entry of each tensor, of the
largest moment), counts exactly; parameters within 1e-2 lr where the
gradient stands above 1e-3 of the largest, within 2 lr elsewhere (Adam's
first step is about the gradient's sign, and rounding noise of a zero true
gradient has either sign). The replicated parameters and statistics are
bit-equal on every rank of the model axis.
"""
import jax
import numpy as np
import pytest
import torch

from image_matching_tpu.models.superglue import SuperGlue as JaxSuperGlue
from image_matching_tpu.parallel import make_mesh as jax_mesh
from image_matching_tpu.parallel import superglue_param_sharding as jax_sharding
from image_matching_tpu.structs import Keypoints as JaxKeypoints
from image_matching_tpu_torch.models import SuperGlue
from image_matching_tpu_torch.parallel.mesh import Axis, Mesh
from image_matching_tpu_torch.parallel.sharding import superglue_param_sharding
from image_matching_tpu_torch.weights import params_from_jax
from test_torch_features import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from torch_mesh_workers import spawn, tp_worker

TOL = 1e-5


def _model_mesh(size: int) -> Mesh:
    """A mesh of one process with a model axis of `size`, as rank 0 sees
    it (the split depends on the axis's size only)."""
    return Mesh(1, 0, torch.device("cpu"), axes=(Axis("model", size, 0, tuple(range(size))),))


def test_param_sharding_follows_jax():
    d = 32
    jm = JaxSuperGlue(descriptor_dim=d, keypoint_encoder=(32, d), gnn_layers=2, sinkhorn_iterations=5)
    rng = np.random.default_rng(0)
    kp = JaxKeypoints(xy=rng.uniform(0, 32, (1, 8, 2)).astype(np.float32), score=np.ones((1, 8), np.float32),
                      mask=np.ones((1, 8), bool), desc=rng.normal(size=(1, 8, d)).astype(np.float32))
    variables = jm.init(jax.random.PRNGKey(0), kp, kp, (32, 32), (32, 32))
    specs = jax_sharding(variables, jax_mesh({"data": 4, "model": 2}))
    # each JAX path as a port state_dict key, with JAX's spec as a torch dim
    spec_dim = {(): None, (None, "model"): 0, ("model", None): 1}
    jax_dims = {}
    for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]:
        flat = "::".join(getattr(k, "key", str(k)) for k in path)
        (key,) = params_from_jax({flat: np.zeros((1, 1) if flat.endswith("kernel") else (1,))})
        jax_dims[key] = spec_dim[tuple(s.spec)]

    port = superglue_param_sharding(SuperGlue(descriptor_dim=d, keypoint_encoder=(32, d), gnn_layers=2,
                                              sinkhorn_iterations=5, device="cpu"), _model_mesh(2))
    assert set(port) == set(jax_dims)
    split_with_columns = (".attn.proj_q.bias", ".attn.proj_k.bias", ".attn.proj_v.bias", ".mlp.Dense_0.bias",
                          ".mlp.MaskedBatchNorm1d_0.weight", ".mlp.MaskedBatchNorm1d_0.bias",
                          ".mlp.MaskedBatchNorm1d_0.running_mean", ".mlp.MaskedBatchNorm1d_0.running_var")
    for key, dim in jax_dims.items():
        want = 0 if key.startswith("gnn.") and key.endswith(split_with_columns) else dim
        assert port[key].dim == want, (key, port[key].dim, dim)
    assert sum(dim is not None for dim in jax_dims.values()) == 2 * 6  # 2 layers x (q, k, v, merge, mlp 0, mlp 1)
    assert all(s.axis.size == 2 for s in port.values() if s.dim is not None)

    # a mesh without a model axis, or of one rank, replicates everything; the heads split whole
    for mesh in (_model_mesh(1), Mesh(1, 0, torch.device("cpu"))):
        sg = SuperGlue(descriptor_dim=d, keypoint_encoder=(32, d), gnn_layers=2, device="cpu")
        assert all(s.dim is None for s in superglue_param_sharding(sg, mesh).values())
    for size in (3, 8):
        with pytest.raises(ValueError, match="whole heads"):
            superglue_param_sharding(sg, _model_mesh(size))


@pytest.mark.parametrize("axes", [{"data": 2, "model": 2}, {"model": 2}], ids=["data2_model2", "model2"])
def test_tensor_parallel_step_equals_one_process(tmp_path, axes):
    world = int(np.prod(list(axes.values())))
    ranks = spawn(tp_worker, world, tmp_path, axes)
    if world == 4:  # row-major layout: rank = 2 * data + model
        for r, rep in enumerate(ranks):
            lay = rep["layouts"]["{'data': 2, 'model': 2}"]
            d, m = divmod(r, 2)
            assert lay["data"] == (2, d, (m, m + 2), True) and lay["model"] == (2, m, (2 * d, 2 * d + 1), True)
            assert lay["data shard"] == (2, d)
            assert rep["layouts"]["{'context': 4}"]["context"] == (4, r, (0, 1, 2, 3), True)
            assert rep["layouts"]["{'pipe': 4}"]["data shard"] == (1, 0)
            three = rep["layouts"]["{'data': 1, 'model': 2, 'pipe': 2}"]  # rank = 2 * model + pipe
            assert three["data"] == (1, 0, (r,), False) and three["data shard"] == (1, 0)
            assert three["model"] == (2, d, (m, m + 2), True) and three["pipe"] == (2, m, (2 * d, 2 * d + 1), True)
    for rep in ranks:
        assert rep["steps"] == (1, 1)
        # 2 layers x (q, k, v and their biases; merge; mlp 0, its bias and its batch norm's 4; mlp 1)
        assert len(rep["split"]) == 2 * 14
        assert rep["replicated differ"] == [], rep["replicated differ"]
        assert rep["metric keys"][0] == rep["metric keys"][1]
        assert all(v <= TOL for v in rep["metrics"].values()), rep["metrics"]
        for k in ("running statistics", "Adam mu", "Adam nu"):
            assert rep[k] <= TOL, (k, rep[k])
        assert rep["parameters where the gradient is above 1e-3 of the largest, in lr"] <= 1e-2
        assert rep["parameters elsewhere, in lr"] <= 2.0
