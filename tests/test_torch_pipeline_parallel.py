"""The port's pipeline parallelism (`parallel/pipeline.py`) on gloo ranks on
the CPU against the JAX package's `make_pipelined_superglue` (6 GNN layers
over 2 and 3 stages, 2 microbatches of 2 pairs, D = 32, K = 32), one spawn
a case (`torch_mesh_workers.pipeline_worker`): every rank's matches0 and
matches1 equal to JAX's and its scores within 1e-4, JAX's own test's
tolerance; `stack_gnn_params` against JAX's, and the divisibility checks.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from image_matching_tpu.parallel.pipeline import make_pipelined_superglue as jax_pipelined
from image_matching_tpu.parallel.pipeline import stack_gnn_params as jax_stack
from image_matching_tpu_torch.parallel.mesh import Axis, Mesh
from image_matching_tpu_torch.parallel.pipeline import make_pipelined_superglue, stack_gnn_params
from test_torch_context_parallel import SHAPE, jax_kpts, kpt_arrays, perturbed_superglue
from test_torch_features import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from torch_mesh_workers import keypoints, pipeline_worker, spawn, superglue

LAYERS = 6
KW = dict(descriptor_dim=32, keypoint_encoder=(16, 32), gnn_layers=LAYERS, sinkhorn_iterations=25,
          match_threshold=0.01)  # random weights: low scores


def _case(n_valid0=None, n_valid1=None):
    rng = np.random.default_rng(3)
    a0, a1 = kpt_arrays(rng, 4, 32, 32, n_valid0), kpt_arrays(rng, 4, 32, 32, n_valid1)
    variables, state = perturbed_superglue(KW, 4, a0, a1)
    return variables, state, a0, a1


@pytest.mark.parametrize("stages,n_valid", [(2, (20, 26)), (3, (None, None))], ids=["pipe2_padded", "pipe3_full"])
def test_pipelined_superglue_equals_jax(tmp_path, stages, n_valid):
    variables, state, a0, a1 = _case(*n_valid)
    pp_kw = dict(gnn_layers=LAYERS, sinkhorn_iterations=25, match_threshold=0.01, num_microbatches=2)
    ref = jax_pipelined(JaxMesh(np.array(jax.devices()[:stages]), ("pipe",)), **pp_kw)(
        variables, jax_kpts(a0), jax_kpts(a1), SHAPE, SHAPE)
    torch.save((dict(KW, compute_dtype="float32"), state, a0, a1, SHAPE, pp_kw), tmp_path / "inputs.pt")
    ranks = spawn(pipeline_worker, stages, tmp_path)
    assert [r["stage"] for r in ranks] == list(range(stages))
    for r in ranks:  # every rank returns the whole result
        out = {k: v.numpy() for k, v in r["out"].items()}
        np.testing.assert_array_equal(out["matches0"], np.asarray(ref["matches0"]))
        np.testing.assert_array_equal(out["matches1"], np.asarray(ref["matches1"]))
        np.testing.assert_allclose(out["matching_scores0"], np.asarray(ref["matching_scores0"]), atol=1e-4)
        assert (out["matches0"] >= 0).sum() > 0


def test_stack_gnn_params_equals_jax():
    variables, state, *_ = _case()
    p, s, cross = stack_gnn_params(superglue(dict(KW, compute_dtype="float32"), state), LAYERS)
    jp, js, jcross = jax_stack(variables, LAYERS)
    np.testing.assert_array_equal(cross.numpy(), np.asarray(jcross))
    assert p["attn.proj_q.weight"].shape == (LAYERS, 32, 32) and s["mlp.MaskedBatchNorm1d_0.running_mean"].shape[0] \
        == LAYERS
    np.testing.assert_array_equal(p["attn.merge.weight"].detach().numpy(),
                                  np.asarray(jp["attn"]["merge"]["kernel"]).transpose(0, 2, 1))
    np.testing.assert_array_equal(p["mlp.Dense_1.bias"].detach().numpy(), np.asarray(jp["mlp"]["Dense_1"]["bias"]))
    np.testing.assert_array_equal(s["mlp.MaskedBatchNorm1d_0.running_var"].numpy(),
                                  np.asarray(js["mlp"]["MaskedBatchNorm1d_0"]["var"]))


def test_pipeline_rejects_bad_divisibility():
    four = Mesh(1, 0, torch.device("cpu"), axes=(Axis("pipe", 4, 0, (0, 1, 2, 3)),))
    with pytest.raises(ValueError, match="not divisible by pipe"):
        make_pipelined_superglue(four, gnn_layers=LAYERS)
    one = Mesh(1, 0, torch.device("cpu"), axes=(Axis("pipe", 1, 0, (0,)),))
    _, state, a0, a1 = _case()
    run = make_pipelined_superglue(one, gnn_layers=LAYERS, num_microbatches=3)
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        run(superglue(dict(KW, compute_dtype="float32"), state), keypoints(a0), keypoints(a1), SHAPE, SHAPE)
