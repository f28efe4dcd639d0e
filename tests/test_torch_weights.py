"""The port's weight mapping (`image_matching_tpu_torch/weights.py`):
JAX variables -> flat npz dict -> torch state_dict, strictly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from image_matching_tpu.models.matching import Matching as JaxMatching
from image_matching_tpu.models.matching import MatchingConfig as JaxConfig
from image_matching_tpu.utils.weights import flatten_tree
from image_matching_tpu_torch.models import Matching, MatchingConfig, SuperGlue, SuperPointBN
from image_matching_tpu_torch.weights import load_jax_params, load_npz, params_from_jax

SMALL = dict(descriptor_dim=64, keypoint_encoder=(16, 32), gnn_layers=2,
             sinkhorn_iterations=3, max_keypoints=32)


def _jax_matching_flat():
    model = JaxMatching(JaxConfig(s2d_backbone=False, compute_dtype="float32", **SMALL))
    img = jnp.zeros((1, 32, 32, 1), jnp.float32)
    return flatten_tree(model.init(jax.random.PRNGKey(0), img, img))


def _to_flax(flat_key, tensor):
    """Invert the documented layout rule for one entry."""
    a = tensor.numpy()
    if flat_key.endswith("::kernel"):
        a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
    return a


def test_matching_tree_round_trip_strict():
    flat = _jax_matching_flat()
    model = Matching(MatchingConfig(compute_dtype="float32", **SMALL), device="cpu")
    load_jax_params(model, flat)
    state = params_from_jax(flat)
    assert len(state) == len(flat) == len(model.state_dict())
    for key, arr in flat.items():
        coll, *path, leaf = key.split("::")
        name = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
                "var": "running_var"}.get(leaf, leaf)
        got = model.state_dict()[".".join([*path, name])]
        np.testing.assert_array_equal(_to_flax(key, got), arr)  # exact: pure relayout


def test_strict_loading_rejects_missing_extra_and_shape():
    flat = _jax_matching_flat()
    model = Matching(MatchingConfig(compute_dtype="float32", **SMALL), device="cpu")
    key = "params::superglue::final_proj::bias"
    missing = {k: v for k, v in flat.items() if k != key}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(model, missing)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(model, {**flat, "params::superglue::extra::bias": flat[key]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, {**flat, key: np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unknown"):
        params_from_jax({"params::x::weird": np.zeros(1)})


@pytest.mark.parametrize("path,build", [
    ("weights/sp_photo.npz", lambda: SuperPointBN(128, device="cpu")),
    ("weights/sg_photo.npz", lambda: SuperGlue(128, (32, 64, 128), device="cpu")),
])
def test_banked_npz_loads_strict(path, build):
    module = build()
    load_npz(module, path)
    with np.load(path) as data:
        for key in data.files:
            if key.endswith("::kernel"):
                *path_, _ = key.split("::")[1:]
                w = module.state_dict()[".".join([*path_, "weight"])]
                np.testing.assert_array_equal(_to_flax(key, w), data[key])
    assert len(module.state_dict()) == len(data.files)
