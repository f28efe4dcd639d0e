"""Weights from the JAX package's flat npz format.

The JAX package writes a variables tree as one npz keyed by tree path,
`::`-joined (`image_matching_tpu/utils/weights.py`): for example
`params::inc::ConvBNReLU_0::Conv_0::kernel` or
`batch_stats::gnn::layer_0_self::mlp::MaskedBatchNorm1d_0::mean`. The
port's modules carry the same names, so a path maps to a state_dict key
by its collection and leaf alone:

  params::...::kernel (kH, kW, I, O)   -> ....weight (O, I, kH, kW)  conv
  params::...::kernel (I, O)           -> ....weight (O, I)          dense
  params::...::bias                    -> ....bias
  params::...::scale                   -> ....weight                 (masked) batch norm
  batch_stats::...::mean / var         -> ....running_mean / running_var
  params::...::bin_score               -> ....bin_score

Both the `Matching` tree (`params::superpoint::...`,
`params::superglue::...`) and the bare SuperPoint / SuperGlue trees of
`weights/sp_*.npz` and `weights/sg_*.npz` map this way.

`SuperPointVGG`'s tree is the flat `params::conv1a::kernel` ...
`params::convDb::bias`, which maps the same way. Its layers carry the
official MagicLeap checkpoint's names, so that checkpoint's state_dict
loads with `load_magicleap_superpoint` (the JAX package converts it with
`utils/torch_convert.convert_superpoint_vgg`).

`params_to_jax` and `save_npz` go the other way, so weights trained by
the port load into the JAX package (`utils/weights.load_npz_into`). A
state_dict `weight` is a conv kernel (4 dims), a dense kernel (2 dims)
or a norm scale (1 dim).
"""
from __future__ import annotations

import io
import os

import numpy as np
import torch

_SEP = "::"
_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "bin_score": "bin_score"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Map a flat JAX variables dict to a torch state_dict (f32 CPU tensors)."""
    state = {}
    for key, arr in flat.items():
        coll, *path, leaf = key.split(_SEP)
        names = {"params": _PARAM_LEAVES, "batch_stats": _STAT_LEAVES}.get(coll)
        if names is None or leaf not in names:
            raise KeyError(f"unknown weight entry {key!r}")
        a = np.asarray(arr, dtype=np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        state[".".join([*path, names[leaf]])] = torch.from_numpy(np.array(a, order="C"))
    return state


def load_jax_params(module: torch.nn.Module, flat: dict[str, np.ndarray]) -> None:
    """Load a flat JAX variables dict into `module`, strictly: no missing
    or extra keys, every shape equal."""
    state = params_from_jax(flat)
    want = module.state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise KeyError(
            f"weights do not match {type(module).__name__}: missing={missing[:5]} "
            f"extra={extra[:5]} ({len(missing)} missing / {len(extra)} extra)"
        )
    for k, t in state.items():
        if tuple(t.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: shape {tuple(t.shape)} != module {tuple(want[k].shape)}")
    module.load_state_dict(state, strict=True)


def load_npz(module: torch.nn.Module, path: str) -> None:
    """Strictly load an npz written by the JAX package's `save_npz`."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    load_jax_params(module, flat)


def load_magicleap_superpoint(module: torch.nn.Module, state: dict) -> None:
    """Strictly load an official MagicLeap SuperPoint state_dict
    (`conv1a.weight` ... `convDb.bias`, with or without DataParallel's
    `module.` prefix) into a `SuperPointVGG`."""
    prefix = "module."
    state = {(k[len(prefix):] if k.startswith(prefix) else k): torch.as_tensor(v, dtype=torch.float32)
             for k, v in state.items()}
    module.load_state_dict(state, strict=True)


def params_to_jax(state_dict: dict) -> dict[str, np.ndarray]:
    """Map a torch state_dict to the JAX package's flat variables dict
    (f32 numpy arrays keyed by `::`-joined tree path)."""
    flat = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        a = t.detach().float().cpu().numpy()
        if leaf in ("running_mean", "running_var"):
            coll, name = "batch_stats", leaf[len("running_"):]
        elif leaf in ("bias", "bin_score"):
            coll, name = "params", leaf
        elif leaf == "weight" and a.ndim in (1, 2, 4):
            coll, name = "params", "scale" if a.ndim == 1 else "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        else:
            raise KeyError(f"no JAX counterpart for state_dict entry {key!r} {tuple(a.shape)}")
        flat[_SEP.join([coll, *path, name])] = np.array(a, order="C")
    return flat


def save_npz(module: torch.nn.Module, path: str) -> None:
    """Write `module`'s weights as the JAX package's `save_npz` does: one
    compressed npz keyed by tree path, written through one atomic rename."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **params_to_jax(module.state_dict()))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
