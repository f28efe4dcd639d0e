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
`utils/torch_convert.convert_superpoint_vgg`). The official SuperGlue
state_dict loads with `load_magicleap_superglue` (the JAX package's
`convert_superglue`).

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


def read_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def load_npz(module: torch.nn.Module, path: str) -> None:
    """Strictly load an npz written by the JAX package's `save_npz`."""
    load_jax_params(module, read_npz(path))


def _strip_module(state: dict) -> dict:
    prefix = "module."
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in state.items()}


def load_magicleap_superpoint(module: torch.nn.Module, state: dict) -> None:
    """Strictly load an official MagicLeap SuperPoint state_dict
    (`conv1a.weight` ... `convDb.bias`, with or without DataParallel's
    `module.` prefix) into a `SuperPointVGG`."""
    state = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in _strip_module(state).items()}
    module.load_state_dict(state, strict=True)


def _magicleap_mlp(state: dict, prefix: str, scope: str) -> dict:
    """The official `MLP` (Conv1d / BatchNorm1d / ReLU slots under
    `prefix.<i>`) -> the port's `SeqMLP` entries (`Dense_j`,
    `MaskedBatchNorm1d_j`), in slot order, as `convert_superglue` maps it."""
    slots = sorted({int(k[len(prefix) + 1:].split(".")[0]) for k in state if k.startswith(prefix + ".")})
    out, dense, norm = {}, 0, 0
    for i in slots:
        w = state.get(f"{prefix}.{i}.weight")
        if w is None:
            continue
        if w.dim() == 3:  # Conv1d (O, I, 1)
            out[f"{scope}.Dense_{dense}.weight"] = w[..., 0]
            out[f"{scope}.Dense_{dense}.bias"] = state[f"{prefix}.{i}.bias"]
            dense += 1
        elif w.dim() == 1 and f"{prefix}.{i}.running_mean" in state:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                out[f"{scope}.MaskedBatchNorm1d_{norm}.{leaf}"] = state[f"{prefix}.{i}.{leaf}"]
            norm += 1
    return out


def load_magicleap_superglue(module: torch.nn.Module, state: dict) -> None:
    """Strictly load an official MagicLeap SuperGlue state_dict (`kenc.encoder.<i>`,
    `gnn.layers.<l>.attn.proj.{0,1,2}` for q, k, v, `.attn.merge`,
    `.mlp.<i>`, `final_proj`, `bin_score`; Conv1d kernels (O, I, 1); with or
    without DataParallel's `module.` prefix) into a `SuperGlue`, as the JAX
    package's `utils/torch_convert.convert_superglue` maps it. Layer l is the
    module's `layer_<l>_self` or `layer_<l>_cross`; `num_batches_tracked`
    has no counterpart."""
    state = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in _strip_module(state).items()
             if not k.endswith("num_batches_tracked")}
    out = _magicleap_mlp(state, "kenc.encoder", "kenc")
    for li, name in enumerate(module.gnn.names):
        layer = f"gnn.layers.{li}"
        for src, dst in (("attn.proj.0", "proj_q"), ("attn.proj.1", "proj_k"), ("attn.proj.2", "proj_v"),
                         ("attn.merge", "merge")):
            out[f"gnn.{name}.attn.{dst}.weight"] = state[f"{layer}.{src}.weight"][..., 0]
            out[f"gnn.{name}.attn.{dst}.bias"] = state[f"{layer}.{src}.bias"]
        out.update(_magicleap_mlp(state, f"{layer}.mlp", f"gnn.{name}.mlp"))
    out["final_proj.weight"] = state["final_proj.weight"][..., 0]
    out["final_proj.bias"] = state["final_proj.bias"]
    out["bin_score"] = state["bin_score"].reshape(())
    module.load_state_dict(out, strict=True)


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


def write_npz(flat: dict, path: str) -> None:
    """Write a flat dict of arrays as the JAX package's `save_npz` does: one
    compressed npz, written through one atomic rename."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **flat)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def save_npz(module: torch.nn.Module, path: str) -> None:
    """Write `module`'s weights as the JAX package's `save_npz` does, keyed by
    tree path."""
    write_npz(params_to_jax(module.state_dict()), path)
