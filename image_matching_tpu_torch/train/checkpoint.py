"""Checkpoints of training, as npz files — the counterpart of
`image_matching_tpu/train/checkpoint.py`, which writes orbax directories.

A checkpoint is `<directory>/<step>.npz`: what the JAX package's
`utils/weights.save_npz` writes for the TrainState payload
`{"params", "batch_stats", "opt_state", "step"}` of the same model and
optimizer chain. The module's weights are the keys of `weights.save_npz`
(`params::...`, `batch_stats::...`); the optimizer's are optax's state
tree, whose path depends on the chain (`train/state.py`):

  Adam                    opt_state::0::.count, ::0::.mu::<param>, ::0::.nu::<param>
  Adam, scheduled lr      the same, and opt_state::1::.count
  clip, then Adam         every path under opt_state::1:: (the clip keeps no state)

so the JAX package's `load_npz_into` reads a checkpoint of the port, and
the port restores one that the JAX package wrote with `save_npz`. Orbax
directories are not read.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from image_matching_tpu_torch.train.state import TrainState
from image_matching_tpu_torch.weights import load_jax_params, params_from_jax, params_to_jax, read_npz, write_npz

_SEP = "::"
_STEP_FILE = re.compile(r"^(\d+)\.npz$")


def _opt_prefix(state: TrainState) -> tuple[str, Optional[str]]:
    """The paths of Adam's state and of the schedule's count in optax's tree."""
    root = "opt_state::1::" if state.grad_clip > 0 else "opt_state::"
    scheduled = state.warmup_steps > 0 or state.cosine_decay_steps > 0
    return root + "0::", (root + "1::.count" if scheduled else None)


def load_weights(module: torch.nn.Module, path: str) -> None:
    """Strictly load the `params::` / `batch_stats::` entries of an npz (a
    checkpoint of either package, or a bare `save_npz` file) into `module`."""
    flat = read_npz(path)
    load_jax_params(module, {k: v for k, v in flat.items() if k.split(_SEP)[0] in ("params", "batch_stats")})


def _is_orbax(directory: str) -> bool:
    return os.path.isdir(directory) and any(
        name.isdigit() and os.path.isdir(os.path.join(directory, name)) or name.startswith("_CHECKPOINT_METADATA")
        for name in os.listdir(directory))


class CheckpointManager:
    """`save`, `latest_step` and `restore` of a TrainState in `directory`,
    keeping the newest `max_to_keep` steps."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        if _is_orbax(self.directory):
            raise ValueError(f"{self.directory} holds orbax checkpoints of the JAX package; the port reads and "
                             "writes npz checkpoints (<step>.npz, the JAX package's save_npz format)")
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.npz")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState) -> int:
        """Write the state at its step (one atomic rename), then drop the
        oldest checkpoints beyond `max_to_keep`."""
        flat = params_to_jax(state.module.state_dict())
        adam, schedule = _opt_prefix(state)
        for which in ("mu", "nu"):
            moments = {name: state.optimizer.state[p].get(which, torch.zeros_like(p))
                       for name, p in state.module.named_parameters()}
            for key, arr in params_to_jax(moments).items():
                flat[f"{adam}.{which}{_SEP}{key[len('params' + _SEP):]}"] = arr
        flat[adam + ".count"] = np.asarray(state.optimizer.param_groups[0]["count"], np.int32)
        if schedule:
            flat[schedule] = np.asarray(state.step, np.int32)
        flat["step"] = np.asarray(state.step, np.int32)
        write_npz(flat, self.path(state.step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return state.step

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load the checkpoint at `step` (the latest if None) into `state`
        in place: weights, Adam's moments and count, the step. The file must
        hold the optimizer state of `state`'s chain."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        flat = read_npz(self.path(step))
        load_weights(state.module, self.path(step))
        adam, schedule = _opt_prefix(state)
        keys = {adam + ".count", "step"} | ({schedule} if schedule else set())
        missing = sorted(k for k in keys if k not in flat)
        if missing:
            raise KeyError(f"{self.path(step)} lacks {missing}: not a checkpoint of this optimizer chain")
        moments = {}
        for which in ("mu", "nu"):
            head = f"{adam}.{which}{_SEP}"
            moments[which] = params_from_jax({"params" + _SEP + k[len(head):]: v
                                              for k, v in flat.items() if k.startswith(head)})
        params = dict(state.module.named_parameters())
        if set(moments["mu"]) != set(params) or set(moments["nu"]) != set(params):
            raise KeyError(f"{self.path(step)}: Adam's moments do not match the module's parameters")
        for name, p in params.items():
            state.optimizer.state[p] = {which: moments[which][name].to(p.device, p.dtype).reshape(p.shape)
                                        for which in ("mu", "nu")}
        for group in state.optimizer.param_groups:
            group["count"] = int(flat[adam + ".count"])
        state.step = int(flat["step"])
        return state


def checkpoint_file(path: str) -> str:
    """An npz file as it is; a directory of the port's checkpoints -> its latest."""
    if path.endswith(".npz"):
        return path
    mgr = CheckpointManager(path)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {path}")
    return mgr.path(step)


def load_submodule_checkpoints(model, cfg, sp_checkpoint: Optional[str] = None,
                               sg_checkpoint: Optional[str] = None) -> None:
    """Load trainer-saved or banked npz weights into a `Matching`'s
    `superpoint` / `superglue`, in place. A checkpoint is an npz file or a
    directory of the port's checkpoints (its latest step). `cfg` is the
    model's `MatchingConfig` (the JAX package builds its templates from
    it; here it must be the model's own)."""
    if cfg != model.config:
        raise ValueError("load_submodule_checkpoints: cfg is not the model's config")
    if sp_checkpoint:
        load_weights(model.superpoint, checkpoint_file(sp_checkpoint))
    if sg_checkpoint:
        load_weights(model.superglue, checkpoint_file(sg_checkpoint))
