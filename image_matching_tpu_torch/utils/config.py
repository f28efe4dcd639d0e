"""YAML configs — the counterpart of `image_matching_tpu/utils/config.py`:
the reference's YAML files merged over defaults with a recursive
`dict_update`, and the merged config snapshotted into the run directory."""
from __future__ import annotations

import os
from typing import Mapping, Optional

import yaml


def dict_update(d: dict, u: Mapping) -> dict:
    """A copy of `d` with `u` merged in, mappings merged recursively."""
    d = dict(d)
    for k, v in u.items():
        if isinstance(v, Mapping) and isinstance(d.get(k), Mapping):
            d[k] = dict_update(d[k], v)
        else:
            d[k] = v
    return d


def load_config(path: str, defaults: Optional[dict] = None) -> dict:
    """The YAML file at `path` (empty: {}), merged over `defaults`."""
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    return dict_update(defaults, cfg) if defaults else cfg


def snapshot_config(cfg: dict, run_dir: str, name: str = "config.yml") -> str:
    """Write `cfg` as YAML to `<run_dir>/<name>` (keys in their order); returns the path."""
    os.makedirs(run_dir, exist_ok=True)
    out = os.path.join(run_dir, name)
    with open(out, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return out
