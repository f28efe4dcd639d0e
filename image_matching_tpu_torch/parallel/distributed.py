"""The multi-process runtime — the counterpart of
`image_matching_tpu/parallel/distributed.py`, on `torch.distributed`.

A data-parallel run is one process a card, started by `torchrun
--nproc_per_node N`, which sets `MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`,
`RANK` and `LOCAL_RANK`. `initialize_multihost` reads them and joins the
process group over a TCP store (NCCL on the card, gloo on the CPU), with
the rank's card as its current device. Without those variables it does
nothing and the world is one process; a group that the caller already
initialised is used as it is.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from image_matching_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def initialize_multihost(device="cuda") -> dict:
    """Join torchrun's process group (no-op without torchrun's variables).
    `device`: the CLI's `--device`: "cuda" takes NCCL and card LOCAL_RANK,
    "cpu" takes gloo. Returns a summary dict for logging, with the JAX
    module's keys and this rank's device and backend."""
    device = torch.device(device)
    env = os.environ
    if not dist.is_initialized() and all(v in env for v in TORCHRUN_VARS):
        local = int(env["LOCAL_RANK"])
        backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(local)
        dist.init_process_group(backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                                world_size=int(env["WORLD_SIZE"]), rank=int(env["RANK"]))
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device())
    info = {
        "process_index": rank(),
        "process_count": world_size(),
        "local_devices": 1,
        "global_devices": world_size(),
        "device": str(device),
        "backend": dist.get_backend() if dist.is_initialized() else None,
    }
    log.info("distributed runtime: %s", info)
    return info


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and summaries."""
    return rank() == 0
