"""Train SuperGlue on self-generated warped pairs — the counterpart of
`image_matching_tpu/cli/train_superglue.py`: pairs are generated on the
device in each step (homographies, warps, optional photometric corruption,
frozen SuperPoint, ground truth), an epoch loop logs the mean loss and
writes a checkpoint after every epoch.

Usage, on the card (the JAX CLI's defaults: 240x320, batch 4, K = 512,
D = 128, 18 GNN layers, 100 Sinkhorn iterations, lr 1e-4, bf16):
  python -m image_matching_tpu_torch.cli.train_superglue --synthetic \
      --sp_checkpoint weights/sp_photo.npz --run_dir runs/superglue
and on the CPU, smaller, with `--device cpu`. Data-parallel over N cards
(gloo over N processes with `--device cpu`), the same flags:
  torchrun --nproc_per_node N -m image_matching_tpu_torch.cli.train_superglue ...
Each rank reads the global batch, keeps its dim-0 shard and runs its part
of the global step (`parallel/mesh.py`): the same losses and updates as
one process on the whole batch, up to the order of f32 sums. Only rank 0
logs and writes checkpoints; `--resume` restores on every rank.

Where the JAX CLI differs: `--sp_checkpoint` and `--init_weights` take npz
files (the JAX package's `save_npz`, or a trainer checkpoint of the port;
for `--sp_checkpoint` also a directory of those); checkpoints are written
as `<run_dir>/checkpoints/<step>.npz` (`train/checkpoint.py`), not orbax.
Random numbers: the data from `--seed` as in JAX; each step's homographies
and photometric draws, for the global batch, from a `torch.Generator`
seeded with seed + 7 on every rank. Metrics go to the log (and to
tensorboardX where it is installed) every `--log_interval` steps, one
host read-back an interval.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from image_matching_tpu_torch.data.datasets import ALLSSDataset, SyntheticShapesDataset
from image_matching_tpu_torch.data.photometric import PhotometricConfig
from image_matching_tpu_torch.device import resolve_device
from image_matching_tpu_torch.geometry.homography import HomographyConfig
from image_matching_tpu_torch.models import SuperGlue, SuperPointBN
from image_matching_tpu_torch.parallel import (
    initialize_multihost,
    is_primary,
    make_data_mesh,
    replicate,
    shard_batch,
    use_mesh,
)
from image_matching_tpu_torch.train.checkpoint import CheckpointManager, checkpoint_file, load_weights
from image_matching_tpu_torch.train.state import TrainState
from image_matching_tpu_torch.train.superglue_trainer import SuperGluePairConfig, make_superglue_train_step
from image_matching_tpu_torch.utils.logging import get_logger, summary_writer

log = get_logger("train_superglue")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--sp_checkpoint", default=None, help="SuperPoint npz (random init if absent)")
    p.add_argument("--run_dir", default="runs/superglue")
    p.add_argument("--descriptor_dim", type=int, default=128)
    p.add_argument("--keypoint_encoder", type=int, nargs="+", default=[32, 64, 128])
    p.add_argument("--gnn_layers", type=int, default=18)
    p.add_argument("--sinkhorn_iterations", type=int, default=100)
    p.add_argument("--max_keypoints", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--grad_clip", type=float, default=0.0, help="global-norm gradient clip (0 = off)")
    p.add_argument("--warmup_steps", type=int, default=0, help="linear lr warmup steps (0 = constant lr)")
    p.add_argument("--cosine_decay_steps", type=int, default=0,
                   help="cosine-decay the lr to lr/10 over this many steps (0 = constant); --warmup_steps wins")
    p.add_argument("--init_weights", default=None,
                   help="warm-start SuperGlue from an npz (step resets to 0; fine-tune entry point)")
    p.add_argument("--subpixel", action="store_true", help="subpixel-refine keypoints in pair generation")
    p.add_argument("--gt_dist_thresh", type=float, default=3.0, help="ground-truth correspondence distance in px")
    p.add_argument("--photometric", action="store_true",
                   help="independent photometric corruption of each view before detection")
    p.add_argument("--perspective_amplitude", type=float, default=0.1)
    p.add_argument("--scaling_amplitude", type=float, default=0.1)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--steps_per_epoch", type=int, default=500)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--log_interval", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train as the command line asks. Returns {"state": the TrainState,
    "history": one record an epoch (epoch, first and last step, mean loss,
    steps/s), "logged": one record a log interval (step, mean loss,
    metrics)}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    initialize_multihost(device)
    mesh = make_data_mesh(args.batch_size, device)
    if not mesh.active:
        log.info("this rank holds no shard of the data mesh (%d ranks divide batch %d): idle", mesh.size,
                 args.batch_size)
        return {"state": None, "history": [], "logged": []}
    primary = is_primary()
    if args.synthetic or args.data_root is None:
        data_iter = SyntheticShapesDataset(args.height, args.width, seed=args.seed).batches(args.batch_size)
    else:
        ds = ALLSSDataset(args.data_root, "train", resize=(args.height, args.width))
        data_iter = ds.batches(args.batch_size, seed=args.seed)

    sp = SuperPointBN(args.descriptor_dim, compute_dtype="bfloat16", device=device, seed=0)
    if args.sp_checkpoint:
        load_weights(sp, checkpoint_file(args.sp_checkpoint))
        log.info("loaded SuperPoint from %s", args.sp_checkpoint)
    sg = SuperGlue(descriptor_dim=args.descriptor_dim, keypoint_encoder=tuple(args.keypoint_encoder),
                   gnn_layers=args.gnn_layers, sinkhorn_iterations=args.sinkhorn_iterations,
                   compute_dtype="bfloat16", device=device, seed=args.seed)
    cfg = SuperGluePairConfig(
        max_keypoints=args.max_keypoints, subpixel=args.subpixel, gt_dist_thresh=args.gt_dist_thresh,
        homography=HomographyConfig(patch_ratio=0.85, allow_artifacts=True,
                                    perspective_amplitude_x=args.perspective_amplitude,
                                    perspective_amplitude_y=args.perspective_amplitude,
                                    scaling_amplitude=args.scaling_amplitude),
        photometric=PhotometricConfig(enable=args.photometric),
    )
    state = TrainState.create(sg, args.learning_rate, warmup_steps=args.warmup_steps,
                              cosine_decay_steps=args.cosine_decay_steps, grad_clip=args.grad_clip)
    if args.init_weights:
        load_weights(sg, args.init_weights)
        log.info("warm-started SuperGlue from %s", args.init_weights)
    ckpt = CheckpointManager(f"{args.run_dir}/checkpoints")
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        log.info("resumed from step %d", state.step)
    replicate(mesh, sg)

    step_fn = make_superglue_train_step(sg, sp, cfg)
    writer = summary_writer(args.run_dir) if primary else None
    gen = torch.Generator(device=device).manual_seed(args.seed + 7)
    history, logged = [], []
    try:
        for epoch in range(args.epochs):
            losses = []  # device scalars, read back at log points
            first, t0 = state.step, time.perf_counter()
            for i in range(args.steps_per_epoch):
                images = shard_batch(mesh, next(data_iter)["image"])
                with use_mesh(mesh):
                    metrics = step_fn(state, images, gen)
                losses.append(metrics["loss"])
                if (i + 1) % args.log_interval == 0:
                    names = [k for k in metrics if k != "loss"]
                    values = torch.stack([torch.stack(losses[-args.log_interval:]).float().mean()]
                                         + [torch.as_tensor(metrics[k], device=device).float() for k in names])
                    recent, *rest = values.tolist()  # the interval's one read-back
                    m = dict(zip(names, rest))
                    if writer:
                        writer.add_scalar("train/Mean_Loss", recent, state.step)
                        for k, v in m.items():
                            writer.add_scalar(f"train/{k}", v, state.step)
                    rate = (i + 1) / (time.perf_counter() - t0)
                    if primary:
                        log.info("epoch %d step %d: loss %.4f (%.1f it/s) %s", epoch, state.step, recent, rate, m)
                    logged.append(dict(step=state.step, loss=recent, **m))
            mean = float(torch.stack(losses).float().mean())
            rate = args.steps_per_epoch / (time.perf_counter() - t0)
            if primary:
                log.info("epoch %d: mean loss %.4f (%.1f steps/s)", epoch, mean, rate)
                ckpt.save(state)
            history.append(dict(epoch=epoch, first_step=first, last_step=state.step, mean_loss=mean, steps_per_s=rate))
    except KeyboardInterrupt:
        log.info("interrupted — saving checkpoint")
    if primary and ckpt.latest_step() != state.step:
        ckpt.save(state)
    return {"state": state, "history": history, "logged": logged}


if __name__ == "__main__":
    main()
