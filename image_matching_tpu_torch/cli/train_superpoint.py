"""Train SuperPoint (detector and descriptor) — the counterpart of
`image_matching_tpu/cli/train_superpoint.py`: an iteration loop around
`train/superpoint_trainer.py`'s step, with batches built on the device
(`data/pipeline.py`), detector precision / recall every
`--tensorboard_interval` steps, an evaluation step every
`--validation_interval`, a checkpoint every `--save_interval` and on Ctrl-C.

Usage, on the card (the JAX CLI's defaults: 240x320, batch 8, D = 128,
bf16, Adam at 1e-4):
  python -m image_matching_tpu_torch.cli.train_superpoint --synthetic \\
      --run_dir runs/sp_synth
  python -m image_matching_tpu_torch.cli.train_superpoint \\
      --data_root datasets/PHOTO --labels runs/pseudo_photo \\
      --init_weights weights/sp_synth.npz --run_dir runs/sp_photo
and on the CPU, smaller, with `--device cpu`. Data-parallel over N cards
(gloo over N processes with `--device cpu`), the same flags:
  torchrun --nproc_per_node N -m image_matching_tpu_torch.cli.train_superpoint ...
Each rank builds the global batch from the same generator, keeps its
dim-0 shard and runs its part of the global step (`parallel/mesh.py`;
batch norms on the global batch's statistics): the same losses and
updates as one process on the whole batch, up to the order of f32 sums.
Only rank 0 logs and writes checkpoints and summaries; `--resume`
restores on every rank.

Data: with `--synthetic` (or no `--data_root`) synthetic shapes are made on
the device (`data/synthetic_device.py`), or by the host's
`SyntheticShapesDataset` with `--host_data`; else `ALLSSDataset` images
under `<data_root>/{train,val}` with the pseudo-label points of `--labels`,
the training images decoded by the repository's threaded C++ loader with
`--native_loader` (`data/native_loader.py`; PNG and JPEG; on four threads,
on one under a data mesh of several ranks, so that every rank draws the
same global batch).

Where the JAX CLI differs: checkpoints are `<run_dir>/checkpoints/<step>.npz`
(`train/checkpoint.py`, the batch statistics under `batch_stats::`, so each
package restores the other's), not orbax; `--init_weights` takes such a
file or the JAX package's `save_npz` snapshot. The tensorboardX writer
(where the package is installed) gets the scalars, the parameter
histograms and, at each evaluation, the first image's detector heatmap
overlay (`utils/viz.heatmap_overlay`). Random numbers: every draw of a
step (the synthetic shapes, the pair's homographies and photometric draws,
the descriptor loss's) from one `torch.Generator` on the device, seeded
with seed + 100; host data from `--seed` as in JAX.
"""
from __future__ import annotations

import argparse
import time

import torch

from image_matching_tpu_torch.data.datasets import ALLSSDataset, SyntheticShapesDataset
from image_matching_tpu_torch.data.pipeline import WarpedPairConfig, make_warped_pair_batch
from image_matching_tpu_torch.data.synthetic_device import synthetic_batch
from image_matching_tpu_torch.device import resolve_device
from image_matching_tpu_torch.geometry.labels import flatten_detection
from image_matching_tpu_torch.models import SuperPointBN
from image_matching_tpu_torch.parallel import (
    initialize_multihost,
    is_primary,
    make_data_mesh,
    replicate,
    shard_batch,
    use_mesh,
)
from image_matching_tpu_torch.train.checkpoint import CheckpointManager, load_weights
from image_matching_tpu_torch.train.metrics import detector_precision_recall
from image_matching_tpu_torch.train.state import TrainState
from image_matching_tpu_torch.train.superpoint_trainer import (
    SuperPointLossConfig,
    make_superpoint_eval_step,
    make_superpoint_train_step,
)
from image_matching_tpu_torch.utils.logging import get_logger, summary_writer
from image_matching_tpu_torch.utils.viz import heatmap_overlay

log = get_logger("train_superpoint")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", default=None)
    p.add_argument("--labels", default=None, help="pseudo-label npz dir")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--run_dir", default="runs/superpoint")
    p.add_argument("--descriptor_dim", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--train_iter", type=int, default=100_000)
    p.add_argument("--validation_interval", type=int, default=2000)
    p.add_argument("--save_interval", type=int, default=2000)
    p.add_argument("--tensorboard_interval", type=int, default=200)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--native_loader", action="store_true",
                   help="decode the training images with the C++ threaded loader (native/imloader)")
    p.add_argument("--host_data", action="store_true",
                   help="generate synthetic batches with the host dataset instead of on the device")
    p.add_argument("--cosine_decay_steps", type=int, default=0,
                   help="cosine-decay the lr to lr/10 over this many steps (0 = constant, the reference's behavior)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init_weights", default=None,
                   help="warm-start params/batch_stats from a .npz weight snapshot; step resets to 0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _read_back(metrics: dict) -> dict:
    """The metrics' device scalars as floats, in one read-back."""
    tensors = {k: v for k, v in metrics.items() if torch.is_tensor(v)}
    values = torch.stack([v.float() for v in tensors.values()]).tolist()
    return {**metrics, **dict(zip(tensors, values))}


@torch.no_grad()
def _overlay(model, image):
    """The detector heatmap of one (1, H, W, 1) image over it, uint8 BGR."""
    heat = flatten_detection(model(image)["semi"], dtype=torch.float32)
    return heatmap_overlay(image[0].float().cpu().numpy(), heat[0].cpu().numpy())


def main(argv=None) -> dict:
    """Train as the command line asks. Returns {"state": the TrainState,
    "history": one record a validation (step, the eval step's metrics),
    "logged": one record a tensorboard interval (step, the step's metrics,
    precision and recall, steps/s)}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    initialize_multihost(device)
    mesh = make_data_mesh(args.batch_size, device)
    if not mesh.active:
        log.info("this rank holds no shard of the data mesh (%d ranks divide batch %d): idle", mesh.size,
                 args.batch_size)
        return {"state": None, "history": [], "logged": []}
    primary = is_primary()
    h, w, bs = args.height, args.width, args.batch_size
    device_data = (args.synthetic or args.data_root is None) and not args.host_data
    train_iter = val_iter = None
    if device_data:
        log.info("synthetic batches made on the device")
    elif args.synthetic or args.data_root is None:
        train_iter = SyntheticShapesDataset(h, w, seed=args.seed).batches(bs)
        val_iter = SyntheticShapesDataset(h, w, seed=args.seed + 1).batches(bs)
    else:
        # under a mesh of several ranks the loader decodes on one thread:
        # its order is then its mt19937(seed) shuffle, the same global batch
        # on every rank (with more threads it follows their timing)
        train_iter = ALLSSDataset(args.data_root, "train", args.labels, resize=(h, w)).batches(
            bs, seed=args.seed, native=args.native_loader, n_threads=4 if mesh.size == 1 else 1)
        val_iter = ALLSSDataset(args.data_root, "val", args.labels, resize=(h, w)).batches(bs, shuffle=False)

    model = SuperPointBN(args.descriptor_dim, compute_dtype="bfloat16", device=device, seed=args.seed)
    state = TrainState.create(model, args.learning_rate, cosine_decay_steps=args.cosine_decay_steps)
    if args.init_weights:
        load_weights(model, args.init_weights)
        log.info("warm-started from %s", args.init_weights)
    ckpt = CheckpointManager(f"{args.run_dir}/checkpoints")
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        log.info("resumed from step %d", state.step)
    replicate(mesh, model)

    pair_cfg, loss_cfg = WarpedPairConfig(), SuperPointLossConfig()
    train_step = make_superpoint_train_step(model, loss_cfg)
    eval_step = make_superpoint_eval_step(model, loss_cfg)
    writer = summary_writer(args.run_dir) if primary else None
    gen = torch.Generator(device=device).manual_seed(args.seed + 100)

    def next_batch(host_iter) -> dict:
        """The global batch, made alike on every rank; this rank's shard of it."""
        if device_data:
            src = synthetic_batch(gen, bs, h, w)
        else:
            host = next(host_iter)
            src = {k: torch.from_numpy(host[k]).to(device) for k in ("image", "points", "points_mask")}
        return shard_batch(mesh, make_warped_pair_batch(gen, src["image"], src["points"], src["points_mask"],
                                                        pair_cfg))

    history, logged = [], []
    # the loop counts iterations on the host, as the JAX CLI does: a batch
    # the non-finite guard skips still takes its iteration
    step = start = state.step
    t0 = time.perf_counter()
    try:
        with use_mesh(mesh):
            while step < args.train_iter:
                batch = next_batch(train_iter)
                metrics = train_step(state, batch, gen)
                step += 1

                if step % args.tensorboard_interval == 0:
                    with torch.no_grad():
                        pr = detector_precision_recall(model(batch["image"])["semi"], batch["labels_2d"])
                    m = _read_back({**metrics, **pr})
                    m["steps_per_s"] = (step - start) / (time.perf_counter() - t0)
                    if primary:
                        log.info("step %d: %s", step, m)
                    if writer:
                        for k, v in m.items():
                            writer.add_scalar(f"train/{k}", v, step)
                    logged.append(dict(step=step, **m))

                if step % args.validation_interval == 0:
                    vbatch = next_batch(val_iter)
                    vm = _read_back(eval_step(state, vbatch, gen))
                    if primary:
                        log.info("val @%d: %s", step, vm)
                    if writer:
                        for k, v in vm.items():
                            writer.add_scalar(f"val/{k}", v, step)
                        writer.add_image("val/heatmap_overlay", _overlay(model, vbatch["image"][:1])[..., ::-1], step,
                                         dataformats="HWC")
                        for name, p in list(model.named_parameters())[:8]:
                            writer.add_histogram(f"params/{name}", p.detach().float().cpu().numpy(), step)
                    history.append(dict(step=step, **vm))

                if primary and step % args.save_interval == 0:
                    ckpt.save(state)
    except KeyboardInterrupt:
        log.info("interrupted — saving checkpoint")
    finally:
        if writer:
            writer.close()
    if primary and ckpt.latest_step() != state.step:
        ckpt.save(state)
    log.info("done at step %d", state.step)
    return {"state": state, "history": history, "logged": logged}


if __name__ == "__main__":
    main()
