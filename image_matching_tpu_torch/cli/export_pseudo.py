"""Homographic-adaptation pseudo-label export — the counterpart of
`image_matching_tpu/cli/export_pseudo.py`: for every image of
`<data_root>/<task>`, the detector aggregated over `--num_homographies`
random warps (`export.py`), NMS, top-k and subpixel refinement, written as
`<out>/<task>/<name>.npz` (`pts` rows x, y, score) and, with `--viz`, a
keypoint overlay `<name>_viz.png`.

Usage, on the card (as the self-supervised cycle runs it, `--batch_size 8`
at 240x320: 400 views a call):
  python -m image_matching_tpu_torch.cli.export_pseudo \\
      --data_root datasets/PHOTO --out runs/pseudo_photo --task train \\
      --checkpoint weights/sp_synth.npz --height 240 --width 320 --batch_size 8
and on the CPU, smaller, with `--device cpu`.

Where the JAX CLI differs: `--checkpoint` takes an npz file (the JAX
package's `save_npz`, or a checkpoint of the port's trainers) or a directory
of the port's checkpoints (its latest step); orbax directories raise. The
homographies come from a `torch.Generator` on the device seeded with
`--seed`, so the two packages draw different warps from one seed.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from image_matching_tpu_torch.data.datasets import ALLSSDataset
from image_matching_tpu_torch.device import resolve_device
from image_matching_tpu_torch.export import ExportConfig, make_export_fn
from image_matching_tpu_torch.models import SuperPointBN
from image_matching_tpu_torch.train.checkpoint import checkpoint_file, load_weights
from image_matching_tpu_torch.utils.logging import get_logger
from image_matching_tpu_torch.utils.viz import draw_keypoints, save_image

log = get_logger("export_pseudo")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--task", default="train", choices=["train", "val"])
    p.add_argument("--descriptor_dim", type=int, default=128)
    p.add_argument("--num_homographies", type=int, default=50)
    p.add_argument("--top_k", type=int, default=1200)
    p.add_argument("--detection_threshold", type=float, default=0.015)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--viz", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Export as the command line asks. Returns {"written": the npz paths,
    "batches": one record a batch (first image, images, seconds from the
    images on the device to the keypoints on the host, keypoints an
    image)}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    ds = ALLSSDataset(args.data_root, args.task, resize=(args.height, args.width))
    log.info("%d images in %s/%s", len(ds), args.data_root, args.task)

    model = SuperPointBN(args.descriptor_dim, compute_dtype="bfloat16", device=device, seed=0)
    if args.checkpoint:
        load_weights(model, checkpoint_file(args.checkpoint))
        log.info("loaded %s", args.checkpoint)
    else:
        log.warning("no checkpoint given — exporting with random weights")
    cfg = ExportConfig(num_homographies=args.num_homographies, top_k=args.top_k,
                       detection_threshold=args.detection_threshold)
    export = make_export_fn(model, cfg)

    out_dir = os.path.join(args.out, args.task)
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    written, batches = [], []
    for start in range(0, len(ds), args.batch_size):
        samples = [ds[i] for i in range(start, min(start + args.batch_size, len(ds)))]
        images = torch.from_numpy(np.stack([s["image"] for s in samples])).to(device)
        t0 = time.perf_counter()
        kpts = export(gen, images)
        xy, score, mask = (t.cpu().numpy() for t in (kpts.xy, kpts.score, kpts.mask))
        seconds = time.perf_counter() - t0
        for i, s in enumerate(samples):
            pts = np.concatenate([xy[i], score[i][:, None]], -1)[mask[i]]
            path = os.path.join(out_dir, s["name"] + ".npz")
            np.savez_compressed(path, pts=pts)
            written.append(path)
            if args.viz:
                save_image(os.path.join(out_dir, s["name"] + "_viz.png"), draw_keypoints(s["image"], pts[:, :2]))
        batches.append(dict(first=start, images=len(samples), seconds=seconds, keypoints=mask.sum(1).tolist()))
        log.info("exported %d/%d (%.3f s)", start + len(samples), len(ds), seconds)
    return {"written": written, "batches": batches}


if __name__ == "__main__":
    main()
