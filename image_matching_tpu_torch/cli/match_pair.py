"""Template-vs-source registration of image files — the counterpart of
`image_matching_tpu/cli/match_pair.py`: for each source image, detect +
match + RANSAC against the template at `--resize_scale`, rescale the
transform to full resolution, and write `<name>_transform.txt`,
`<name>_matches.png` and `<name>_warped.png`; log each pair's wall time,
matches, inliers and whether the fit is valid.

Usage, on the card (the JAX CLI's defaults: the bn backbone in the H-only
space-to-depth layout, D = 128, K = 1200, similarity RANSAC at 7 px):
  python -m image_matching_tpu_torch.cli.match_pair \
      --template T.png --source_dir sources/ --out out/ \
      --matcher superglue --resize_scale 0.25 \
      --sp_checkpoint weights/sp_photo.npz --sg_checkpoint weights/sg_photo.npz
and on the CPU with `--device cpu`.

Where the JAX CLI differs: checkpoints are npz files (the JAX package's
`save_npz`, a trainer checkpoint of the port, or a directory of those);
orbax directories are not read. Images are 8-bit PNG or binary PGM / PPM
(`imgproc.READS`): other files in the source directory with an image
suffix raise. RANSAC draws from a `torch.Generator` seeded with `--seed`
where JAX takes PRNGKey(seed). `--device` defaults to cuda.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from image_matching_tpu_torch.data.datasets import SSHIDataset
from image_matching_tpu_torch.device import resolve_device
from image_matching_tpu_torch.models.matching import Matching, MatchingConfig
from image_matching_tpu_torch.registration import build_registration_fn, rescale_transform
from image_matching_tpu_torch.train.checkpoint import load_submodule_checkpoints
from image_matching_tpu_torch.utils.logging import get_logger
from image_matching_tpu_torch.utils.viz import make_matching_plot, save_image

log = get_logger("match_pair")

MIN_MATCH_COUNT = 10


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--template", required=True)
    p.add_argument("--source_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--matcher", default="ratio", choices=["ratio", "superglue"])
    p.add_argument("--backbone", default="bn", choices=["bn", "vgg"])
    p.add_argument("--sp_checkpoint", default=None, help="SuperPoint npz, or a directory of trainer checkpoints")
    p.add_argument("--sg_checkpoint", default=None, help="SuperGlue npz, or a directory of trainer checkpoints")
    p.add_argument("--descriptor_dim", type=int, default=128)
    p.add_argument("--resize_scale", type=float, default=0.25)
    p.add_argument("--max_keypoints", type=int, default=1200)
    p.add_argument("--keypoint_threshold", type=float, default=0.005)
    p.add_argument("--nms_radius", type=int, default=4)
    p.add_argument("--sinkhorn_iterations", type=int, default=30)
    p.add_argument("--match_threshold", type=float, default=0.1)
    p.add_argument("--ratio", type=float, default=0.7)
    p.add_argument("--ransac_threshold", type=float, default=7.0)
    p.add_argument("--ransac_model", default="similarity", choices=["similarity", "homography"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _pad_to(img: np.ndarray, h: int, w: int) -> np.ndarray:
    out = np.zeros((h, w, 1), np.float32)
    out[: img.shape[0], : img.shape[1]] = img[:h, :w]
    return out


def build_model(args) -> Matching:
    """The JAX CLI's `MatchingConfig`: its flags over the JAX defaults,
    among them the H-only space-to-depth backbone and bf16 compute; seeded
    random weights until the checkpoints load."""
    cfg = MatchingConfig(
        backbone=args.backbone,
        s2d_backbone=True,
        s2d_layout="h",
        descriptor_dim=args.descriptor_dim,
        max_keypoints=args.max_keypoints,
        keypoint_threshold=args.keypoint_threshold,
        nms_radius=args.nms_radius,
        keypoint_encoder=(32, 64, 128) if args.descriptor_dim == 128 else (32, 64, 128, 256),
        sinkhorn_iterations=args.sinkhorn_iterations,
        match_threshold=args.match_threshold,
    )
    model = Matching(cfg, device=resolve_device(args.device), seed=0)
    load_submodule_checkpoints(model, cfg, sp_checkpoint=args.sp_checkpoint, sg_checkpoint=args.sg_checkpoint)
    return model


def main(argv=None) -> list[dict]:
    """Register every source against the template as the command line
    asks; returns one record a pair: name, wall_s, matches, inliers, valid
    and the full-resolution transform."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    ds = SSHIDataset(args.template, args.source_dir, args.resize_scale)
    os.makedirs(args.out, exist_ok=True)
    log.info("%d source images", len(ds))
    model = build_model(args)

    # one padded shape for every pair (the JAX CLI's single compiled program)
    t = ds[0]
    h = max(t["template"].shape[0], t["source"].shape[0])
    w = max(t["template"].shape[1], t["source"].shape[1])
    h, w = ((h + 7) // 8) * 8, ((w + 7) // 8) * 8
    register = build_registration_fn(model, matcher=args.matcher, ratio=args.ratio, ransac_model=args.ransac_model,
                                     ransac_threshold=args.ransac_threshold, min_match_count=MIN_MATCH_COUNT)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    records = []
    for i in range(len(ds)):
        s = ds[i]
        tpl = torch.from_numpy(_pad_to(s["template"], h, w))[None].to(device)
        src = torch.from_numpy(_pad_to(s["source"], h, w))[None].to(device)
        t0 = time.perf_counter()
        res = register(tpl, src, gen)
        n_inl = int(res.fit.num_inliers[0])
        dt = time.perf_counter() - t0
        n_matches, valid = int(res.matches.num_matches()[0]), bool(res.fit.valid[0])
        log.info("%s: %.3fs, %d matches, %d inliers, valid=%s", s["name"], dt, n_matches, n_inl, valid)

        full = rescale_transform(res.fit.matrix[0], args.resize_scale).cpu().numpy()
        np.savetxt(os.path.join(args.out, s["name"] + "_transform.txt"), full)
        viz = make_matching_plot(tpl[0].cpu().numpy(), src[0].cpu().numpy(), res.kpts0.xy[0].cpu().numpy(),
                                 res.kpts1.xy[0].cpu().numpy(), res.matches.matches0[0].cpu().numpy(),
                                 res.matches.scores0[0].float().cpu().numpy())
        save_image(os.path.join(args.out, s["name"] + "_matches.png"), viz)
        warped = (np.clip(res.warped[0, :, :, 0].float().cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        save_image(os.path.join(args.out, s["name"] + "_warped.png"), warped)
        records.append(dict(name=s["name"], wall_s=dt, matches=n_matches, inliers=n_inl, valid=valid, transform=full))
    return records


if __name__ == "__main__":
    main()
