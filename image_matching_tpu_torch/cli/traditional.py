"""Classical SIFT / ORB registration of image files — the counterpart of
`image_matching_tpu/cli/traditional.py` (the reference's `traditional.py`):
each source image against a template, both shrunk by `--resize_scale`,
detect + match + RANSAC on the device, the translation rescaled to full
resolution; writes `<name>_transform.txt`, `<name>_warped.png` (the
template warped by the fit) and `<name>_matches.png`, and logs each
pair's wall time, matches, inliers and whether the fit is valid.

Usage, on the card:
  python -m image_matching_tpu_torch.cli.traditional \
      --template T.png --source_dir sources/ --out out/ \
      --method sift --resize_scale 0.5
and on the CPU with `--device cpu`.

Where the JAX CLI differs: images are 8-bit PNG or binary PGM / PPM
(`imgproc.READS`); RANSAC draws from a `torch.Generator` seeded with
`--seed` where JAX takes PRNGKey(seed); the warped image is
`imgproc.warp_affine` of the 8-bit template in float32, rounded to uint8,
where JAX calls cv2.warpAffine on uint8 (OpenCV's fixed-point weights):
within 2 gray levels of it on at least 99% of the pixels. `--device`
defaults to cuda.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from image_matching_tpu_torch import imgproc
from image_matching_tpu_torch.data.datasets import SSHIDataset
from image_matching_tpu_torch.device import resolve_device
from image_matching_tpu_torch.features.registration import build_classical_registration_fn
from image_matching_tpu_torch.registration import rescale_transform
from image_matching_tpu_torch.utils.logging import get_logger
from image_matching_tpu_torch.utils.viz import make_matching_plot, save_image

log = get_logger("traditional")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--template", required=True)
    p.add_argument("--source_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--method", default="sift", choices=["sift", "orb"])
    p.add_argument("--resize_scale", type=float, default=0.5)
    p.add_argument("--ratio", type=float, default=0.7)
    p.add_argument("--ransac_threshold", type=float, default=7.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _pad_to(img: np.ndarray, h: int, w: int) -> np.ndarray:
    out = np.zeros((h, w, 1), np.float32)
    out[: img.shape[0], : img.shape[1]] = img[:h, :w]
    return out


def warp_template(template: np.ndarray, mat: np.ndarray, size) -> np.ndarray:
    """The template (H, W, 1) in [0, 1], made 8-bit as the JAX CLI makes it,
    warped by the (2, 3) fit into a (width, height) = `size` uint8 image."""
    u8 = (template[..., 0] * 255).astype(np.uint8)
    warped = imgproc.warp_affine(u8.astype(np.float32), mat, size)
    return np.clip(np.rint(warped), 0, 255).astype(np.uint8)


def main(argv=None) -> list[dict]:
    """Register every source against the template as the command line
    asks; returns one record a pair: name, wall_s, matches, inliers, valid
    and the full-resolution transform."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    ds = SSHIDataset(args.template, args.source_dir, args.resize_scale)
    os.makedirs(args.out, exist_ok=True)

    # one padded shape for every pair
    t = ds[0]
    h = max(t["template"].shape[0], t["source"].shape[0])
    w = max(t["template"].shape[1], t["source"].shape[1])
    register = build_classical_registration_fn(args.method, ratio=args.ratio, ransac_threshold=args.ransac_threshold)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    records = []
    for i in range(len(ds)):
        s = ds[i]
        tpl = _pad_to(s["template"], h, w)
        src = _pad_to(s["source"], h, w)
        t0 = time.perf_counter()
        res = register(torch.from_numpy(tpl)[None].to(device), torch.from_numpy(src)[None].to(device), gen)
        n_inl = int(res.fit.num_inliers[0])
        dt = time.perf_counter() - t0
        n_matches, valid = int(res.matches.num_matches()[0]), bool(res.fit.valid[0])
        log.info("%s: Time used %.3f s, %d matches, %d inliers, valid=%s", s["name"], dt, n_matches, n_inl, valid)

        mat = res.fit.matrix[0].cpu().numpy()
        full = rescale_transform(res.fit.matrix[0], args.resize_scale).cpu().numpy()
        np.savetxt(os.path.join(args.out, s["name"] + "_transform.txt"), full)
        save_image(os.path.join(args.out, s["name"] + "_warped.png"), warp_template(tpl, mat, (w, h)))
        viz = make_matching_plot(tpl, src, res.kpts0.xy[0].cpu().numpy(), res.kpts1.xy[0].cpu().numpy(),
                                 res.matches.matches0[0].cpu().numpy(),
                                 np.clip(res.matches.scores0[0].float().cpu().numpy(), 0, 1))
        save_image(os.path.join(args.out, s["name"] + "_matches.png"), viz)
        records.append(dict(name=s["name"], wall_s=dt, matches=n_matches, inliers=n_inl, valid=valid, transform=full))
    return records


if __name__ == "__main__":
    main()
