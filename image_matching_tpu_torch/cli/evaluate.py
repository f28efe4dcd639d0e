"""Evaluate the learned registration pipelines on synthetic pairs with
exact ground truth — the counterpart of `image_matching_tpu/cli/evaluate.py`.

Configs:
  sp    — SuperPoint + ratio-KNN + RANSAC
  spsg  — SuperPoint + SuperGlue + RANSAC
(`sift` and `orb`, the classical features, are not ported: ROADMAP.md,
Queue A item 7.)

Usage, on the card (the defaults: 50 photo-texture pairs at 480x640,
K = 1200, similarity RANSAC at 7 px, the H-only backbone):
  python -m image_matching_tpu_torch.cli.evaluate \
      --sp_checkpoint weights/sp_photo.npz --sg_checkpoint weights/sg_photo.npz
and on the CPU, smaller:
  python -m image_matching_tpu_torch.cli.evaluate --device cpu --n_pairs 3 \
      --height 240 --width 320 --max_keypoints 256 \
      --sp_checkpoint weights/sp_photo.npz --sg_checkpoint weights/sg_photo.npz

It prints one JSON object per config and writes them all to `--out`.
Where the JAX CLI differs: checkpoints are npz files written by the JAX
package's `save_npz` (orbax directories are not read); `--device`
defaults to cuda; RANSAC draws from a `torch.Generator` seeded with
seed + 1 where JAX takes PRNGKey(seed + 1). The pairs are the JAX CLI's:
`np.random.default_rng(seed)` through the same makers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time

import numpy as np
import torch

from image_matching_tpu_torch.device import resolve_device
from image_matching_tpu_torch.evaluation import evaluate_pipeline, make_eval_pairs
from image_matching_tpu_torch.models.matching import Matching, MatchingConfig
from image_matching_tpu_torch.registration import build_registration_fn
from image_matching_tpu_torch.weights import load_npz

log = logging.getLogger("evaluate")

CLASSICAL_NOT_PORTED = ("the classical features (sift, orb) are not ported yet: "
                        "ROADMAP.md, Queue A item 7")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--configs", nargs="+", default=["sp", "spsg"], choices=["sift", "orb", "sp", "spsg"])
    p.add_argument("--n_pairs", type=int, default=50)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--max_keypoints", type=int, default=1200)
    p.add_argument("--keypoint_threshold", type=float, default=0.005)
    p.add_argument("--ransac_threshold", type=float, default=7.0)
    p.add_argument("--ransac_model", default="similarity", choices=["similarity", "homography"])
    p.add_argument("--sp_checkpoint", default=None, help="SuperPoint npz (the JAX package's save_npz)")
    p.add_argument("--sg_checkpoint", default=None, help="SuperGlue npz (the JAX package's save_npz)")
    p.add_argument("--descriptor_dim", type=int, default=128)
    p.add_argument("--max_angle", type=float, default=0.25)
    p.add_argument("--max_shift", type=float, default=48.0)
    p.add_argument("--texture", default="photo", choices=["blobs", "photo", "noise"])
    p.add_argument("--gt", default="similarity", choices=["similarity", "perspective"])
    p.add_argument("--max_perspective", type=float, default=48.0, help="corner jitter in px for --gt perspective")
    p.add_argument("--photo_asym", action="store_true", help="photometric corruption of the source only")
    p.add_argument("--s2d_backbone", default="h", choices=["h", "2x2", "off"],
                   help="SuperPoint layout: H-only s2d, (2, 2) s2d, or the plain conv path")
    p.add_argument("--match_threshold", type=float, default=0.1)
    p.add_argument("--sg_ratio_gate", type=float, default=0.0)
    p.add_argument("--conf_gamma", type=float, default=1.0)
    p.add_argument("--success_px", type=float, default=5.0)
    p.add_argument("--per_pair", action="store_true", help="include per-pair diagnostics in the JSON")
    p.add_argument("--out", default="EVAL.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if {"sift", "orb"} & set(args.configs):
        p.error(CLASSICAL_NOT_PORTED)
    return args


def make_pairs(args):
    """The evaluation pairs: `np.random.default_rng(seed)` through the makers."""
    return make_eval_pairs(np.random.default_rng(args.seed), args.n_pairs, args.height, args.width,
                           max_angle=args.max_angle, max_shift=args.max_shift, texture=args.texture,
                           gt_model=args.gt, max_perspective=args.max_perspective, photo_asym=args.photo_asym)


def build_model(args, **config) -> Matching:
    """The JAX CLI's `_sp_model_and_vars`: `SuperPointBN` with subpixel
    refinement, 30 Sinkhorn iterations, the chosen backbone layout, the
    checkpoints loaded (seeded random weights without them). `config`
    overrides fields of the `MatchingConfig` (the JAX CLI's defaults
    otherwise, bf16 compute among them)."""
    cfg = MatchingConfig(
        backbone="bn",
        descriptor_dim=args.descriptor_dim,
        max_keypoints=args.max_keypoints,
        keypoint_threshold=args.keypoint_threshold,
        subpixel=True,
        keypoint_encoder=(32, 64, 128) if args.descriptor_dim == 128 else (32, 64, 128, 256),
        sinkhorn_iterations=30,
        match_threshold=args.match_threshold,
        s2d_backbone=args.s2d_backbone != "off",
        s2d_layout=args.s2d_backbone if args.s2d_backbone != "off" else "h",
    )
    cfg = dataclasses.replace(cfg, **config)
    model = Matching(cfg, device=resolve_device(args.device), seed=0)
    if args.sp_checkpoint:
        load_npz(model.superpoint, args.sp_checkpoint)
    if args.sg_checkpoint:
        load_npz(model.superglue, args.sg_checkpoint)
    return model


def evaluate_configs(model: Matching, pairs, args) -> dict:
    """{config: metrics} for each of `args.configs`, each config's RANSAC
    drawing from a generator seeded with seed + 1."""
    results = {}
    device = next(model.parameters()).device
    for name in args.configs:
        t0 = time.perf_counter()
        register = build_registration_fn(
            model, matcher="ratio" if name == "sp" else "superglue", ransac_model=args.ransac_model,
            ransac_threshold=args.ransac_threshold, min_match_count=8, produce_warp=False,
            confidence_gamma=args.conf_gamma, sg_ratio_gate=args.sg_ratio_gate)
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        res = evaluate_pipeline(register, pairs, gen, args.success_px, per_pair=args.per_pair)
        res["wall_s_total"] = round(time.perf_counter() - t0, 2)
        results[name] = res
        log.info("%s: %s", name, json.dumps(res))
    return results


def main(argv=None) -> dict:
    """Run the evaluation as the command line asks; returns {config: metrics}
    and writes them to `--out`."""
    args = parse_args(argv)
    pairs = make_pairs(args)
    log.info("%d synthetic pairs (%dx%d)", len(pairs), args.height, args.width)
    results = evaluate_configs(build_model(args), pairs, args)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    log.info("wrote %s", args.out)
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    main()
