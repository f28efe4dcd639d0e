"""Sequence registration: frames -> pairwise registration -> pose graph
-> (optionally) track-based bundle adjustment -> trajectory — the
counterpart of `image_matching_tpu/cli/sequence.py`.

Frames are registered along consecutive and stride-K loop-closure edges
with the classical SIFT / ORB front end, the pose graph is solved
globally (`slam/pose_graph.py`), and with --ba the trajectory is refined
by robust bundle adjustment over SIFT point tracks
(`slam/bundle_adjustment.py`). Writes `--out` (TRAJECTORY.json) with the
per-frame world-from-frame similarity params [a, b, tx, ty] and prints
the same JSON without the trajectory.

Usage, on the card:
  python -m image_matching_tpu_torch.cli.sequence --frames_dir video_frames/ \
      --out TRAJECTORY.json --method sift --strides 1 4 --ba
  # or, with no data, a synthetic self-check with ATE against the ground truth:
  python -m image_matching_tpu_torch.cli.sequence --synthetic --ba
and on the CPU with `--device cpu`.

Where the JAX CLI differs: frames are 8-bit PNG or binary PGM / PPM read
by `imgproc.imread_gray` (a frame of another format raises, naming it);
RANSAC draws from one `torch.Generator` seeded with `--seed`, edge after
edge, where JAX splits PRNGKey(seed); `--device` defaults to cuda.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from image_matching_tpu_torch import imgproc
from image_matching_tpu_torch.data.datasets import IMAGE_EXTS
from image_matching_tpu_torch.device import resolve_device
from image_matching_tpu_torch.evaluation import make_synthetic_sequence
from image_matching_tpu_torch.features.registration import build_classical_registration_fn
from image_matching_tpu_torch.features.sift import sift_detect_and_describe
from image_matching_tpu_torch.models.tracker import get_tracks, tracker_init, tracker_update
from image_matching_tpu_torch.slam import absolute_trajectory_error, compose_similarity, invert_similarity
from image_matching_tpu_torch.slam.sequence import refine_trajectory_with_tracks, register_sequence, solve_trajectory
from image_matching_tpu_torch.utils.logging import get_logger

log = get_logger("sequence")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames_dir", help="directory of frame images (sorted)")
    p.add_argument("--synthetic", action="store_true", help="run on a synthetic drifting-camera sequence with GT")
    p.add_argument("--n_frames", type=int, default=12)
    p.add_argument("--out", default="TRAJECTORY.json")
    p.add_argument("--method", default="sift", choices=["sift", "orb"])
    p.add_argument("--strides", type=int, nargs="+", default=[1, 4])
    p.add_argument("--ba", action="store_true", help="refine with track-based robust bundle adjustment")
    p.add_argument("--min_track_length", type=int, default=3)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_frames(frames_dir: str):
    """The frames of a directory, in name order, as float32 (H, W, 1) in [0, 1]."""
    names = sorted(f for f in os.listdir(frames_dir) if os.path.splitext(f)[1].lower() in IMAGE_EXTS | {".pgm"})
    frames = [(imgproc.imread_gray(os.path.join(frames_dir, n)).astype(np.float32) / 255.0)[..., None]
              for n in names]
    return frames, names


def main(argv=None) -> dict:
    """Run the sequence pipeline as the command line asks; returns the
    result written to `--out` (with the trajectory)."""
    args = parse_args(argv)
    device = resolve_device(args.device)

    gt_rel = None
    if args.synthetic:
        frames, gt = make_synthetic_sequence(np.random.default_rng(args.seed), n_frames=args.n_frames)
        names = [f"synthetic_{i:03d}" for i in range(len(frames))]
        gt_t = torch.from_numpy(gt).to(device)
        gt_rel = compose_similarity(invert_similarity(gt_t[0])[None], gt_t)
    elif args.frames_dir:
        frames, names = load_frames(args.frames_dir)
    else:
        raise SystemExit("provide --frames_dir or --synthetic")
    n = len(frames)
    log.info("%d frames", n)

    register = build_classical_registration_fn(args.method)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    graph = register_sequence(register, frames, gen, strides=tuple(args.strides))
    n_valid = int((graph.weight > 0).sum())
    log.info("pose graph: %d/%d valid edges", n_valid, graph.src.shape[0])
    traj = solve_trajectory(graph, iters=args.iters)

    result = {"frames": names, "method": args.method, "valid_edges": n_valid, "stage": "pose_graph"}
    if gt_rel is not None:
        ate = float(absolute_trajectory_error(traj, gt_rel, align=True))
        result["ate_pose_graph_px"] = round(ate, 4)
        log.info("pose-graph ATE %.4f px", ate)

    if args.ba:
        state = tracker_init(max_length=n, capacity=1024, desc_dim=128, device=device)
        with torch.inference_mode():
            for fr in frames:
                kp = sift_detect_and_describe(torch.from_numpy(fr).to(device)[None])
                state = tracker_update(state, kp.select(0), max_dist=0.9)
        tracks = get_tracks(state, min_length=args.min_track_length)
        log.info("%d tracks (>= %d obs)", len(tracks), args.min_track_length)
        traj, landmarks = refine_trajectory_with_tracks(tracks, traj, n, iters=args.iters,
                                                        min_track_length=args.min_track_length)
        result["stage"] = "bundle_adjusted"
        result["num_tracks"] = len(tracks)
        result["num_landmarks"] = int(landmarks.shape[0])
        if gt_rel is not None:
            ate = float(absolute_trajectory_error(traj, gt_rel, align=True))
            result["ate_bundle_adjusted_px"] = round(ate, 4)
            log.info("bundle-adjusted ATE %.4f px", ate)

    result["trajectory"] = traj.cpu().numpy().tolist()
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    log.info("wrote %s", args.out)
    print(json.dumps({k: v for k, v in result.items() if k != "trajectory"}))
    return result


if __name__ == "__main__":
    main()
