"""Rank bodies of the port's model-parallel CPU tests (`test_torch_tensor_parallel.py`,
`test_torch_context_parallel.py`, `test_torch_pipeline_parallel.py`,
`test_torch_sharded_solvers.py`). Each test computes the JAX package's
results and writes the inputs to a directory, then `spawn` starts the gloo
ranks on one of these bodies; each rank reads the inputs, runs its shard
and writes what it measured, which the test reads. This module imports no
JAX, so that the ranks start quickly.
"""
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from image_matching_tpu_torch.data.datasets import SyntheticShapesDataset
from image_matching_tpu_torch.models import SuperGlue
from image_matching_tpu_torch.models.superpoint import SuperPointBN
from image_matching_tpu_torch.ops.attention import attention_lse_plain, attention_plain
from image_matching_tpu_torch.ops.sinkhorn import log_sinkhorn_scan
from image_matching_tpu_torch.parallel import mesh as pmesh
from image_matching_tpu_torch.parallel.collectives import all_gather
from image_matching_tpu_torch.parallel.context_parallel import make_context_parallel_superglue
from image_matching_tpu_torch.parallel.pipeline import make_pipelined_superglue
from image_matching_tpu_torch.parallel.ring_attention import make_ring_attention
from image_matching_tpu_torch.parallel.sharded_sinkhorn import make_sharded_log_optimal_transport
from image_matching_tpu_torch.parallel.sharding import apply_param_sharding, gather_param, superglue_param_sharding
from image_matching_tpu_torch.slam import bundle_adjustment as ba
from image_matching_tpu_torch.slam import pose_graph as pg
from image_matching_tpu_torch.structs import Keypoints
from image_matching_tpu_torch.train.state import TrainState
from image_matching_tpu_torch.train.superglue_trainer import SuperGluePairConfig, make_superglue_train_step


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn, world: int, out_dir, *args):
    """Run `fn(rank, world, port, out_dir, *args)` on `world` gloo ranks;
    returns what each rank saved to `out_dir/rank<r>.pt`."""
    mp.spawn(fn, args=(world, free_port(), str(out_dir), *args), nprocs=world, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(world)]


def _join(rank, world, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)


def _save(out_dir, rank, report):
    torch.save(report, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _inputs(out_dir):
    return torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)  # written by the test itself


def keypoints(arrays: dict, index=slice(None)) -> Keypoints:
    """Port Keypoints from numpy (xy, score, mask, desc), sliced along K."""
    return Keypoints(**{k: torch.from_numpy(np.ascontiguousarray(a[:, index])) for k, a in arrays.items()})


def superglue(kw: dict, state: dict) -> SuperGlue:
    sg = SuperGlue(**kw, device="cpu")
    sg.load_state_dict(state)
    return sg.eval()


def _gather_k(x, axis):
    """The whole K axis from every rank's (B, K_local) block."""
    g = all_gather(x, axis)
    return g.transpose(0, 1).reshape(x.shape[0], -1, *x.shape[2:])


# ---------------------------------------------------------------- context parallelism

def context_worker(rank, world, port, out_dir):
    """Ring attention (the JAX cases and packed heads); at 4 ranks also the
    sharded Sinkhorn and context-parallel SuperGlue (full and padded masks)."""
    _join(rank, world, port)
    inp = _inputs(out_dir)
    mesh = pmesh.make_mesh({"context": world}, "cpu")
    axis = mesh.axis("context")
    report = {}
    attn = make_ring_attention(mesh)
    for name, (q, k, v, mask, heads) in inp["ring"].items():
        sl = axis.shard(q.shape[1])
        out = attn(q[:, sl], k[:, sl], v[:, sl], mask[:, sl], heads)
        report[f"ring {name}"] = _gather_k(out, axis)
        report[f"ring {name} unsharded"] = (attention_lse_plain(q, k, v, mask, heads)[0] if heads == 1
                                            else attention_plain(q, k, v, mask, heads))
    if world == 4:
        z, mu, nu, iters = inp["sinkhorn"]  # one coupling, as the JAX package's test has it
        sl = axis.shard(z.shape[0])
        ot = make_sharded_log_optimal_transport(mesh, iters)
        report["sinkhorn"] = all_gather(ot(z[sl], mu[sl], nu), axis).reshape(z.shape)
        zb, mub, nub = inp["sinkhorn batched"]
        report["sinkhorn batched"] = _gather_k(ot(zb[:, sl], mub[:, sl], nub), axis)
        report["sinkhorn batched unsharded"] = log_sinkhorn_scan(zb, mub, nub, iters)
        for name, (kw, state, a0, a1, shape, cp_kw) in inp["superglue"].items():
            sg = superglue(kw, state)
            sl = axis.shard(a0["xy"].shape[1])
            outs = make_context_parallel_superglue(mesh, **cp_kw)(sg, keypoints(a0, sl), keypoints(a1, sl), shape,
                                                                  shape)
            report[f"cp {name}"] = [_gather_k(o, axis) for o in outs]
            with torch.no_grad():
                whole = sg(keypoints(a0), keypoints(a1), shape, shape)
            report[f"cp {name} unsharded"] = [whole[k] for k in ("matches0", "matches1", "matching_scores0",
                                                                 "matching_scores1")]
    _save(out_dir, rank, report)


# ---------------------------------------------------------------- pipeline parallelism

def pipeline_worker(rank, world, port, out_dir):
    _join(rank, world, port)
    kw, state, a0, a1, shape, pp_kw = _inputs(out_dir)
    sg = superglue(kw, state)
    mesh = pmesh.make_mesh({"pipe": world}, "cpu")
    out = make_pipelined_superglue(mesh, **pp_kw)(sg, keypoints(a0), keypoints(a1), shape, shape)
    _save(out_dir, rank, {"stage": mesh.axis("pipe").index, "out": out})


# ---------------------------------------------------------------- tensor parallelism

TP_B, TP_HW = 4, 64
TP_SG = dict(descriptor_dim=32, keypoint_encoder=(8, 16), gnn_layers=2, sinkhorn_iterations=5)


def _dist(a, b) -> float:
    """max |a - b| over the largest |b| (exact for integer tensors: 0 or inf)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if not b.is_floating_point():
        return 0.0 if torch.equal(a, b) else float("inf")
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def _layouts(world):
    """Every axis of a few meshes of `world` ranks, as this rank sees it."""
    shapes = [{"data": 2, "model": 2}, {"context": 4}, {"pipe": 4}, {"data": 1, "model": 2, "pipe": 2}]
    out = {}
    for shape in shapes:
        if np.prod(list(shape.values())) == world:
            m = pmesh.make_mesh(shape, "cpu")
            out[str(shape)] = {a.name: (a.size, a.index, a.ranks, a.group is not None) for a in m.axes}
            out[str(shape)]["data shard"] = (m.size, m.rank)
    return out


def tp_worker(rank, world, port, out_dir, axes):
    """One SuperGlue training step on a data x model mesh against the
    one-process step, in every rank: losses, metrics, running statistics,
    Adam's moments and parameters (the split ones gathered whole), and the
    replicated parameters equal on every rank of the model axis."""
    _join(rank, world, port)
    report = {"layouts": _layouts(world)}
    mesh = pmesh.make_mesh(axes, "cpu")
    images = torch.from_numpy(next(SyntheticShapesDataset(TP_HW, TP_HW, seed=3).batches(TP_B))["image"])
    cfg = SuperGluePairConfig(max_keypoints=64, photometric=SuperGluePairConfig().photometric._replace(enable=True))
    runs = []
    for m in (None, mesh):
        sp = SuperPointBN(32, device="cpu", seed=0)
        sg = SuperGlue(**TP_SG, device="cpu", seed=1)
        specs = superglue_param_sharding(sg, m) if m is not None else None
        if m is not None:
            apply_param_sharding(sg, specs)
        state = TrainState.create(sg, 1e-3)
        with pmesh.use_mesh(m):
            metrics = make_superglue_train_step(sg, sp, cfg)(state, images if m is None else images[mesh.shard(TP_B)],
                                                            torch.Generator().manual_seed(5))
        runs.append((sg, state, metrics, specs))
    (ref, ref_state, ref_m, _), (tp, tp_state, tp_m, specs) = runs
    report["split"] = sorted(k for k, s in specs.items() if s.dim is not None)
    model = mesh.axis("model")
    params = dict(tp.named_parameters())
    whole = {k: gather_param(t, specs[k]) for k, t in tp.state_dict().items()}
    moments = {k: {n: gather_param(tp_state.optimizer.state[p][n], specs[k]) for n in ("mu", "nu")}
               for k, p in params.items()}
    # replicated parameters and statistics: the same bits on every rank of the model axis
    report["replicated differ"] = [k for k, t in tp.state_dict().items() if specs[k].dim is None
                                   and not all(torch.equal(g, t) for g in all_gather(t, model))]
    sd = ref.state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    report["running statistics"] = max(_dist(whole[k], sd[k]) for k in stats)
    ref_params = dict(ref.named_parameters())
    for n in ("mu", "nu"):  # against the largest moment of the model
        scale = max(float(ref_state.optimizer.state[p][n].abs().max()) for p in ref_params.values())
        report[f"Adam {n}"] = max(float((moments[k][n] - ref_state.optimizer.state[p][n]).abs().max()) / scale
                                  for k, p in ref_params.items())
    gscale = max(float(p.grad.abs().max()) for p in ref_params.values())
    lr = ref_state.optimizer.param_groups[0]["lr"]
    moved = noise = 0.0
    for k, p in ref_params.items():
        d = (whole[k] - p.detach()).abs()
        big = p.grad.abs() > 1e-3 * gscale
        moved = max(moved, float(torch.where(big, d, 0.0).max()) / lr)
        noise = max(noise, float(torch.where(big, 0.0, d).max()) / lr)
    report["parameters where the gradient is above 1e-3 of the largest, in lr"] = moved
    report["parameters elsewhere, in lr"] = noise
    report["metric keys"] = (sorted(tp_m), sorted(ref_m))
    report["metrics"] = {k: _dist(tp_m[k], ref_m[k]) for k in ref_m}  # counts exactly: 0 or inf
    report["steps"] = (ref_state.step, tp_state.step)
    _save(out_dir, rank, report)


# ---------------------------------------------------------------- the sharded solvers

def solver_worker(rank, world, port, out_dir):
    _join(rank, world, port)
    inp = _inputs(out_dir)
    mesh = pmesh.make_mesh({"data": world}, "cpu")
    axis = mesh.axis("data")
    g = inp["pose graph"]
    sl = axis.shard(g["src"].shape[0])
    solve = pg.make_sharded_pose_graph_solver(mesh, g["num_frames"], iters=g["iters"])
    z0 = torch.tensor([1.0, 0.0, 0.0, 0.0]).repeat(g["num_frames"], 1)
    report = {"pose graph": solve(g["src"][sl], g["dst"][sl], g["rel"][sl], g["weight"][sl], z0),
              "pose graph unsharded": pg.optimize_pose_graph(
                  pg.PoseGraph(g["src"], g["dst"], g["rel"], g["weight"], g["num_frames"]), iters=g["iters"])}
    p = inp["bundle adjustment"]
    sl = axis.shard(p["frame"].shape[0])
    solve = ba.make_sharded_bundle_adjuster(mesh, p["num_frames"], p["num_landmarks"], iters=p["iters"])
    z0 = torch.tensor([1.0, 0.0, 0.0, 0.0]).repeat(p["num_frames"], 1)
    report["bundle adjustment"] = solve(p["frame"][sl], p["landmark"][sl], p["uv"][sl], p["weight"][sl], z0)
    report["bundle adjustment unsharded"] = ba.bundle_adjust(
        ba.BAProblem(p["frame"], p["landmark"], p["uv"], p["weight"], p["num_frames"], p["num_landmarks"]),
        iters=p["iters"])
    _save(out_dir, rank, report)
