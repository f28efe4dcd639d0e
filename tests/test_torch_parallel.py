"""The port's data parallelism (`parallel/{distributed,mesh}.py`, the
data-parallel training steps and CLIs) on the CPU: two gloo ranks, each on
its half of a batch of 4, against one process on the whole batch. Each
test is one `torch.multiprocessing.spawn` of the two ranks; the ranks
write what they measured, and the test reads it.

Tolerances. The sharded step sums in another order (two half-batch sums,
then the all_reduce), so it rounds apart from the whole-batch step:
  * batch-norm outputs, input gradients and running statistics, the loss
    normalisers, every metric of a step (SuperGlue's, SuperPoint's train
    and evaluation steps, the detector's precision), and the running
    statistics after a step: within 1e-5 of the largest entry of each
    tensor (measured at most 3.7e-7), counts exactly;
  * Adam's moments after a step (the summed gradients): within 1e-5 of
    the model's largest moment (measured 5.1e-6, SuperPoint's first
    convolutions' weight gradients, sums of 16k terms with the batch
    norm's cancellation);
  * the parameters after a step: within 1e-2 lr (1e-5 absolute) where the
    gradient stands above 1e-3 of the largest (measured 1.2e-4 lr), and
    within 2 lr elsewhere: Adam's first step is about the gradient's sign,
    and gradients whose exact value is 0 (a bias ahead of a batch norm,
    the attention's key, value and merge biases: a constant that the
    softmax or a batch norm removes) are rounding noise of either sign in
    both runs (measured 1.95 lr).
`train_superpoint --native_loader` over two ranks decodes on one loader
thread, so both ranks draw the same global batches, the one-process run's
at one thread, and log its losses within 1e-5 relative.
The training CLI over two ranks (f32 compute on both sides) gives the
one-process CLI's records, losses and match metrics within 1e-5 relative
(measured 1.2e-7) and counts exactly, and its parameters after two steps
within 2 lr a step (measured 3.59 lr over the two), 0.95 of the entries
within 1e-2 lr (measured 0.978).
"""
import os
import socket
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import cv2

from image_matching_tpu_torch.cli import train_superglue as sg_cli
from image_matching_tpu_torch.cli import train_superpoint as sp_cli
from image_matching_tpu_torch.data.datasets import ALLSSDataset, SyntheticShapesDataset
from image_matching_tpu_torch.data.pipeline import make_warped_pair_batch
from image_matching_tpu_torch.data.synthetic_device import synthetic_batch
from image_matching_tpu_torch.losses import descriptor, detector, superglue_loss
from image_matching_tpu_torch.models import SuperGlue, SuperPointBN
from image_matching_tpu_torch.models.common import BatchNorm, MaskedBatchNorm1d
from image_matching_tpu_torch.parallel import distributed, mesh as pmesh
from image_matching_tpu_torch.train import metrics as tmetrics
from image_matching_tpu_torch.train import superpoint_trainer
from image_matching_tpu_torch.train.state import TrainState
from image_matching_tpu_torch.train.superglue_trainer import SuperGluePairConfig, make_superglue_train_step

from test_torch_features import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)

WORLD, B, HW = 2, 4, 64
TOL = 1e-5
SG_KW = dict(descriptor_dim=32, keypoint_encoder=(8, 16), gnn_layers=2, sinkhorn_iterations=5)
LOSS_KW = dict(num_matching_attempts=100, num_masked_non_matches_per_match=10)
CLI_ARGS = ["--device", "cpu", "--synthetic", "--epochs", "1", "--steps_per_epoch", "2", "--batch_size", str(B),
            "--height", str(HW), "--width", str(HW), "--descriptor_dim", "32", "--keypoint_encoder", "16", "32",
            "--gnn_layers", "2", "--sinkhorn_iterations", "5", "--max_keypoints", "64", "--log_interval", "1"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(fn, out_dir):
    mp.spawn(fn, args=(WORLD, _free_port(), str(out_dir)), nprocs=WORLD, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(WORLD)]


def _join(rank, world, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)


def _dist(a, b) -> float:
    """max |a - b| over the largest |b| (exact for integer tensors: 0 or inf)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if not b.is_floating_point():
        return 0.0 if torch.equal(a, b) else float("inf")
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------- in each rank

def _direct_sums(mesh, report):
    """Normalisers, batch-norm statistics and their gradients: each rank's
    shard under the mesh against the whole batch without one."""
    rng = np.random.default_rng(0)
    sl = mesh.shard(B)

    def bn_case(name, make, x, mask=None):
        w = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
        outs = []
        for s, m in ((slice(None), None), (sl, mesh)):
            bn, xs = make(), x[s].clone().requires_grad_(True)
            with pmesh.use_mesh(m):
                y = bn(xs, train=True) if mask is None else bn(xs, mask[s], train=True)
                (y * w[s]).sum().backward()
            outs.append((y.detach(), xs.grad, bn.running_mean, bn.running_var))
        (y, g, rm, rv), (y2, g2, rm2, rv2) = outs
        report[f"{name} output"] = _dist(y2, y[sl])
        report[f"{name} input gradient"] = _dist(g2, g[sl])
        report[f"{name} running mean"] = _dist(rm2, rm)
        report[f"{name} running var"] = _dist(rv2, rv)

    bn_case("conv batch norm", lambda: BatchNorm(5, dim=1),
            torch.from_numpy(rng.normal(3, 2, (B, 5, 6, 7)).astype(np.float32)))
    bn_case("masked batch norm", lambda: MaskedBatchNorm1d(5),
            torch.from_numpy(rng.normal(1, 2, (B, 9, 5)).astype(np.float32)),
            torch.from_numpy(rng.uniform(size=(B, 9)) < 0.6))

    lc = torch.from_numpy(np.log(rng.dirichlet(np.ones(7), (B, 6)).astype(np.float32)))
    gt0 = torch.from_numpy(rng.integers(0, 7, (B, 5)).astype(np.int32))
    gt1 = torch.from_numpy(rng.integers(0, 6, (B, 6)).astype(np.int32))
    m0, m1 = (torch.from_numpy(rng.uniform(size=s) < 0.7) for s in ((B, 5), (B, 6)))
    semi = torch.from_numpy(rng.normal(0, 2, (B, 4, 6, 65)).astype(np.float32))
    labels = torch.from_numpy((rng.uniform(size=(B, 32, 48, 1)) < 0.03).astype(np.float32))
    valid = torch.from_numpy((rng.uniform(size=(B, 32, 48, 1)) < 0.9).astype(np.float32))
    d0, d1 = (torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(B, 8, 8, 16)).astype(np.float32)),
                                            dim=-1) for _ in range(2))
    hs = torch.eye(3).repeat(B, 1, 1) + torch.from_numpy(rng.normal(0, 0.01, (B, 3, 3)).astype(np.float32))
    draws = descriptor.draw_descriptor_loss(torch.Generator().manual_seed(1), B, 8, 8, 40, 12)
    losses = {
        "superglue NLL": lambda s, d: superglue_loss.superglue_nll_loss(lc[s], gt0[s], gt1[s], m0[s], m1[s]),
        "detector loss": lambda s, d: detector.detector_loss(semi[s], labels[s], valid[s]),
        "descriptor loss": lambda s, d: torch.stack(descriptor.sparse_descriptor_loss(d, d0[s], d1[s], hs[s])),
    }
    for name, fn in losses.items():
        whole = fn(slice(None), draws)
        with pmesh.use_mesh(mesh):
            report[name] = _dist(pmesh.all_sum(fn(sl, pmesh.shard_batch(mesh, draws))), whole)


def _superglue_step(mesh, images, report):
    """A SuperGlue step (pairs made from homographies and photometric draws
    for the whole batch, then sliced)."""
    cfg = SuperGluePairConfig(max_keypoints=64, photometric=SuperGluePairConfig().photometric._replace(enable=True))
    runs = []
    for m in (None, mesh):
        sp = SuperPointBN(32, device="cpu", seed=0)
        sg = SuperGlue(**SG_KW, device="cpu", seed=1)
        state = TrainState.create(sg, 1e-3)
        with pmesh.use_mesh(m):
            metrics = make_superglue_train_step(sg, sp, cfg)(state, images if m is None else images[mesh.shard(B)],
                                                            torch.Generator().manual_seed(5))
        runs.append((sg, state, [metrics]))
    _compare_states("superglue", runs, report)


def _superpoint_step(mesh, report):
    """The evaluation step and the detector's precision on the synthetic
    pipeline's batch (built whole, then sliced), then a SuperPoint step."""
    cfg = superpoint_trainer.SuperPointLossConfig(**LOSS_KW)
    runs = []
    for m in (None, mesh):
        model = SuperPointBN(32, device="cpu", seed=2)
        state = TrainState.create(model, 1e-3)
        gen = torch.Generator().manual_seed(7)
        src = synthetic_batch(gen, B, HW, HW)
        batch = make_warped_pair_batch(gen, src["image"], src["points"], src["points_mask"])
        if m is not None:
            batch = pmesh.shard_batch(mesh, batch)
        with pmesh.use_mesh(m):
            with torch.no_grad():
                metrics = [superpoint_trainer.make_superpoint_eval_step(model, cfg)(state, batch, gen),
                           tmetrics.detector_precision_recall(model(batch["image"])["semi"], batch["labels_2d"])]
            metrics.append(superpoint_trainer.make_superpoint_train_step(model, cfg)(state, batch, gen))
        runs.append((model, state, metrics))
    _compare_states("superpoint", runs, report)


def _compare_states(label, runs, report):
    """The state after the step: parameters, Adam's moments and the running
    statistics, and every metric."""
    (ref, ref_state, ref_m), (dp, dp_state, dp_m) = runs
    sd, sd2 = ref.state_dict(), dp.state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    report[f"{label} running statistics"] = max(_dist(sd2[k], sd[k]) for k in stats)
    pairs = list(zip(ref.parameters(), dp.parameters()))
    for k in ("mu", "nu"):  # against the largest moment of the model
        scale = max(float(ref_state.optimizer.state[p][k].abs().max()) for p, _ in pairs)
        report[f"{label} Adam {k}"] = max(
            float((dp_state.optimizer.state[p2][k] - ref_state.optimizer.state[p][k]).abs().max()) / scale
            for p, p2 in pairs)
    gscale = max(float(p.grad.abs().max()) for p, _ in pairs)
    lr = ref_state.optimizer.param_groups[0]["lr"]
    moved, noise = 0.0, 0.0
    for p, p2 in pairs:
        d = (p2.detach() - p.detach()).abs()
        big = p.grad.abs() > 1e-3 * gscale
        moved = max(moved, float(torch.where(big, d, 0.0).max()) / lr)
        noise = max(noise, float(torch.where(big, 0.0, d).max()) / lr)
    report[f"{label} parameters where the gradient is above 1e-3 of the largest, in lr"] = moved
    report[f"{label} parameters elsewhere, in lr"] = noise
    for want, got in zip(ref_m, dp_m):
        assert set(want) == set(got), (set(want), set(got))
        for k in want:
            d = _dist(got[k], want[k])
            report[f"{label} metrics"] = max(report.get(f"{label} metrics", 0.0), d)
            if not torch.as_tensor(want[k]).is_floating_point():
                report[f"{label} count {k}"] = max(report.get(f"{label} count {k}", 0.0), d)
    report[f"{label} steps"] = (ref_state.step, dp_state.step)


def _steps_worker(rank, world, port, out_dir):
    _join(rank, world, port)
    mesh = pmesh.make_data_mesh(B, "cpu")
    report = {"mesh": (mesh.size, mesh.rank)}
    _direct_sums(mesh, report)
    _superglue_step(mesh, torch.from_numpy(next(SyntheticShapesDataset(HW, HW, seed=3).batches(B))["image"]), report)
    _superpoint_step(mesh, report)
    torch.save(report, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _f32_cli(run_dir):
    """The training CLI with f32 compute (its models are bf16 by default)."""
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(sg_cli, "SuperGlue", lambda **kw: SuperGlue(**{**kw, "compute_dtype": "float32"}))
        mpatch.setattr(sg_cli, "SuperPointBN", lambda d, **kw: SuperPointBN(d, **{**kw, "compute_dtype": "float32"}))
        return sg_cli.main([*CLI_ARGS, "--run_dir", run_dir])


def _cli_worker(rank, world, port, out_dir):
    _join(rank, world, port)
    info = distributed.initialize_multihost("cpu")
    out = _f32_cli(os.path.join(out_dir, "run"))
    torch.save({"info": info, "primary": distributed.is_primary(), "logged": out["logged"],
                "history": [h["mean_loss"] for h in out["history"]], "step": out["state"].step,
                "params": out["state"].module.state_dict()}, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _native_sp_cli(root, run_dir, seen, threads=None):
    """`train_superpoint --native_loader` (f32 compute) for 2 steps on the JPEG files under
    `root`, the training split's (loader threads, names) of each batch
    appended to `seen`; `threads` overrides the CLI's thread count."""
    batches = ALLSSDataset.batches

    def recorded(self, *args, **kw):
        if kw.get("native") and threads is not None:
            kw["n_threads"] = threads
        for b in batches(self, *args, **kw):
            if kw.get("native"):
                seen.append((kw["n_threads"], b["names"]))
            yield b

    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(ALLSSDataset, "batches", recorded)
        mpatch.setattr(sp_cli, "SuperPointBN", lambda d, **kw: SuperPointBN(d, **{**kw, "compute_dtype": "float32"}))
        out = sp_cli.main(["--device", "cpu", "--batch_size", str(B), "--height", str(HW), "--width", str(HW),
                           "--descriptor_dim", "32", "--data_root", str(root / "data"), "--labels",
                           str(root / "labels"), "--native_loader", "--train_iter", "2", "--tensorboard_interval",
                           "1", "--validation_interval", "100", "--save_interval", "100", "--run_dir", run_dir])
    return [r["loss"] for r in out["logged"]]


def _native_worker(rank, world, port, out_dir):
    _join(rank, world, port)
    distributed.initialize_multihost("cpu")
    seen = []
    losses = _native_sp_cli(Path(out_dir), os.path.join(out_dir, f"run{rank}"), seen)
    torch.save({"seen": seen, "losses": losses}, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------- the tests

def test_two_gloo_ranks_give_the_single_process_steps(tmp_path):
    reports = _spawn(_steps_worker, tmp_path)
    assert [r["mesh"] for r in reports] == [(2, 0), (2, 1)]
    for r in reports:
        assert r["superglue steps"] == (1, 1) and r["superpoint steps"] == (1, 1)
        counts = {k: v for k, v in r.items() if " count " in k}
        assert counts and all(v == 0 for v in counts.values()), counts
        dists = {k: v for k, v in r.items() if isinstance(v, float)}
        assert len(dists) >= 20, sorted(dists)
        bound = {k: (0.01 if "above" in k else 2.0) if k.endswith("in lr") else TOL for k in dists}
        assert all(v <= bound[k] for k, v in dists.items()), {k: v for k, v in dists.items() if v > bound[k]}


def test_train_superglue_cli_over_two_gloo_ranks_equals_one_process(tmp_path):
    ranks = _spawn(_cli_worker, tmp_path)
    assert [r["info"]["process_count"] for r in ranks] == [2, 2] and [r["primary"] for r in ranks] == [True, False]
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints")) == ["2.npz"]  # rank 0 alone writes
    one = _f32_cli(str(tmp_path / "one"))
    for r in ranks:
        assert r["step"] == one["state"].step == 2
        assert [x["step"] for x in r["logged"]] == [x["step"] for x in one["logged"]] == [1, 2]
        for got, want in zip(r["logged"], one["logged"]):
            assert got["gt_matches"] == want["gt_matches"] and got["pred_matches"] == want["pred_matches"]
            for k in ("loss", "match_precision", "match_recall"):
                assert abs(got[k] - want[k]) <= TOL * max(abs(want[k]), 1e-30), (k, got[k], want[k])
        np.testing.assert_allclose(r["history"], [h["mean_loss"] for h in one["history"]], rtol=TOL)
        sd = one["state"].module.state_dict()
        lr = one["state"].learning_rate
        worst = max(float((r["params"][k] - sd[k]).abs().max()) for k in sd) / lr
        agree = sum(int(((r["params"][k] - sd[k]).abs() <= 1e-2 * lr).sum()) for k in sd) / sum(
            t.numel() for t in sd.values())
        assert worst <= 2 * 2 and agree >= 0.95, (worst, agree)  # at most 2 lr a step; most entries agree


def test_native_loader_over_two_gloo_ranks_draws_one_global_batch(tmp_path):
    rng = np.random.default_rng(0)
    for task in ("train", "val"):
        (tmp_path / "data" / task).mkdir(parents=True)
        (tmp_path / "labels" / task).mkdir(parents=True)
        for i in range(7):
            img = cv2.GaussianBlur(rng.uniform(0, 255, (HW, HW)).astype(np.float32), (0, 0), 2).astype(np.uint8)
            cv2.imwrite(str(tmp_path / "data" / task / f"im_{i}.jpg"), img)
            pts = rng.uniform(0, HW, (6, 2)).astype(np.float32)
            np.savez(tmp_path / "labels" / task / f"im_{i}.npz", pts=pts)
    ranks = _spawn(_native_worker, tmp_path)
    one_seen = []
    one = _native_sp_cli(tmp_path, str(tmp_path / "one"), one_seen, threads=1)
    assert len(one_seen) >= 2 and all(t == 1 for t, _ in one_seen)
    for r in ranks:  # every rank's global batches: one thread's order, the one process's
        assert r["seen"] == one_seen[:len(r["seen"])] and len(r["seen"]) >= 2
        np.testing.assert_allclose(r["losses"], one, rtol=TOL)


def test_without_torchrun_the_runtime_is_one_process(monkeypatch):
    for var in distributed.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    info = distributed.initialize_multihost("cpu")
    assert info["process_count"] == 1 and info["process_index"] == 0 and distributed.is_primary()
    mesh = pmesh.make_data_mesh(6, "cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None) and pmesh.current_mesh() is None
    batch = {"image": np.zeros((6, 2, 2, 1), np.float32), "names": list("abcdef")}
    shard = pmesh.shard_batch(mesh, batch)
    assert shard["image"].shape == (6, 2, 2, 1) and shard["names"] == list("abcdef")
    x = torch.ones(3, requires_grad=True)
    with pmesh.use_mesh(mesh):  # no process group: nothing to sum over
        assert pmesh.all_sum(x) is x and pmesh.global_count(5) == 5
    two = pmesh.make_mesh({"data": 1, "model": 1}, "cpu")  # two axes of one process: no group to reduce over
    assert two.shape == {"data": 1, "model": 1} and (two.size, two.rank, two.group, two.axis("model").group) == (
        1, 0, None, None)
    with pytest.raises(ValueError, match="need 2 processes"):
        pmesh.make_mesh({"data": 1, "model": 2}, "cpu")
    with pytest.raises(ValueError, match="does not split"):
        pmesh.Mesh(2, 0, torch.device("cpu")).shard(5)
