"""Pipeline-parallel SuperGlue: the GNN's layers staged over a `pipe` mesh
axis — the counterpart of `image_matching_tpu/parallel/pipeline.py`.

The GNN (the bulk of SuperGlue's work) is cut into S contiguous stages of
L/S layers, one a rank, and microbatches of image pairs stream through
them in a GPipe schedule: stage s runs microbatch i through its layers,
then sends the activations to stage s + 1 and goes on to microbatch i + 1,
so stage s works on microbatch t - s at tick t. The JAX package runs that
schedule as one `lax.scan` over M + S - 1 ticks in which a stage also
computes, and throws away, its idle ticks; here a stage simply waits for
its next input. The keypoint encoder (before the GNN, on stage 0) and the
Sinkhorn and extraction (after it, on every rank) are the port's own
`SuperGlue.encode` and `SuperGlue.assign`: the last stage broadcasts the
GNN's outputs, and every rank returns the whole result, as the JAX
package's replicated outputs. On the card the layers' attention runs
`csrc/attention.cu` and the Sinkhorn `csrc/sinkhorn.cu`.

Evaluation only (running statistics), in f32 as in the JAX package.
`stack_gnn_params` stacks the layers' parameters on a leading layer axis,
the JAX package's weight layout for its scan over layers; each rank here
runs its stage's layers from the module itself.
"""
from __future__ import annotations

import torch

from image_matching_tpu_torch.parallel.collectives import broadcast, recv, send
from image_matching_tpu_torch.parallel.mesh import Mesh
from image_matching_tpu_torch.structs import Keypoints


def stack_gnn_params(module, gnn_layers: int):
    """(params, stats, is_cross): every GNN layer parameter of `module` (a
    port `SuperGlue`) stacked on a leading layer axis, keyed by its path
    within a layer (`attn.proj_q.weight`, ...), the running statistics
    likewise, and an (L,) bool vector, True for the cross layers."""
    names = [f"layer_{i}_{'self' if i % 2 == 0 else 'cross'}" for i in range(gnn_layers)]
    layers = [getattr(module.gnn, n) for n in names]
    params = {k: torch.stack([layer.get_parameter(k) for layer in layers]) for k, _ in layers[0].named_parameters()}
    stats = {k: torch.stack([layer.get_buffer(k) for layer in layers]) for k, _ in layers[0].named_buffers()}
    is_cross = torch.tensor([i % 2 == 1 for i in range(gnn_layers)])
    return params, stats, is_cross


def make_pipelined_superglue(mesh: Mesh, gnn_layers: int = 18, sinkhorn_iterations: int = 30,
                             match_threshold: float = 0.2, num_microbatches: int = 4, axis_name: str = "pipe"):
    """`f(module, kpts0, kpts1, shape0, shape1) -> dict` running the GNN of
    a port `SuperGlue` pipeline-parallel over `axis_name`, on keypoint sets
    that every rank of the axis holds whole. Needs gnn_layers % stages == 0
    and batch % num_microbatches == 0. Evaluation mode; every rank returns
    the outputs of `SuperGlue.forward`."""
    axis = mesh.axis(axis_name)
    n_stages = axis.size
    if gnn_layers % n_stages:
        raise ValueError(f"gnn_layers={gnn_layers} not divisible by pipe={n_stages}")
    per_stage = gnn_layers // n_stages

    @torch.no_grad()
    def run(module, kpts0: Keypoints, kpts1: Keypoints, shape0, shape1) -> dict:
        if len(module.gnn.names) != gnn_layers:
            raise ValueError(f"gnn_layers={gnn_layers}, the model has {len(module.gnn.names)}")
        b, n, d = kpts0.desc.shape
        if b % num_microbatches:
            raise ValueError(f"batch={b} not divisible by microbatches={num_microbatches}")
        mb = b // num_microbatches
        dt = torch.float32
        s = axis.index
        names = module.gnn.names[s * per_stage:(s + 1) * per_stage]
        mask0, mask1 = kpts0.mask, kpts1.mask
        if s == 0:
            desc = torch.stack([module.encode(kpts0, shape0, dt), module.encode(kpts1, shape1, dt)])
        out = torch.empty((2, b, n, d), dtype=dt, device=kpts0.desc.device)
        pending = []
        for i in range(num_microbatches):
            rows = slice(i * mb, (i + 1) * mb)
            x = desc[:, rows] if s == 0 else recv(out[:, rows], axis, s - 1)
            y0, y1 = module.gnn(x[0], x[1], mask0[rows], mask1[rows], dt, "float32", names=names)
            if s < n_stages - 1:
                pending.append(send(torch.stack([y0, y1]), axis, s + 1))
            else:
                out[0, rows], out[1, rows] = y0, y1
        for work, _ in pending:
            work.wait()
        out = broadcast(out, axis, n_stages - 1)
        return module.assign(out[0], out[1], mask0, mask1, dt, sinkhorn_iterations, match_threshold)

    return run


__all__ = ["stack_gnn_params", "make_pipelined_superglue"]
