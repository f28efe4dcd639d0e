"""Log-domain Sinkhorn with the coupling's rows sharded over a mesh axis —
the counterpart of `image_matching_tpu/parallel/sharded_sinkhorn.py`.

Each rank holds M/P rows of the (M, N) coupling (its queries, as they come
out of ring attention). The row (u) update is local; the column (v)
update's logsumexp over the rows is an all_reduce MAX of the rows' maxima,
then an all_reduce SUM of the shifted sums: two collectives an iteration,
each over the whole batch at once (the JAX package maps the body over the
batch). The JAX package has no kernel here (its loop is `lax.scan`), and
the fused Sinkhorn kernel of `csrc/sinkhorn.cu` holds whole columns, so
this loop is plain PyTorch.
"""
from __future__ import annotations

import torch

from image_matching_tpu_torch.parallel.collectives import all_reduce
from image_matching_tpu_torch.parallel.mesh import Mesh


def _lse_rows_sharded(t, axis):
    """logsumexp over the sharded row axis of t (B, M_local, N) -> (B, N)."""
    mx = all_reduce(t.amax(dim=1), axis, "max")
    s = all_reduce(torch.exp(t - mx[:, None, :]).sum(dim=1), axis, "sum")
    return mx + torch.log(s.clamp_min(1e-38))


def sharded_log_sinkhorn_local(z_local, log_mu_local, log_nu, iters: int, axis):
    """This rank's rows of Z + u + v after `iters` iterations from zeros:
    z_local (B, M_local, N) or (M_local, N), log_mu_local (B, M_local) or
    (M_local,), log_nu (B, N) or (N,) replicated; f32."""
    batched = z_local.dim() == 3
    if not batched:
        z_local, log_mu_local, log_nu = z_local[None], log_mu_local[None], log_nu[None]
    z = z_local.float()
    u = torch.zeros_like(log_mu_local, dtype=torch.float32)
    v = torch.zeros_like(log_nu, dtype=torch.float32)
    for _ in range(iters):
        u = log_mu_local - torch.logsumexp(z + v[:, None, :], dim=2)
        v = log_nu - _lse_rows_sharded(z + u[:, :, None], axis)
    out = z + u[:, :, None] + v[:, None, :]
    return out if batched else out[0]


def make_sharded_log_optimal_transport(mesh: Mesh, iters: int, axis_name: str = "context"):
    """`ot(z_local, log_mu_local, log_nu) -> z_local` on this rank's rows
    of the coupling, sharded over `axis_name`. As in the JAX package, the
    dustbins and the m + n normalisation are the caller's
    (`ops/sinkhorn.log_optimal_transport`'s recipe): this is the inner
    loop, where the sharding matters."""
    axis = mesh.axis(axis_name)

    def ot(z_local, log_mu_local, log_nu):
        return sharded_log_sinkhorn_local(z_local, log_mu_local, log_nu, iters, axis)

    return ot


__all__ = ["sharded_log_sinkhorn_local", "make_sharded_log_optimal_transport"]
