"""Ring attention: attention with the keypoint axis sharded over a mesh
axis — the counterpart of `image_matching_tpu/parallel/ring_attention.py`.

Each rank holds N/P queries and N/P keys and values. The key/value blocks
travel round the ring (rank i sends to i + 1), and each rank attends its
queries to every block in turn. Where the JAX package folds each block
into an online softmax of its scores, each ring step here is one call of
the port's own forward with LSE (`ops.attention.attention_lse`: the
`csrc/attention.cu` kernel on the card, its plain version on the CPU), and
the (output, LSE) pairs of the blocks are merged by their log-sum-exp, the
same online softmax one level up. Exact, not approximate.

A batch element with no valid key in a block gets from the kernel the mean
of that block's values and an LSE of log(N_local); in a ring that block
must weigh nothing where the element has valid keys elsewhere, so its LSE
becomes NEG_INF, the JAX package's masked logit (-1e9 + log(N_local)
rounds to -1e9 in f32). An element with no valid key anywhere then weighs
every block alike and gets the mean of all N values, as JAX's ring gives.
"""
from __future__ import annotations

import torch

from image_matching_tpu_torch.ops.attention import attention_lse
from image_matching_tpu_torch.parallel.collectives import ring_pass
from image_matching_tpu_torch.parallel.mesh import Mesh

NEG_INF = -1e9


def ring_attention_local(q, k, v, key_mask, axis, num_heads: int = 1):
    """This rank's attention output (B, N_local, H*dh) for its queries over
    the keys of every rank of `axis` (a `parallel/mesh.Axis`). q, k, v:
    this rank's (B, N_local, H*dh) packed heads; key_mask (B, N_local)
    bool. The scale is 1/sqrt(dh), as in the JAX package's callers."""
    b, n, dt = q.shape
    dh = dt // num_heads
    kv = torch.cat([k, v], -1)  # one buffer on the ring, each half a view the kernel reads by row stride
    mask = key_mask.contiguous()  # as the kernel takes it (a shard may be a view of the whole mask)
    m = l = acc = None
    for step in range(axis.size):
        if step:
            kv, mask = ring_pass([kv, mask], axis)
        out, lse = attention_lse(q, kv[..., :dt], kv[..., dt:], mask, num_heads)
        lse = torch.where(mask.any(-1)[:, None, None], lse, NEG_INF)
        lse = lse.transpose(1, 2)[..., None]  # (B, N, H, 1) beside the (B, N, H, dh) heads
        o = out.float().reshape(b, n, num_heads, dh)
        if m is None:
            m, l, acc = lse, torch.ones_like(lse), o
        else:
            m_new = torch.maximum(m, lse)
            a, c = torch.exp(m - m_new), torch.exp(lse - m_new)
            m, l, acc = m_new, l * a + c, acc * a + o * c
    return (acc / l).reshape(b, n, dt).to(q.dtype)


def make_ring_attention(mesh: Mesh, axis_name: str = "context"):
    """`attn(q, k, v, key_mask, num_heads=1)` on this rank's shards of the
    keypoint axis, sharded over `axis_name`; returns this rank's shard of
    the output."""
    axis = mesh.axis(axis_name)

    def attn(q, k, v, key_mask, num_heads: int = 1):
        return ring_attention_local(q, k, v, key_mask, axis, num_heads)

    return attn


__all__ = ["NEG_INF", "ring_attention_local", "make_ring_attention"]
