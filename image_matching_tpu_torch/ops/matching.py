"""Descriptor matching as batched dense similarity products — the
counterpart of `image_matching_tpu/ops/matching.py`: 2-NN + Lowe ratio
(+ mutual check), the ratio gate over an existing match set, two-way
nearest neighbours with a distance cutoff, and brute-force Hamming with
cross-check.

All matchers take fixed-K masked sets and return `MatchResult` with -1
for "no match" (SuperGlue's output contract). Similarities are f32
products (on the card, full f32: TF32 stays off for matmuls).

Where several rows of set 0 claim the same column (possible only
without the mutual check), which of them `matches1` names is not
defined, as in the JAX package's scatter.
"""
from __future__ import annotations

import math

import torch

from image_matching_tpu_torch.structs import MatchResult

NEG_INF = -1e9


def _sim(d0, d1):
    return torch.einsum("...nd,...md->...nm", d0.float(), d1.float())


def pairwise_sqdist(d0, d1):
    """Squared L2 distances (..., N0, N1) via one matmul, in f32."""
    n0 = (d0.float() ** 2).sum(-1)[..., :, None]
    n1 = (d1.float() ** 2).sum(-1)[..., None, :]
    return (n0 + n1 - 2.0 * _sim(d0, d1)).clamp_min(0.0)


def _masked_sim(d0, d1, mask0, mask1):
    valid = mask0[..., :, None] & mask1[..., None, :]
    return torch.where(valid, _sim(d0, d1), NEG_INF)


def _dist_from_sim(s):
    """Squared distance of unit descriptors with similarity s."""
    return (2.0 - 2.0 * s).clamp_min(0.0)


def _result(valid0, best1, scores_for0, n1: int) -> MatchResult:
    """Assemble a MatchResult from the accepted rows: matches0 is best1
    where valid0, and matches1 / scores1 are its inverse by scatter."""
    matches0 = torch.where(valid0, best1, -1).to(torch.int32)
    matches1, scores1 = _invert_matches(matches0, scores_for0, n1)
    return MatchResult(matches0=matches0, matches1=matches1,
                       scores0=torch.where(valid0, scores_for0, 0.0), scores1=scores1)


def match_ratio_mutual(d0, d1, mask0, mask1, ratio: float = 0.7, cross_check: bool = True) -> MatchResult:
    """2-NN + Lowe ratio test (+ optional mutual check) for unit
    descriptors: dist^2 = 2 - 2 sim, so the top-2 by similarity are the
    top-2 by distance and `d1 < ratio * d2` becomes
    `(2 - 2 s1) < ratio^2 (2 - 2 s2)`."""
    sim = _masked_sim(d0, d1, mask0, mask1)
    top2, idx2 = torch.topk(sim, 2, dim=-1)
    best1 = idx2[..., 0]
    s1, s2 = top2[..., 0], top2[..., 1]
    valid0 = (_dist_from_sim(s1) < (ratio * ratio) * _dist_from_sim(s2)) & mask0 & (s1 > NEG_INF / 2)
    if cross_check:
        valid0 = valid0 & _is_mutual(sim.argmax(dim=-2), best1)
    return _result(valid0, best1, s1, d1.shape[-2])


def ratio_gate_matches(matches: MatchResult, d0, d1, mask0, mask1, gate: float = 0.9) -> MatchResult:
    """Descriptor-consistency gate over an existing match set: keep match
    (i, j) only if dist(i, j) < gate^2 * min over m != j of dist(i, m).
    Strict <, so an exact-duplicate alternative (both distances 0) fails."""
    sim = _masked_sim(d0, d1, mask0, mask1)
    n1 = sim.shape[-1]
    j = matches.matches0.clamp_min(0).long()
    sim_j = torch.gather(sim, -1, j[..., None])[..., 0]
    is_j = torch.arange(n1, device=sim.device) == j[..., None]
    alt = torch.where(is_j, NEG_INF, sim).amax(dim=-1)
    ok = (matches.matches0 >= 0) & (_dist_from_sim(sim_j) < (gate * gate) * _dist_from_sim(alt))
    matches0 = torch.where(ok, matches.matches0, -1).to(torch.int32)
    scores0 = torch.where(ok, matches.scores0, 0.0)
    matches1, scores1 = _invert_matches(matches0, scores0, n1)
    return MatchResult(matches0=matches0, matches1=matches1, scores0=scores0, scores1=scores1)


def match_mutual_nn(d0, d1, mask0, mask1, max_dist: float = math.inf) -> MatchResult:
    """Two-way nearest-neighbour matching with an L2 distance cutoff."""
    sim = _masked_sim(d0, d1, mask0, mask1)
    s1, best1 = sim.max(dim=-1)
    dist = torch.sqrt(_dist_from_sim(s1))
    valid0 = _is_mutual(sim.argmax(dim=-2), best1) & mask0 & (s1 > NEG_INF / 2) & (dist < max_dist)
    return _result(valid0, best1, s1, d1.shape[-2])


def match_hamming(bits0, bits1, mask0, mask1) -> MatchResult:
    """Brute-force Hamming matching with cross-check for binary descriptors
    (..., N, nbytes) uint8: bits unpacked to +-1, hamming = (nbits - dot) / 2."""
    pm0, pm1 = _unpack_pm1(bits0), _unpack_pm1(bits1)
    ham = (pm0.shape[-1] - _sim(pm0, pm1)) * 0.5
    valid = mask0[..., :, None] & mask1[..., None, :]
    ham = torch.where(valid, ham, math.inf)
    h1, best1 = ham.min(dim=-1)
    valid0 = _is_mutual(ham.argmin(dim=-2), best1) & mask0 & torch.isfinite(h1)
    return _result(valid0, best1, -h1, bits1.shape[-2])  # higher score = better


def _is_mutual(best0_of_1, best1):
    """Row i's best column names row i as its own best row."""
    k0 = torch.arange(best1.shape[-1], device=best1.device)
    return torch.gather(best0_of_1, -1, best1) == k0


def _unpack_pm1(bits):
    """(..., nbytes) uint8 -> (..., nbytes * 8) in {-1, +1} (MSB first)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    b = (bits[..., None] >> shifts) & 1
    return b.reshape(*bits.shape[:-1], bits.shape[-1] * 8).float() * 2.0 - 1.0


def _invert_matches(matches0, scores_for0, n1: int):
    """matches1 / scores1 from matches0 by scatter; unmatched rows go to a
    dump slot past the end."""
    lead, n0 = matches0.shape[:-1], matches0.shape[-1]
    target = torch.where(matches0 >= 0, matches0, n1).long()
    rows = torch.arange(n0, dtype=torch.int32, device=matches0.device).expand(*lead, n0)
    m1 = torch.full((*lead, n1 + 1), -1, dtype=torch.int32, device=matches0.device).scatter_(-1, target, rows)
    s1 = scores_for0.new_zeros((*lead, n1 + 1)).scatter_(-1, target, scores_for0)
    return m1[..., :n1], s1[..., :n1]


def gather_matched_points(xy0, xy1, result: MatchResult):
    """Matched coordinate pairs as fixed-size arrays + mask: (p0, p1, valid)
    with p0, p1 (..., K0, 2) and valid (..., K0); row i pairs xy0[i] with
    xy1[matches0[i]] where matched."""
    idx = result.matches0.clamp_min(0).long()
    p1 = torch.gather(xy1, -2, idx[..., None].expand(*idx.shape, 2))
    return xy0, p1, result.matches0 >= 0
