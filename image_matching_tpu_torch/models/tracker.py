"""Point tracker: a fixed-memory multi-frame track store — the counterpart
of `image_matching_tpu/models/tracker.py` (after the reference's
`PointTracker`, superpoint/models/model_wrap.py:355-578).

The last L frames' keypoints and descriptors sit in a ring buffer of
tensors (newest at index L-1). Each new frame is matched to the previous
one by two-way nearest neighbours under a descriptor distance
(`ops/matching.match_mutual_nn`); matched keypoints inherit their track
id, the others get fresh ones, and tracks carry a running average of
their match scores. One frame's update is a few tensor ops on the
state's device, with no host read.
"""
from __future__ import annotations

import dataclasses

import torch

from image_matching_tpu_torch.device import resolve_device
from image_matching_tpu_torch.ops.matching import match_mutual_nn
from image_matching_tpu_torch.structs import Keypoints


@dataclasses.dataclass(frozen=True)
class TrackerState:
    """Ring buffer of the last L frames (newest at index L-1)."""

    xy: torch.Tensor  # (L, K, 2)
    desc: torch.Tensor  # (L, K, D)
    mask: torch.Tensor  # (L, K) bool
    track_ids: torch.Tensor  # (L, K) int32, -1 for invalid slots
    track_score: torch.Tensor  # (L, K) running average match score
    next_id: torch.Tensor  # () int32
    frame_idx: torch.Tensor  # () int32

    @property
    def max_length(self) -> int:
        return self.xy.shape[0]

    @property
    def capacity(self) -> int:
        return self.xy.shape[1]

    def replace(self, **changes) -> "TrackerState":
        return dataclasses.replace(self, **changes)


def tracker_init(max_length: int, capacity: int, desc_dim: int, device=None) -> TrackerState:
    """An empty state on `device` (None: the card)."""
    l, k, d = max_length, capacity, desc_dim
    device = resolve_device(device)
    return TrackerState(
        xy=torch.zeros((l, k, 2), device=device),
        desc=torch.zeros((l, k, d), device=device),
        mask=torch.zeros((l, k), dtype=torch.bool, device=device),
        track_ids=torch.full((l, k), -1, dtype=torch.int32, device=device),
        track_score=torch.zeros((l, k), device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def tracker_update(state: TrackerState, kpts: Keypoints, max_dist: float = 0.7) -> TrackerState:
    """Ingest one frame's keypoints (xy (K, 2), score, mask (K,), desc (K,
    D)): match to the previous frame, extend or spawn tracks. `max_dist`
    is the descriptor L2 threshold (`nn_thresh`, the reference's 0.7)."""
    res = match_mutual_nn(kpts.desc, state.desc[-1], kpts.mask, state.mask[-1], max_dist=max_dist)
    matched = res.matches0 >= 0  # new-frame slots matched to the previous frame
    prev_slot = res.matches0.clamp_min(0).long()

    inherited_ids = torch.where(matched, state.track_ids[-1][prev_slot], -1)
    fresh = ~matched & kpts.mask
    fresh_ids = state.next_id + torch.cumsum(fresh.to(torch.int32), 0) - 1
    new_ids = torch.where(matched, inherited_ids, torch.where(kpts.mask, fresh_ids, -1)).to(torch.int32)
    n_new = fresh.sum().to(torch.int32)

    # running-average track score (reference: average of match confidences)
    inherited_score = torch.where(matched, state.track_score[-1][prev_slot], 0.0)
    new_score = torch.where(matched, 0.5 * (inherited_score + res.scores0), kpts.score)

    def roll(buf, new):
        return torch.cat([buf[1:], new[None].to(buf.dtype)], dim=0)

    return state.replace(
        xy=roll(state.xy, kpts.xy), desc=roll(state.desc, kpts.desc), mask=roll(state.mask, kpts.mask),
        track_ids=roll(state.track_ids, new_ids), track_score=roll(state.track_score, new_score),
        next_id=state.next_id + n_new, frame_idx=state.frame_idx + 1)


def track_lengths(state: TrackerState) -> torch.Tensor:
    """(K,) number of window frames each newest-frame track appears in."""
    newest = state.track_ids[-1][None, :]
    present = (state.track_ids[:, :, None] == newest) & (newest >= 0)
    return present.any(dim=1).sum(0)


def get_tracks_dense(state: TrackerState, min_length: int = 2) -> dict:
    """Track extraction as fixed-shape tensors: for every newest-frame
    slot, its track id located in each window frame by one broadcast
    compare and the first matching slot (argmax of a bool, as in JAX).
    Returns tid (K,) int32 (-1 invalid), xy (K, L, 2), present (K, L),
    valid (K,) (visible now with >= min_length observations) and length
    (K,) int32. Window frame f is absolute frame `frame_idx - L + f`."""
    ids = state.track_ids
    newest = ids[-1]
    eq = (ids[:, :, None] == newest[None, None, :]) & (newest >= 0)[None, None, :]  # (L, slots, tracks)
    present = eq.any(dim=1)
    slot = eq.to(torch.uint8).argmax(dim=1)  # first matching slot
    xy = torch.gather(state.xy, 1, slot[..., None].expand(-1, -1, 2))
    length = present.sum(0).to(torch.int32)
    return {"tid": newest, "xy": xy.transpose(0, 1), "present": present.t(),
            "valid": (newest >= 0) & (length >= min_length), "length": length}


def get_tracks(state: TrackerState, min_length: int = 2):
    """`get_tracks_dense` as a list [(track_id, [(frame, x, y), ...]), ...]
    of the tracks visible in the newest frame with >= min_length
    observations; the search runs on the state's device and its result
    comes to the host in one transfer."""
    dense = get_tracks_dense(state, min_length)
    k, l = dense["present"].shape
    packed = torch.cat([dense["tid"].double()[:, None], dense["valid"].double()[:, None],
                        dense["present"].double(), dense["xy"].double().reshape(k, 2 * l),
                        state.frame_idx.double().expand(k)[:, None]], dim=1).cpu().numpy()
    if k == 0:
        return []
    frame0 = int(packed[0, -1]) - l
    out = []
    for row in packed[packed[:, 1] > 0]:
        present, xy = row[2:2 + l], row[2 + l:2 + 3 * l].reshape(l, 2)
        out.append((int(row[0]), [(frame0 + int(f), float(xy[f, 0]), float(xy[f, 1]))
                                  for f in range(l) if present[f] > 0]))
    return out
