"""Bundle adjustment over similarity poses and 2D landmarks, by a Schur
solve — the counterpart of `image_matching_tpu/slam/bundle_adjustment.py`:
the one-device solvers and the solver with the observations sharded over a
mesh axis (`make_sharded_bundle_adjuster`).

Pose z_i = (a, b, tx, ty) maps frame pixels u to the world by
S_i(u) = [[a, -b], [b, a]] u + t, linear in z_i. An observation m of
landmark l in frame f at pixel u_m has the residual

    r_m = A(u_m) z_f - p_l,   A(u) = [[u_x, -u_y, 1, 0],
                                      [u_y,  u_x, 0, 1]],

linear in both unknowns, so BA is an exact sparse linear least-squares
problem; an anchor prior on frame 0 fixes the gauge. Landmarks are
eliminated by the Schur complement (their block is diagonal, c_l I2 with
c_l the sum of w^2 over the landmark's observations), and the reduced
camera system is solved matrix-free by conjugate gradients
(`slam/cg.py`): a matvec gathers poses to observations, sums over
landmarks and scatters back to poses (`index_add_`, whose float32 sum
order on the card varies from run to run). Landmarks back-substitute as
the weighted mean of their predicted world points.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from image_matching_tpu_torch.device import resolve_device
from image_matching_tpu_torch.parallel.collectives import all_reduce
from image_matching_tpu_torch.slam.cg import cg


@dataclasses.dataclass(frozen=True)
class BAProblem:
    """Observation list (fixed capacity, masked by weight 0):
    obs_frame, obs_landmark (M,) int indices; obs_uv (M, 2) pixel
    coordinates of the landmark seen in that frame; obs_weight (M,) float
    (0 = padding or outlier)."""

    obs_frame: torch.Tensor
    obs_landmark: torch.Tensor
    obs_uv: torch.Tensor
    obs_weight: torch.Tensor
    num_frames: int = 0
    num_landmarks: int = 0

    def replace(self, **changes) -> "BAProblem":
        return dataclasses.replace(self, **changes)


def apply_similarity(z, uv):
    """S_z(uv) for params (..., 4) applied to points (..., 2)."""
    a, b, tx, ty = z.unbind(-1)
    x, y = uv[..., 0], uv[..., 1]
    return torch.stack([a * x - b * y + tx, b * x + a * y + ty], -1)


def invert_similarity(z):
    """Params of S^-1: conjugate / |s|^2 rotation, t' = -R^-1 t."""
    a, b, tx, ty = z.unbind(-1)
    s2 = (a * a + b * b).clamp_min(1e-12)
    ia, ib = a / s2, -b / s2
    return torch.stack([ia, ib, -(ia * tx - ib * ty), -(ib * tx + ia * ty)], -1)


def _obs_matrix(uv):
    """(M, 2, 4) A(u) with A(u) z = S_z(u)."""
    x, y = uv[..., 0], uv[..., 1]
    o, zr = torch.ones_like(x), torch.zeros_like(x)
    return torch.stack([torch.stack([x, -y, o, zr], -1), torch.stack([y, x, zr, o], -1)], -2)


def _same(t):
    return t


def _segment_sum(n: int, index, values):
    """(n, ...) sums of `values` (M, ...) by row `index` (M,)."""
    return torch.zeros((n, *values.shape[1:]), dtype=values.dtype, device=values.device).index_add_(0, index, values)


def _landmark_weight(problem: BAProblem, reduce=_same):
    """(L,) c_l = sum of w^2 over each landmark's observations."""
    return reduce(_segment_sum(problem.num_landmarks, problem.obs_landmark, problem.obs_weight ** 2))


def _predicted(problem: BAProblem, z):
    return apply_similarity(z[problem.obs_frame], problem.obs_uv)


def solve_landmarks(problem: BAProblem, z, reduce=_same):
    """Closed-form back-substitution: (L, 2) weighted mean of S_f(u_m) over
    each landmark's observations (zero for unobserved landmarks). `reduce`
    sums over the ranks that share the observations."""
    w2 = (problem.obs_weight ** 2)[:, None]
    num = reduce(_segment_sum(problem.num_landmarks, problem.obs_landmark, w2 * _predicted(problem, z)))
    return num / _landmark_weight(problem, reduce)[:, None].clamp_min(1e-12)


def robust_landmarks(problem: BAProblem, z, weiszfeld_iters: int = 8):
    """(L, 2) geometric-median landmark estimates by Weiszfeld iteration,
    which tolerate up to half a track being wrong (the weighted mean has
    zero breakdown)."""
    w2 = (problem.obs_weight ** 2)[:, None]
    pred = _predicted(problem, z)
    lm, nl = problem.obs_landmark, problem.num_landmarks

    def seg_mean(ww):
        return _segment_sum(nl, lm, ww * pred) / _segment_sum(nl, lm, ww).clamp_min(1e-12)

    p = seg_mean(w2)
    for _ in range(weiszfeld_iters):
        d = torch.linalg.vector_norm(pred - p[lm], dim=-1, keepdim=True)
        p = seg_mean(w2 / d.clamp_min(1.0))
    return p


def ba_residuals(problem: BAProblem, z, landmarks):
    """(M, 2) weighted reprojection residuals in world units."""
    return (_predicted(problem, z) - landmarks[problem.obs_landmark]) * problem.obs_weight[:, None]


def _schur_matvec(v, problem: BAProblem, amat, inv_c, anchor_weight: float, reduce=_same):
    """(H_zz - H_zp H_pp^-1 H_pz) v plus the anchor prior, matrix-free.
    `reduce` sums the landmark sums and the pose scatter over the ranks
    that share the observations."""
    w2 = (problem.obs_weight ** 2)[:, None]
    y = (amat * v[problem.obs_frame][:, None, :]).sum(-1)  # A v (M, 2)
    # H_zz v: w^2 A^T (A v) scattered to frames
    out = _segment_sum(v.shape[0], problem.obs_frame, (amat * (w2 * y)[:, :, None]).sum(1))
    # the Schur correction: with q_l = c_l^-1 sum_{m in l} w^2 y_m, -sum w^2 A^T q_{l_m}
    q = reduce(_segment_sum(inv_c.shape[0], problem.obs_landmark, w2 * y)) * inv_c[:, None]
    out = reduce(out.index_add_(0, problem.obs_frame, (amat * (-w2 * q[problem.obs_landmark])[:, :, None]).sum(1)))
    return out + torch.cat([anchor_weight * v[:1], torch.zeros_like(v[1:])])


def _schur_diag(problem: BAProblem, num_frames: int, anchor_weight: float, reduce=_same):
    """Jacobi preconditioner ~ diag(H_zz): per observation w^2 (|u|^2, |u|^2, 1, 1)."""
    u2 = (problem.obs_uv ** 2).sum(-1)
    w2 = problem.obs_weight ** 2
    one = torch.ones_like(u2)
    diag = reduce(_segment_sum(num_frames, problem.obs_frame, w2[:, None] * torch.stack([u2, u2, one, one], -1)))
    diag[0] += anchor_weight
    return diag.clamp_min(1e-8)


def _solve_linear(problem: BAProblem, z0, iters: int, anchor_weight: float, reduce=_same):
    """One exact solve of the reduced camera system (poses only), in
    normalised coordinates: raw pixel magnitudes make its condition number
    ~|u|^4 and stall float32 CG; u' = u / s with z' = (a, b, t / s) is an
    exact reparameterisation, and the translations are unscaled after.
    `reduce` sums over the ranks that share the observations (the sharded
    solver's all_reduce; the identity on one device)."""
    n = problem.num_frames
    w2 = problem.obs_weight ** 2
    sums = reduce(torch.stack([(w2 * (problem.obs_uv ** 2).sum(-1)).sum(), w2.sum()]))
    scale = torch.sqrt(sums[0] / sums[1].clamp_min(1e-12)).clamp_min(1e-6)
    sp = problem.replace(obs_uv=problem.obs_uv / scale)
    tscale = torch.stack([torch.ones_like(scale), torch.ones_like(scale), scale, scale])
    z0s = z0 / tscale
    inv_c = 1.0 / _landmark_weight(sp, reduce).clamp_min(1e-12)
    amat = _obs_matrix(sp.obs_uv)
    rhs = torch.zeros((n, 4), dtype=z0s.dtype, device=z0.device)
    rhs[0] += anchor_weight * z0s[0]
    diag = _schur_diag(sp, n, anchor_weight, reduce)
    zs = cg(lambda v: _schur_matvec(v, sp, amat, inv_c, anchor_weight, reduce), rhs, x0=z0s, maxiter=iters,
            tol=1e-12, M=lambda v: v / diag)
    return zs * tscale


def _identity_poses(n: int, device):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(n, 1)


def bundle_adjust(problem: BAProblem, init: Optional[torch.Tensor] = None, iters: int = 200,
                  anchor_weight: float = 10.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jointly optimal (poses (N, 4), landmarks (L, 2)), frame 0 anchored
    to init[0] (identity without init). The problem is linear, so CG on the
    reduced camera system reaches the joint optimum without relinearising."""
    z0 = init if init is not None else _identity_poses(problem.num_frames, problem.obs_uv.device)
    z = _solve_linear(problem, z0, iters, anchor_weight)
    return z, solve_landmarks(problem, z)


def make_sharded_bundle_adjuster(mesh, num_frames: int, num_landmarks: int, iters: int = 200,
                                 axis_name: str = "data", anchor_weight: float = 10.0):
    """Bundle adjustment with the observations sharded over `axis_name` of
    a `parallel/mesh.Mesh`: `solve(obs_frame, obs_landmark, obs_uv,
    obs_weight, z0)` takes this rank's observations (padding of weight 0
    adds nothing) and the replicated init, and returns the replicated
    (poses (N, 4), landmarks (L, 2)). Each CG matvec all_reduces the
    landmark sums (L, 2) and the pose scatter (N, 4), as do the coordinate
    scale, the landmark weights, the Jacobi diagonal and the landmarks'
    back-substitution; the reduced vectors are the same on every rank, so
    the CG's done mask stays in step."""
    axis = mesh.axis(axis_name)

    def reduce(t):
        return all_reduce(t, axis)

    def solve(obs_frame, obs_landmark, obs_uv, obs_weight, z0):
        problem = BAProblem(obs_frame, obs_landmark, obs_uv, obs_weight, num_frames, num_landmarks)
        z = _solve_linear(problem, z0, iters, anchor_weight, reduce)
        return z, solve_landmarks(problem, z, reduce)

    return solve


def _nanmedian(x):
    """`jnp.nanmedian`: the mean of the two middle values of an even count
    (`torch.nanmedian` returns the lower one)."""
    return torch.nanquantile(x, 0.5)


def bundle_adjust_robust(problem: BAProblem, init: Optional[torch.Tensor] = None, iters: int = 200,
                         rounds: int = 4, anchor_weight: float = 10.0, huber_k: float = 3.0, cut_k: float = 6.0):
    """IRLS bundle adjustment for outlier-contaminated tracks. Each round:
    residual norms at the current poses against geometric-median landmarks,
    a robust scale s = 1.4826 median, Huber weights at huber_k s and zero
    beyond cut_k s, then an exact linear solve. Returns (poses, landmarks,
    final weights); weight-0 observations are the rejected outliers."""
    z = init if init is not None else _identity_poses(problem.num_frames, problem.obs_uv.device)
    w0 = problem.obs_weight
    real = w0 > 0
    prob = problem
    for _ in range(rounds):
        p = robust_landmarks(prob, z)
        rn = torch.linalg.vector_norm(_predicted(problem, z) - p[problem.obs_landmark], dim=-1)
        s = 1.4826 * _nanmedian(torch.where(real, rn, torch.nan))
        s = torch.nan_to_num(s, nan=1.0).clamp_min(0.5)
        robust = torch.clamp_max(huber_k * s / rn.clamp_min(1e-9), 1.0)
        robust = torch.where(rn > cut_k * s, 0.0, robust)
        prob = problem.replace(obs_weight=w0 * torch.sqrt(robust))
        z = _solve_linear(prob, z, iters, anchor_weight)
    return z, solve_landmarks(prob, z), prob.obs_weight


def tracks_to_ba_problem(tracks, num_frames: int, max_observations: int, weight: float = 1.0,
                         device=None) -> BAProblem:
    """`get_tracks` output ([(tid, [(frame, x, y), ...]), ...]) as a
    fixed-capacity BAProblem, assembled on the host and put on `device`
    (None: the card)."""
    device = resolve_device(device)
    frames, lms, uvs, ws = [], [], [], []
    for lm_idx, (_, obs) in enumerate(tracks):
        for f, x, y in obs:
            frames.append(f)
            lms.append(lm_idx)
            uvs.append((x, y))
            ws.append(weight)
    m = len(frames)
    if m > max_observations:
        raise ValueError(f"{m} observations exceed capacity {max_observations}")
    pad = max_observations - m

    def put(values, dtype):
        return torch.from_numpy(np.asarray(values, dtype)).to(device)

    return BAProblem(
        obs_frame=put(frames + [0] * pad, np.int64), obs_landmark=put(lms + [0] * pad, np.int64),
        obs_uv=put(uvs + [(0.0, 0.0)] * pad, np.float32).reshape(max_observations, 2),
        obs_weight=put(ws + [0.0] * pad, np.float32), num_frames=num_frames, num_landmarks=max(len(tracks), 1))
