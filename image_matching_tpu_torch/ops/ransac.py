"""Vectorised-hypothesis RANSAC — the counterpart of
`image_matching_tpu/ops/ransac.py`.

A fixed budget of minimal samples is drawn, every hypothesis is solved
at once, all hypotheses are scored against all correspondences with one
broadcast residual computation, the best consensus is taken, and the
model is refitted on its inliers by weighted least squares and polished
by IRLS. Degenerate samples score -1.

Model types: similarity ("partial affine", 4 DOF; minimal sample 2
points, closed form) and homography (8 DOF; minimal sample 4 points,
DLT).

Everything is strict f32: no TF32 (PyTorch's default for matmuls), no
lower-precision type. Linear systems go through `torch.linalg.solve_ex`,
which does not raise on a singular system; like the JAX package's, a
singular hypothesis is recognised by its non-finite entries.

Every function takes one problem, p0 / p1 (N, 2), or a batch,
(B, N, 2), where the JAX package uses `vmap`. Sampling draws from an
explicit `torch.Generator` on the points' device. Each estimator is
split into sampling (`sample_indices`) and a `*_from_indices` part that
takes the sample indices, so the same samples can be given to both
packages.
"""
from __future__ import annotations

from typing import Optional

import torch

from image_matching_tpu_torch.geometry.homography import homography_from_4pts, warp_points
from image_matching_tpu_torch.structs import RobustFit


def sample_indices(gen: torch.Generator, valid, num_hyp: int, sample_size: int, weights=None):
    """(..., M, k) indices drawn from the valid slots, with replacement.
    With `weights` (match confidences) minimal samples are drawn
    proportionally to confidence, floored at 1e-6. A problem with no valid
    slot draws uniformly (its fit is invalid anyway)."""
    probs = valid.float() if weights is None else torch.where(valid, weights.float().clamp_min(1e-6), 0.0)
    probs = probs + (~valid.any(dim=-1, keepdim=True)).float()
    lead = probs.shape[:-1]
    flat = torch.multinomial(probs.reshape(-1, probs.shape[-1]), num_hyp * sample_size,
                             replacement=True, generator=gen)
    return flat.reshape(*lead, num_hyp, sample_size)


def similarity_from_2pts(p0, p1):
    """The exact similarity (scale + rotation + translation) mapping 2
    source points onto 2 destination points. p0, p1 (..., 2, 2) ->
    (..., 2, 3) as [[a, -b, tx], [b, a, ty]]: with points as complex
    numbers, (q2 - q1) / (p2 - p1) plus a translation."""
    dp = p0[..., 1, :] - p0[..., 0, :]
    dq = p1[..., 1, :] - p1[..., 0, :]
    den = (dp[..., 0] ** 2 + dp[..., 1] ** 2).clamp_min(1e-12)
    a = (dq[..., 0] * dp[..., 0] + dq[..., 1] * dp[..., 1]) / den
    b = (dq[..., 1] * dp[..., 0] - dq[..., 0] * dp[..., 1]) / den
    tx = p1[..., 0, 0] - (a * p0[..., 0, 0] - b * p0[..., 0, 1])
    ty = p1[..., 0, 1] - (b * p0[..., 0, 0] + a * p0[..., 0, 1])
    return torch.stack([torch.stack([a, -b, tx], -1), torch.stack([b, a, ty], -1)], -2)


def _solve_normal(a_mat, b_vec, ww, ridge: float):
    """Weighted normal equations (A^T W A + ridge I) z = A^T W b. a_mat
    (..., R, P), b_vec and ww (..., R) -> z (..., P)."""
    aw = (a_mat * ww[..., None]).transpose(-1, -2)
    ata = aw @ a_mat + ridge * torch.eye(a_mat.shape[-1], dtype=a_mat.dtype, device=a_mat.device)
    atb = aw @ b_vec[..., None]
    return torch.linalg.solve_ex(ata, atb)[0][..., 0]


def fit_similarity_lsq(p0, p1, weights):
    """Weighted least-squares similarity fit (the RANSAC polish step).
    p0, p1 (..., N, 2), weights (..., N) -> (..., 2, 3). Solves for
    (a, b, tx, ty) by 4x4 normal equations: x' = a x - b y + tx,
    y' = b x + a y + ty."""
    x, y = p0[..., 0], p0[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    a_mat = torch.cat([torch.stack([x, -y, one, zero], -1), torch.stack([y, x, zero, one], -1)], -2)
    b_vec = torch.cat([p1[..., 0], p1[..., 1]], -1)
    w = weights.float()
    z = _solve_normal(a_mat, b_vec, torch.cat([w, w], -1), 1e-6)
    a, b, tx, ty = z.unbind(-1)
    return torch.stack([torch.stack([a, -b, tx], -1), torch.stack([b, a, ty], -1)], -2)


def _normalizing_transform(pts, weights):
    """Hartley normalisation: centroid to the origin, mean distance sqrt 2."""
    w = weights[..., None]
    wsum = w.sum(dim=(-2, -1)).clamp_min(1e-6)[..., None]
    mean = (pts * w).sum(dim=-2) / wsum
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1, keepdim=True))
    mean_d = ((d * w).sum(dim=(-2, -1)) / wsum[..., 0]).clamp_min(1e-6)
    s = (2.0 ** 0.5) / mean_d
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([torch.stack([s, zero, -s * mean[..., 0]], -1),
                        torch.stack([zero, s, -s * mean[..., 1]], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def fit_homography_lsq(p0, p1, weights):
    """Weighted DLT homography fit with Hartley normalisation. p0, p1
    (..., N, 2), weights (..., N) -> (..., 3, 3). h33 is fixed at 1, so the
    solve is an 8x8 normal-equation system instead of an SVD."""
    t0 = _normalizing_transform(p0, weights)
    t1 = _normalizing_transform(p1, weights)
    q0, q1 = warp_points(p0, t0), warp_points(p1, t1)
    x, y = q0[..., 0], q0[..., 1]
    u, v = q1[..., 0], q1[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    ax = torch.stack([x, y, one, zero, zero, zero, -x * u, -y * u], -1)
    ay = torch.stack([zero, zero, zero, x, y, one, -x * v, -y * v], -1)
    w = weights.float()
    h8 = _solve_normal(torch.cat([ax, ay], -2), torch.cat([u, v], -1), torch.cat([w, w], -1), 1e-8)
    h = torch.cat([h8, torch.ones_like(h8[..., :1])], -1).reshape(*h8.shape[:-1], 3, 3)
    h = torch.linalg.inv_ex(t1)[0] @ h @ t0
    return h / h[..., 2:3, 2:3]


def _residuals_affine(mat, p0, p1):
    """mat (B, M, 2, 3), p0 / p1 (B, N, 2) -> squared residuals (B, M, N)."""
    pred = torch.einsum("bmij,bnj->bmni", mat[..., :2], p0) + mat[..., None, :, 2]
    return ((pred - p1[:, None]) ** 2).sum(-1)


def _residuals_homography(h, p0, p1):
    """h (B, M, 3, 3), p0 / p1 (B, N, 2) -> squared residuals (B, M, N)."""
    return ((warp_points(p0[:, None], h) - p1[:, None]) ** 2).sum(-1)


def consensus(res_sq, valid, thresh: float):
    """Inlier mask and MSAC score (truncated quadratic loss, lower is
    better) per hypothesis. res_sq (..., M, N), valid (..., N)."""
    t2 = thresh * thresh
    v = valid[..., None, :]
    inl = (res_sq < t2) & v
    score = (torch.where(inl, res_sq, t2) * v).sum(-1)
    return inl, score


def _rows(t, index):
    """t (B, N, ...) gathered at index (B, ...) along dim 1."""
    return t[torch.arange(t.shape[0], device=t.device).reshape(-1, *[1] * (index.dim() - 1)), index]


def _robust_fit(mats, degen, residuals, fit_lsq, identity, p0, p1, valid, threshold, min_matches,
                polish_iters, weights) -> RobustFit:
    """What both estimators share after their hypotheses are solved:
    consensus, the best hypothesis (most inliers, ties broken by the lower
    MSAC score), the weighted refit on its inliers, IRLS with a Cauchy
    kernel at scale threshold / 2 (inlier semantics stay at the full
    threshold), and the final inlier set."""
    inl, msac = consensus(residuals(mats, p0, p1), valid, threshold)
    counts = torch.where(degen, -1, inl.sum(-1))
    order = counts.float() - msac / (msac.amax(dim=-1, keepdim=True) + 1.0)
    best_inl = _rows(inl, order.argmax(dim=-1))  # (B, N)

    conf = torch.ones_like(p0[..., 0]) if weights is None else weights
    refined = fit_lsq(p0, p1, best_inl.float() * conf)
    t2 = threshold * threshold
    sigma2 = t2 * 0.25
    for _ in range(polish_iters):
        res_r = residuals(refined[:, None], p0, p1)[:, 0]
        refined = fit_lsq(p0, p1, torch.where((res_r < t2) & valid, conf / (1.0 + res_r / sigma2), 0.0))
    res_r = residuals(refined[:, None], p0, p1)[:, 0]
    final_inl = (res_r < t2) & valid
    n_inl = final_inl.sum(-1)
    ok = (valid.sum(-1) >= min_matches) & (n_inl >= min_matches)
    return RobustFit(
        matrix=torch.where(ok[:, None, None], refined, identity.to(refined)),
        inliers=final_inl & ok[:, None],
        num_inliers=torch.where(ok, n_inl, 0),
        valid=ok,
    )


def _batched(fn):
    """Let an estimator written for (B, N, 2) also take one problem."""

    def run(idx, p0, p1, valid, *, weights=None, **kw):
        if p0.dim() == 3:
            return fn(idx, p0, p1, valid, weights=weights, **kw)
        fit = fn(idx[None], p0[None], p1[None], valid[None],
                 weights=None if weights is None else weights[None], **kw)
        return RobustFit(fit.matrix[0], fit.inliers[0], fit.num_inliers[0], fit.valid[0])

    run.__doc__ = fn.__doc__
    return run


@_batched
def ransac_similarity_from_indices(idx, p0, p1, valid, *, threshold: float = 7.0, min_matches: int = 4,
                                   polish_iters: int = 2, weights=None) -> RobustFit:
    """`ransac_similarity` on given sample indices idx (..., M, 2)."""
    s0, s1 = _rows(p0, idx), _rows(p1, idx)  # (B, M, 2, 2)
    mats = similarity_from_2pts(s0, s1)
    # degenerate: the two sample points (nearly) coincide
    degen = (((s0[:, :, 0] - s0[:, :, 1]) ** 2).sum(-1) < 1e-6) | ~torch.isfinite(mats).all(-1).all(-1)
    identity = torch.eye(2, 3)
    return _robust_fit(mats, degen, _residuals_affine, fit_similarity_lsq, identity, p0, p1, valid,
                       threshold, min_matches, polish_iters, weights)


@_batched
def ransac_homography_from_indices(idx, p0, p1, valid, *, threshold: float = 7.0, min_matches: int = 6,
                                   polish_iters: int = 2, weights=None) -> RobustFit:
    """`ransac_homography` on given sample indices idx (..., M, 4)."""
    s0, s1 = _rows(p0, idx), _rows(p1, idx)  # (B, M, 4, 2)
    hs = homography_from_4pts(s0, s1, check=False)
    # degenerate: singular DLT (non-finite) or near-coincident sample points
    pair_d = ((s0[:, :, :, None, :] - s0[:, :, None, :, :]) ** 2).sum(-1)  # (B, M, 4, 4)
    off_diagonal = ~torch.eye(4, dtype=torch.bool, device=p0.device)
    finite = torch.isfinite(hs).all(-1).all(-1)
    degen = ((pair_d < 1e-6) & off_diagonal).any(-1).any(-1) | ~finite
    hs = torch.where(finite[..., None, None], hs, torch.eye(3, dtype=hs.dtype, device=hs.device))
    return _robust_fit(hs, degen, _residuals_homography, fit_homography_lsq, torch.eye(3), p0, p1, valid,
                       threshold, min_matches, polish_iters, weights)


def ransac_similarity(gen: torch.Generator, p0, p1, valid, threshold: float = 7.0, num_hypotheses: int = 512,
                      min_matches: int = 4, polish_iters: int = 2, weights: Optional[torch.Tensor] = None) -> RobustFit:
    """Robust partial-affine (similarity) estimation.

    gen: generator for hypothesis sampling, on the points' device. p0, p1
    (N, 2) or (B, N, 2) matched source / destination points; valid the
    mask of real correspondences; threshold the inlier reprojection
    threshold in px; num_hypotheses the fixed hypothesis budget;
    polish_iters the IRLS rounds after the inlier refit; weights optional
    match confidences in (0, 1], which bias the sampling toward confident
    matches and scale the refit and IRLS weights (inlier counting stays
    unweighted at the full threshold). Returns a `RobustFit` with a (2, 3)
    matrix per problem."""
    idx = sample_indices(gen, valid, num_hypotheses, 2, weights)
    return ransac_similarity_from_indices(idx, p0, p1, valid, threshold=threshold, min_matches=min_matches,
                                          polish_iters=polish_iters, weights=weights)


def ransac_homography(gen: torch.Generator, p0, p1, valid, threshold: float = 7.0, num_hypotheses: int = 512,
                      min_matches: int = 6, polish_iters: int = 2, weights: Optional[torch.Tensor] = None) -> RobustFit:
    """Robust homography estimation: 4-point DLT hypotheses, DLT refit and
    IRLS polish; see `ransac_similarity` for the arguments. Returns a
    `RobustFit` with a (3, 3) matrix per problem."""
    idx = sample_indices(gen, valid, num_hypotheses, 4, weights)
    return ransac_homography_from_indices(idx, p0, p1, valid, threshold=threshold, min_matches=min_matches,
                                          polish_iters=polish_iters, weights=weights)
