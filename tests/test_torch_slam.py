"""The port's sequence / SLAM back end (`models/tracker.py`, `slam/cg.py`,
`slam/pose_graph.py`, `slam/bundle_adjustment.py`, `slam/sequence.py`,
`evaluation.make_synthetic_sequence`, `imgproc.invert_affine_transform`)
against the JAX package's (and OpenCV's), on the CPU. Tolerances:

  * tracker: identical ids, lengths, next id and `get_tracks` over 4 frames;
  * CG against `jax.scipy.sparse.linalg.cg`: within 1e-5 of max(|x|) (float32
    dot products summed in another order), with maxiter reached and with an
    early stop at the same iteration;
  * BA against JAX on `test_bundle_adjustment.py`'s problem maker, noisy and
    with outliers: within 1e-4 of max(|z|) (its coordinates are normalised,
    so its CG is well conditioned); the pose graph on `test_pose_graph.py`'s
    graph maker no further from the exact float64 solution, nor from JAX's
    result, than twice JAX's own distance from it (see that test for why
    not 1e-4);
  * the robust scale's median: `jnp.nanmedian` exactly, an even count too;
  * `register_sequence` -> `solve_trajectory` -> `refine_trajectory_with_tracks`
    on 8 synthetic frames, both fed JAX's RANSAC draws: ATE within 1e-3 px of
    JAX's at both stages;
  * `make_synthetic_sequence` against the JAX package's (cv2): the ground
    truth equal, frames within 1e-5 (the blur's float64 sums);
    `invert_affine_transform` equal to cv2.invertAffineTransform.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu import evaluation as jax_evaluation
from image_matching_tpu.features.registration import build_classical_registration_fn as jax_build
from image_matching_tpu.models import tracker as jax_tracker
from image_matching_tpu.ops import ransac as jax_ransac
from image_matching_tpu.slam import bundle_adjustment as jax_ba
from image_matching_tpu.slam import pose_graph as jax_pg
from image_matching_tpu.slam import sequence as jax_seq
from image_matching_tpu.structs import Keypoints as JaxKeypoints
from image_matching_tpu_torch import evaluation, imgproc
from image_matching_tpu_torch.features.registration import build_classical_registration_fn
from image_matching_tpu_torch.models import tracker
from image_matching_tpu_torch.slam import bundle_adjustment as ba
from image_matching_tpu_torch.slam import pose_graph as pg
from image_matching_tpu_torch.slam import sequence
from image_matching_tpu_torch.slam.cg import cg
from image_matching_tpu_torch.structs import Keypoints
from test_bundle_adjustment import _make_problem
from test_pose_graph import build_graph
from test_torch_features import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() <= rel * max(1.0, np.abs(ref).max())


# ---------------------------------------------------------------- tracker

def test_tracker_matches_jax_over_four_frames():
    rng = np.random.default_rng(0)
    k, d = 24, 32
    base = rng.normal(size=(k, d)).astype(np.float32)
    xy = rng.uniform(0, 100, (k, 2)).astype(np.float32)
    js, ts = jax_tracker.tracker_init(3, k, d), tracker.tracker_init(3, k, d, device="cpu")
    for f in range(4):
        desc = base + rng.normal(0, 0.05, (k, d)).astype(np.float32)
        desc[rng.choice(k, 5, replace=False)] = rng.normal(size=(5, d))  # fresh points
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        mask = rng.uniform(size=k) > 0.15
        score = rng.uniform(0.2, 1.0, k).astype(np.float32)
        pts = xy + f * 2.0
        js = jax_tracker.tracker_update(js, JaxKeypoints(jnp.asarray(pts), jnp.asarray(score), jnp.asarray(mask),
                                                         jnp.asarray(desc)), max_dist=0.9)
        ts = tracker.tracker_update(ts, Keypoints(_t(pts), _t(score), _t(mask), _t(desc)), max_dist=0.9)
        assert np.array_equal(np.asarray(js.track_ids), ts.track_ids.numpy())
        assert int(js.next_id) == int(ts.next_id) and int(js.frame_idx) == int(ts.frame_idx)
        assert np.allclose(np.asarray(js.track_score), ts.track_score.numpy(), atol=1e-6)
    assert np.array_equal(np.asarray(jax_tracker.track_lengths(js)), tracker.track_lengths(ts).numpy())
    dense_j, dense_t = jax_tracker.get_tracks_dense(js, 2), tracker.get_tracks_dense(ts, 2)
    for key in ("tid", "present", "valid", "length", "xy"):
        assert np.array_equal(np.asarray(dense_j[key]), dense_t[key].numpy()), key
    ref, got = jax_tracker.get_tracks(js, 2), tracker.get_tracks(ts, 2)
    assert len(ref) > 5 and got == ref


# ---------------------------------------------------------------- CG

@pytest.mark.parametrize("maxiter,tol", [(6, 1e-10), (200, 1e-3)])
def test_cg_matches_jax(maxiter, tol):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(24, 24)).astype(np.float32)
    a = a @ a.T + 2.0 * np.eye(24, dtype=np.float32) * np.linspace(1, 30, 24, dtype=np.float32)
    b = rng.normal(size=(6, 4)).astype(np.float32)
    diag = np.diag(a).reshape(6, 4)
    x0 = np.zeros_like(b)
    ref = np.asarray(jax.scipy.sparse.linalg.cg(lambda v: (jnp.asarray(a) @ v.reshape(-1)).reshape(6, 4),
                                                jnp.asarray(b), x0=jnp.asarray(x0), maxiter=maxiter, tol=tol,
                                                M=lambda v: v / jnp.asarray(diag))[0])
    iters = []

    def matvec(v):
        iters.append(1)
        return (_t(a) @ v.reshape(-1)).reshape(6, 4)

    got = cg(matvec, _t(b), x0=_t(x0), maxiter=maxiter, tol=tol, M=lambda v: v / _t(diag)).numpy()
    assert len(iters) == maxiter + 1  # every iteration runs; the done mask freezes the result
    assert _close(got, ref, 1e-5)
    exact = np.linalg.solve(a.astype(np.float64), b.reshape(-1).astype(np.float64)).reshape(6, 4)
    if maxiter == 200:  # stopped early, by the rule, at tol 1e-3 of ||b||
        assert np.abs(got - exact).max() > 1e-6 and np.abs(got - exact).max() < 1e-2 * np.abs(exact).max()


# ---------------------------------------------------------------- pose graph

def _torch_graph(graph):
    return pg.PoseGraph(src=_t(graph.src).long(), dst=_t(graph.dst).long(), rel=_t(graph.rel),
                        weight=_t(graph.weight), num_frames=graph.num_frames)


def _exact_pose_graph(graph: pg.PoseGraph, anchor_weight: float = 10.0):
    """The float64 solution of the normal equations that the CG solves,
    by a dense solve of the matvec's matrix."""
    g64 = pg.PoseGraph(graph.src, graph.dst, graph.rel.double(), graph.weight.double(), graph.num_frames)
    l_op, n = pg._edge_operator(g64.rel), graph.num_frames
    cols = [pg._normal_matvec(e.reshape(n, 4), g64, l_op, anchor_weight).reshape(-1)
            for e in torch.eye(4 * n, dtype=torch.float64)]
    rhs = torch.zeros(4 * n, dtype=torch.float64)
    rhs[0] = anchor_weight
    return torch.linalg.solve(torch.stack(cols, 1), rhs).reshape(n, 4).numpy()


@pytest.mark.parametrize("seed,n,noise,loops,outliers,iters", [
    (2, 16, 0.0, 8, 0, 200),  # test_pose_graph.py's noiseless recovery
    (3, 24, 0.01, 20, 0, 300),  # its noisy loop closures
    (4, 10, 0.01, 8, 3, 300),  # with 3 gross outlier edges
])
def test_pose_graph_matches_jax(seed, n, noise, loops, outliers, iters):
    """Not within 1e-4 of max(|z|): the translation columns (~30 px) make
    the normal equations' condition number ~1e4, so 200-300 float32 CG
    iterations end at their accuracy floor, where the dot products' and
    scatter-adds' float32 sum order (XLA fuses x + alpha p into FMAs; the
    port rounds twice) moves the result as far as both packages lie from
    the exact float64 solution (measured: port - JAX 1.9e-3-7.2e-3, JAX -
    exact 1.5e-3-1.6e-2 on these graphs). So the port is held to that
    solution: no further from it than twice JAX's own distance, and no
    further from JAX than twice that distance, plus 1e-4 of max(|z|)."""
    rng = np.random.default_rng(seed)
    gt, graph = build_graph(rng, n, noise=noise, extra_loops=loops)
    if outliers:
        rel = np.array(graph.rel)
        bad = rng.choice(rel.shape[0], outliers, replace=False)
        rel[bad, 2:] += rng.uniform(20, 40, (outliers, 2)).astype(np.float32)
        graph = graph.replace(rel=jnp.asarray(rel))
    ref = np.asarray(jax_pg.optimize_pose_graph(graph, iters=iters))
    got = pg.optimize_pose_graph(_torch_graph(graph), iters=iters).numpy()
    exact = _exact_pose_graph(_torch_graph(graph))
    jax_err, scale = np.abs(ref - exact).max(), np.abs(exact).max()
    assert np.abs(got - exact).max() <= 2 * jax_err + 1e-6 * scale
    assert np.abs(got - ref).max() <= 2 * jax_err + 1e-4 * scale
    if not outliers:
        assert np.abs(got - gt).max() < 0.05 + 20 * noise
    ate_j = float(jax_pg.absolute_trajectory_error(jnp.asarray(ref), jnp.asarray(gt)))
    ate_t = float(pg.absolute_trajectory_error(_t(got), _t(gt)))
    assert abs(ate_j - ate_t) <= 1e-2


def test_similarity_algebra_matches_jax():
    rng = np.random.default_rng(3)
    z1, z2 = rng.normal(size=(5, 4)).astype(np.float32), rng.normal(size=(5, 4)).astype(np.float32)
    pairs = [(jax_pg.compose_similarity(jnp.asarray(z2), jnp.asarray(z1)), pg.compose_similarity(_t(z2), _t(z1))),
             (jax_pg.similarity_params_to_matrix(jnp.asarray(z1)), pg.similarity_params_to_matrix(_t(z1))),
             (jax_ba.invert_similarity(jnp.asarray(z1)), ba.invert_similarity(_t(z1))),
             (jax_ba.apply_similarity(jnp.asarray(z1), jnp.asarray(z2[:, :2])), ba.apply_similarity(_t(z1), _t(z2[:, :2])))]
    for ref, got in pairs:
        assert np.allclose(np.asarray(ref), got.numpy(), rtol=1e-6, atol=1e-6)
    m = pg.similarity_params_to_matrix(_t(z1))
    assert torch.equal(pg.matrix_to_similarity_params(m), _t(z1))


# ---------------------------------------------------------------- bundle adjustment

def _torch_problem(problem):
    return ba.BAProblem(obs_frame=_t(problem.obs_frame).long(), obs_landmark=_t(problem.obs_landmark).long(),
                        obs_uv=_t(problem.obs_uv), obs_weight=_t(problem.obs_weight),
                        num_frames=problem.num_frames, num_landmarks=problem.num_landmarks)


def _corrupted(seed, frac=0.2):
    problem, z_gt, _ = _make_problem(n_frames=8, n_landmarks=40, obs_per_landmark=5, noise=0.3)
    rng = np.random.default_rng(seed)
    m = int(problem.obs_frame.shape[0])
    bad = rng.choice(m, int(m * frac), replace=False)
    uv = np.array(problem.obs_uv)
    uv[bad] += rng.uniform(30, 120, (len(bad), 2)) * rng.choice([-1, 1], (len(bad), 2))
    z_init = np.asarray(z_gt) + rng.normal(0, 0.02, z_gt.shape).astype(np.float32)
    z_init[0] = np.asarray(z_gt[0])
    return problem.replace(obs_uv=jnp.asarray(uv)), z_init


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_bundle_adjust_matches_jax(noise):
    problem, _, _ = _make_problem(noise=noise)
    z_ref, p_ref = jax_ba.bundle_adjust(problem, iters=300)
    z, p = ba.bundle_adjust(_torch_problem(problem), iters=300)
    assert _close(z.numpy(), z_ref, 1e-4) and _close(p.numpy(), p_ref, 1e-4)
    r_ref = jax_ba.ba_residuals(problem, z_ref, p_ref)
    assert _close(ba.ba_residuals(_torch_problem(problem), _t(z_ref), _t(p_ref)).numpy(), r_ref, 1e-5)
    assert _close(ba.robust_landmarks(_torch_problem(problem), _t(z_ref)).numpy(),
                  jax_ba.robust_landmarks(problem, z_ref), 1e-5)


def test_bundle_adjust_robust_matches_jax_with_outliers():
    problem, z_init = _corrupted(7)
    z_ref, p_ref, w_ref = jax_ba.bundle_adjust_robust(problem, init=jnp.asarray(z_init), iters=300)
    z, p, w = ba.bundle_adjust_robust(_torch_problem(problem), init=_t(z_init), iters=300)
    assert _close(z.numpy(), z_ref, 1e-4) and _close(p.numpy(), p_ref, 1e-4)
    assert np.array_equal(np.asarray(w_ref) == 0, w.numpy() == 0) and _close(w.numpy(), w_ref, 1e-4)


@pytest.mark.parametrize("count", [7, 8])
def test_robust_scale_median_is_jnp_nanmedian(count):
    """An even count takes the mean of the two middle values, as
    jnp.nanmedian does (torch.nanmedian would take the lower one)."""
    x = np.random.default_rng(count).uniform(0, 10, 12).astype(np.float32)
    x[count:] = np.nan
    ref = float(jnp.nanmedian(jnp.asarray(x)))
    got = float(ba._nanmedian(_t(x)))
    assert got == ref
    if count % 2 == 0:
        assert got != float(torch.nanmedian(_t(x)))


def test_tracks_to_ba_problem_and_refine_match_jax():
    problem, z_gt, _ = _make_problem(n_frames=6, n_landmarks=30)
    f, lm, uv = np.asarray(problem.obs_frame), np.asarray(problem.obs_landmark), np.array(problem.obs_uv)
    tracks = [(t, [(int(f[i]), float(uv[i, 0]), float(uv[i, 1])) for i in np.nonzero(lm == t)[0]])
              for t in range(problem.num_landmarks)]
    ref_p = jax_ba.tracks_to_ba_problem(tracks, 6, 128)
    got_p = ba.tracks_to_ba_problem(tracks, 6, 128, device="cpu")
    for name in ("obs_frame", "obs_landmark", "obs_uv", "obs_weight"):
        assert np.array_equal(np.asarray(getattr(ref_p, name)), getattr(got_p, name).numpy())
    assert (got_p.num_frames, got_p.num_landmarks) == (ref_p.num_frames, ref_p.num_landmarks)
    with pytest.raises(ValueError, match="exceed capacity"):
        ba.tracks_to_ba_problem(tracks, 6, 8, device="cpu")
    z_init = np.asarray(z_gt) + np.random.default_rng(3).normal(0, 0.05, z_gt.shape).astype(np.float32)
    z_init[0] = np.asarray(z_gt[0])
    z_ref, p_ref = jax_seq.refine_trajectory_with_tracks(tracks, jnp.asarray(z_init), 6, iters=400)
    z, p = sequence.refine_trajectory_with_tracks(tracks, _t(z_init), 6, iters=400)
    assert _close(z.numpy(), z_ref, 1e-4) and _close(p.numpy(), p_ref, 1e-4)
    passthrough, _ = sequence.refine_trajectory_with_tracks([], _t(z_init), 6)
    assert torch.equal(passthrough, _t(z_init))


# ---------------------------------------------------------------- the synthetic sequence and the pipeline

def test_make_synthetic_sequence_matches_the_cv2_maker():
    frames_ref, gt_ref = jax_evaluation.make_synthetic_sequence(np.random.default_rng(5), n_frames=6)
    frames, gt = evaluation.make_synthetic_sequence(np.random.default_rng(5), n_frames=6)
    assert np.array_equal(gt, gt_ref) and len(frames) == 6
    for a, b in zip(frames, frames_ref):
        assert a.shape == b.shape == (160, 160, 1) and a.dtype == np.float32 and np.abs(a - b).max() <= 1e-5


def test_invert_affine_transform_matches_cv2():
    rng = np.random.default_rng(6)
    for _ in range(20):
        m = rng.normal(size=(2, 3)).astype(np.float32) * np.float32([[1, 1, 50], [1, 1, 50]])
        assert np.array_equal(imgproc.invert_affine_transform(m), cv2.invertAffineTransform(m))
    assert np.array_equal(imgproc.invert_affine_transform(np.zeros((2, 3), np.float32)),
                          cv2.invertAffineTransform(np.zeros((2, 3), np.float32)))


def test_sequence_pipeline_matches_jax_on_its_draws():
    """8 frames of 160x160, SIFT, strides (1, 4): the port fed the sample
    indices JAX draws edge by edge from its key splits; then the pose graph
    and the track-based bundle adjustment on the same tracks."""
    frames, gt = jax_evaluation.make_synthetic_sequence(np.random.default_rng(0), n_frames=8)
    jreg = jax.jit(jax_build("sift"))
    graph_ref = jax_seq.register_sequence(jreg, frames, jax.random.PRNGKey(0))
    key, indices = jax.random.PRNGKey(0), []
    for i, j in jax_seq.sequence_edges(8):
        key, k = jax.random.split(key)
        valid = jreg(jnp.asarray(frames[i]), jnp.asarray(frames[j]), k).matches.matches0 >= 0
        indices.append(_t(np.asarray(jax_ransac._sample_indices(k, valid, 512, 2)))[None])
    graph = sequence.register_sequence(lambda a, b, gen, idx: build_classical_registration_fn("sift")(a, b, gen, idx),
                                       frames, indices=indices, device="cpu")
    assert np.array_equal(graph.src.numpy(), np.asarray(graph_ref.src))
    assert np.array_equal(graph.weight.numpy() > 0, np.asarray(graph_ref.weight) > 0)
    assert int((graph.weight > 0).sum()) >= 10
    gt_rel = jax_pg.compose_similarity(jax_ba.invert_similarity(jnp.asarray(gt[0]))[None], jnp.asarray(gt))
    traj_ref = jax_seq.solve_trajectory(graph_ref, iters=300)
    traj = sequence.solve_trajectory(graph, iters=300)
    ate_ref = float(jax_pg.absolute_trajectory_error(traj_ref, gt_rel))
    ate = float(pg.absolute_trajectory_error(traj, _t(gt_rel)))
    assert ate < 0.1 and abs(ate - ate_ref) <= 1e-3

    # tracks from JAX's tracker on JAX's keypoints, refined by both packages
    from image_matching_tpu.features.sift import sift_detect_and_describe

    state = jax_tracker.tracker_init(8, 1024, 128)
    for fr in frames:
        state = jax_tracker.tracker_update(state, sift_detect_and_describe(jnp.asarray(fr[..., 0])), max_dist=0.9)
    tracks = jax_tracker.get_tracks(state, 3)
    z_ref, _ = jax_seq.refine_trajectory_with_tracks(tracks, traj_ref, 8, iters=300, min_track_length=3)
    z, _ = sequence.refine_trajectory_with_tracks(tracks, _t(np.asarray(traj_ref)), 8, iters=300,
                                                  min_track_length=3)
    ate_ref = float(jax_pg.absolute_trajectory_error(z_ref, gt_rel))
    ate = float(pg.absolute_trajectory_error(z, _t(gt_rel)))
    assert len(tracks) > 100 and ate < 0.1 and abs(ate - ate_ref) <= 1e-3
