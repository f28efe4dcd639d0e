"""The port's sharded SLAM solvers (`slam/pose_graph.make_sharded_pose_graph_solver`,
`slam/bundle_adjustment.make_sharded_bundle_adjuster`) on 4 gloo ranks on
the CPU (one spawn, `torch_mesh_workers.solver_worker`), on the JAX
package's own test problems padded with weight-0 edges and observations,
against the JAX package's sharded solvers over 4 devices and the port's
unsharded ones, at the JAX tests' tolerances: 0.02 for the poses of the
pose graph, 5e-3 for the poses and landmarks of bundle adjustment (float32
CG whose all-reduced sums run in another order ends near, not at, the
same optimum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from image_matching_tpu.parallel import make_mesh as jax_mesh
from image_matching_tpu.slam import make_sharded_pose_graph_solver as jax_pose_graph
from image_matching_tpu.slam.bundle_adjustment import make_sharded_bundle_adjuster as jax_ba
from test_bundle_adjustment import _make_problem
from test_pose_graph import build_graph
from test_torch_features import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from torch_mesh_workers import solver_worker, spawn

WORLD = 4


def _padded(a, n):
    a = np.asarray(a)
    return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1))


def test_sharded_solvers_equal_jax_and_unsharded(tmp_path):
    mesh = jax_mesh({"data": WORLD}, jax.devices()[:WORLD])
    _, graph = build_graph(np.random.default_rng(5), n_frames=16, noise=0.005, extra_loops=9)
    e = -(-graph.src.shape[0] // 8) * 8  # padding edges: weight 0
    g = {k: _padded(getattr(graph, k), e) for k in ("src", "dst", "rel", "weight")}
    z0 = jnp.tile(jnp.array([1.0, 0.0, 0.0, 0.0]), (16, 1))
    jax_z = np.asarray(jax_pose_graph(mesh, 16, iters=150)(*(jnp.asarray(g[k]) for k in ("src", "dst", "rel",
                                                                                          "weight")), z0))

    problem, _, _ = _make_problem(n_landmarks=32, obs_per_landmark=4)
    m = -(-problem.obs_frame.shape[0] // 8) * 8
    p = {k: _padded(getattr(problem, f"obs_{k}"), m) for k in ("frame", "landmark", "uv", "weight")}
    z0 = jnp.tile(jnp.array([1.0, 0.0, 0.0, 0.0]), (problem.num_frames, 1))
    jax_zp = [np.asarray(x) for x in jax_ba(mesh, problem.num_frames, problem.num_landmarks, iters=300)(
        *(jnp.asarray(p[k]) for k in ("frame", "landmark", "uv", "weight")), z0)]

    t = lambda a, dtype=None: torch.from_numpy(np.array(a, dtype=dtype))  # noqa: E731
    torch.save({"pose graph": {"src": t(g["src"], np.int64), "dst": t(g["dst"], np.int64), "rel": t(g["rel"]),
                               "weight": t(g["weight"], np.float32), "num_frames": 16, "iters": 150},
                "bundle adjustment": {"frame": t(p["frame"], np.int64), "landmark": t(p["landmark"], np.int64),
                                      "uv": t(p["uv"]), "weight": t(p["weight"], np.float32),
                                      "num_frames": problem.num_frames, "num_landmarks": problem.num_landmarks,
                                      "iters": 300}}, tmp_path / "inputs.pt")
    ranks = spawn(solver_worker, WORLD, tmp_path)
    for r in ranks:  # every rank returns the whole, replicated solution
        np.testing.assert_array_equal(r["pose graph"].numpy(), ranks[0]["pose graph"].numpy())
        np.testing.assert_allclose(r["pose graph"].numpy(), jax_z, atol=0.02)
        np.testing.assert_allclose(r["pose graph"].numpy(), r["pose graph unsharded"].numpy(), atol=0.02)
        for got, whole, want in zip(r["bundle adjustment"], r["bundle adjustment unsharded"], jax_zp):
            np.testing.assert_allclose(got.numpy(), want, atol=5e-3)
            np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=5e-3)
