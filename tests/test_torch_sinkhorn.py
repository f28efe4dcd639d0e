"""Port's Sinkhorn (plain loop, CPU), dustbin assembly and match
extraction vs the JAX package's `fused_log_sinkhorn` (interpret mode),
`log_sinkhorn` scan and `log_optimal_transport` /
`extract_matches_from_transport`.

f32 on both sides with the same max-shifted logsumexp; the sums run in
another order, so 1e-5 (the JAX package's own Pallas-vs-scan tolerance).
"""
import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ops.pallas import sinkhorn as pallas_sinkhorn
from image_matching_tpu.ops.pallas.sinkhorn import fused_log_sinkhorn
from image_matching_tpu.ops.sinkhorn import (
    extract_matches_from_transport as jax_extract,
    log_optimal_transport as jax_lot,
    log_sinkhorn as jax_log_sinkhorn,
)
from image_matching_tpu_torch.ops.sinkhorn import (
    BIG_NEG,
    ROW_MULTIPLE,
    extract_matches_from_transport,
    log_optimal_transport,
    log_sinkhorn,
    log_sinkhorn_plain,
    sinkhorn_route,
)


def _problem(b=2, m=37, n=53, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(b, m, n)).astype(np.float32)
    log_mu = np.log(rng.dirichlet(np.ones(m), b)).astype(np.float32)
    log_nu = np.log(rng.dirichlet(np.ones(n), b)).astype(np.float32)
    return z, log_mu, log_nu


@pytest.mark.parametrize("m,n,iters", [(37, 53, 20), (64, 128, 30)])
def test_plain_matches_pallas_and_scan(m, n, iters):
    z, mu, nu = _problem(m=m, n=n, seed=m)
    got = log_sinkhorn(*map(torch.from_numpy, (z, mu, nu)), iters).numpy()
    pallas = np.asarray(fused_log_sinkhorn(*map(jnp.asarray, (z, mu, nu)), iters=iters, interpret=True))
    scan = np.asarray(jax_log_sinkhorn(*map(jnp.asarray, (z, mu, nu)), iters))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, scan, rtol=1e-5, atol=1e-5)


def _masked_scores(seed, b=2, m=30, n=41):
    rng = np.random.default_rng(seed)
    scores = rng.normal(0, 3, (b, m, n)).astype(np.float32)
    mask0 = rng.uniform(size=(b, m)) < 0.8
    mask1 = rng.uniform(size=(b, n)) < 0.8
    return scores, mask0, mask1


@pytest.mark.parametrize("masked", [False, True])
def test_log_optimal_transport_matches_scan(masked):
    scores, mask0, mask1 = _masked_scores(seed=7)
    if not masked:
        mask0, mask1 = None, None
    conv = lambda f, a: None if a is None else f(a)
    got = log_optimal_transport(torch.from_numpy(scores), torch.tensor(1.3), 25,
                                conv(torch.from_numpy, mask0), conv(torch.from_numpy, mask1)).numpy()
    ref = np.asarray(jax_lot(jnp.asarray(scores), jnp.asarray(1.3), 25,
                             conv(jnp.asarray, mask0), conv(jnp.asarray, mask1), impl="scan"))
    assert got.shape == (2, 31, 42)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_extract_matches_identical():
    scores, mask0, mask1 = _masked_scores(seed=9)
    z = np.array(jax_lot(jnp.asarray(scores), jnp.asarray(1.0), 50,
                           jnp.asarray(mask0), jnp.asarray(mask1), impl="scan"))
    ref = jax_extract(jnp.asarray(z), 0.05, jnp.asarray(mask0), jnp.asarray(mask1))
    got = extract_matches_from_transport(torch.from_numpy(z), 0.05, torch.from_numpy(mask0),
                                         torch.from_numpy(mask1))
    for g, r in zip(got[:2], ref[:2]):  # matches: exact
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert g.dtype == torch.int32
    assert (got[0] >= 0).sum() > 0
    for g, r in zip(got[2:], ref[2:]):  # scores: exp of the same f32 values
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


def _main_path_problem(b=2, k=1024, seed=3):
    """The main path's Sinkhorn input: (b, k+1, k+1) with dustbins, masked
    rows and columns (one of each wholly masked) as `log_optimal_transport`
    builds them."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(0, 3, (b, k, k)).astype(np.float32)
    mask0 = rng.uniform(size=(b, k)) < 0.9
    mask1 = rng.uniform(size=(b, k)) < 0.9
    mask0[:, 0] = False
    mask1[:, 1] = False
    return scores, mask0, mask1


def test_plain_and_lot_match_pallas_at_the_main_path_shape():
    """(2, 1025, 1025) x 30 with masked rows and columns: the port's plain
    loop and its `log_optimal_transport` against JAX's `fused_log_sinkhorn`
    (interpret mode) and its `log_optimal_transport(impl="pallas")` (the
    same kernel).
    Masked entries sit near BIG_NEG, where an f32 step is 64: they are held
    to being masked on both sides, the rest to 1e-4."""
    scores, mask0, mask1 = _main_path_problem()
    got = log_optimal_transport(torch.from_numpy(scores), torch.tensor(1.3), 30,
                                torch.from_numpy(mask0), torch.from_numpy(mask1)).numpy()
    # JAX's impl="pallas" imports the kernel at call time: give it interpret mode, as on the CPU it must
    interpreted = functools.partial(pallas_sinkhorn.fused_log_sinkhorn, interpret=True)
    with mock.patch.object(pallas_sinkhorn, "fused_log_sinkhorn", interpreted):
        ref = np.asarray(jax_lot(jnp.asarray(scores), jnp.asarray(1.3), 30, jnp.asarray(mask0),
                                 jnp.asarray(mask1), impl="pallas"))
    assert got.shape == ref.shape == (2, 1025, 1025)
    real = (got > -1e8) & (ref > -1e8)
    np.testing.assert_array_equal(got > -1e8, ref > -1e8)
    assert np.abs(got - ref)[real].max() <= 1e-4

    # the loop alone on the same coupling, through the Pallas kernel in interpret mode
    b, m, n = 2, 1025, 1025
    rng = np.random.default_rng(4)
    z = rng.normal(0, 3, (b, m, n)).astype(np.float32)
    mu = np.full((b, m), -np.log(m + n - 2), np.float32)
    nu = np.full((b, n), -np.log(m + n - 2), np.float32)
    z[:, 0, :] = BIG_NEG
    mu[:, 0] = BIG_NEG
    z[:, :, 1] = BIG_NEG
    nu[:, 1] = BIG_NEG
    got = log_sinkhorn_plain(*map(torch.from_numpy, (z, mu, nu)), 30).numpy()
    ref = np.asarray(fused_log_sinkhorn(*map(jnp.asarray, (z, mu, nu)), iters=30, interpret=True))
    real = (got > -1e8) & (ref > -1e8)
    np.testing.assert_array_equal(got > -1e8, ref > -1e8)
    assert np.abs(got - ref)[real].max() <= 1e-4


H100 = dict(sms=132, smem_per_block=232448)  # SMs, cudaDevAttrMaxSharedMemoryPerBlockOptin


# (b, M+1, N+1), expected route, rows a block, blocks per element
ROUTES = [
    ((4, 1025, 1025), "resident", 32, 33),   # the headline: 33 bands of 32 rows, 132 blocks
    ((1, 1025, 1025), "resident", 8, 129),   # the banked model
    ((4, 1201, 1201), "resident", 40, 31),   # the CLI's default 1200 keypoints
    ((4, 1320, 1320), "resident", 40, 33),   # the largest resident square at batch 4
    ((4, 1321, 1321), "streamed", 16, 83),   # one more row: 48-row bands no longer fit
    ((2, 2049, 2049), "streamed", 16, 129),  # 2048 keypoints
    ((2, 37, 53), "resident", 8, 5),         # ragged, rows rounded up to 8
    ((200, 10, 10), "streamed", 16, 1),      # more batch elements than SMs
]


@pytest.mark.parametrize("shape,name,rows,bands", ROUTES)
def test_sinkhorn_route_cutoff(shape, name, rows, bands):
    b, mr, nc = shape
    route = sinkhorn_route(b, mr, nc, **H100)
    assert (route.name, route.rows, route.bands) == (name, rows, bands)
    assert route.smem == 4096 + 4 * (rows * nc + 2 * rows + nc) <= H100["smem_per_block"]
    assert (bands - 1) * rows < mr <= bands * rows
    assert route.rows % ROW_MULTIPLE == 0
    if name == "resident":
        assert b * bands <= H100["sms"]  # one block an SM: all resident at once
        assert route.launches(30) == 1
    else:
        assert route.launches(30) == 61


def test_sinkhorn_route_follows_the_card():
    # fewer SMs (an H100 PCIe's 114) give more rows a block; less shared
    # memory a block moves the headline to the streamed route
    assert sinkhorn_route(4, 1025, 1025, sms=114, smem_per_block=232448)[:3] == ("resident", 40, 26)
    assert sinkhorn_route(4, 1025, 1025, sms=132, smem_per_block=101376).name == "streamed"
    with pytest.raises(ValueError, match="does not fit"):
        sinkhorn_route(1, 8, 70000, **H100)
