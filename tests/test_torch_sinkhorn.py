"""Port's Sinkhorn (plain loop, CPU), dustbin assembly and match
extraction vs the JAX package's `fused_log_sinkhorn` (interpret mode),
`log_sinkhorn` scan and `log_optimal_transport` /
`extract_matches_from_transport`.

f32 on both sides with the same max-shifted logsumexp; the sums run in
another order, so 1e-5 (the JAX package's own Pallas-vs-scan tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ops.pallas.sinkhorn import fused_log_sinkhorn
from image_matching_tpu.ops.sinkhorn import (
    extract_matches_from_transport as jax_extract,
    log_optimal_transport as jax_lot,
    log_sinkhorn as jax_log_sinkhorn,
)
from image_matching_tpu_torch.ops.sinkhorn import (
    extract_matches_from_transport,
    log_optimal_transport,
    log_sinkhorn,
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
