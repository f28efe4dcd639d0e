"""Preconditioned conjugate gradients — the port's counterpart of
`jax.scipy.sparse.linalg.cg`, which the JAX package's pose-graph and
bundle-adjustment solvers call.

JAX's loop (`jax/_src/scipy/sparse/linalg.py`, `_cg_solve`) runs while
||r||^2 > max(tol^2 ||b||^2, atol^2) and fewer than `maxiter` iterations
have run, testing before each iteration. Here the loop always runs
`maxiter` iterations on the device, and a done mask freezes x, r, gamma
and p once the rule fails: the same result, without a host read an
iteration. (At the solvers' tol of 1e-10 and 1e-12 in float32, JAX's loop
almost always runs all `maxiter` iterations anyway.)
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def _vdot(a, b):
    return (a * b).sum()


def cg(matvec: Callable, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0, maxiter: Optional[int] = None,
       M: Optional[Callable] = None):
    """Solve A x = b for a symmetric positive definite A given as
    `matvec`, preconditioned by `M` (a function, identity by default).
    Returns x, shaped as b."""
    x = torch.zeros_like(b) if x0 is None else x0
    if maxiter is None:
        maxiter = 10 * b.numel()  # scipy's default
    if M is None:
        M = lambda v: v  # noqa: E731
    atol2 = torch.clamp_min(tol * tol * _vdot(b, b), atol * atol)
    r = b - matvec(x)
    p = z = M(r)
    gamma = _vdot(r, z)
    active = _vdot(r, r) > atol2
    for _ in range(maxiter):
        ap = matvec(p)
        alpha = gamma / _vdot(p, ap)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z_new = M(r_new)
        gamma_new = _vdot(r_new, z_new)
        p_new = z_new + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
        active = active & (_vdot(r, r) > atol2)
    return x
