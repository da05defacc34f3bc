"""Freivalds verification against poisoning (§6, Robustness).

For a returned block C =? A @ B the PS samples random vectors r, s and checks
r^T (A (B s)) == (r^T C) s up to fp tolerance — O(n^2) work instead of
O(n^3), false-negative probability O(2^-n) over repeated trials with
fresh randomness.

This is the host-side fallback oracle: the JAX fleet executor runs the same
check as device-side batched matvecs inside the bucket launch
(``kernels.ops``) and only calls back into this function for blocks the
device-side pass flags.
"""
from __future__ import annotations

import numpy as np


def freivalds(A: np.ndarray, B: np.ndarray, C: np.ndarray,
              rng: np.random.Generator, iters: int = 2,
              rtol: float = 1e-9) -> bool:
    """True iff C passes `iters` independent Freivalds checks of C == A@B.

    The float64 upcasts are hoisted out of the iteration loop (no-ops when
    the caller already holds float64 operands), and the |r|·|C|·|s| noise
    scale collapses to Σ|C| once — sign vectors have unit magnitude — so
    each extra iteration costs exactly three matvecs."""
    m, n = A.shape
    n2, q = B.shape
    assert n == n2 and C.shape == (m, q)
    A64 = np.asarray(A, np.float64)
    B64 = np.asarray(B, np.float64)
    C64 = np.asarray(C, np.float64)
    scale = float(np.abs(C64).sum()) + 1e-30
    for _ in range(iters):
        r = rng.choice((-1.0, 1.0), size=m)
        s = rng.choice((-1.0, 1.0), size=q)
        lhs = (r @ A64) @ (B64 @ s)
        rhs = (r @ C64) @ s
        if not np.isclose(lhs, rhs, rtol=rtol, atol=rtol * scale):
            return False
    return True
