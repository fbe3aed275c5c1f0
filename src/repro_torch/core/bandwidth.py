"""Optimal OFDMA bandwidth allocation (paper Lemmas 1 and 3).

Both lemmas reduce to a one-dimensional root of a strictly decreasing rational
function, solved here by fixed-iteration bisection (jit/vmap compatible and
exact to ~1 ulp of the bracket width after 100 halvings).
"""

from __future__ import annotations

import numpy as np

_BISECT_ITERS = 100


def _bisect_decreasing(f, lo, hi, xp=np, iters: int = _BISECT_ITERS):
    """Root of strictly-decreasing f on (lo, hi) with f(lo+)>0>f(hi-)."""
    lo = xp.asarray(lo, dtype=np.float64 if xp is np else None)
    hi = xp.asarray(hi, dtype=np.float64 if xp is np else None)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        pos = f(mid) > 0.0
        lo = xp.where(pos, mid, lo)
        hi = xp.where(pos, hi, mid)
    return 0.5 * (lo + hi)


def solve_equalized_theta(T_S, r, Q_tok, B, xp=np):
    """Lemma 1: minimal per-token multi-access latency theta*.

    Solves  sum_k Q_tok / (r_k (theta - T_k^S)) = B   over theta > max_k T_k^S
    (paper eq. 20).  Returns (theta_star, B_star) with
    B_k* = Q_tok / (r_k (theta* - T_k^S))   (paper eq. 19).

    Leading batch dimensions on ``T_S``/``r`` are supported; the device axis
    is the last one.
    """
    T_S = xp.asarray(T_S, dtype=np.float64 if xp is np else None)
    r = xp.asarray(r, dtype=np.float64 if xp is np else None)

    def excess(theta):
        return xp.sum(Q_tok / (r * (xp.expand_dims(theta, -1) - T_S)), axis=-1) - B

    t_max = xp.max(T_S, axis=-1)
    K = T_S.shape[-1]
    hi = t_max + (K * Q_tok) / (B * xp.min(r, axis=-1)) + 1.0
    lo = t_max * (1.0 + 1e-12) + 1e-15
    theta = _bisect_decreasing(excess, lo, hi, xp=xp)
    B_star = Q_tok / (r * (xp.expand_dims(theta, -1) - T_S))
    return theta, B_star


def solve_equalized_phi(L, T_S, r, Q_tok, B, xp=np):
    """Lemma 3: equalized multi-access latency phi for given draft lengths.

    Solves  sum_k Q_tok L_k / (r_k (phi - L_k T_k^S)) = B   over
    phi > max_k L_k T_k^S (paper eq. 28).  Returns (phi, B(L)) with
    B_k(L) = Q_tok L_k / (r_k (phi - L_k T_k^S))   (paper eq. 27).
    """
    L = xp.asarray(L, dtype=np.float64 if xp is np else None)
    T_S = xp.asarray(T_S, dtype=np.float64 if xp is np else None)
    r = xp.asarray(r, dtype=np.float64 if xp is np else None)

    def excess(phi):
        phi_b = xp.expand_dims(phi, -1)
        return xp.sum(Q_tok * L / (r * (phi_b - L * T_S)), axis=-1) - B

    p_max = xp.max(L * T_S, axis=-1)
    K = T_S.shape[-1]
    hi = p_max + (K * Q_tok * xp.max(L, axis=-1)) / (B * xp.min(r, axis=-1)) + 1.0
    lo = p_max * (1.0 + 1e-12) + 1e-15
    phi = _bisect_decreasing(excess, lo, hi, xp=xp)
    B_of_L = Q_tok * L / (r * (xp.expand_dims(phi, -1) - L * T_S))
    return phi, B_of_L


def uniform_bandwidth(B, K, xp=np):
    """Heterogeneity-agnostic baseline: B_k = B / K."""
    return xp.full((K,), B / K)
