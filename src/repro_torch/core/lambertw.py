"""Lambert W function (principal ``W0`` and lower ``W-1`` branches).

The paper's closed-form draft-length solutions (Theorem 1, eq. 23 and
Proposition 1, eq. 33) are expressed through the Lambert W function.  scipy is
not a guaranteed dependency of the deployment environment, so we implement W
ourselves with a branch-aware initial guess followed by Halley iterations
(cubic convergence; a fixed iteration count keeps the routine jit-compatible).

Both branches are implemented against a pluggable array namespace ``xp`` so the
same code serves the float64 numpy controller path and jnp-traced graphs.
"""

from __future__ import annotations

import numpy as np

_INV_E = -np.exp(-1.0)

_HALLEY_ITERS = 24


def _halley(xp, w, x, iters: int = _HALLEY_ITERS):
    """Halley iterations for w*exp(w) = x, branch-agnostic."""
    for _ in range(iters):
        ew = xp.exp(w)
        f = w * ew - x
        # Halley update: w -= f / (ew*(w+1) - (w+2)*f/(2w+2)).
        # Guard the w = -1 branch point (both inner divisions degenerate).
        two_w = xp.where(xp.abs(2.0 * w + 2.0) < 1e-30, 1e-30, 2.0 * w + 2.0)
        denom = ew * (w + 1.0) - (w + 2.0) * f / two_w
        denom = xp.where(xp.abs(denom) < 1e-300, 1e-300, denom)
        w = w - f / denom
    return w


def lambert_w0(x, xp=np):
    """Principal branch W0(x) for x >= -1/e.

    Accurate to ~1e-12 (float64) across the domain; returns NaN below -1/e.
    """
    x = xp.asarray(x)
    x = x * xp.ones_like(x)  # materialize scalars
    # Initial guesses per region.
    # Near branch point: series W ~ -1 + p - p^2/3 with p = sqrt(2(e x + 1)).
    p = xp.sqrt(xp.maximum(2.0 * (xp.e * x + 1.0), 0.0))
    w_branch = -1.0 + p - p * p / 3.0 + 11.0 / 72.0 * p * p * p
    # Moderate |x|: W0(x) ~ log(1+x) is within ~15% on [-0.25, 3), plenty for
    # Halley.  Log asymptotics only for genuinely large x (lnln x well-defined).
    safe_x = xp.maximum(x, 3.0)
    lx = xp.log(safe_x)
    llx = xp.log(lx)
    w_log = lx - llx + llx / lx
    w_mid = xp.log1p(xp.maximum(x, -0.999))
    w0 = xp.where(x < -0.25, w_branch, xp.where(x < 3.0, w_mid, w_log))
    w = _halley(xp, w0, x)
    return xp.where(x < _INV_E - 1e-12, xp.nan, w)


def lambert_wm1(x, xp=np):
    """Lower branch W-1(x) for -1/e <= x < 0.

    Returns NaN outside the branch domain.
    """
    x = xp.asarray(x)
    x = x * xp.ones_like(x)
    # Near branch point: series with p = -sqrt(2(e x + 1)) (negative root).
    p = -xp.sqrt(xp.maximum(2.0 * (xp.e * x + 1.0), 0.0))
    w_branch = -1.0 + p - p * p / 3.0 + 11.0 / 72.0 * p * p * p
    # Asymptotic for x -> 0-:  W-1(x) ~ ln(-x) - ln(-ln(-x)).
    nx = xp.minimum(x, -1e-300)
    l1 = xp.minimum(xp.log(-nx), -1e-10)  # valid domain has log(-x) < -1
    l2 = xp.log(xp.maximum(-l1, 1e-300))
    w_asym = l1 - l2 + l2 / l1
    w0 = xp.where(x < -0.27, w_branch, w_asym)
    w = _halley(xp, w0, x)
    bad = (x < _INV_E - 1e-12) | (x >= 0.0)
    return xp.where(bad, xp.nan, w)
