"""Inner steps of Algorithm 1 for the port's ``solve_heterogeneous``.

The same maths as the batched reference in ``draft_control`` (Proposition 1's
lengths, Lemma 3's equalized latency, eq. 29's goodput, the grid argmax),
done with less work:

  * Proposition 1's W0 starts within 4e-9 of the root (Winitzki's guess and
    two log-space steps) and takes Halley steps only on the elements not yet
    converged, instead of 24 steps on all of them from guesses 32% off.
  * The rounded length vectors of a (phi, lambda) grid repeat: Lemma 3's
    root is found once per distinct vector, by Newton steps on the convex,
    decreasing excess from a point at or left of the root (so they rise
    monotonically and never overshoot).  A row that does not converge falls
    back to the reference's bisection.
  * The argmax keeps the reference's choice exactly: rows whose goodput lies
    within a rounding distance of the best are re-ranked with the
    reference's own bisection, and ties go to the smallest grid index, as
    ``np.argmax`` over the whole grid resolves them.
  * The chosen row's phi and bandwidth are the reference bisection's, bit
    for bit: its halvings are replayed from its own bracket, and the excess
    is evaluated only where the root found above leaves its sign open.

Float64 numpy on the host, like the rest of the controller.
"""

from __future__ import annotations

import numpy as np

from .bandwidth import _BISECT_ITERS, solve_equalized_phi
from .goodput import goodput_from_equalized_latency

_W0_RTOL = 1e-7
_W0_ITERS = 24         # the reference's fixed Halley count, kept as the cap
_ROOT_TOL = 1e-14      # stop once |step| <= _ROOT_TOL phi
_ROOT_ITERS = 64
_TIE_RTOL = 1e-9       # far above the Newton-vs-bisection gap (~K ulp)
_SIGN_RTOL = 1e-12     # past this from the root the excess's sign is exact


def w0_of_exp(y):
    """W0(exp(y)) elementwise, and the most Halley steps any element took.

    Winitzki's guess ln(1+x) (1 - ln(1+ln(1+x)) / (2+ln(1+x))) (within 2%
    for x >= 0), two steps w <- w (1 + y - ln w) / (1 + w) (within 4e-9),
    then Halley steps for w e^w = x, scaled by e^-w, on the elements whose
    last step exceeded ``_W0_RTOL`` w.  Halley is cubic: after a step s the
    error left is about |C| s^3, |C| <= 1/2 falling to 1/12 as w grows,
    under an ulp for s <= 1e-7 w and w <= 700, so one step does.  A NaN input
    gives NaN and drops out after the first step.  For |y| <= 700, as the
    caller clips it (exp(y) stays finite).
    """
    y = np.asarray(y, dtype=np.float64)
    x = np.exp(y)
    l1 = np.log1p(x)
    w = l1 * (1.0 - np.log1p(l1) / (2.0 + l1))
    for _ in range(2):
        w = w / (1.0 + w) * (1.0 + y - np.log(w))
    out = w.reshape(-1)
    idx, xs, ws = np.arange(out.size), x.reshape(-1), out
    iters = 0
    while idx.size and iters < _W0_ITERS:
        iters += 1
        g = ws - xs * np.exp(-ws)            # (w e^w - x) / e^w
        p = ws + 1.0
        step = g / (p - (ws + 2.0) * g / (2.0 * p))
        ws = ws - step
        live = np.abs(step) > _W0_RTOL * ws  # NaN: done
        if not live.all():
            out[idx] = ws
            keep = np.flatnonzero(live)
            idx, xs, ws = idx[keep], xs[keep], ws[keep]
    out[idx] = ws
    return w, iters


def proposition1_lengths(phi, lam, alphas, T_S, r, Q_tok):
    """``draft_control.heterogeneous_lengths`` through ``w0_of_exp``: the
    continuous lengths of eq. 33, and the most W0 steps any element took."""
    ln_a = np.log(alphas)
    log_pref = (-phi / (2.0 * T_S)) * ln_a - np.log(2.0 * T_S)
    log_sqrt = 0.5 * np.log(lam * Q_tok * phi * np.abs(ln_a) * (1.0 - alphas)
                            / (r * alphas))
    w, iters = w0_of_exp(np.clip(log_pref + log_sqrt, -700.0, 700.0))
    return phi / T_S + (2.0 / ln_a) * w, iters


def distinct_rows(L_int, L_max: int):
    """Grid index of the first occurrence of each distinct row of the
    rounded lengths ``L_int`` (G, K), in ascending order."""
    if L_max > 255:
        raise ValueError(f"L_max={L_max}: length rows are deduplicated as bytes")
    L8 = np.ascontiguousarray(L_int.astype(np.uint8))
    keys = L8.view(np.dtype((np.void, L8.shape[1]))).reshape(-1)
    _, first = np.unique(keys, return_index=True)
    return np.sort(first)


def lemma3_roots(L, T_S, r, Q_tok, B, max_iter: int = _ROOT_ITERS):
    """Lemma 3's phi for each row of ``L`` (R, K): the root of
    sum_k c_k / (phi - a_k) = B with c = Q_tok L / r and a = L T_S.

    Newton from max(max_k (a_k + c_k / B), min_k a_k + sum_k c_k / B), two
    points at or left of the root; rows not converged within ``max_iter``
    steps take the reference's bisection.
    """
    L = np.asarray(L, dtype=np.float64)
    T_S = np.asarray(T_S, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    c = Q_tok * L / r
    a = L * T_S
    phi = np.maximum(np.max(a + c / B, axis=-1),
                     np.min(a, axis=-1) + np.sum(c, axis=-1) / B)
    out = np.empty(len(L))
    idx = np.arange(len(L))
    for _ in range(max_iter):
        if not idx.size:
            break
        d = phi[:, None] - a
        q = c / d
        step = (np.sum(q, axis=-1) - B) / np.sum(q / d, axis=-1)
        phi = phi + step
        live = np.abs(step) > _ROOT_TOL * phi     # NaN: out, bisected below
        if not live.all():
            out[idx] = phi
            keep = np.flatnonzero(live)
            idx, phi, c, a = idx[keep], phi[keep], c[keep], a[keep]
    out[idx] = np.nan                             # not converged: bisected
    todo = np.flatnonzero(~np.isfinite(out))
    if todo.size:
        out[todo] = solve_equalized_phi(L[todo], T_S[None, :], r[None, :],
                                        Q_tok, B)[0]
    return out


def equalized_phi(L, T_S, r, Q_tok, B, root):
    """``bandwidth.solve_equalized_phi`` of one row ``L`` (K,), bit for bit,
    given its root (finite, > 0) to within ``_SIGN_RTOL``.

    The reference's halvings are replayed from its bracket; a midpoint
    farther than ``_SIGN_RTOL`` from ``root`` takes the excess's sign from
    the side it lies on (convexity puts |excess| there above B 1e-12, a
    thousand times its rounding), the rest evaluate the reference's
    expression.
    """
    L = np.asarray(L, dtype=np.float64)
    T_S = np.asarray(T_S, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    p_max = np.max(L * T_S, axis=-1)
    K = T_S.shape[-1]
    hi = p_max + (K * Q_tok * np.max(L, axis=-1)) / (B * np.min(r, axis=-1)) + 1.0
    lo = p_max * (1.0 + 1e-12) + 1e-15
    left, right = root * (1.0 - _SIGN_RTOL), root * (1.0 + _SIGN_RTOL)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        if mid < left:
            pos = True
        elif mid > right:
            pos = False
        else:
            pos = np.sum(Q_tok * L / (r * (np.expand_dims(mid, -1) - L * T_S)),
                         axis=-1) - B > 0.0
        if pos:
            lo = mid
        else:
            hi = mid
    phi = 0.5 * (lo + hi)
    return phi, Q_tok * L / (r * (np.expand_dims(phi, -1) - L * T_S))


def _goodput(alphas, L, phi, T_ver):
    tau = goodput_from_equalized_latency(alphas[None, :], L, phi, T_ver)
    return np.where(np.isfinite(tau), tau, -np.inf)


def best_grid_point(alphas, L_int, T_S, r, Q_tok, B, T_ver, L_max: int):
    """The grid index ``np.argmax`` of the reference's eq. 29 goodput picks,
    the Lemma-3 root of its row, and the number of distinct rows solved."""
    first = distinct_rows(L_int, L_max)
    U = L_int[first]
    phi = lemma3_roots(U, T_S, r, Q_tok, B)
    tau = _goodput(alphas, U, phi, T_ver)
    top = tau.max()
    near = (np.flatnonzero(tau >= top - _TIE_RTOL * abs(top))
            if np.isfinite(top) else np.arange(len(U)))
    if near.size > 1:       # a near tie: rank it as the reference does
        phi_n, _ = solve_equalized_phi(U[near], T_S[None, :], r[None, :],
                                       Q_tok, B)
        tau = _goodput(alphas, U[near], phi_n, T_ver)
        near = near[tau == tau.max()]
    return int(first[near[0]]), float(phi[near[0]]), len(first)
