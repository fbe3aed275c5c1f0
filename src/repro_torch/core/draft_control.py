"""Multi-access draft control (paper Sec. IV and V).

Implements:
  * Theorem 1 — closed-form optimal uniform draft length via Lambert W-1.
  * Proposition 1 — closed-form heterogeneous draft lengths via Lambert W0.
  * Algorithm 1 — joint (phi, lambda) grid search for problem (P2).
  * Baseline controllers (Fixed BW&L, Uni-BW, Homo-Multi-SPIN, P2P, Cen-SPIN)
    used in benchmarks for Figs. 6-8.

The controller runs on the host at the start of every Multi-SPIN round (paper
Fig. 2, step 1), so it is implemented in float64 numpy; all routines also
accept jnp via ``xp`` for vmapped parameter sweeps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import hete_solve
from repro_torch.obs import trace
from .bandwidth import solve_equalized_phi, solve_equalized_theta, uniform_bandwidth
from .goodput import (
    expected_accepted_tokens,
    goodput_from_equalized_latency,
    goodput_homogeneous,
)
from .lambertw import lambert_w0, lambert_wm1


# ---------------------------------------------------------------------------
# Theorem 1: uniform draft-length control
# ---------------------------------------------------------------------------

def optimal_uniform_length(alpha, theta, T_ver, L_max: int | None = None, xp=np):
    """Closed-form optimal uniform draft length (paper Theorem 1, eq. 22-23).

    Returns (L_star, L_tilde): the integer optimum and the continuous
    relaxation.  When T_ver/theta <= (1-alpha)/(alpha |ln alpha|) the goodput
    is decreasing and L* = 1.
    """
    alpha = xp.asarray(alpha, dtype=np.float64 if xp is np else None)
    theta = xp.asarray(theta, dtype=np.float64 if xp is np else None)
    t = T_ver / theta
    ln_a = xp.log(alpha)
    interior = t > (1.0 - alpha) / (alpha * xp.abs(ln_a))

    # eq. 23:  L~* = -ln(-W_{-1}(-alpha^(t-1)/e)) / ln(alpha) - 1
    arg = -(alpha ** (t - 1.0)) / xp.e
    arg = xp.clip(arg, -np.exp(-1.0), -1e-300)  # numerical guard at branch point
    w = lambert_wm1(arg, xp=xp)
    L_tilde = -xp.log(-w) / ln_a - 1.0
    L_tilde = xp.where(interior, L_tilde, 1.0)

    lo = xp.maximum(xp.floor(L_tilde), 1.0)
    hi = lo + 1.0
    if L_max is not None:
        lo = xp.minimum(lo, float(L_max))
        hi = xp.minimum(hi, float(L_max))
    g_lo = _tau_uniform(alpha, lo, theta, T_ver, xp)
    g_hi = _tau_uniform(alpha, hi, theta, T_ver, xp)
    L_star = xp.where(interior, xp.where(g_hi > g_lo, hi, lo), 1.0)
    return L_star, L_tilde


def _tau_uniform(alpha, L, theta, T_ver, xp):
    """Goodput of one device under uniform length (K factors out of argmax)."""
    return goodput_homogeneous(alpha, L, theta, T_ver, K=1, xp=xp)


# ---------------------------------------------------------------------------
# Proposition 1: heterogeneous draft lengths for given (phi, lambda)
# ---------------------------------------------------------------------------

def heterogeneous_lengths(phi, lam, alphas, T_S, r, Q_tok, xp=np):
    """Closed-form continuous draft lengths (paper Proposition 1, eq. 33).

    L~_k = phi/T_k^S + (2/ln a_k) W0( a_k^(-phi/(2 T_k^S)) / (2 T_k^S)
             * sqrt( lam Q_tok phi |ln a_k| (1-a_k) / (r_k a_k) ) )
    """
    alphas = xp.asarray(alphas, dtype=np.float64 if xp is np else None)
    T_S = xp.asarray(T_S, dtype=np.float64 if xp is np else None)
    r = xp.asarray(r, dtype=np.float64 if xp is np else None)
    ln_a = xp.log(alphas)
    # a^(-phi/(2T)) can overflow float64 for tiny alpha / large phi; compute in
    # log space and clamp.
    log_pref = (-phi / (2.0 * T_S)) * ln_a - xp.log(2.0 * T_S)
    log_sqrt = 0.5 * xp.log(lam * Q_tok * phi * xp.abs(ln_a) * (1.0 - alphas)
                            / (r * alphas))
    log_w_arg = xp.clip(log_pref + log_sqrt, -700.0, 700.0)
    w = lambert_w0(xp.exp(log_w_arg), xp=xp)
    return phi / T_S + (2.0 / ln_a) * w


def round_lengths(L_tilde, L_max: int, xp=np):
    """Rounding rule of eq. 32, clipped into the admissible range [1, L_max]."""
    return xp.clip(xp.round(L_tilde), 1.0, float(L_max))


# ---------------------------------------------------------------------------
# Algorithm 1: joint multi-access draft control for (P2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DraftControlSolution:
    """Controller output for one Multi-SPIN round."""

    lengths: np.ndarray           # integer draft lengths L_k*
    bandwidth: np.ndarray         # B_k* [Hz]
    goodput: float                # predicted sum goodput [tokens/s]
    equalized_latency: float      # phi* (or L* theta* in the uniform regime)
    meta: dict


def search_grids(alphas, T_S, r, Q_tok, B, L_max: int,
                 n_phi: int = 40, n_lam: int = 40):
    """Bounded search grids for (phi, lambda) (paper Appendix F)."""
    T_S = np.asarray(T_S, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    alphas = np.asarray(alphas, dtype=np.float64)
    phi_lo = np.max(T_S + Q_tok / (B * r))
    phi_hi = np.max(L_max * (T_S + len(T_S) * Q_tok / (B * r)))
    ln_a = np.log(alphas)
    lam_lo = 1e-9
    lam_hi = np.max(r * (phi_hi - T_S) ** 2 / (Q_tok * phi_hi)
                    * (-ln_a) / (1.0 - alphas) * alphas ** 2)
    phis = np.geomspace(phi_lo * (1 + 1e-9), phi_hi, n_phi)
    lams = np.geomspace(lam_lo, max(lam_hi, lam_lo * 10), n_lam)
    return phis, lams


def solve_heterogeneous(alphas, T_S, r, Q_tok, B, T_ver, L_max: int = 25,
                        n_phi: int = 40, n_lam: int = 40) -> DraftControlSolution:
    """Algorithm 1: grid search over (phi, lambda), closed-form inner steps.

    Vectorized over the whole grid: for every candidate pair we compute the
    Proposition-1 lengths, re-equalize phi via Lemma 3 (eq. 28 root), and
    evaluate the eq. 29 goodput; the best feasible candidate wins.  The port
    runs the inner steps through ``hete_solve``: W0 stops each element at
    convergence, and Lemma 3 is solved once per distinct length vector, with
    the reference's choice, bandwidth and latency, bit for bit.
    """
    alphas = np.asarray(alphas, dtype=np.float64)
    T_S = np.asarray(T_S, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)

    with trace.span("cell.plan_lengths", cat="cell") as sp:
        phis, lams = search_grids(alphas, T_S, r, Q_tok, B, L_max, n_phi, n_lam)
        PH, LM = np.meshgrid(phis, lams, indexing="ij")
        grid = np.stack([PH.ravel(), LM.ravel()], axis=-1)  # (G, 2)

        # Proposition 1 lengths for every grid point: (G, K)
        L_tilde, iters = hete_solve.proposition1_lengths(
            grid[:, :1], grid[:, 1:2], alphas[None, :], T_S[None, :],
            r[None, :], Q_tok)
        L_int = round_lengths(np.nan_to_num(L_tilde, nan=1.0), L_max)
        sp.set(iters=iters)

    with trace.span("cell.plan_equalize", cat="cell") as sp:
        # Lemma 3 re-equalization, eq. 29 goodput and argmax (Alg. 1, step 4)
        best, root, rows = hete_solve.best_grid_point(
            alphas, L_int, T_S, r, Q_tok, B, T_ver, L_max)
        L_best = L_int[best].astype(np.int64)
        if 0.0 < root < np.inf:
            phi_best, B_best = hete_solve.equalized_phi(L_best, T_S, r, Q_tok,
                                                        B, root)
        else:               # no root to replay the halvings against
            phi_best, B_best = solve_equalized_phi(L_best, T_S, r, Q_tok, B)
        tau = float(goodput_from_equalized_latency(alphas, L_best, phi_best,
                                                   T_ver))
        sp.set(grid=len(L_int), rows=rows)
    return DraftControlSolution(
        lengths=L_best,
        bandwidth=np.asarray(B_best),
        goodput=tau if np.isfinite(tau) else -np.inf,
        equalized_latency=float(phi_best),
        meta={"phi_grid": phis, "lam_grid": lams, "grid_best": grid[best],
              "scheme": "hete-multi-spin"},
    )


# ---------------------------------------------------------------------------
# Homogeneous controller (Sec. IV) and benchmark baselines (Sec. VI-A4)
# ---------------------------------------------------------------------------

def solve_homogeneous(alpha_eff, alphas, T_S, r, Q_tok, B, T_ver,
                      L_max: int = 25) -> DraftControlSolution:
    """Optimal uniform-length control: Lemma 1 bandwidth + Theorem 1 length.

    ``alpha_eff`` is the common acceptance rate used by the controller (the
    paper's uniform regime); the realized goodput is evaluated with the true
    per-device ``alphas``.
    """
    alphas = np.asarray(alphas, dtype=np.float64)
    theta, B_star = solve_equalized_theta(T_S, r, Q_tok, B)
    L_star, _ = optimal_uniform_length(alpha_eff, theta, T_ver, L_max=L_max)
    L = np.full(len(alphas), int(L_star), dtype=np.int64)
    tau = float(np.sum(expected_accepted_tokens(alphas, L))
                / (int(L_star) * float(theta) + T_ver))
    return DraftControlSolution(
        lengths=L, bandwidth=np.asarray(B_star), goodput=tau,
        equalized_latency=float(L_star * theta),
        meta={"theta_star": float(theta), "scheme": "homo-multi-spin"},
    )


def solve_homogeneous_exhaustive(alphas, T_S, r, Q_tok, B, T_ver,
                                 L_max: int = 25) -> DraftControlSolution:
    """Homo-Multi-SPIN baseline: exhaustive search over uniform L with
    Lemma-1-optimal bandwidth (paper Sec. VI-A4), vectorized over the whole
    L grid."""
    alphas = np.asarray(alphas, dtype=np.float64)
    theta, B_star = solve_equalized_theta(T_S, r, Q_tok, B)
    Ls = np.arange(1, L_max + 1, dtype=np.float64)
    n_acc = np.sum(expected_accepted_tokens(alphas[None, :], Ls[:, None]),
                   axis=-1)
    taus = n_acc / (Ls * float(theta) + T_ver)
    best = int(np.argmax(taus))
    L = np.full(len(alphas), int(Ls[best]), dtype=np.int64)
    return DraftControlSolution(
        lengths=L, bandwidth=np.asarray(B_star), goodput=float(taus[best]),
        equalized_latency=float(Ls[best] * theta),
        meta={"theta_star": float(theta), "scheme": "homo-multi-spin"},
    )


def solve_uniform_bandwidth(alphas, T_S, r, Q_tok, B, T_ver,
                            L_max: int = 25, n_phi: int = 200) -> DraftControlSolution:
    """Uni-BW Multi-SPIN baseline: heterogeneous lengths under B_k = B/K.

    With fixed bandwidth the per-device per-token latency c_k is constant, so
    for a target round latency phi the optimal lengths are
    L_k = floor(phi / c_k) (goodput numerator is increasing in each L_k); a 1-D
    sweep over phi recovers the optimum of (P2.1a) under uniform bandwidth.
    """
    alphas = np.asarray(alphas, dtype=np.float64)
    K = len(alphas)
    B_k = uniform_bandwidth(B, K)
    c = np.asarray(T_S) + Q_tok / (B_k * np.asarray(r))
    phi_lo, phi_hi = np.min(c), L_max * np.max(c)
    phis = np.linspace(phi_lo, phi_hi, n_phi)
    L_grid = np.clip(np.floor(phis[:, None] / c[None, :]), 1.0, L_max)  # (n_phi, K)
    t_ma = np.max(L_grid * c[None, :], axis=-1)
    taus = np.sum(expected_accepted_tokens(alphas[None, :], L_grid), axis=-1) / (t_ma + T_ver)
    best = int(np.argmax(taus))
    return DraftControlSolution(
        lengths=L_grid[best].astype(np.int64), bandwidth=B_k,
        goodput=float(taus[best]), equalized_latency=float(t_ma[best]),
        meta={"scheme": "uni-bw-multi-spin"},
    )


def solve_fixed(alphas, T_S, r, Q_tok, B, T_ver, L_fixed: int = 8) -> DraftControlSolution:
    """Fixed BW&L baseline: L_k = L_fixed, B_k = B/K (paper Sec. VI-A4)."""
    alphas = np.asarray(alphas, dtype=np.float64)
    K = len(alphas)
    B_k = uniform_bandwidth(B, K)
    c = np.asarray(T_S) + Q_tok / (B_k * np.asarray(r))
    L = np.full(K, L_fixed, dtype=np.int64)
    t_ma = float(np.max(L * c))
    tau = float(np.sum(expected_accepted_tokens(alphas, L)) / (t_ma + T_ver))
    return DraftControlSolution(lengths=L, bandwidth=B_k, goodput=tau,
                                equalized_latency=t_ma,
                                meta={"scheme": "fixed-bw-l"})


def solve_p2p(alpha, T_S, r, Q_tok, B, T_ver_single, L_max: int = 25) -> DraftControlSolution:
    """P2P-SPIN baseline: one device, full bandwidth, exhaustive L."""
    c = float(T_S) + Q_tok / (B * float(r))
    Ls = np.arange(1, L_max + 1, dtype=np.float64)
    taus = expected_accepted_tokens(float(alpha), Ls) / (Ls * c + T_ver_single)
    best = int(np.argmax(taus))
    return DraftControlSolution(
        lengths=np.array([int(Ls[best])], dtype=np.int64),
        bandwidth=np.array([B]), goodput=float(taus[best]),
        equalized_latency=float(Ls[best] * c), meta={"scheme": "p2p-spin"},
    )


def solve_centralized(alphas, T_ver, T_draft_fix, T_draft_lin,
                      L_max: int = 25) -> DraftControlSolution:
    """Cen-SPIN baseline: server drafts AND verifies for all K prompts.

    Server-side drafting is a batched SLM forward per token with the same
    affine batch-latency law as verification: per drafted token the server
    spends T_draft_fix + K*T_draft_lin; no uplink is involved.
    """
    alphas = np.asarray(alphas, dtype=np.float64)
    K = len(alphas)
    per_tok = T_draft_fix + K * T_draft_lin
    Ls = np.arange(1, L_max + 1, dtype=np.float64)
    n_acc = np.sum(expected_accepted_tokens(alphas[None, :], Ls[:, None]),
                   axis=-1)
    taus = n_acc / (Ls * per_tok + T_ver)
    best = int(np.argmax(taus))
    return DraftControlSolution(
        lengths=np.full(K, int(Ls[best]), dtype=np.int64),
        bandwidth=np.zeros(K), goodput=float(taus[best]),
        equalized_latency=float(Ls[best] * per_tok), meta={"scheme": "cen-spin"},
    )
