"""Analytic goodput model of Multi-SPIN (paper Sec. II-C and III-B).

All formulas are namespace-generic (numpy for the float64 controller path,
jnp inside jit-traced experiment sweeps).

Notation (paper):
    alpha_k  token acceptance rate of device k            (eq. 10)
    L_k      draft length of device k
    T_k^S    per-token SLM inference latency of device k  (eq. 2)
    r_k      uplink spectrum efficiency [bit/s/Hz]         (eq. 8)
    B_k      allocated bandwidth [Hz]
    Q_tok    per-token uplink payload [bits]               (eq. 9)
    T_ver    batched verification latency                  (eq. 7)
"""

from __future__ import annotations

import numpy as np


def expected_accepted_tokens(alpha, L, xp=np):
    """E[N_k | L_k] = (1 - alpha^(L+1)) / (1 - alpha)   (paper eq. 12).

    Includes the bonus token sampled from the LLM when the whole draft is
    accepted.  Handles alpha -> 1 (limit is L + 1) and alpha -> 0 (limit 1).
    """
    alpha = xp.asarray(alpha, dtype=xp.float64 if xp is np else None)
    L = xp.asarray(L)
    near_one = xp.abs(1.0 - alpha) < 1e-12
    safe = xp.where(near_one, 0.5, alpha)
    val = (1.0 - safe ** (L + 1.0)) / (1.0 - safe)
    return xp.where(near_one, L + 1.0, val)


def verification_latency(K, t_fix, t_lin):
    """T_ver(K) = T_fix + K * T_lin   (paper eq. 7)."""
    return t_fix + K * t_lin


def per_token_upload_latency(Q_tok, B_k, r_k):
    """Q_tok / (B_k r_k): uplink seconds per drafted token (from eq. 9)."""
    return Q_tok / (B_k * r_k)


def per_token_ma_latency(T_S, Q_tok, B_k, r_k):
    """T_k^S + Q_tok/(B_k r_k): per-token draft+upload latency of device k."""
    return T_S + per_token_upload_latency(Q_tok, B_k, r_k)


def multi_access_latency(L, T_S, Q_tok, B, r, xp=np):
    """T^ma = max_k L_k (T_k^S + Q_tok/(B_k r_k))   (paper eq. 25).

    With scalar ``L`` this specializes to the homogeneous eq. 15.
    """
    L = xp.asarray(L)
    per_tok = per_token_ma_latency(xp.asarray(T_S), Q_tok, xp.asarray(B), xp.asarray(r))
    return xp.max(L * per_tok, axis=-1)


def goodput_homogeneous(alpha, L, theta, T_ver, K, xp=np):
    """Sum goodput under uniform draft length (paper eq. 17 / 18).

    theta is the per-token multi-access latency of the slowest device
    (theta^* after Lemma-1 equalization).
    """
    n_acc = expected_accepted_tokens(alpha, L, xp=xp)
    return K * n_acc / (xp.asarray(L) * theta + T_ver)


def goodput_heterogeneous(alphas, Ls, T_S, Q_tok, B, r, T_ver, xp=np):
    """Sum goodput with per-device draft lengths (paper eq. 26)."""
    n_acc = expected_accepted_tokens(xp.asarray(alphas), xp.asarray(Ls), xp=xp)
    t_ma = multi_access_latency(Ls, T_S, Q_tok, B, r, xp=xp)
    return xp.sum(n_acc, axis=-1) / (t_ma + T_ver)


def goodput_from_equalized_latency(alphas, Ls, phi, T_ver, xp=np):
    """Sum goodput when Lemma 3 has equalized every device latency to phi
    (paper eq. 29)."""
    n_acc = expected_accepted_tokens(xp.asarray(alphas), xp.asarray(Ls), xp=xp)
    return xp.sum(n_acc, axis=-1) / (phi + T_ver)
