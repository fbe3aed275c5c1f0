"""Beyond-paper goodput optimizations (§Perf / DESIGN.md §3).

The paper's verification-latency model T_ver = T_fix + K*T_lin is
draft-length-agnostic (its footnote 1), and its round is fully synchronous
(T_e2e = T_ma + T_ver).  Two standard serving-systems ideas transfer:

1. **Packed ragged verification** — zero-padding heterogeneous drafts to
   (K, L_max+1) wastes verification compute on pad tokens.  Under the
   token-budget refinement T_ver = T_fix + c_tok * (total window tokens),
   packing the K windows into one ragged batch (block-diagonal attention —
   the flash kernel path supports it via per-row lengths) replaces
   K*(L_max+1) tokens with sum_k (L_k+1).  The heterogeneous-length
   optimizer is re-solved under the packed objective: longer drafts no
   longer inflate other devices' verification cost, which shifts L* upward
   for high-alpha devices.

2. **Pipelined half-batch rounds** — split the K devices into two
   half-cells that alternate: while half A drafts+uploads, half B verifies.
   After pipeline fill, the round period is max(T_ma(K/2), T_ver(K/2))
   instead of T_ma(K) + T_ver(K).  Exactness is untouched (each half runs
   the unmodified protocol); only the schedule changes.

Both are evaluated with the same closed-form machinery as the paper's
optimizer so gains are apples-to-apples (benchmarks/bench_beyond.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .bandwidth import solve_equalized_phi, solve_equalized_theta
from .draft_control import (
    DraftControlSolution,
    heterogeneous_lengths,
    round_lengths,
    search_grids,
)
from .goodput import expected_accepted_tokens


@dataclasses.dataclass(frozen=True)
class TokenBudgetVerifier:
    """Two-part verification cost: per-sequence + per-window-token.

        T_ver = T_fix + K * c_seq + c_tok * (total window tokens)

    The per-sequence term c_seq models the length-AGNOSTIC work (reading the
    device's whole KV cache / prefix state — the memory-bound bulk of batched
    verification, and the reason the paper's length-agnostic T_lin is a good
    model); c_tok models the pad-sensitive per-token compute.  Calibrated
    against the paper's affine model at a reference draft length with a
    kv_fraction split:  T_lin = c_seq + c_tok * (L_ref + 1).
    """

    t_fix: float
    c_seq: float
    c_tok: float

    @classmethod
    def from_affine(cls, t_fix: float, t_lin: float, L_ref: int = 8,
                    kv_fraction: float = 0.7):
        return cls(t_fix=t_fix, c_seq=t_lin * kv_fraction,
                   c_tok=t_lin * (1 - kv_fraction) / (L_ref + 1))

    def padded(self, K: int, L_max):
        """Zero-padded batch cost; ``L_max`` may carry batch dimensions."""
        return self.t_fix + self.c_seq * K + self.c_tok * K * (L_max + 1.0)

    def packed(self, lengths: np.ndarray) -> float:
        K = len(lengths)
        return (self.t_fix + self.c_seq * K
                + self.c_tok * float(np.sum(np.asarray(lengths) + 1.0)))


def solve_heterogeneous_packed(alphas, T_S, r, Q_tok, B,
                               verifier: TokenBudgetVerifier,
                               L_max: int = 25, n_phi: int = 40,
                               n_lam: int = 40) -> DraftControlSolution:
    """Algorithm-1 grid search under the PACKED token-budget objective.

    Proposition-1 lengths remain the candidate generator (they solve the
    constant-T_ver KKT system); each candidate is re-scored with the packed
    objective, so the returned solution maximizes the true packed goodput
    over the candidate set (near-optimal; exact for the paper's objective).
    """
    alphas = np.asarray(alphas, dtype=np.float64)
    T_S = np.asarray(T_S, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)

    phis, lams = search_grids(alphas, T_S, r, Q_tok, B, L_max, n_phi, n_lam)
    PH, LM = np.meshgrid(phis, lams, indexing="ij")
    grid = np.stack([PH.ravel(), LM.ravel()], axis=-1)

    L_tilde = heterogeneous_lengths(grid[:, :1], grid[:, 1:2], alphas[None, :],
                                    T_S[None, :], r[None, :], Q_tok)
    L_int = round_lengths(np.nan_to_num(L_tilde, nan=1.0), L_max)
    phi_hat, _ = solve_equalized_phi(L_int, T_S[None, :], r[None, :], Q_tok, B)

    n_acc = np.sum(expected_accepted_tokens(alphas[None, :], L_int), axis=-1)
    K = len(alphas)
    t_ver = (verifier.t_fix + verifier.c_seq * K
             + verifier.c_tok * np.sum(L_int + 1.0, axis=-1))
    tau = n_acc / (phi_hat + t_ver)
    tau = np.where(np.isfinite(tau), tau, -np.inf)

    best = int(np.argmax(tau))
    L_best = L_int[best].astype(np.int64)
    phi_best, B_best = solve_equalized_phi(L_best, T_S, r, Q_tok, B)
    return DraftControlSolution(
        lengths=L_best, bandwidth=np.asarray(B_best), goodput=float(tau[best]),
        equalized_latency=float(phi_best),
        meta={"scheme": "hete-packed", "t_ver": float(t_ver[best])},
    )


def solve_heterogeneous_padded_tokenbudget(alphas, T_S, r, Q_tok, B,
                                           verifier: TokenBudgetVerifier,
                                           L_max: int = 25, n_phi: int = 40,
                                           n_lam: int = 40) -> DraftControlSolution:
    """Same token-budget verifier but ZERO-PADDED batching (paper layout):
    T_ver charges K * (max L_k + 1) tokens.  The honest baseline for
    measuring the packing gain."""
    alphas = np.asarray(alphas, dtype=np.float64)
    T_S = np.asarray(T_S, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    K = len(alphas)

    phis, lams = search_grids(alphas, T_S, r, Q_tok, B, L_max, n_phi, n_lam)
    PH, LM = np.meshgrid(phis, lams, indexing="ij")
    grid = np.stack([PH.ravel(), LM.ravel()], axis=-1)
    L_tilde = heterogeneous_lengths(grid[:, :1], grid[:, 1:2], alphas[None, :],
                                    T_S[None, :], r[None, :], Q_tok)
    L_int = round_lengths(np.nan_to_num(L_tilde, nan=1.0), L_max)
    phi_hat, _ = solve_equalized_phi(L_int, T_S[None, :], r[None, :], Q_tok, B)
    n_acc = np.sum(expected_accepted_tokens(alphas[None, :], L_int), axis=-1)
    t_ver = verifier.padded(K, np.max(L_int, axis=-1))  # vectorized over grid
    tau = n_acc / (phi_hat + t_ver)
    tau = np.where(np.isfinite(tau), tau, -np.inf)
    best = int(np.argmax(tau))
    L_best = L_int[best].astype(np.int64)
    phi_best, B_best = solve_equalized_phi(L_best, T_S, r, Q_tok, B)
    return DraftControlSolution(
        lengths=L_best, bandwidth=np.asarray(B_best), goodput=float(tau[best]),
        equalized_latency=float(phi_best),
        # the token-budget padded cost is the scheme's OWN verification
        # model — carried in meta so executed rounds bill it instead of the
        # affine T_ver(K) (same contract as the packed solver)
        meta={"scheme": "hete-padded-tokenbudget", "t_ver": float(t_ver[best])},
    )


def pipelined_plan(scheme, obs) -> dict:
    """Two half-batch pipeline: steady-state period = max(T_ma, T_ver).

    ``scheme`` is a registered ``repro.core.schemes.Scheme`` instance and
    ``obs`` the full-cell ``CellObservation``; each half is planned on its
    sub-observation at the FULL bandwidth (the other half is in its verify
    phase while this one uploads).  Returns
    ``{goodput, period, halves: [RoundPlan]}``.
    """
    if scheme.capabilities.server_drafting:
        raise ValueError(
            f"scheme {scheme.name!r} drafts on the server (capability "
            f"'server_drafting'): a two-half pipeline would overlap the "
            f"server's own drafting with its own verification")
    alphas = np.asarray(obs.alphas, dtype=np.float64)
    idx = np.argsort(alphas)          # interleave to balance the halves
    halves = [h for h in (idx[0::2], idx[1::2]) if len(h)]
    total_tokens, plans, t_ma, t_ver = 0.0, [], [], []
    for h in halves:
        obs_h = obs.take(h)
        plan = scheme.plan(obs_h)
        total_tokens += (float(plan.expected_tokens)
                         if plan.expected_tokens is not None else
                         float(np.sum(expected_accepted_tokens(alphas[h],
                                                               plan.lengths))))
        t_ma.append(plan.equalized_latency)
        # a scheme with its own verification model reports the true t_ver
        t_ver.append(float(plan.t_ver) if plan.t_ver is not None
                     else obs_h.t_ver())
        plans.append(plan)
    if len(halves) == 1:              # K == 1: nothing to overlap with
        period = t_ma[0] + t_ver[0]
    else:
        # steady-state cycle: verify(A) overlaps draft/upload(B), vice versa
        period = (max(t_ma[0], t_ver[1]) + max(t_ma[1], t_ver[0]))
    return {"goodput": total_tokens / period, "period": float(period),
            "halves": plans}


# ---------------------------------------------------------------------------
# Multi-draft verification (paper Sec. I cites [25]: multiple drafts raise
# acceptance at higher local C2 cost — here the tradeoff is OPTIMIZED)
# ---------------------------------------------------------------------------

def expected_accepted_multidraft(alpha, L, J, xp=np):
    """E[N] when each device uploads J i.i.d. drafts of length L and the
    server keeps the longest-accepted one (SpecInfer-style tree verification
    preserves exactness).

    N = max_j n_j + 1 with n_j ~ geometric truncated at L:
    P(n_j >= l) = alpha^l  =>  E[max] = sum_{l=1..L} (1 - (1 - alpha^l)^J).
    J = 1 reduces to eq. 12.
    """
    alpha = xp.asarray(alpha, dtype=np.float64 if xp is np else None)
    ls = xp.arange(1, L + 1)
    surv = 1.0 - (1.0 - alpha[..., None] ** ls) ** J
    return xp.sum(surv, axis=-1) + 1.0


def solve_uniform_multidraft(alpha, T_S, r, Q_tok, B,
                             verifier: TokenBudgetVerifier, K: int,
                             L_max: int = 25, J_max: int = 6,
                             J_min: int = 1) -> dict:
    """Joint (L, J) optimization in the uniform regime, vectorized over the
    whole (J, L) grid.

    Per round: each device drafts J*L tokens locally (J sequential draft
    passes share the prefix KV, so drafting costs J*L*T_S), uploads J*L
    token payloads, and the server verifies K*J sequences of L+1 window
    tokens.  Returns the grid optimum and the J=1 (paper) baseline, plus
    the Lemma-1 bandwidth shares at the winning J.  ``J_min`` floors the
    searched widths (engine benchmarks pin J_min=2 to exercise the tree
    path even where the latency model prefers J*=1); the reported
    ``single_draft`` baseline is always the true J=1 optimum.
    """
    if not 1 <= J_min <= J_max:
        raise ValueError(f"need 1 <= J_min <= J_max, got "
                         f"J_min={J_min}, J_max={J_max}")
    T_S = np.asarray(T_S, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    Kd = len(T_S)
    Js = np.arange(1, J_max + 1, dtype=np.float64)
    # Equalized theta with a J-fold payload: eq. 20 with Q_tok*J is the same
    # root as eq. 20 with budget B/J (both sides scale by J), which batches
    # all J rows through one bisection.  The realized shares are then
    # B_k = J * B_k(scaled).
    theta_J, B_scaled = solve_equalized_theta(
        np.broadcast_to(T_S, (J_max, Kd)), np.broadcast_to(r, (J_max, Kd)),
        Q_tok, B / Js)

    Ls = np.arange(1, L_max + 1, dtype=np.float64)
    # E[N](J, L) = 1 + sum_{l<=L} (1 - (1 - alpha^l)^J): cumulative sum of
    # the survival terms gives every L at once.
    surv = 1.0 - (1.0 - np.float64(alpha) ** Ls[None, :]) ** Js[:, None]
    e_n = np.cumsum(surv, axis=1) + 1.0                       # (J, L)
    t_ma = Ls[None, :] * theta_J[:, None]
    t_ver = (verifier.t_fix + verifier.c_seq * K * Js[:, None]
             + verifier.c_tok * K * Js[:, None] * (Ls[None, :] + 1.0))
    tau = K * e_n / (t_ma + t_ver)

    def rec(j: int, l: int) -> dict:
        return {"goodput": float(tau[j, l]), "L": int(Ls[l]), "J": int(Js[j]),
                "E_N": float(e_n[j, l]), "t_ma": float(t_ma[j, l]),
                "t_ver": float(t_ver[j, l])}

    tau_adm = tau[J_min - 1:]                   # admissible J >= J_min
    j_adm, l_best = np.unravel_index(int(np.argmax(tau_adm)), tau_adm.shape)
    j_best = j_adm + J_min - 1
    best = rec(j_best, l_best)
    base = rec(0, int(np.argmax(tau[0])))
    return {"best": best, "single_draft": base,
            "gain": best["goodput"] / base["goodput"] - 1.0,
            "theta": float(theta_J[j_best]),
            "bandwidth": Js[j_best] * B_scaled[j_best]}
