"""Server-side speculative verification (paper Sec. II-A2, eq. 4-5).

Exact speculative sampling [Leviathan et al. 2023]: each drafted token is
accepted with probability min(1, p_L/p_S); the first rejected position is
replaced by a sample from the calibrated residual normalize(max(p_L - p_S,
0)); full acceptance earns one bonus token from the LLM distribution.

The port covers the engine's J=1 path: sparse uplink-compressed SLM rows
(top-|V^hat| values + indices, Sec. II-B) verified by the fused
``ops.fused_verify_sample``.  The dense ``q_dense`` branch and
``verify_tree`` (J > 1) are not ported yet (ROADMAP A7).  Randomness is an
input: the accept uniforms, the residual uniforms and the bonus Gumbel
noise come from the caller (``core.draws.RoundDraws``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


@dataclasses.dataclass
class VerifyResult:
    """Outcome of one batched verification round.

    accept_counts: (B,) int32 — n_k in [0, L_k]: accepted draft tokens.
    output_tokens: (B, L+1) int32 — accepted tokens + calibrated/bonus token
        at position n_k; positions > n_k are padding (0).
    output_len:    (B,) int32 — n_k + 1 (paper: N_k, includes the extra token).
    accept_mask:   (B, L) bool — per-position Bernoulli outcomes A_{k,l}.
    """

    accept_counts: torch.Tensor
    output_tokens: torch.Tensor
    output_len: torch.Tensor
    accept_mask: torch.Tensor


def truncate_renormalize(probs: torch.Tensor, k: int):
    """Top-k truncation + renormalization of draft distributions (paper Sec.
    II-B uplink compression).  Returns (idx (.., k) int32, val (.., k))."""
    val, idx = torch.topk(probs, k, dim=-1)
    val = val / val.sum(dim=-1, keepdim=True)
    return idx.to(torch.int32), val


def verify_drafts(draft_tokens: torch.Tensor,     # (B, L) int32
                  draft_probs: torch.Tensor,      # (B, L) p_S of each token
                  target_logits: torch.Tensor,    # (B, L+1, V) LLM logits
                  q_idx: torch.Tensor,            # (B, L, Vhat) sparse form
                  q_val: torch.Tensor,
                  u_accept: torch.Tensor,         # (B, L) accept uniforms
                  u_resid: torch.Tensor,          # (B,) residual uniforms
                  bonus_gumbel: torch.Tensor,     # (B, V) bonus Gumbel noise
                  draft_len: torch.Tensor | None = None,  # (B,) true L_k <= L
                  ) -> VerifyResult:
    """Batched verification of K drafts in one pass (paper protocol step 4).

    ``target_logits[:, l]`` must condition on the prefix + draft tokens < l
    (one ``forward_window`` call).  Rows are zero-padded to L = max L_k and
    ``draft_len`` marks each row's true length; padded positions are never
    accepted.  The bonus token is ``argmax(logits + bonus_gumbel)``, the
    Gumbel-max form of a categorical draw.
    """
    B, L = draft_tokens.shape
    dev = draft_tokens.device
    accept, n_acc, calibrated = kops.fused_verify_sample(
        target_logits, draft_tokens, draft_probs, q_idx, q_val, u_accept,
        u_resid, draft_len)
    n_acc = n_acc.long()

    # --- bonus token when the whole draft is accepted ---
    true_len = (draft_len.long() if draft_len is not None
                else torch.full((B,), L, dtype=torch.long, device=dev))
    rows = torch.arange(B, device=dev)
    logits_bonus = target_logits[rows, true_len].float()
    bonus = torch.argmax(logits_bonus + bonus_gumbel, dim=-1).to(torch.int32)

    full_accept = n_acc >= true_len
    extra = torch.where(full_accept, bonus, calibrated)

    # --- assemble outputs: draft[:n] + extra at position n ---
    pos = torch.arange(L + 1, device=dev)[None, :]
    n_col = n_acc[:, None]
    padded_draft = F.pad(draft_tokens.to(torch.int32), (0, 1))
    out = torch.where(pos < n_col, padded_draft,
                      torch.where(pos == n_col, extra[:, None],
                                  torch.zeros((), dtype=torch.int32,
                                              device=dev)))
    return VerifyResult(accept_counts=n_acc.to(torch.int32),
                        output_tokens=out.to(torch.int32),
                        output_len=(n_acc + 1).to(torch.int32),
                        accept_mask=accept)
