"""Plain PyTorch versions of the kernels on the J=1 paged serving path.

Each function is the semantic ground truth of one hand-written CUDA kernel
in ``csrc/``: the CPU path of ``ops.py`` runs it, and the card tests hold
the kernel against it on the same inputs.  The functions mirror the JAX
package's oracles operation for operation, with one deliberate difference
noted at ``paged_attention_ref``.
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor,
                        scale: float | None = None) -> torch.Tensor:
    """Decode/window attention through a paged KV cache.

    q: (B, T, H, D) window queries (T=1 decode, T=L+1 verification).
    k_pool / v_pool: (P, ps, KV, D) physical page pools.
    page_table: (B, n_slots) int32, physical page per logical slot (-1 =
        unmapped: those positions are masked out).
    lengths: (B,) valid kv count for query row 0; query row t attends
        logical positions [0, lengths_b + t).
    Returns (B, T, H, D).

    A query row that sees no key at all (an all-(-1) table row: retired or
    padding rows) returns 0, as the attention kernels do.  The JAX oracle
    returns the mean of page 0's values there instead (a softmax over all
    -1e30); such rows are never committed.
    """
    B, T, H, D = q.shape
    P, ps, KV, _ = k_pool.shape
    n_slots = page_table.shape[1]
    S = n_slots * ps
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    safe = page_table.clamp(min=0).long()
    k = k_pool[safe].reshape(B, S, KV, D)
    v = v_pool[safe].reshape(B, S, KV, D)
    qg = q.reshape(B, T, KV, G, D)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k).float() * scale
    kpos = torch.arange(S, device=q.device)
    horizon = lengths.long()[:, None] + torch.arange(T, device=q.device)[None]
    valid = kpos[None, None, :] < horizon[:, :, None]              # (B, T, S)
    mapped = (page_table >= 0).repeat_interleave(ps, dim=1)       # (B, S)
    valid = valid & mapped[:, None, :]
    logits = torch.where(valid[:, None, None], logits,
                         torch.full((), _NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    seen = valid.any(dim=-1)[:, None, None, :, None]              # (B,1,1,T,1)
    probs = torch.where(seen, probs, torch.zeros((), device=q.device))
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
    return out.reshape(B, T, H, D)


def gather_softmax_prob_ref(logits: torch.Tensor,
                            token_ids: torch.Tensor) -> torch.Tensor:
    """logits: (N, V); token_ids: (N,) -> softmax(logits)[token] (N,)."""
    logits = logits.float()
    m = logits.max(dim=-1, keepdim=True).values
    z = torch.exp(logits - m).sum(dim=-1)
    picked = logits.gather(-1, token_ids.long()[:, None])[:, 0]
    return torch.exp(picked - m[:, 0]) / z


def residual_sample_ref(p: torch.Tensor, q: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """Sample from normalize(max(p - q, 0)) by inverse CDF.

    p, q: (N, V) probability rows; u: (N,) uniforms in [0,1) -> tokens (N,)
    int32.  argmax(p) when the residual is numerically all-zero; when
    rounding leaves ``u * Z`` at or past the last CDF value (nothing
    crosses), the count saturates at V - 1, as in the JAX oracle.
    """
    r = torch.clamp(p.float() - q.float(), min=0.0)
    z = r.sum(dim=-1, keepdim=True)
    degenerate = z[:, 0] <= 0.0
    cdf = torch.cumsum(r, dim=-1)
    target = u.float()[:, None] * z
    token = (cdf <= target).to(torch.int32).sum(dim=-1)
    token = torch.clamp(token, max=p.shape[-1] - 1)
    return torch.where(degenerate, p.argmax(dim=-1).to(torch.int32),
                       token.to(torch.int32))


def fused_verify_sample_ref(target_logits: torch.Tensor,   # (B, L+1, V)
                            draft_tokens: torch.Tensor,    # (B, L) int32
                            draft_probs: torch.Tensor,     # (B, L) p_S
                            q_idx: torch.Tensor,           # (B, L, Vhat)
                            q_val: torch.Tensor,           # (B, L, Vhat)
                            u_accept: torch.Tensor,        # (B, L)
                            u_resid: torch.Tensor,         # (B,)
                            draft_len: torch.Tensor,       # (B,) L_k <= L
                            ):
    """Accept test + prefix count + calibrated residual token.

    p_L of each drafted token, the accept test ``u < min(1, p_L/p_S)``
    masked to ``draft_len``, the prefix-acceptance count, and the residual
    sample at the first rejected position with the sparse SLM row scattered
    dense.  Returns ``(accept (B, L) bool, n_acc (B,) int32, calibrated (B,)
    int32)``; the bonus token stays outside.
    """
    B, L = draft_tokens.shape
    V = target_logits.shape[-1]
    dev = target_logits.device

    flat_logits = target_logits[:, :L].reshape(B * L, V)
    p_target = gather_softmax_prob_ref(
        flat_logits, draft_tokens.reshape(B * L)).reshape(B, L)

    ratio = p_target / torch.clamp(draft_probs.float(), min=1e-30)
    accept = u_accept.float() < torch.clamp(ratio, max=1.0)
    accept = accept & (torch.arange(L, device=dev)[None, :]
                       < draft_len.long()[:, None])
    prefix_ok = torch.cumprod(accept.to(torch.int32), dim=-1)
    n_acc = prefix_ok.sum(dim=-1)

    sel = torch.clamp(n_acc, max=L - 1).long()
    rows = torch.arange(B, device=dev)
    p_rej = torch.softmax(target_logits[rows, sel].float(), dim=-1)
    idx_rej = q_idx[rows, sel].long()
    val_rej = q_val[rows, sel].float()
    q_rej = torch.zeros(B, V, dtype=torch.float32, device=dev)
    q_rej.scatter_add_(1, idx_rej, val_rej)
    calibrated = residual_sample_ref(p_rej, q_rej, u_resid)
    return accept, n_acc.to(torch.int32), calibrated
