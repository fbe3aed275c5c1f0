"""Server-side speculative verification (paper Sec. II-A2, eq. 4-5).

Exact speculative sampling [Leviathan et al. 2023]: each drafted token is
accepted with probability min(1, p_L/p_S); the first rejected position is
replaced by a sample from the calibrated residual normalize(max(p_L - p_S,
0)); full acceptance earns one bonus token from the LLM distribution.

The engine's J=1 path verifies sparse uplink-compressed SLM rows
(top-|V^hat| values + indices, Sec. II-B) with the fused
``ops.fused_verify_sample``; the dense ``q_dense`` branch and
``verify_tree`` (multi-draft token trees, J > 1) run
``ops.gather_softmax_prob`` and ``ops.residual_sample``.  ``verify_tree``
implements the ``multidraft`` scheme's MAX-OF-J acceptance law on purpose,
as the JAX package does (J = 1 stays bit-exact).  Randomness is an input:
the accept uniforms, the residual uniforms and the bonus Gumbel noise come
from the caller (``core.draws.RoundDraws`` / ``TreeDraws``).
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


@dataclasses.dataclass
class TreeVerifyResult(VerifyResult):
    """Outcome of one batched TREE verification round (multi-draft).

    Same commit surface as ``VerifyResult`` (``accept_counts`` /
    ``output_tokens`` / ``output_len`` refer to the LONGEST accepted
    root-to-leaf path), except ``accept_mask`` is per NODE (B, W) — the
    Bernoulli outcome of every tree node's accept test — and ``winner``
    names the draft whose path was committed.
    """

    winner: torch.Tensor = None        # (B,) int32 winning draft index
    node_valid: torch.Tensor = None    # (B, W) bool live-node mask


def sparse_to_dense(idx: torch.Tensor, val: torch.Tensor,
                    vocab: int) -> torch.Tensor:
    """Scatter top-|V^hat| (idx, val) rows into dense (.., V) distributions
    (duplicate indices add up)."""
    out = torch.zeros(idx.shape[:-1] + (vocab,), dtype=val.dtype,
                      device=val.device)
    return out.scatter_add_(-1, idx.long(), val)


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
                  q_dense: torch.Tensor | None = None,    # (B, L, V) dense SLM
                  ) -> VerifyResult:
    """Batched verification of K drafts in one pass (paper protocol step 4).

    ``target_logits[:, l]`` must condition on the prefix + draft tokens < l
    (one ``forward_window`` call).  Rows are zero-padded to L = max L_k and
    ``draft_len`` marks each row's true length; padded positions are never
    accepted.  The bonus token is ``argmax(logits + bonus_gumbel)``, the
    Gumbel-max form of a categorical draw.

    Sparse SLM rows (``q_idx`` / ``q_val``, the engine path) run the accept
    test, prefix count and calibrated token as ONE fused dispatch; dense
    rows (``q_dense``, the co-located path) run ``ops.gather_softmax_prob``
    for p_L and ``ops.residual_sample`` for the calibrated token.
    """
    B, L = draft_tokens.shape
    dev = draft_tokens.device
    if q_dense is None:
        accept, n_acc, calibrated = kops.fused_verify_sample(
            target_logits, draft_tokens, draft_probs, q_idx, q_val, u_accept,
            u_resid, draft_len)
    else:
        V = target_logits.shape[-1]
        # p_L(x_l) for every drafted position — fused softmax + gather
        flat_logits = target_logits[:, :L].reshape(B * L, V).float()
        p_target = kops.gather_softmax_prob(
            flat_logits.contiguous(),
            draft_tokens.reshape(B * L).to(torch.int32).contiguous()
        ).reshape(B, L)
        ratio = p_target / torch.clamp(draft_probs.float(), min=1e-30)
        accept = u_accept < torch.clamp(ratio, max=1.0)          # eq. 4
        if draft_len is not None:
            accept = accept & (torch.arange(L, device=dev)[None, :]
                               < draft_len.long()[:, None])
        prefix_ok = torch.cumprod(accept.to(torch.int32), dim=-1)
        n_acc = prefix_ok.sum(dim=-1)                            # first-rej index

        # --- calibrated residual sample at the first rejection (eq. 5) ---
        sel = torch.clamp(n_acc, max=L - 1).long()
        rows = torch.arange(B, device=dev)
        p_rej = torch.softmax(target_logits[rows, sel].float(), dim=-1)
        q_rej = q_dense[rows, sel].float()
        calibrated = kops.residual_sample(p_rej.contiguous(),
                                          q_rej.contiguous(),
                                          u_resid.float().contiguous())
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


def verify_tree(tree_tokens: torch.Tensor,     # (B, W) node tokens
                tree_parents: torch.Tensor,    # (B, W) parent (-1 root, -2 dead)
                tree_depth: torch.Tensor,      # (B, W) 1-based depth (0 dead)
                tree_probs: torch.Tensor,      # (B, W) p_S of each node token
                paths: torch.Tensor,           # (B, J, L) node idx per position
                target_logits: torch.Tensor,   # (B, W+1, V) tree-window logits
                q_idx: torch.Tensor,           # (B, W, Vhat) sparse SLM dists
                q_val: torch.Tensor,
                draft_len: torch.Tensor,       # (B,) true L_k <= L
                u_accept: torch.Tensor,        # (B, W) accept uniforms
                u_resid: torch.Tensor,         # (B,) residual uniforms
                bonus_gumbel: torch.Tensor,    # (B, V) bonus Gumbel noise
                ) -> TreeVerifyResult:
    """Batched token-tree verification (multi-draft protocol step 4).

    ``target_logits`` must come from ONE ancestor-masked window pass over
    [pending, node_0, ...]: the logits at a node's PARENT slot condition on
    exactly the root-to-parent path, so every node runs the standard accept
    test (eq. 4) in parallel (``ops.gather_softmax_prob`` over all nodes).
    The committed output is the LONGEST accepted root-to-leaf path (ties ->
    first draft), closed by the calibrated residual token at its first
    rejection (eq. 5, ``ops.residual_sample``) or a bonus token on full
    acceptance.

    At J = 1 (every tree a chain) this takes the draws of ``verify_drafts``
    in the same places and commits bit-identical tokens.  At J > 1 it is
    deliberately the scheme's MAX-OF-J law, not exact multi-draft
    speculative sampling: each node runs the unmodified min(1, p_L/p_S)
    test, so the committed per-position distribution tilts toward
    draft-supported tokens — the acceptance model the ``multidraft``
    goodput analysis and ``SyntheticBackend`` assume, ported as it is.
    """
    B, W = tree_tokens.shape
    V = target_logits.shape[-1]
    J, L = paths.shape[1], paths.shape[2]
    dev = target_logits.device
    rows = torch.arange(B, device=dev)

    # p_L(token_i | path to parent): logits at each node's parent slot
    # (root parent = pending at slot 0; node i sits at slot i + 1)
    parent_slot = torch.where(tree_parents >= 0, tree_parents.long() + 1,
                              torch.zeros((), dtype=torch.long, device=dev))
    logits_par = target_logits.gather(
        1, parent_slot[:, :, None].expand(B, W, V))              # (B, W, V)
    p_target = kops.gather_softmax_prob(
        logits_par.reshape(B * W, V).float().contiguous(),
        tree_tokens.reshape(B * W).to(torch.int32).contiguous()
    ).reshape(B, W)

    ratio = p_target / torch.clamp(tree_probs.float(), min=1e-30)
    dl = draft_len.long()
    valid = (tree_depth >= 1) & (tree_depth.long() <= dl[:, None])
    accept = (u_accept < torch.clamp(ratio, max=1.0)) & valid  # per NODE

    # per-path acceptance: shared prefixes share their nodes' outcomes
    safe_paths = paths.long().clamp(min=0).reshape(B, J * L)
    acc_path = accept.to(torch.int32).gather(1, safe_paths).reshape(B, J, L)
    acc_path = torch.where(paths >= 0, acc_path, torch.zeros_like(acc_path))
    n_path = torch.cumprod(acc_path, dim=-1).sum(dim=-1)        # (B, J)
    n_acc = n_path.max(dim=-1).values
    winner = torch.argmax(n_path, dim=-1).to(torch.int32)      # first max

    path_w = paths.long().gather(
        1, winner.long()[:, None, None].expand(B, 1, L))[:, 0]  # (B, L)

    # --- calibrated residual at the winner's first rejected node (eq. 5) ---
    sel = torch.clamp(n_acc, max=L - 1).long()
    rej_node = path_w.gather(1, sel[:, None])[:, 0].clamp(min=0)
    rej_slot = parent_slot.gather(1, rej_node[:, None])[:, 0]
    p_rej = torch.softmax(target_logits[rows, rej_slot].float(), dim=-1)
    q_rej = sparse_to_dense(q_idx[rows, rej_node], q_val[rows, rej_node].float(),
                            V)
    calibrated = kops.residual_sample(p_rej.contiguous(), q_rej.contiguous(),
                                      u_resid.float().contiguous())

    # --- bonus token when the winner's whole draft is accepted ---
    last = torch.clamp(dl - 1, min=0)
    last_node = path_w.gather(1, last[:, None])[:, 0]
    bonus_slot = last_node.clamp(min=0) + 1
    logits_bonus = target_logits[rows, bonus_slot].float()
    bonus = torch.argmax(logits_bonus + bonus_gumbel, dim=-1).to(torch.int32)

    full_accept = n_acc >= dl
    extra = torch.where(full_accept, bonus, calibrated)

    # --- assemble outputs: winner path[:n] + extra at position n ---
    path_tokens = tree_tokens.to(torch.int32).gather(1, path_w.clamp(min=0))
    pos = torch.arange(L + 1, device=dev)[None, :]
    n_col = n_acc[:, None]
    padded_path = F.pad(path_tokens, (0, 1))
    out = torch.where(pos < n_col, padded_path,
                      torch.where(pos == n_col, extra[:, None],
                                  torch.zeros((), dtype=torch.int32,
                                              device=dev)))
    return TreeVerifyResult(accept_counts=n_acc.to(torch.int32),
                            output_tokens=out.to(torch.int32),
                            output_len=(n_acc + 1).to(torch.int32),
                            accept_mask=accept,
                            winner=winner,
                            node_valid=valid)
