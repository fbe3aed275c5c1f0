"""Device-side draft generation (paper Sec. II-A1, protocol step 2).

The SLM drafts autoregressively; each step's distribution is truncated to
the top-|V^hat| tokens and renormalized — the device samples from exactly
the distribution it uploads (eq. 9 payload), which keeps server-side
verification exact under uplink compression.  Each draw is the Gumbel-max
form of a categorical sample, ``argmax(log(val) + gumbel)``, with the noise
supplied by the caller (``core.draws.RoundDraws.draft_gumbel``).
"""

from __future__ import annotations

import dataclasses

import torch

from .verification import truncate_renormalize


@dataclasses.dataclass
class DraftResult:
    """One round of drafting for a batch of B device streams.

    tokens: (B, L) int32 sampled draft tokens.
    probs:  (B, L) probability of each sampled token under the (truncated)
            SLM distribution — the p_S of eq. 4.
    q_idx / q_val: (B, L, Vhat) the uploaded sparse SLM distributions.
    cache:  SLM cache after processing [pending, d_1 .. d_L].
    """

    tokens: torch.Tensor
    probs: torch.Tensor
    q_idx: torch.Tensor
    q_val: torch.Tensor
    cache: object


@dataclasses.dataclass
class DraftForest:
    """J i.i.d. drafting runs per stream (the ``multidraft`` scheme's
    device-side step).  Axes: (B, J, L[, Vhat]); ``cache`` is the SLM cache
    after the LAST run — every run re-draws from the same committed prefix,
    so run j's window writes fully shadow run j-1's.

    ``windows`` (with ``keep_windows=True``) snapshots every run's window
    K/V — cache-leaf name -> (Ln, B, J, L, KV, D), the K/V written at
    positions [pos + 1, pos + L] by run j (position ``pos`` holds the
    pending token, identical across runs).  The engine's scatter-commit
    selects the winning run's rows from here instead of re-forwarding the
    accepted path through the draft model.
    """

    tokens: torch.Tensor
    probs: torch.Tensor
    q_idx: torch.Tensor
    q_val: torch.Tensor
    cache: object
    windows: dict | None = None


def generate_draft_forest(model, params, cache, pending: torch.Tensor,
                          pos: torch.Tensor, L: int, J: int,
                          gumbel: torch.Tensor, vhat: int,
                          temperature: float = 1.0,
                          keep_windows: bool = False) -> DraftForest:
    """Draft J independent length-L runs per stream.

    ``gumbel`` (J, L, B, vhat): run j's draft-step noise (the reference
    draws run 0 from the round's draft key, exactly as ``generate_drafts``
    does, and run j > 0 from that key folded with j).  Each run starts from
    the same committed prefix: its window writes land at cache positions
    [pos, pos + L], past every valid position, so runs never see each other
    and the last run's writes are the only survivors.  ``keep_windows=True``
    snapshots each run's window K/V right after the run (the cache keeps
    only the LAST run's), so the engine can scatter-commit the accepted
    branch without a repair forward.
    """
    from repro_torch.models.layers import gather_kv_window

    if tuple(gumbel.shape[:2]) != (J, L):
        raise ValueError(f"forest gumbel {tuple(gumbel.shape)} != "
                         f"(J={J}, L={L}, B, vhat)")
    tokens, probs, q_idx, q_val = [], [], [], []
    snaps: list[dict] = []
    if keep_windows:
        win_pos = (pos[:, None].long() + 1
                   + torch.arange(L, device=pos.device)[None, :])  # (B, L)
        page_table = cache.get("pages")
    for j in range(J):
        res = generate_drafts(model, params, cache, pending, pos, L,
                              gumbel[j], vhat=vhat, temperature=temperature)
        cache = res.cache
        tokens.append(res.tokens)
        probs.append(res.probs)
        q_idx.append(res.q_idx)
        q_val.append(res.q_val)
        if keep_windows:
            snaps.append({leaf: gather_kv_window(cache[leaf], win_pos,
                                                 page_table=page_table)
                          for leaf in cache if leaf != "pages"})
    windows = None
    if keep_windows:
        windows = {leaf: torch.stack([s[leaf] for s in snaps], dim=2)
                   for leaf in snaps[0]}                # (Ln, B, J, L, KV, D)
    return DraftForest(tokens=torch.stack(tokens, dim=1),
                       probs=torch.stack(probs, dim=1),
                       q_idx=torch.stack(q_idx, dim=1),
                       q_val=torch.stack(q_val, dim=1),
                       cache=cache,
                       windows=windows)


def generate_drafts(model, params, cache, pending: torch.Tensor,
                    pos: torch.Tensor, L: int, gumbel: torch.Tensor,
                    vhat: int, temperature: float = 1.0) -> DraftResult:
    """Draft L tokens per stream.

    pending: (B,) the last committed token not yet in the SLM cache.
    pos:     (B,) SLM cache fill levels (tokens already processed).
    gumbel:  (L, B, vhat) Gumbel noise, one (B, vhat) draw per step.
    """
    if tuple(gumbel.shape) != (L, pending.shape[0], vhat):
        raise ValueError(f"draft gumbel {tuple(gumbel.shape)} != "
                         f"(L={L}, B={pending.shape[0]}, vhat={vhat})")
    toks = pending
    out_tokens, out_probs, out_idx, out_val = [], [], [], []
    for t in range(L):
        logits, cache = model.forward_window(params, toks[:, None], cache,
                                             pos + t)
        probs = torch.softmax(logits[:, 0].float() / temperature, dim=-1)
        idx, val = truncate_renormalize(probs, vhat)
        j = torch.argmax(torch.log(torch.clamp(val, min=1e-30)) + gumbel[t],
                         dim=-1)                                 # (B,)
        toks = idx.gather(1, j[:, None])[:, 0]
        p_tok = val.gather(1, j[:, None])[:, 0]
        out_tokens.append(toks)
        out_probs.append(p_tok)
        out_idx.append(idx)
        out_val.append(val)
    # Write d_L into the cache (logits discarded): on full acceptance the
    # committed prefix includes d_L, and without this step the SLM cache
    # would have a hole at its position.
    _, cache = model.forward_window(params, toks[:, None], cache, pos + L)
    return DraftResult(
        tokens=torch.stack(out_tokens, dim=1),
        probs=torch.stack(out_probs, dim=1),
        q_idx=torch.stack(out_idx, dim=1),
        q_val=torch.stack(out_val, dim=1),
        cache=cache,
    )
