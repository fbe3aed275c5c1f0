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
