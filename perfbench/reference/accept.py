"""The accept rule's two samplers, written out plainly, and the two
readings the check takes with them.

Speculative sampling (Leviathan et al. 2023), as the engine's round uses
it: the draft uploads its distribution truncated to its top ``vhat``
tokens and renormalised; at the first rejected position the token comes
from normalize(max(p_target - q_draft, 0)) by inverse CDF with the round's
uniform u (the smallest token whose cumulative mass exceeds u); a greedy
token is the argmax of the logits.

* ``gap``: how far below the reference's best logit a token's logit lies
  (0 for the reference's own argmax).
* ``residual_miss``: how far u lies outside the reference's CDF interval
  [F(t - 1), F(t)) of the served token t, in probability mass (0 when the
  reference would have drawn t too).
"""

from __future__ import annotations

import torch


def gap(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(n,) best logit less the logit of each token, float64."""
    lg = logits.double()
    return lg.max(dim=-1).values - lg.gather(1, tokens.long()[:, None])[:, 0]


def _residual_cdf(p_logits: torch.Tensor, q_logits: torch.Tensor,
                  vhat: int) -> torch.Tensor:
    """(n, V) normalised CDF of max(p - q, 0), float64."""
    p = torch.softmax(p_logits.double(), dim=-1)
    qd = torch.softmax(q_logits.double(), dim=-1)
    val, idx = torch.topk(qd, vhat, dim=-1)
    q = torch.zeros_like(p).scatter_(1, idx, val / val.sum(-1, keepdim=True))
    r = torch.clamp(p - q, min=0.0)
    cdf = torch.cumsum(r, dim=-1)
    return cdf / cdf[:, -1:]


def residual_miss(p_logits, q_logits, vhat: int, u: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    cdf = _residual_cdf(p_logits, q_logits, vhat)
    t = tokens.long()[:, None]
    hi = cdf.gather(1, t)[:, 0]
    lo = torch.where(t[:, 0] > 0, cdf.gather(1, (t - 1).clamp(min=0))[:, 0],
                     torch.zeros_like(hi))
    u = u.double()
    return torch.clamp(lo - u, min=0.0) + torch.clamp(u - hi, min=0.0)


def residual_token(p_logits, q_logits, vhat: int,
                   u: torch.Tensor) -> torch.Tensor:
    """The token inverse-CDF sampling draws with u (V - 1 when rounding
    leaves nothing past u)."""
    cdf = _residual_cdf(p_logits, q_logits, vhat)
    t = (cdf <= u.double()[:, None]).sum(dim=-1)
    return torch.clamp(t, max=cdf.shape[-1] - 1)
