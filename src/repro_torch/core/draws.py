"""The random draws of one J=1 speculative round, as tensors.

The port never reproduces jax's PRNG: every sampling step takes its
randomness as an input.  ``RoundDraws`` bundles what one ``spin_round``
consumes — Gumbel noise for each draft step's categorical draw, the accept
and residual uniforms of verification, and Gumbel noise for the bonus
token.  A categorical draw is ``argmax(logits + gumbel)``.

``RoundDraws.sample`` draws them from a ``torch.Generator`` seeded with one
integer (what ``EngineBackend`` does each round); a caller that must match
another implementation's stream builds the tensors itself.
"""

from __future__ import annotations

import dataclasses

import torch

_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass
class RoundDraws:
    draft_gumbel: torch.Tensor    # (L, B, vhat) one draw per draft step
    u_accept: torch.Tensor        # (B, L) accept-test uniforms
    u_resid: torch.Tensor         # (B,) residual-sample uniforms
    bonus_gumbel: torch.Tensor    # (B, V) bonus-token Gumbel noise

    @staticmethod
    def sample(seed: int, B: int, L: int, vhat: int, V: int,
               device="cuda") -> "RoundDraws":
        gen = torch.Generator(device=device).manual_seed(int(seed))

        def uniform(*shape):
            return torch.rand(shape, generator=gen, device=device)

        def gumbel(*shape):
            u = torch.clamp(uniform(*shape), min=_TINY)
            return -torch.log(-torch.log(u))

        return RoundDraws(draft_gumbel=gumbel(L, B, vhat),
                          u_accept=uniform(B, L), u_resid=uniform(B),
                          bonus_gumbel=gumbel(B, V))

    def to(self, device) -> "RoundDraws":
        return RoundDraws(*(t.to(device) for t in dataclasses.astuple(self)))
