"""The random draws of one speculative round, as tensors.

The port never reproduces jax's PRNG: every sampling step takes its
randomness as an input.  ``RoundDraws`` bundles what one J=1 ``spin_round``
consumes — Gumbel noise for each draft step's categorical draw, the accept
and residual uniforms of verification, and Gumbel noise for the bonus
token.  ``TreeDraws`` is the same for a multi-draft tree round: J runs of
draft-step noise and one accept uniform per tree node (W = J * L).  A
categorical draw is ``argmax(logits + gumbel)``.

``sample`` draws them from a ``torch.Generator`` seeded with one integer
(what ``EngineBackend`` does each round); a caller that must match another
implementation's stream builds the tensors itself.
"""

from __future__ import annotations

import dataclasses

import torch

_TINY = torch.finfo(torch.float32).tiny


class _Draws:
    def to(self, device):
        return type(self)(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


@dataclasses.dataclass
class RoundDraws(_Draws):
    draft_gumbel: torch.Tensor    # (L, B, vhat) one draw per draft step
    u_accept: torch.Tensor        # (B, L) accept-test uniforms
    u_resid: torch.Tensor         # (B,) residual-sample uniforms
    bonus_gumbel: torch.Tensor    # (B, V) bonus-token Gumbel noise

    @staticmethod
    def sample(seed: int, B: int, L: int, vhat: int, V: int,
               device="cuda") -> "RoundDraws":
        """The J = 1 tree round's draws without the J axis (the same
        values, drawn in the same order)."""
        t = TreeDraws.sample(seed, B, 1, L, vhat, V, device=device)
        return RoundDraws(draft_gumbel=t.draft_gumbel[0], u_accept=t.u_accept,
                          u_resid=t.u_resid, bonus_gumbel=t.bonus_gumbel)


@dataclasses.dataclass
class TreeDraws(_Draws):
    draft_gumbel: torch.Tensor    # (J, L, B, vhat) run j's draft-step noise
    u_accept: torch.Tensor        # (B, J * L) one accept uniform per node
    u_resid: torch.Tensor         # (B,) residual-sample uniforms
    bonus_gumbel: torch.Tensor    # (B, V) bonus-token Gumbel noise

    @property
    def J(self) -> int:
        return int(self.draft_gumbel.shape[0])

    @staticmethod
    def sample(seed: int, B: int, J: int, L: int, vhat: int, V: int,
               device="cuda") -> "TreeDraws":
        gen = torch.Generator(device=device).manual_seed(int(seed))

        def uniform(*shape):
            return torch.rand(shape, generator=gen, device=device)

        def gumbel(*shape):
            u = torch.clamp(uniform(*shape), min=_TINY)
            return -torch.log(-torch.log(u))

        return TreeDraws(draft_gumbel=gumbel(J, L, B, vhat),
                         u_accept=uniform(B, J * L), u_resid=uniform(B),
                         bonus_gumbel=gumbel(B, V))

    @staticmethod
    def from_round(draws: RoundDraws) -> "TreeDraws":
        """The J = 1 tree round that consumes a sequential round's draws in
        the same places (and so commits the same tokens)."""
        return TreeDraws(draft_gumbel=draws.draft_gumbel[None],
                         u_accept=draws.u_accept, u_resid=draws.u_resid,
                         bonus_gumbel=draws.bonus_gumbel)
