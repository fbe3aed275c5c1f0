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

``KeyedDraws`` serves an engine that derives its randomness per dispatch
rather than per round (the continuous engine): each half of a round — the
draft noise, or the verification draws — is addressed by a key path.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

_TINY = torch.finfo(torch.float32).tiny


def _uniform(gen: torch.Generator, device, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device)


def _gumbel(gen: torch.Generator, device, *shape) -> torch.Tensor:
    u = torch.clamp(_uniform(gen, device, *shape), min=_TINY)
    return -torch.log(-torch.log(u))


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
        return TreeDraws(draft_gumbel=_gumbel(gen, device, J, L, B, vhat),
                         u_accept=_uniform(gen, device, B, J * L),
                         u_resid=_uniform(gen, device, B),
                         bonus_gumbel=_gumbel(gen, device, B, V))

    @staticmethod
    def from_round(draws: RoundDraws) -> "TreeDraws":
        """The J = 1 tree round that consumes a sequential round's draws in
        the same places (and so commits the same tokens)."""
        return TreeDraws(draft_gumbel=draws.draft_gumbel[None],
                         u_accept=draws.u_accept, u_resid=draws.u_resid,
                         bonus_gumbel=draws.bonus_gumbel)


class KeyedDraws:
    """A round's draws in two halves, each addressed by a key path.

    A path is ``(root, step, ...)``: ``root`` an integer seed, each step
    ``("fold", i)`` (fold a counter in) or ``("split", h)`` (half ``h`` of
    a two-way split) — the derivation a JAX engine applies to its PRNG key,
    written down instead of computed.  ``draft(path, L, n, vhat)`` is the
    (L, n, vhat) Gumbel noise of L draft steps; ``verify(path, n, L, V)``
    is ``(u_accept (n, L), u_resid (n,), bonus_gumbel (n, V))``.

    Here each half comes from a ``torch.Generator`` on ``device`` seeded
    by a hash of its path.  A caller that must match another
    implementation's stream overrides both methods (the parity tests
    replay the JAX package's keys this way)."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def _generator(self, path) -> torch.Generator:
        digest = hashlib.blake2b(repr(tuple(path)).encode(), digest_size=8)
        seed = int.from_bytes(digest.digest(), "little") & (2 ** 63 - 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def draft(self, path, L: int, n: int, vhat: int) -> torch.Tensor:
        return _gumbel(self._generator(path), self.device, L, n, vhat)

    def verify(self, path, n: int, L: int, V: int):
        gen, dev = self._generator(path), self.device
        return (_uniform(gen, dev, n, L), _uniform(gen, dev, n),
                _gumbel(gen, dev, n, V))
