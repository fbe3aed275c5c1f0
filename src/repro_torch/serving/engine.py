"""Single-model serving engine (non-speculative baseline).

The port of ``repro.serving.engine``: plain autoregressive decoding of B
streams on one model, the vanilla-AR baseline and the decode-path
workload.  ``start`` prefills a contiguous cache (``ops.flash_attention``
on every attention layer); each ``decode_step`` is one T = 1
``forward_window`` (``ops.decode_attention`` on every attention layer)
and one host fetch of the new tokens.

Randomness is an input, as in the rest of the port: a sampled step takes
Gumbel noise (B, V) and picks ``argmax(logits / temperature + noise)``,
which is how ``jax.random.categorical`` samples, so replaying the
reference's Gumbel draws replays its tokens.  ``temperature=0`` is argmax.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model


@dataclasses.dataclass
class EngineState:
    pending: torch.Tensor    # (B,) last committed token not yet in cache
    pos: torch.Tensor        # (B,) cache fill level
    committed: list          # python-side committed token lists (B)


def gumbel_noise(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` float32 on ``gen``'s device:
    -log(E) with E ~ Exp(1)."""
    e = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return -e.exponential_(generator=gen).log()


class ServingEngine:
    """Plain decoding of B streams through a contiguous KV cache.  Tensors
    live on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, max_len: int = 512,
                 cache_dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_model(cfg, device=self.device)
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.params = None
        self.cache = None
        self.host_syncs = 0

    def init_params(self, gen: torch.Generator | int = 0):
        """Random weights from a seeded ``torch.Generator`` (or a seed) on
        the engine's device."""
        self.params = self.model.init(gen)
        return self.params

    def load_params(self, tree):
        """Carry a JAX-package ``init`` pytree (numpy leaves) across."""
        self.params = params_from_jax(self.cfg, tree, device=self.device)
        return self.params

    def start(self, prompts) -> EngineState:
        """Prefill the prompts (B, M) but their last token, which becomes
        the pending token."""
        prompts = torch.as_tensor(prompts, device=self.device)
        B, M = prompts.shape
        self.cache = self.model.init_cache(B, self.max_len, self.cache_dtype)
        _, self.cache, _ = self.model.prefill(self.params, prompts[:, :-1],
                                              self.cache)
        host = prompts.cpu().numpy()
        return EngineState(
            pending=prompts[:, -1].to(torch.int32).contiguous(),
            pos=torch.full((B,), M - 1, dtype=torch.int32, device=self.device),
            committed=[list(host[b]) for b in range(B)])

    def decode_step(self, state: EngineState, noise: torch.Tensor | None = None,
                    temperature: float = 1.0):
        """One autoregressive token per stream: argmax at temperature 0,
        else ``argmax(logits / temperature + noise)`` with ``noise`` (B, V)
        Gumbel draws.  One host fetch, to append the tokens."""
        logits, self.cache = self.model.forward_window(
            self.params, state.pending[:, None], self.cache, state.pos)
        if temperature == 0:
            nxt = logits[:, 0].argmax(-1).to(torch.int32)
        else:
            if noise is None:
                raise ValueError("a sampled step needs its Gumbel noise (B, V)")
            nxt = (logits[:, 0].float() / temperature
                   + noise.to(self.device)).argmax(-1).to(torch.int32)
        out = nxt.cpu().numpy()
        self.host_syncs += 1
        for b in range(len(out)):
            state.committed[b].append(int(out[b]))
        return EngineState(pending=nxt, pos=state.pos + 1,
                           committed=state.committed), nxt

    def generate(self, prompts, n_tokens: int,
                 noise: torch.Generator | torch.Tensor | None = None,
                 temperature: float = 1.0) -> list:
        """``start`` then ``n_tokens`` decode steps.  ``noise`` is a
        ``torch.Generator`` the steps draw their Gumbel noise from, or the
        (n_tokens, B, V) draws themselves; greedy (``temperature=0``) needs
        none."""
        state = self.start(prompts)
        B, V = len(state.committed), self.cfg.vocab_size
        for t in range(n_tokens):
            step_noise = None
            if temperature != 0:
                step_noise = (gumbel_noise(noise, (B, V))
                              if isinstance(noise, torch.Generator)
                              else noise[t])
            state, _ = self.decode_step(state, step_noise, temperature)
        return state.committed
