"""Dense decoder-only transformer LM on torch tensors (paged serving path).

The port of ``repro.models.transformer.DecoderLM`` for ``family="dense"``:

  * ``prefill``        — causal forward that writes the paged KV cache at
    offset 0
  * ``forward_window`` — T new tokens against the paged cache at per-row
    offsets: T=1 is a draft step, T=L+1 the speculative-verification window

Parameters keep the JAX package's names and (in, out) layouts, but the
layers are a python list of per-layer dicts instead of arrays stacked on a
leading axis; ``bridge.params_from_jax`` converts one into the other.  The
layer loop is a plain python loop (the counterpart of ``jax.lax.scan``).
Attention goes through ``ops.paged_attention``: the CUDA kernel on the
card, its plain version on the CPU.  Caches are updated in place.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig

from .layers import (
    attention_apply,
    dense_init,
    embed_init,
    init_attention,
    init_mlp,
    make_norm,
    mlp_apply,
    new_page_pool,
)

Params = Any

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def strip_view(cache: Params) -> Params:
    """Drop the ``"pages"`` page-table entry from a paged cache view,
    leaving only the pool leaves: the page allocator's device mirror owns
    the live table, and the engine never keeps a copy inside its cache."""
    if "pages" not in cache:
        return cache
    return {k: v for k, v in cache.items() if k != "pages"}


class DecoderLM:
    """Dense decoder-only LM parameterized by ``ModelConfig``.

    ``device`` is where ``init`` draws the weights and
    ``init_paged_cache`` allocates the pools (the card unless the caller
    asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.num_experts:
            raise NotImplementedError(
                "MoE stacks are not ported yet (ROADMAP A12)")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP A14)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.init_norm, self.norm = make_norm(cfg.norm)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def _init_block(self, gen: torch.Generator) -> Params:
        cfg = self.cfg
        dtype = _dtype(cfg.param_dtype)
        return {
            "ln_attn": self.init_norm(cfg.d_model, dtype, self.device),
            "attn": init_attention(gen, cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim,
                                   qkv_bias=cfg.qkv_bias, dtype=dtype),
            "ln_mlp": self.init_norm(cfg.d_model, dtype, self.device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype),
        }

    def init(self, gen: torch.Generator | int) -> Params:
        """Random weights with the JAX package's distributions
        (``layers.dense_init`` / ``embed_init``), drawn from a seeded
        ``torch.Generator`` on this model's device, in ``param_dtype``."""
        if isinstance(gen, int):
            gen = torch.Generator(device=self.device).manual_seed(gen)
        cfg = self.cfg
        dtype = _dtype(cfg.param_dtype)
        params: Params = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
            "ln_f": self.init_norm(cfg.d_model, dtype, self.device),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                           dtype)
        params["blocks"] = [self._init_block(gen)
                            for _ in range(cfg.num_layers)]
        return params

    # ------------------------------------------------------------------
    # Cache
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        raise NotImplementedError(
            "the contiguous cache layout is not ported yet (ROADMAP A2)")

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype=torch.bfloat16) -> Params:
        """Paged KV pool: every attention leaf is (layers, P, ps, KV, D)
        with NO batch axis.  Pair it with a ``"pages"`` (B, n_slots) int32
        page table to form the cache view ``prefill`` / ``forward_window``
        take."""
        cfg = self.cfg
        args = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                cfg.head_dim)
        return {"k": new_page_pool(*args, dtype=dtype, device=self.device),
                "v": new_page_pool(*args, dtype=dtype, device=self.device)}

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------

    def _stack_forward(self, params, x, positions, cache, offset):
        """Run all blocks through the paged cache; returns (hidden, cache)."""
        cfg = self.cfg
        if "pages" not in cache:
            raise NotImplementedError(
                "the contiguous cache layout is not ported yet (ROADMAP A2)")
        page_table = cache["pages"]
        for i, p in enumerate(params["blocks"]):
            h = self.norm(p["ln_attn"], x)
            attn_out, _ = attention_apply(
                p["attn"], h, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                positions=positions, rope_theta=cfg.rope_theta,
                kv_cache=(cache["k"][i], cache["v"][i]), cache_offset=offset,
                page_table=page_table)
            x = x + attn_out
            h = self.norm(p["ln_mlp"], x)
            x = x + mlp_apply(p["mlp"], h, cfg.activation)
        return x, cache

    def _embed(self, params, tokens):
        return params["embed"][tokens.long()].to(_dtype(self.cfg.compute_dtype))

    def _logits(self, params, x):
        x = self.norm(params["ln_f"], x)
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return (x @ w.to(x.dtype)).float()

    def prefill(self, params, tokens, cache, prefix_embeds=None):
        """Causal forward writing the paged KV cache at offset 0.
        tokens (B, S) -> (logits (B, S, V) float32, cache, aux=0)."""
        if prefix_embeds is not None:
            raise NotImplementedError(
                "prefix embeddings (VLM / enc-dec) are not ported yet "
                "(ROADMAP A14)")
        x = self._embed(params, tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        offset = torch.zeros((B,), dtype=torch.int32, device=x.device)
        x, cache = self._stack_forward(params, x, positions, cache, offset)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(params, x), cache, aux

    def forward_window(self, params, tokens, cache, pos, window_mask=None,
                       window_depth=None):
        """T new tokens against the paged cache.

        tokens: (B, T); pos: (B,) per-row write offsets (current lengths).
        T=1 -> draft step; T=L+1 -> speculative-verification scoring.
        Returns (logits (B, T, V) float32, cache).  Token-tree windows
        (``window_mask`` / ``window_depth``) are not ported yet (ROADMAP A7).
        """
        if window_mask is not None or window_depth is not None:
            raise NotImplementedError(
                "token-tree windows are not ported yet (ROADMAP A7)")
        x = self._embed(params, tokens)
        B, T, _ = x.shape
        pos = torch.as_tensor(pos, device=x.device)
        positions = pos[:, None].long() + torch.arange(T, device=x.device)[None]
        x, cache = self._stack_forward(params, x, positions, cache, pos)
        return self._logits(params, x), cache

    def num_params(self, params) -> int:
        n = params["embed"].numel() + params["ln_f"]["scale"].numel()
        if "unembed" in params:
            n += params["unembed"].numel()
        for p in params["blocks"]:
            for group in p.values():
                n += sum(t.numel() for t in group.values())
        return n
