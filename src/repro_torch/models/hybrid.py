"""Zamba2-style hybrid on torch tensors: a Mamba-2 backbone with a shared
attention block.

The port of ``repro.models.hybrid``.  ``hybrid_group`` Mamba-2 layers form a
group; after each group the single shared transformer block (attention +
MLP, one weight set) runs with its own per-invocation contiguous KV cache.
54 layers / group 6 -> 9 shared-block invocations.  Recurrent state is
functional as in ``ssm.MambaLM``; the KV caches are written in place (they
need no rollback: positions past a row's committed prefix are masked).
The shared block's attention is ``layers.attention_apply`` on the
contiguous layout: ``ops.flash_attention`` in the prefill and
``ops.decode_attention`` on every per-token step (the JAX package runs
``gqa_attention`` over the cache there; the function is the same).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig

from .layers import (
    attention_apply,
    causal_mask,
    dense_init,
    embed_init,
    init_attention,
    init_mlp,
    init_rmsnorm,
    mlp_apply,
    new_page_pool,
    rmsnorm,
)
from .ssm import (
    _count,
    init_mamba2_block,
    keep_snapshot,
    mamba2_block_apply,
    ssm_dims,
)
from .transformer import _dtype

Params = Any


class HybridLM:
    """Mamba-2 groups with one shared attention block.  ``device`` is where
    ``init`` draws the weights and ``init_cache`` allocates the caches."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.num_layers % cfg.hybrid_group:
            raise ValueError(f"{cfg.num_layers} layers are not a multiple of "
                             f"the hybrid group {cfg.hybrid_group}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.num_groups = cfg.num_layers // cfg.hybrid_group

    def init(self, gen: torch.Generator | int) -> Params:
        if isinstance(gen, int):
            gen = torch.Generator(device=self.device).manual_seed(gen)
        cfg = self.cfg
        dtype = _dtype(cfg.param_dtype)
        params = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
            "ln_f": init_rmsnorm(cfg.d_model, dtype, self.device),
            "mamba": [[init_mamba2_block(gen, cfg)
                       for _ in range(cfg.hybrid_group)]
                      for _ in range(self.num_groups)],
            "shared": {
                "ln_attn": init_rmsnorm(cfg.d_model, dtype, self.device),
                "attn": init_attention(gen, cfg.d_model, cfg.num_heads,
                                       cfg.num_kv_heads, cfg.head_dim,
                                       dtype=dtype),
                "ln_mlp": init_rmsnorm(cfg.d_model, dtype, self.device),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                                dtype),
            },
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                           dtype)
        return params

    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> Params:
        """Recurrent state per Mamba-2 layer, on (groups, group_size) axes,
        and one contiguous (B, max_len) KV cache per shared-block
        invocation (with the drop slot of ``layers.new_page_pool``)."""
        cfg = self.cfg
        d_inner, nheads, g, n, conv_dim = ssm_dims(cfg)
        G, gs = self.num_groups, cfg.hybrid_group
        kv = (G, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {
            "ssm": torch.zeros((G, gs, batch, nheads, cfg.ssm_head_dim, n),
                               dtype=torch.float32, device=self.device),
            "conv": torch.zeros((G, gs, batch, cfg.ssm_conv_width - 1,
                                 conv_dim), dtype=dtype, device=self.device),
            "k": new_page_pool(*kv, dtype=dtype, device=self.device),
            "v": new_page_pool(*kv, dtype=dtype, device=self.device),
        }

    CACHE_BATCH_AXES = {"ssm": 2, "conv": 2, "k": 1, "v": 1}

    def concat_caches(self, caches: list) -> Params:
        out = {}
        for key in caches[0]:
            cat = torch.cat([c[key] for c in caches],
                            dim=self.CACHE_BATCH_AXES[key])
            if key in ("k", "v"):       # a fresh cache with its drop slots
                out[key] = new_page_pool(*cat.shape, dtype=cat.dtype,
                                         device=cat.device)
                out[key].copy_(cat)
            else:
                out[key] = cat
        return out

    def _shared_block(self, params, x, positions, mask, kv_cache=None,
                      offset=None):
        cfg = self.cfg
        p = params["shared"]
        h = rmsnorm(p["ln_attn"], x)
        attn_out, kv = attention_apply(
            p["attn"], h, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            positions=positions, rope_theta=cfg.rope_theta, kv_cache=kv_cache,
            cache_offset=offset, mask=mask)
        x = x + attn_out
        h = rmsnorm(p["ln_mlp"], x)
        return x + mlp_apply(p["mlp"], h, cfg.activation), kv

    def _forward(self, params, x, positions, mask, cache=None, offset=None,
                 decode=False):
        new_ssm, new_conv = [], []
        for gi, group in enumerate(params["mamba"]):
            g_ssm, g_conv = [], []
            for li, p in enumerate(group):
                ssm_s = cache["ssm"][gi, li] if cache is not None else None
                conv_s = cache["conv"][gi, li] if cache is not None else None
                x, s_new, c_new = mamba2_block_apply(p, x, self.cfg, ssm_s,
                                                     conv_s, decode)
                g_ssm.append(s_new)
                g_conv.append(c_new)
            kv = None if cache is None else (cache["k"][gi], cache["v"][gi])
            x, _ = self._shared_block(params, x, positions, mask, kv, offset)
            new_ssm.append(torch.stack(g_ssm))
            new_conv.append(torch.stack(g_conv))
        if cache is None:
            return x, None
        return x, {"ssm": torch.stack(new_ssm), "conv": torch.stack(new_conv),
                   "k": cache["k"], "v": cache["v"]}

    def _embed(self, params, tokens):
        return params["embed"][tokens.long()].to(_dtype(self.cfg.compute_dtype))

    def _logits(self, params, x):
        x = rmsnorm(params["ln_f"], x)
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return (x @ w.to(x.dtype)).float()

    def apply(self, params, tokens, prefix_embeds=None):
        x = self._embed(params, tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        x, _ = self._forward(params, x, positions,
                             causal_mask(S, S, device=x.device))
        return (self._logits(params, x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def prefill(self, params, tokens, cache, prefix_embeds=None):
        x = self._embed(params, tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        # the 0-d offset 0, as the JAX package: the shared block's prefill
        # runs ops.flash_attention over the prompt's own keys, unmasked here
        x, cache = self._forward(params, x, positions, None, cache=cache,
                                 offset=0)
        return (self._logits(params, x), cache,
                torch.zeros((), dtype=torch.float32, device=x.device))

    def forward_window(self, params, tokens, cache, pos,
                       return_snapshots=False):
        """T tokens one recurrence step at a time.  With return_snapshots
        also returns the state after every step (leading axis T) — only
        ``ssm`` and ``conv``: the KV entries need no rollback (masked by
        position)."""
        T = tokens.shape[1]
        pos = torch.as_tensor(pos, device=params["embed"].device)
        logits_steps, snaps = [], None
        for t in range(T):
            # a T = 1 step: the shared block runs ops.decode_attention at
            # lengths pos + t + 1, which needs no mask
            x = self._embed(params, tokens[:, t:t + 1])
            positions = (pos + t)[:, None]
            x, cache = self._forward(params, x, positions, None, cache=cache,
                                     offset=pos + t, decode=True)
            logits_steps.append(self._logits(params, x))
            if return_snapshots:
                snaps = keep_snapshot(snaps, cache, ("ssm", "conv"), t, T)
        logits = torch.cat(logits_steps, dim=1)
        if return_snapshots:
            return logits, cache, snaps
        return logits, cache

    def num_params(self, params) -> int:
        return _count(params)
