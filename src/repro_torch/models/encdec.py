"""Whisper-style encoder-decoder on torch tensors (conv frontend stubbed).

The port of ``repro.models.encdec.EncDecLM``.  The encoder consumes
precomputed frame embeddings (B, T_frames, d_model) through
``prefix_embeds``; the decoder is a causal transformer with a
self-attention KV cache and cross-attention into per-layer K/V computed
once from the encoder output at ``prefill``.  Positions are learned
embeddings (whisper has no RoPE).  Layers are python lists of per-layer
dicts (``enc_blocks``, ``dec_blocks``), as ``bridge.params_from_jax`` gives
them.

Kernel routing.  ``apply`` (no cache) runs plain ``gqa_attention``
everywhere, as every family's cache-free path does.  ``prefill`` runs the
encoder's full non-causal attention over the frames through
``ops.flash_attention(causal=False)`` (B8); the decoder's self-attention
goes through ``layers.attention_apply``: B8 for the prefill at offset 0,
B7 for one-token windows.  Cross-attention, which the JAX package runs as
plain ``gqa_attention`` over the fixed frame K/V with no mask, runs B8
non-causal in ``prefill`` and ``forward_window`` alike: every query row
sees all ``encoder_seq_len`` frames, the function B8 computes at any
number of query rows (B7 at lengths ``encoder_seq_len`` would compute the
same for the one-token steps only).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

from .layers import (
    _project_qkv,
    attention_apply,
    causal_mask,
    dense_init,
    embed_init,
    gqa_attention,
    init_attention,
    init_mlp,
    make_norm,
    mlp_apply,
    new_page_pool,
)
from .transformer import _dtype, concat_caches, num_params

Params = Any

MAX_DECODER_POS = 33024  # covers the decode_32k cell (+ draft window)


class EncDecLM:
    """Encoder-decoder LM parameterized by ``ModelConfig`` (family
    ``"audio"``); ``device`` as ``DecoderLM``'s."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.init_norm, self.norm = make_norm(cfg.norm)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def _attn(self, gen, dtype):
        cfg = self.cfg
        return init_attention(gen, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.head_dim, dtype=dtype)

    def init(self, gen: torch.Generator | int) -> Params:
        """Random weights with the JAX package's distributions, drawn from a
        seeded ``torch.Generator`` on this model's device."""
        if isinstance(gen, int):
            gen = torch.Generator(device=self.device).manual_seed(gen)
        cfg = self.cfg
        dtype = _dtype(cfg.param_dtype)
        d = cfg.d_model

        def norm():
            return self.init_norm(d, dtype, self.device)

        def mlp():
            return init_mlp(gen, d, cfg.d_ff, cfg.activation, dtype)

        def positions(n):
            return (torch.randn((n, d), generator=gen, device=self.device)
                    * 0.02).to(dtype)

        return {
            "embed": embed_init(gen, cfg.vocab_size, d, dtype),
            "pos_embed": positions(MAX_DECODER_POS),
            "enc_pos_embed": positions(cfg.encoder_seq_len),
            "enc_blocks": [{"ln_attn": norm(), "attn": self._attn(gen, dtype),
                            "ln_mlp": norm(), "mlp": mlp()}
                           for _ in range(cfg.num_encoder_layers)],
            "dec_blocks": [{"ln_self": norm(),
                            "self_attn": self._attn(gen, dtype),
                            "ln_cross": norm(),
                            "cross_attn": self._attn(gen, dtype),
                            "ln_mlp": norm(), "mlp": mlp()}
                           for _ in range(cfg.num_layers)],
            "ln_enc": norm(),
            "ln_f": norm(),
            "unembed": dense_init(gen, d, cfg.vocab_size, dtype),
        }

    # ------------------------------------------------------------------
    # Encoder and cross-attention K/V
    # ------------------------------------------------------------------

    def _full_attention(self, q, k, v, fused: bool):
        """Every query row over every key: B8 non-causal when ``fused``,
        else plain ``gqa_attention`` with no mask."""
        if not fused:
            return gqa_attention(q, k, v, None)
        return kops.flash_attention(q.contiguous(), k.to(q.dtype).contiguous(),
                                    v.to(q.dtype).contiguous(), causal=False)

    def encode(self, params, frames, fused: bool = False) -> torch.Tensor:
        """frames (B, T_frames, d_model) stub embeddings -> encoder output;
        ``fused`` runs the attention through B8."""
        cfg = self.cfg
        x = torch.as_tensor(frames, device=self.device).to(
            _dtype(cfg.compute_dtype))
        S = x.shape[1]
        x = x + params["enc_pos_embed"][None, :S].to(x.dtype)
        for p in params["enc_blocks"]:
            h = self.norm(p["ln_attn"], x)
            B = h.shape[0]
            q, k, v = _project_qkv(p["attn"], h, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim)
            ctx = self._full_attention(q, k, v, fused)
            x = x + ctx.to(x.dtype).reshape(B, S, -1) @ p["attn"]["wo"]
            h = self.norm(p["ln_mlp"], x)
            x = x + mlp_apply(p["mlp"], h, cfg.activation)
        return self.norm(params["ln_enc"], x)

    def _cross_kv(self, params, enc_out):
        """Per-layer cross-attention K/V from the encoder output: two lists
        of (B, S_enc, KV, D)."""
        cfg = self.cfg
        B, S, _ = enc_out.shape
        shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
        ks = [(enc_out @ p["cross_attn"]["wk"]).reshape(shape)
              for p in params["dec_blocks"]]
        vs = [(enc_out @ p["cross_attn"]["wv"]).reshape(shape)
              for p in params["dec_blocks"]]
        return ks, vs

    # ------------------------------------------------------------------
    # Decoder
    # ------------------------------------------------------------------

    def _decoder(self, params, tokens, cross_k, cross_v, positions, *,
                 cache=None, offset=None, mask=None, fused=False):
        """Decoder logits (B, T, V) float32; with ``cache`` the window's
        self-attention K/V are written at ``offset`` (in place)."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        x = params["embed"][tokens.long()].to(_dtype(cfg.compute_dtype))
        pos_idx = positions.long().clamp(0, MAX_DECODER_POS - 1)
        x = x + params["pos_embed"][pos_idx].to(x.dtype)
        B, T, _ = x.shape
        for i, p in enumerate(params["dec_blocks"]):
            h = self.norm(p["ln_self"], x)
            attn, _ = attention_apply(
                p["self_attn"], h, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                positions=positions, rope_theta=None,
                kv_cache=(None if cache is None
                          else (cache["k"][i], cache["v"][i])),
                cache_offset=offset, mask=mask)
            x = x + attn
            # cross attention: all encoder frames valid, no rope
            h = self.norm(p["ln_cross"], x)
            q = (h @ p["cross_attn"]["wq"]).reshape(B, T, cfg.num_heads,
                                                    cfg.head_dim)
            cross = self._full_attention(q, cross_k[i].to(h.dtype),
                                         cross_v[i].to(h.dtype), fused)
            x = x + cross.to(x.dtype).reshape(B, T, -1) @ p["cross_attn"]["wo"]
            h = self.norm(p["ln_mlp"], x)
            x = x + mlp_apply(p["mlp"], h, cfg.activation)
        x = self.norm(params["ln_f"], x)
        return (x @ params["unembed"].to(x.dtype)).float()

    # ------------------------------------------------------------------
    # Unified API (frames go through ``prefix_embeds``)
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> Params:
        """Self-attention ``k`` / ``v`` (layers, B, max_len, KV, D) and the
        fixed ``cross_k`` / ``cross_v`` (layers, B, encoder_seq_len, KV, D),
        zeroed, each from ``new_page_pool``."""
        cfg = self.cfg
        tail = (cfg.num_kv_heads, cfg.head_dim)
        cache = {}
        for leaf, width in (("k", max_len), ("v", max_len),
                            ("cross_k", cfg.encoder_seq_len),
                            ("cross_v", cfg.encoder_seq_len)):
            cache[leaf] = new_page_pool(cfg.num_layers, batch, width, *tail,
                                        dtype=dtype, device=self.device)
        return cache

    CACHE_BATCH_AXES = {"k": 1, "v": 1, "cross_k": 1, "cross_v": 1}

    def concat_caches(self, caches: list) -> Params:
        """Stack per-row caches into one batch, in a fresh cache."""
        return concat_caches(caches, self.CACHE_BATCH_AXES)

    def apply(self, params, tokens, prefix_embeds=None):
        """Training forward: frames (``prefix_embeds``) + decoder tokens ->
        (logits (B, S, V) float32, aux = 0), plain attention throughout."""
        if prefix_embeds is None:
            raise ValueError("whisper training needs frame embeddings")
        enc_out = self.encode(params, prefix_embeds)
        ck, cv = self._cross_kv(params, enc_out)
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        logits = self._decoder(params, tokens, ck, cv, positions,
                               mask=causal_mask(S, S, device=self.device))
        return logits, torch.zeros((), dtype=torch.float32, device=self.device)

    def prefill(self, params, tokens, cache, prefix_embeds=None):
        """Encode the frames (B8), write the cross K/V into the cache, and
        run the decoder over ``tokens`` writing its self-attention cache at
        offset 0 -> (logits (B, S, V) float32, cache, aux = 0)."""
        if prefix_embeds is None:
            raise ValueError("the encoder-decoder prefill needs frame "
                             "embeddings")
        enc_out = self.encode(params, prefix_embeds, fused=True)
        ck, cv = self._cross_kv(params, enc_out)
        for i in range(self.cfg.num_layers):
            cache["cross_k"][i].copy_(ck[i])
            cache["cross_v"][i].copy_(cv[i])
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        logits = self._decoder(params, tokens, ck, cv, positions, cache=cache,
                               offset=0, fused=True)
        return logits, cache, torch.zeros((), dtype=torch.float32,
                                          device=self.device)

    def forward_window(self, params, tokens, cache, pos):
        """T new decoder tokens at per-row offsets ``pos`` (B,) against the
        cache -> (logits (B, T, V) float32, cache)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        B, T = tokens.shape
        pos = torch.as_tensor(pos, device=self.device)
        positions = pos[:, None].long() + torch.arange(T, device=self.device)
        mask = None     # T = 1 runs ops.decode_attention, which needs none
        if T > 1:
            kj = torch.arange(cache["k"].shape[2], device=self.device)
            mask = (kj[None, None, :] <= positions[:, :, None])[:, None, None]
        logits = self._decoder(params, tokens, cache["cross_k"],
                               cache["cross_v"], positions, cache=cache,
                               offset=pos, mask=mask, fused=True)
        return logits, cache

    def num_params(self, params) -> int:
        return num_params(params)
