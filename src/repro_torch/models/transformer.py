"""Decoder-only transformer LM on torch tensors (dense / MoE / VLM backbone).

The port of ``repro.models.transformer.DecoderLM`` for ``family`` "dense",
"moe" and "vlm":

  * ``apply``          — full causal forward (scoring), no cache
  * ``prefill``        — causal forward that writes the KV cache at offset 0
  * ``forward_window`` — T new tokens against the cache at per-row offsets:
    T=1 is a draft step, T=L+1 the speculative-verification window, and
    with ``window_mask`` / ``window_depth`` a token-tree window of a
    multi-draft round

Two cache layouts, as in the JAX package: contiguous (B, max_len) slabs
(``init_cache``) and paged pools (``init_paged_cache``) viewed through a
``"pages"`` page table.  Parameters keep the JAX package's names and (in,
out) layouts, but the layers are a python list of per-layer dicts instead of
arrays stacked on a leading axis; ``bridge.params_from_jax`` converts one
into the other.  The layer loop is a plain python loop (the counterpart of
``jax.lax.scan``).  Paged attention goes through ``ops.paged_attention``
(``ops.paged_tree_attention`` for tree windows), contiguous tree windows
through ``ops.tree_attention``: the CUDA kernels on the card, their plain
versions on the CPU.  On the contiguous layout the prefill runs
``ops.flash_attention`` over the prompt's own keys and every T = 1 window
``ops.decode_attention``; the T > 1 sequential windows (J=1 verification)
run ``gqa_attention`` over the cache, as the JAX package does for all
three.  Caches are updated in place.

MoE stacks (``num_experts`` > 0) run ``first_k_dense`` dense blocks
(``dense_blocks``, cache leaves ``dense_k`` / ``dense_v``) before the MoE
blocks (``blocks``, leaves ``k`` / ``v``); each MoE block's MLP is
``layers.moe_apply`` at the configured capacity factor in ``apply``, and at
the no-drop capacity in ``prefill`` (by default) and in every
``forward_window`` (the exact model for verification).  The aux losses of
the blocks are summed.  A VLM prepends ``prefix_embeds`` (B, P, d) to the
token embeddings in ``apply`` and ``prefill``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig

from .layers import (
    MoEConfig,
    attention_apply,
    causal_mask,
    dense_init,
    embed_init,
    init_attention,
    init_mlp,
    init_moe,
    make_norm,
    mlp_apply,
    moe_apply,
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
    """Decoder-only LM (dense, MoE or VLM backbone) parameterized by
    ``ModelConfig``.

    ``device`` is where ``init`` draws the weights and ``init_cache`` /
    ``init_paged_cache`` allocate the caches (the card unless the caller
    asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"DecoderLM builds dense, moe and vlm models, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.init_norm, self.norm = make_norm(cfg.norm)
        self.moe_cfg = None
        if cfg.num_experts:
            self.moe_cfg = MoEConfig(
                num_experts=cfg.num_experts, top_k=cfg.top_k,
                d_ff=cfg.moe_d_ff, activation=cfg.activation,
                capacity_factor=cfg.capacity_factor,
                num_shared_experts=cfg.num_shared_experts,
                shared_d_ff=cfg.shared_d_ff,
                dense_residual=cfg.dense_residual, dense_d_ff=cfg.d_ff)
        # leading dense blocks of a MoE stack, then the (MoE) ``blocks``
        self.n_dense = cfg.first_k_dense if cfg.num_experts else 0
        self.n_blocks = cfg.num_layers - self.n_dense

    @property
    def no_drop_capacity(self) -> float:
        """Capacity factor at which dropping is impossible (C = T tokens):
        cf = E / k since C = ceil(T k / E * cf)."""
        assert self.moe_cfg is not None
        return self.moe_cfg.num_experts / self.moe_cfg.top_k

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def _init_block(self, gen: torch.Generator, moe: bool) -> Params:
        cfg = self.cfg
        dtype = _dtype(cfg.param_dtype)
        p = {
            "ln_attn": self.init_norm(cfg.d_model, dtype, self.device),
            "attn": init_attention(gen, cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim,
                                   qkv_bias=cfg.qkv_bias, dtype=dtype),
            "ln_mlp": self.init_norm(cfg.d_model, dtype, self.device),
        }
        if moe:
            p["moe"] = init_moe(gen, cfg.d_model, self.moe_cfg, dtype)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                                dtype)
        return p

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
        if self.n_dense:
            params["dense_blocks"] = [self._init_block(gen, moe=False)
                                      for _ in range(self.n_dense)]
        params["blocks"] = [self._init_block(gen, moe=self.moe_cfg is not None)
                            for _ in range(self.n_blocks)]
        return params

    # ------------------------------------------------------------------
    # Cache
    # ------------------------------------------------------------------

    def _kv_leaves(self, rows: int, width: int, dtype) -> Params:
        """``k`` / ``v`` of the ``blocks`` and, in a MoE stack with leading
        dense blocks, ``dense_k`` / ``dense_v``: each (layers, rows, width,
        KV, D) from ``new_page_pool``, with its drop slot."""
        cfg = self.cfg
        tail = (rows, width, cfg.num_kv_heads, cfg.head_dim)
        cache = {}
        for prefix, n in (("", self.n_blocks), ("dense_", self.n_dense)):
            if n:
                for leaf in ("k", "v"):
                    cache[prefix + leaf] = new_page_pool(
                        n, *tail, dtype=dtype, device=self.device)
        return cache

    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> Params:
        """Contiguous KV cache: every attention leaf is (layers, B, max_len,
        KV, D), zeroed, each layer followed by the drop slot of
        ``scatter_kv_window`` (outside the view: shapes and bytes are the
        JAX cache's)."""
        return self._kv_leaves(batch, max_len, dtype)

    CACHE_BATCH_AXES = {"k": 1, "v": 1, "dense_k": 1, "dense_v": 1}

    def concat_caches(self, caches: list) -> Params:
        """Stack per-row contiguous caches (ragged prefill) into one batch,
        in a fresh cache with its drop slots."""
        return concat_caches(caches, self.CACHE_BATCH_AXES)

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype=torch.bfloat16) -> Params:
        """Paged KV pool: every attention leaf is (layers, P, ps, KV, D)
        with NO batch axis.  Pair it with a ``"pages"`` (B, n_slots) int32
        page table to form the cache view ``prefill`` / ``forward_window``
        take."""
        return self._kv_leaves(num_pages, page_size, dtype)

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------

    def _stack_forward(self, params, x, positions, cache=None, offset=None,
                       window_mask=None, mask=None, moe_capacity=None):
        """Run the leading dense blocks, then the blocks, through the cache
        when one is given (paged when it carries ``"pages"``, contiguous
        otherwise); returns (hidden, cache, summed aux loss), the aux loss
        None when no block is MoE (``_aux`` makes it a tensor for the
        entry points that return it)."""
        cfg = self.cfg
        page_table = cache.get("pages") if cache is not None else None
        aux = None
        for stack, prefix in (("dense_blocks", "dense_"), ("blocks", "")):
            for i, p in enumerate(params.get(stack, ())):
                h = self.norm(p["ln_attn"], x)
                attn_out, _ = attention_apply(
                    p["attn"], h, num_heads=cfg.num_heads,
                    num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                    positions=positions, rope_theta=cfg.rope_theta,
                    kv_cache=(None if cache is None
                              else (cache[prefix + "k"][i],
                                    cache[prefix + "v"][i])),
                    cache_offset=offset, page_table=page_table,
                    window_mask=window_mask, mask=mask)
                x = x + attn_out
                h = self.norm(p["ln_mlp"], x)
                if "moe" in p:
                    out, layer_aux = moe_apply(p["moe"], h, self.moe_cfg,
                                               capacity_factor=moe_capacity)
                    aux = layer_aux if aux is None else aux + layer_aux
                else:
                    out = mlp_apply(p["mlp"], h, cfg.activation)
                x = x + out
        return x, cache, aux

    @staticmethod
    def _aux(aux, like: torch.Tensor) -> torch.Tensor:
        """The summed aux loss as a float32 0-d tensor (0 for a dense
        stack)."""
        if aux is None:
            return torch.zeros((), dtype=torch.float32, device=like.device)
        return aux

    @staticmethod
    def _cache_kv_capacity(cache: Params) -> int:
        """Logical KV positions per row: S for contiguous (B, S, KV, D)
        leaves, n_slots * page_size for a paged view."""
        if "pages" in cache:
            return cache["pages"].shape[1] * cache["k"].shape[2]
        return cache["k"].shape[2]

    def _embed(self, params, tokens, prefix_embeds=None):
        x = params["embed"][tokens.long()].to(_dtype(self.cfg.compute_dtype))
        if prefix_embeds is not None:
            x = torch.cat([torch.as_tensor(prefix_embeds, device=x.device)
                           .to(x.dtype), x], dim=1)
        return x

    def _logits(self, params, x):
        x = self.norm(params["ln_f"], x)
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return (x @ w.to(x.dtype)).float()

    def apply(self, params, tokens, prefix_embeds=None, moe_capacity=None):
        """Full causal forward, no cache.  tokens (B, S), with a VLM's
        ``prefix_embeds`` (B, P, d) prepended -> (logits (B, P + S, V)
        float32, aux).  MoE blocks dispatch at ``moe_capacity`` (default:
        the configured factor)."""
        x = self._embed(params, tokens, prefix_embeds)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        x, _, aux = self._stack_forward(
            params, x, positions, mask=causal_mask(S, S, device=x.device),
            moe_capacity=moe_capacity)
        return self._logits(params, x), self._aux(aux, x)

    def prefill(self, params, tokens, cache, prefix_embeds=None,
                moe_capacity="no_drop"):
        """Causal forward writing the KV cache at offset 0.
        tokens (B, S), with ``prefix_embeds`` prepended -> (logits
        (B, P + S, V) float32, cache, aux).  MoE blocks dispatch at the
        no-drop capacity unless ``moe_capacity`` names a factor: the cache
        must hold the exact model for verification to stay exact."""
        if moe_capacity == "no_drop":
            moe_capacity = self.no_drop_capacity if self.moe_cfg else None
        x = self._embed(params, tokens, prefix_embeds)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        # the 0-d offset 0, as the JAX package: every row starts at the
        # beginning of its cache, so the contiguous layout attends the
        # window's own keys (``ops.flash_attention``) and the paged one
        # runs ``ops.paged_attention`` at lengths 1
        x, cache, aux = self._stack_forward(params, x, positions, cache, 0,
                                            moe_capacity=moe_capacity)
        return self._logits(params, x), cache, self._aux(aux, x)

    def forward_window(self, params, tokens, cache, pos, window_mask=None,
                       window_depth=None):
        """T new tokens against an existing cache (contiguous or paged).

        tokens: (B, T); pos: (B,) per-row write offsets (current lengths).
        T=1 -> draft step; T=L+1 -> speculative-verification scoring.
        Returns (logits (B, T, V) float32, cache).

        Token-TREE windows (multi-draft verification) pass ``window_mask``
        (B, T, T) bool, the tree's ancestor-or-self matrix, and
        ``window_depth`` (B, T) node depths: window token t keeps cache slot
        pos + t but takes rope position pos + depth_t and attends committed
        KV plus its in-window ancestors only.  A lower-triangular mask with
        depths 0..T-1 is the sequential window.  A ``window_depth`` without
        a ``window_mask`` is refused: its rope positions would be out of
        step with the row-index mask of the sequential kernel.
        """
        if window_depth is not None and window_mask is None:
            raise ValueError("window_depth needs the tree's window_mask")
        # MoE blocks score with the exact model: capacity dropping is
        # batch-coupled, so windows dispatch at the no-drop factor
        x = self._embed(params, tokens)
        B, T, _ = x.shape
        pos = torch.as_tensor(pos, device=x.device)
        if window_depth is None:
            offsets = torch.arange(T, device=x.device)[None]
        else:
            offsets = torch.as_tensor(window_depth, device=x.device).long()
        positions = pos[:, None].long() + offsets
        mask = None     # T = 1 runs ops.decode_attention, which needs none
        if "pages" not in cache and window_mask is None and T > 1:
            kj = torch.arange(self._cache_kv_capacity(cache), device=x.device)
            mask = (kj[None, None, :] <= positions[:, :, None])[:, None, None]
        x, cache, _ = self._stack_forward(
            params, x, positions, cache, pos, window_mask=window_mask,
            mask=mask,
            moe_capacity=self.no_drop_capacity if self.moe_cfg else None)
        return self._logits(params, x), cache

    def num_params(self, params) -> int:
        return num_params(params)


def concat_caches(caches: list, batch_axes: dict) -> Params:
    """Stack per-row contiguous caches, every leaf (layers, B, S, KV, D)
    along its batch axis, into a fresh cache from ``new_page_pool``."""
    out = {}
    for key in caches[0]:
        leaves = [c[key] for c in caches]
        Ln, _, S, KV, D = leaves[0].shape
        B = sum(int(leaf.shape[1]) for leaf in leaves)
        out[key] = new_page_pool(Ln, B, S, KV, D, dtype=leaves[0].dtype,
                                 device=leaves[0].device)
        out[key].copy_(torch.cat(leaves, dim=batch_axes[key]))
    return out


def num_params(tree) -> int:
    """Elements of every tensor of a parameter tree (dicts and lists)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(num_params(t) for t in items)
