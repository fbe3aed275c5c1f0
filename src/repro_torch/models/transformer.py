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
``layers.moe_apply`` at the configured capacity factor in ``apply``, and
dropless (the routed rows alone, grouped products) in ``prefill`` (by
default) and in every ``forward_window`` (the exact model for
verification).  The aux losses of the blocks are summed.  A VLM prepends
``prefix_embeds`` (B, P, d) to the token embeddings in ``apply`` and
``prefill``.

A ``LayerPatternConfig`` (``layer_pattern.py``) varies the layers: window
layers see their last ``sliding_window`` keys (``ops.paged_attention``'s
``window``; a band mask in ``apply``) and keep their K/V in leaves of their
own, ``win_k`` / ``win_v``, a pool viewed through ``"win_pages"``; NoPE
layers apply no rotary embedding; an ``attn_norm`` router scores the
attention's normed input.  Such a model serves on paged caches in J=1
windows: the contiguous layout and token-tree windows refuse it.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.kernels import ops as kops

from .layer_pattern import layer_rope, layer_windows, router_input
from .layers import (
    MoEConfig,
    attention_apply,
    causal_mask,
    dense_init,
    embed_init,
    embed_lookup,
    init_attention,
    init_mlp,
    init_moe,
    make_norm,
    mlp_apply,
    moe_apply,
    new_page_pool,
    remat,
)

Params = Any

# float32 logits past this many bytes are made in chunks of rows (``_logits``)
LOGIT_CHUNK_BYTES = 1 << 32
LOGIT_CHUNK_ROWS = 2048

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return DTYPES[name]


TABLES = ("pages", "win_pages")


def strip_view(cache: Params) -> Params:
    """Drop the page tables (``"pages"``, a windowed model's
    ``"win_pages"``) from a paged cache view, leaving only the pool leaves:
    the page allocators' device mirrors own the live tables, and the engine
    never keeps a copy inside its cache."""
    if not any(t in cache for t in TABLES):
        return cache
    return {k: v for k, v in cache.items() if k not in TABLES}


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
        # per layer (dense blocks first): key window (0: full), RoPE or not,
        # and the cache leaf that holds its K/V with its index there
        self.windows = layer_windows(cfg)
        self.rope = layer_rope(cfg)
        self.windowed = any(self.windows)
        self.router_attn = router_input(cfg) == "attn_norm"
        n = {"dense_": 0, "": 0, "win_": 0}
        self.kv_slot = []
        for layer in range(cfg.num_layers):
            prefix = ("dense_" if layer < self.n_dense
                      else "win_" if self.windows[layer] else "")
            self.kv_slot.append((prefix, n[prefix]))
            n[prefix] += 1
        self.n_window = n["win_"]
        # per MoE layer, the routed rows of the counted tokens per expert
        # (``forward_window``'s ``count_tokens``), for tracing
        self.moe_counts: torch.Tensor | None = None

    def _refuse_contiguous(self) -> None:
        if self.windowed:
            raise NotImplementedError(
                "a model with sliding-window layers serves on paged caches "
                "only: its window layers' pages below the window go back to "
                "their pool, and a contiguous slab holds every position")

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
        for prefix, n in (("", self.n_blocks - self.n_window),
                          ("dense_", self.n_dense)):
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
        JAX cache's).  A windowed model refuses: it serves on pages."""
        self._refuse_contiguous()
        return self._kv_leaves(batch, max_len, dtype)

    CACHE_BATCH_AXES = {"k": 1, "v": 1, "dense_k": 1, "dense_v": 1}

    def concat_caches(self, caches: list) -> Params:
        """Stack per-row contiguous caches (ragged prefill) into one batch,
        in a fresh cache with its drop slots."""
        return concat_caches(caches, self.CACHE_BATCH_AXES)

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype=torch.bfloat16,
                         window_pages: int | None = None) -> Params:
        """Paged KV pool: every attention leaf is (layers, P, ps, KV, D)
        with NO batch axis.  Pair it with a ``"pages"`` (B, n_slots) int32
        page table to form the cache view ``prefill`` / ``forward_window``
        take.  A windowed model's window layers get leaves ``win_k`` /
        ``win_v`` of ``window_pages`` pages (default ``num_pages``), viewed
        through a ``"win_pages"`` table of their own; a view without one
        maps no window page (writes dropped, nothing read)."""
        cache = self._kv_leaves(num_pages, page_size, dtype)
        if self.n_window:
            cfg = self.cfg
            for leaf in ("k", "v"):
                cache["win_" + leaf] = new_page_pool(
                    self.n_window, window_pages or num_pages, page_size,
                    cfg.num_kv_heads, cfg.head_dim, dtype=dtype,
                    device=self.device)
        return cache

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------

    def _stack_forward(self, params, x, positions, cache=None, offset=None,
                       window_mask=None, mask=None, moe_capacity=None,
                       band_mask=None, count_tokens=None):
        """Run the leading dense blocks, then the blocks, through the cache
        when one is given (paged when it carries ``"pages"``, contiguous
        otherwise); returns (hidden, cache, summed aux loss), the aux loss
        None when no block is MoE (``_aux`` makes it a tensor for the
        entry points that return it).  With ``cfg.remat`` each of the
        ``blocks`` runs under ``layers.remat`` (the leading dense blocks do
        not, as in the JAX package).  Window layers read their leaves
        through ``"win_pages"`` and take ``band_mask`` for ``mask``;
        ``count_tokens`` (B, T) bool counts each MoE layer's routed rows of
        those tokens into ``moe_counts``."""
        page_table = cache.get("pages") if cache is not None else None
        tables = {"": page_table, "dense_": page_table}
        if self.n_window and page_table is not None:
            win = cache.get("win_pages")
            tables["win_"] = (torch.full_like(page_table, -1) if win is None
                              else win)
        if count_tokens is not None and self.moe_cfg is not None:
            if self.moe_counts is None or self.moe_counts.device != x.device:
                self.moe_counts = torch.zeros(
                    (self.n_blocks, self.moe_cfg.num_experts),
                    dtype=torch.int32, device=x.device)
        aux = None
        layer = 0
        for stack in ("dense_blocks", "blocks"):
            block = remat(self._block, self.cfg.remat and stack == "blocks")
            for i, p in enumerate(params.get(stack, ())):
                prefix, j = self.kv_slot[layer]
                window = self.windows[layer]
                kv = (None if cache is None
                      else (cache[prefix + "k"][j], cache[prefix + "v"][j]))
                count = None
                if count_tokens is not None and "moe" in p:
                    count = (self.moe_counts[i], count_tokens)
                x, layer_aux = block(
                    p, x, positions, kv, offset, tables.get(prefix),
                    window_mask, band_mask if window else mask, moe_capacity,
                    window, self.rope[layer], count)
                if layer_aux is not None:
                    aux = layer_aux if aux is None else aux + layer_aux
                layer += 1
        return x, cache, aux

    def _block(self, p, x, positions, kv_cache, offset, page_table,
               window_mask, mask, moe_capacity, window=0, rope=True,
               count=None):
        """One pre-norm block: attention, then the MLP or the MoE layer ->
        (hidden, the MoE aux loss or None).  ``moe_capacity`` "dropless"
        runs the MoE layer on its routed rows alone."""
        cfg = self.cfg
        h = self.norm(p["ln_attn"], x)
        attn_out, _ = attention_apply(
            p["attn"], h, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            positions=positions, rope_theta=cfg.rope_theta if rope else None,
            kv_cache=kv_cache, cache_offset=offset, page_table=page_table,
            window_mask=window_mask, mask=mask, window=window)
        # the residual stream: batch over the data axes, whole over model
        # (a no-op without an active mesh); DTensor would otherwise leave a
        # partial sum reduce-scattered over the sequence, which its matmul
        # cannot flatten
        x = x + logical_constraint(attn_out, "batch")
        hm = self.norm(p["ln_mlp"], x)
        if "moe" in p:
            dropless = moe_capacity == "dropless"
            out, layer_aux = moe_apply(
                p["moe"], hm, self.moe_cfg,
                capacity_factor=None if dropless else moe_capacity,
                router_x=h if self.router_attn else None, dropless=dropless,
                count=count)
        else:
            out, layer_aux = mlp_apply(p["mlp"], hm, cfg.activation), None
        return x + logical_constraint(out, "batch"), layer_aux

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
        x = logical_constraint(embed_lookup(params["embed"], tokens), "batch")
        x = x.to(_dtype(self.cfg.compute_dtype))
        if prefix_embeds is not None:
            x = torch.cat([torch.as_tensor(prefix_embeds, device=x.device)
                           .to(x.dtype), x], dim=1)
        return x

    def _logits(self, params, x):
        """float32 logits (B, S, V).  Past ``LOGIT_CHUNK_BYTES`` of them
        (a long prompt's prefill) with no gradient to keep, each chunk of
        ``LOGIT_CHUNK_ROWS`` rows is computed and cast into the output in
        turn, so that the product in the compute dtype never stands whole
        beside its float32 copy."""
        x = self.norm(params["ln_f"], x)
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        w = w.to(x.dtype)
        B, S, d = x.shape
        V = w.shape[1]
        if (B * S * V * 4 <= LOGIT_CHUNK_BYTES or kops._is_dtensor(x)
                or (torch.is_grad_enabled() and x.requires_grad)):
            return logical_constraint((x @ w).float(), "batch", None, "vocab")
        out = torch.empty((B, S, V), dtype=torch.float32, device=x.device)
        flat, o = x.reshape(B * S, d), out.view(B * S, V)
        for a in range(0, B * S, LOGIT_CHUNK_ROWS):
            o[a:a + LOGIT_CHUNK_ROWS] = flat[a:a + LOGIT_CHUNK_ROWS] @ w
        return out

    def apply(self, params, tokens, prefix_embeds=None, moe_capacity=None):
        """Full causal forward, no cache.  tokens (B, S), with a VLM's
        ``prefix_embeds`` (B, P, d) prepended -> (logits (B, P + S, V)
        float32, aux).  MoE blocks dispatch at ``moe_capacity`` (default:
        the configured factor)."""
        x = self._embed(params, tokens, prefix_embeds)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        band = None
        if self.windowed:
            # a window layer's query i sees keys i - window < j <= i
            qi = torch.arange(S, device=x.device)[:, None]
            kj = torch.arange(S, device=x.device)[None, :]
            band = ((kj <= qi) & (kj > qi - self.cfg.sliding_window))[
                None, None, None]
        x, _, aux = self._stack_forward(
            params, x, positions, mask=causal_mask(S, S, device=x.device),
            moe_capacity=moe_capacity, band_mask=band)
        return self._logits(params, x), self._aux(aux, x)

    def prefill(self, params, tokens, cache, prefix_embeds=None,
                moe_capacity="no_drop"):
        """Causal forward writing the KV cache at offset 0.
        tokens (B, S), with ``prefix_embeds`` prepended -> (logits
        (B, P + S, V) float32, cache, aux).  MoE blocks run dropless unless
        ``moe_capacity`` names a factor: the cache must hold the exact model
        for verification to stay exact."""
        if moe_capacity == "no_drop":
            moe_capacity = "dropless" if self.moe_cfg else None
        if "pages" not in cache:
            self._refuse_contiguous()
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
                       window_depth=None, count_tokens=None):
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

        ``count_tokens`` (B, T) bool: each MoE layer counts the routed rows
        of these tokens per expert into ``moe_counts`` (tracing).  A
        windowed model refuses tree windows and contiguous caches.
        """
        if window_depth is not None and window_mask is None:
            raise ValueError("window_depth needs the tree's window_mask")
        if self.windowed and window_mask is not None:
            raise NotImplementedError(
                "token-tree windows of a model with sliding-window layers: "
                "a tree node's key window would follow its depth, not its "
                "cache slot, and the tree kernels have no key window")
        if "pages" not in cache:
            self._refuse_contiguous()
        # MoE blocks score with the exact model: capacity dropping is
        # batch-coupled, so windows dispatch dropless
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
            mask=mask, moe_capacity="dropless" if self.moe_cfg else None,
            count_tokens=count_tokens)
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
