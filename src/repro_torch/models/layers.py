"""Dense decoder building blocks on torch tensors.

Functional like the JAX package: parameters are plain dicts of tensors with
the same names and layouts, and projections compute ``x @ W`` with W shaped
(in, out), so parameters carried across from the JAX package need no
transpose.  Both cache layouts are here: paged pools addressed through a
page table and contiguous (B, S) slabs, each with sequential windows
(prefill, draft steps, J=1 verification), token-tree windows (J > 1
rounds) and the K/V window gather/scatter of the tree scatter-commit; plus
cache-free attention for full-sequence scoring, and the mixture of experts
(``MoEConfig``, ``init_moe``, ``moe_apply``: the capacity dispatch, or
dropless over the routed rows alone).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import precision as _precision  # noqa: F401  (no TF32)
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import (
    constrain_attention_scores,
    logical_constraint,
    shards_dividing,
)
from repro_torch.kernels import ops as kops
from repro_torch.obs import trace

Params = Any  # nested dict of tensors


def remat(fn, enabled: bool):
    """``fn`` under ``torch.utils.checkpoint`` when ``enabled`` (a config's
    ``remat``, the JAX package's ``jax.checkpoint`` of each block): the
    block's activations are recomputed in the backward instead of kept."""
    if not enabled:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


# ---------------------------------------------------------------------------
# Initializers (the JAX package's distributions, from a torch.Generator)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: float | None = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype=torch.float32):
    w = torch.randn((vocab, dim), generator=gen, device=gen.device)
    return (w * 0.02).to(dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``table`` (``F.embedding``).  Its backward sums the
    gradients of repeated ids in a fixed order on both devices, so a train
    step is repeatable bit for bit; advanced indexing's backward
    (``index_put_`` with accumulate) races between threads on the CPU."""
    return F.embedding(ids.long(), table)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype=torch.float32, device="cuda") -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(dim: int, dtype=torch.float32, device="cuda") -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return init_rmsnorm, rmsnorm
    if kind == "layernorm":
        return init_layernorm, layernorm
    raise ValueError(f"unknown norm {kind}")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device="cuda") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a python-scalar base: no host tensor to copy (and wait for) per call
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs          # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Grouped-query attention
# ---------------------------------------------------------------------------

def init_attention(gen, d_model: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, qkv_bias: bool = False,
                   dtype=torch.float32) -> Params:
    p = {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, dtype),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, dtype),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype),
    }
    if qkv_bias:
        for name, width in (("bq", num_heads), ("bk", num_kv_heads),
                            ("bv", num_kv_heads)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype,
                                  device=gen.device)
    return p


def _project_qkv(params: Params, x: torch.Tensor, num_heads: int,
                 num_kv_heads: int, head_dim: int):
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = shards_dividing(q, 2, num_heads).reshape(B, S, num_heads, head_dim)
    k = shards_dividing(k, 2, num_kv_heads).reshape(B, S, num_kv_heads,
                                                    head_dim)
    v = shards_dividing(v, 2, num_kv_heads).reshape(B, S, num_kv_heads,
                                                    head_dim)
    return q, k, v


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None,
                  scale: float | None = None) -> torch.Tensor:
    """Grouped-query attention core over materialized K/V.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D); mask broadcastable to
    (B, KV, G, Sq, Skv) or None.  Returns (B, Sq, H, D).  Cache-free
    scoring and the sequential windows of T > 1 tokens at per-row offsets
    on the contiguous layout (the J=1 verify window) run it, as the JAX
    package does; the contiguous T = 1 windows and the prefill run
    ``ops.decode_attention`` / ``ops.flash_attention`` and the paged path
    ``ops.paged_attention`` instead.

    DTensor inputs run the same core through ``local_map``, on shards laid
    out as ``sharding.attention_score_spec`` lays out the score tensor
    (batch over the data axes; kv heads, else query groups, over model;
    the keys whole over model when it shards the groups): every score and
    softmax is local to its shard, forward and backward.
    """
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if kops._is_dtensor(q):
        return _gqa_attention_sharded(q, k, v, mask, scale)
    qg = q.reshape(B, Sq, KV, G, D)
    return _gqa_core(qg, k, v, mask, scale).reshape(B, Sq, H, D)


def _gqa_core(qg, k, v, mask, scale: float):
    """(B, Sq, KV, G, D) queries against (B, Skv, KV, D) keys and values
    -> (B, Sq, KV, G, D)."""
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    # keep the O(S^2) score tensor sharded: batch over data axes, kv-heads
    # (or query-heads) over model; a no-op without an active mesh
    logits = constrain_attention_scores(logits)
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.full((), -1e30, device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def _gqa_attention_sharded(q, k, v, mask, scale: float):
    """``gqa_attention`` of DTensors: ``_gqa_core`` under ``local_map``."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    rows, kvs, gs, _, _ = shd.attention_score_spec(mesh, (B, KV, G, Sq, Skv))

    def pl(*dims):
        return list(shd.placements(dims, mesh))

    qg = shards_dividing(q, 2, KV).reshape(B, Sq, KV, G, D)
    args, in_pl = [qg, k, v], [pl(rows, None, kvs, gs, None),
                               pl(rows, None, kvs, None),
                               pl(rows, None, kvs, None)]
    if mask is not None:
        if not kops._is_dtensor(mask):
            mask = DTensor.from_local(mask, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        args.append(mask)
        in_pl.append(pl(rows if mask.shape[0] == B else None,
                        *([None] * (mask.dim() - 1))))
    out = local_map(
        kops.contiguous_local(
            lambda qg, k, v, mask=None: _gqa_core(qg, k, v, mask, scale)),
        out_placements=pl(rows, None, kvs, gs, None),
        in_placements=tuple(in_pl), device_mesh=mesh,
        redistribute_inputs=True)(*args)
    if gs is not None:          # groups split over model: whole heads first
        out = out.redistribute(mesh, pl(rows, None, None, None, None))
    return out.reshape(B, Sq, H, D)


# ---------------------------------------------------------------------------
# KV caches: contiguous slabs and paged pools
# ---------------------------------------------------------------------------

def new_page_pool(n_layers: int, num_pages: int, page_size: int,
                  num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                  device="cuda") -> torch.Tensor:
    """A zeroed (layers, P, ps, KV, D) page pool.

    Each layer's (P, ps, KV, D) slice is contiguous and is followed in
    memory by one extra (KV, D) slot, the drop bin of
    ``paged_update_kv_cache`` (flat index P * ps, as in the JAX package).
    The slot lies outside the returned view, so shapes and byte accounting
    are those of the JAX pool.  A contiguous (layers, B, S, KV, D) cache is
    the same layout with P = B rows of ps = S positions: its drop slot takes
    the dropped writes of ``scatter_kv_window``."""
    P_ps = num_pages * page_size
    base = torch.zeros((n_layers, P_ps + 1, num_kv_heads, head_dim),
                       dtype=dtype, device=device)
    return base[:, :P_ps].unflatten(1, (num_pages, page_size))


def _flat_with_drop_slot(pool: torch.Tensor) -> torch.Tensor:
    """The (P * ps + 1, KV, D) flat view of one layer's pool, drop slot
    included.  The pool must come from ``new_page_pool``."""
    P, ps = pool.shape[:2]
    rest = tuple(pool.shape[2:])
    row = math.prod(rest)
    need = (pool.storage_offset() + (P * ps + 1) * row) * pool.element_size()
    if not pool.is_contiguous() or pool.untyped_storage().nbytes() < need:
        raise ValueError("page pools and contiguous caches must be allocated "
                         "by new_page_pool (each layer carries a trailing "
                         "drop slot)")
    return pool.as_strided((P * ps + 1,) + rest, (row,) + pool.stride()[2:],
                           pool.storage_offset())


def update_kv_cache(cache: torch.Tensor, new: torch.Tensor,
                    offset) -> torch.Tensor:
    """Write ``new`` (B, T, KV, D) into ``cache`` (B, S, KV, D) at ``offset``,
    IN PLACE, and return ``cache``.

    ``offset`` may be a scalar (all rows aligned: prefill) or per-row (B,).
    As ``jax.lax.dynamic_update_slice`` in the JAX package, each row's start
    is clamped to [0, S - T] so the whole window lands: a window written at
    an offset past S - T lands at S - T, neither dropped nor refused.
    """
    if kops._is_dtensor(cache):
        return _update_kv_cache_sharded(cache, new, offset)
    B, T = new.shape[:2]
    S = cache.shape[1]
    offset = torch.as_tensor(offset, device=cache.device)
    if offset.dim() == 0:
        offset = offset.expand(B)
    start = offset.long().clamp(0, S - T)
    idx = start[:, None] + torch.arange(T, device=cache.device)[None, :]
    rows = torch.arange(B, device=cache.device)[:, None]
    cache[rows, idx] = new.to(cache.dtype)
    return cache


def _update_kv_cache_sharded(cache, new, offset):
    """``update_kv_cache`` into a DTensor cache, in place in each rank's
    local shard (DTensor has no in-place strategy for the indexed write):
    ``new`` and ``offset`` are redistributed to follow the cache's rows and
    kv heads, replicated where the cache shards its sequence over a mesh
    dim (the reference's sequence-over-model fallback).  There each rank
    writes the window positions that fall in its [lo, lo + S_local): a
    window of T <= S_local positions lands at ``pos % S_local``, distinct
    slots of which the ones outside the rank's range get their old value
    back; a longer window is gathered into the whole local shard.  No
    collective touches the cache itself."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = cache.device_mesh
    B, S = cache.shape[:2]
    T = new.shape[1]
    cpl = tuple(cache.placements)
    rep = (Replicate(),) * mesh.ndim

    def follow(t, dims):
        if not kops._is_dtensor(t):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        target = tuple(p if isinstance(p, Shard) and p.dim in dims
                       else Replicate() for p in cpl)
        return t.redistribute(mesh, target).to_local()

    offset = torch.as_tensor(offset, device=cache.device)
    if offset.dim() == 0:
        offset = offset.expand(B)
    n = follow(new.to(cache.dtype), (0, 2))
    start = follow(offset, (0,)).long().clamp(0, S - T)
    c = cache.to_local()
    rows = torch.arange(c.shape[0], device=c.device)[:, None]
    pos = start[:, None] + torch.arange(T, device=c.device)[None, :]
    seq = [i for i, p in enumerate(cpl) if isinstance(p, Shard) and p.dim == 1]
    if not seq:
        c[rows, pos] = n
        return cache
    coord = mesh.get_coordinate()
    shard = 0
    for i in seq:                   # major to minor, as DTensor shards
        shard = shard * mesh.size(i) + coord[i]
    S_loc = c.shape[1]
    lo = shard * S_loc
    if T <= S_loc:
        slot = pos % S_loc
        ok = ((pos >= lo) & (pos < lo + S_loc))[..., None, None]
        c[rows, slot] = torch.where(ok, n, c[rows, slot])
    else:
        w = lo + torch.arange(S_loc, device=c.device)[None, :] - start[:, None]
        ok = ((w >= 0) & (w < T))[..., None, None]
        idx = w.clamp(0, T - 1)[..., None, None].expand(-1, -1, *c.shape[2:])
        c.copy_(torch.where(ok, n.gather(1, idx), c))
    return cache


def causal_mask(Sq: int, Skv: int, offset: int = 0,
                device="cuda") -> torch.Tensor:
    """(1, 1, 1, Sq, Skv) boolean mask: query i attends to kv j <= i+offset."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    kj = torch.arange(Skv, device=device)[None, :]
    return (kj <= qi)[None, None, None]


def paged_update_kv_cache(pool: torch.Tensor, new: torch.Tensor, offset,
                          page_table: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, T, KV, D) into a page pool (P, ps, KV, D), IN PLACE.

    Logical position ``p`` of row ``b`` lives at physical page
    ``page_table[b, p // ps]``, in-page slot ``p % ps``.  Writes through
    unmapped table entries (-1) or past the table width are dropped: they go
    to the pool's drop slot (flat index P * ps), which frozen and retired
    engine rows rely on.  Every dropped write shares that slot, so the
    scatter has duplicate indices there and only there.  Updating in place
    saves a pool-sized copy per layer per forward; returns ``pool``.
    """
    B, T = new.shape[:2]
    P, ps = pool.shape[:2]
    offset = torch.as_tensor(offset, device=pool.device)
    if offset.dim() == 0:
        offset = offset.expand(B)
    pos = (offset[:, None].to(torch.int64)
           + torch.arange(T, device=pool.device)[None, :])
    flat = _drop_or_flat(pos, page_table, ps, P)
    _flat_with_drop_slot(pool).index_copy_(
        0, flat.reshape(-1),
        new.to(pool.dtype).reshape((B * T,) + tuple(new.shape[2:])))
    return pool


def paged_gather_kv(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Materialize the logical (B, n_slots * ps, KV, D) view of a page pool.
    Unmapped slots (-1) clamp to page 0; callers mask them by position."""
    B, n_slots = page_table.shape
    ps = pool.shape[1]
    gathered = pool[page_table.clamp(min=0).long()]
    return gathered.reshape((B, n_slots * ps) + tuple(pool.shape[2:]))


def _window_flat(pos: torch.Tensor, page_table: torch.Tensor, ps: int):
    """(physical page, table slot, in-page offset) of each logical position
    ``pos`` (B, T) through ``page_table``, all int64; unmapped entries give
    a negative page, slots past the table read its last entry."""
    n_slots = page_table.shape[1]
    pos = pos.long()
    slot = torch.div(pos, ps, rounding_mode="floor")
    phys = page_table.long().gather(1, slot.clamp(0, n_slots - 1))
    return phys, slot, pos % ps


def _drop_or_flat(pos: torch.Tensor, page_table: torch.Tensor, ps: int,
                  P: int, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Flat pool index (page * ps + offset) of each logical position; those
    through -1 entries, past the table or not ``valid`` get the drop slot's
    index P * ps."""
    phys, slot, off = _window_flat(pos, page_table, ps)
    ok = (phys >= 0) & (slot < page_table.shape[1])
    if valid is not None:
        ok = ok & valid
    return torch.where(ok, phys * ps + off,
                       torch.full((), P * ps, device=pos.device))


def gather_kv_window(leaf: torch.Tensor, pos: torch.Tensor,
                     page_table: torch.Tensor | None = None) -> torch.Tensor:
    """Gather K/V rows at logical positions ``pos`` (B, T) from a stacked
    cache leaf: (Ln, B, S, KV, D) contiguous, or (Ln, P, ps, KV, D) pools
    with ``page_table`` (B, n_slots).  Out-of-range and unmapped positions
    clamp to a valid slot (contiguous: to [0, S - 1]); callers mask by
    validity.  Returns a new (Ln, B, T, KV, D) tensor."""
    if page_table is None:
        S = leaf.shape[2]
        rows = torch.arange(leaf.shape[1], device=leaf.device)[:, None]
        return leaf[:, rows, pos.long().clamp(0, S - 1)]
    ps = leaf.shape[2]
    phys, _, off = _window_flat(pos, page_table, ps)
    return leaf.flatten(1, 2)[:, phys.clamp(min=0) * ps + off]


def scatter_kv_window(leaf: torch.Tensor, values: torch.Tensor,
                      pos: torch.Tensor, valid: torch.Tensor,
                      page_table: torch.Tensor | None = None) -> torch.Tensor:
    """Write ``values`` (Ln, B, T, KV, D) into a stacked cache leaf at
    logical positions ``pos`` (B, T) where ``valid`` (B, T), IN PLACE: a
    contiguous (Ln, B, S, KV, D) cache, or page pools (Ln, P, ps, KV, D)
    through ``page_table``.  Invalid, out-of-range and unmapped positions go
    to each layer's drop slot (the JAX package's ``mode="drop"``, and the
    contract of ``paged_update_kv_cache``).  This is the scatter-commit
    primitive: the engine moves the accepted tree branch's K/V into its
    committed slots instead of re-forwarding the path.  ``values`` must not
    alias ``leaf`` (gather first).  Returns ``leaf``."""
    if page_table is None:
        B, S = leaf.shape[1:3]
        pos = pos.long()
        ok = valid & (pos >= 0) & (pos < S)
        rows = torch.arange(B, device=leaf.device)[:, None]
        flat = torch.where(ok, rows * S + pos,
                           torch.full((), B * S, device=leaf.device))
    else:
        P, ps = leaf.shape[1:3]
        flat = _drop_or_flat(pos, page_table, ps, P, valid)
    flat = flat.reshape(-1)
    for layer, vals in zip(leaf, values.to(leaf.dtype).flatten(1, 2)):
        _flat_with_drop_slot(layer).index_copy_(0, flat, vals)
    return leaf


def tree_window_mask(pos: torch.Tensor, window_mask: torch.Tensor,
                     S_max: int) -> torch.Tensor:
    """(B, 1, 1, T, S_max) attention mask of a token-tree window written at
    cache positions [pos_b, pos_b + T): query row t attends every committed
    position [0, pos_b) plus window position pos_b + t' iff
    ``window_mask[b, t, t']`` (the tree's ancestor-or-self matrix).  With a
    lower-triangular matrix this is the causal window mask.  The serving
    path runs ``ops.paged_tree_attention`` / ``ops.tree_attention``
    instead; this is the dense form the tests compare against."""
    B, T = window_mask.shape[:2]
    kj = torch.arange(S_max, device=window_mask.device)
    pos = pos.long()
    committed = kj[None, None, :] < pos[:, None, None]            # (B, 1, S)
    w = kj[None, :] - pos[:, None]                                # (B, S)
    in_win = (w >= 0) & (w < T)
    idx = w.clamp(0, T - 1)[:, None, :].expand(B, T, S_max)
    allow = window_mask.bool().gather(2, idx)                     # (B, T, S)
    return (committed | (allow & in_win[:, None, :]))[:, None, None]


def attention_apply(params: Params, x: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int, positions: torch.Tensor,
                    rope_theta: float | None, kv_cache=None, cache_offset=None,
                    page_table: torch.Tensor | None = None,
                    window_mask: torch.Tensor | None = None,
                    mask: torch.Tensor | None = None, window: int = 0):
    """Full attention layer.  Returns (out, (k, v)): the updated caches, or
    the fresh keys and values when there is no cache.  ``rope_theta`` None
    applies no rotary embedding (a NoPE layer); ``window`` > 0 is a
    sliding-window layer's key window, passed to ``ops.paged_attention``
    (the paged sequential windows only: cache-free scoring takes it in
    ``mask``).

    * ``kv_cache=None``: cache-free attention under ``mask`` (full-sequence
      scoring, ``apply``).
    * ``page_table`` given: ``kv_cache`` holds page pools (P, ps, KV, D);
      the window's keys and values are written at ``cache_offset`` through
      the table (in place).  A sequential window (no ``window_mask``) then
      runs ``ops.paged_attention`` (row t attends [0, cache_offset + t]); a
      token-tree window (``window_mask`` (B, T, T), the ancestor-or-self
      matrix) runs ``ops.paged_tree_attention`` with lengths = offset.
    * no table: ``kv_cache`` holds contiguous (B, S, KV, D) caches; the
      window is written at ``cache_offset`` (in place, clamped as
      ``update_kv_cache``).  A tree window runs ``ops.tree_attention``
      (lengths = offset).  The prefill (``cache_offset`` the python int 0)
      runs ``ops.flash_attention`` causally over the window's own keys and
      values, cast to the cache dtype as the cache then holds them: key j
      <= i are exactly the ones written.  A T = 1 window runs
      ``ops.decode_attention`` with lengths = offset + 1 (an offset >= S
      writes at S - 1 and attends all S keys, as the mask did).  Other
      sequential windows (T > 1 at per-row offsets: the J=1 verify window)
      run ``gqa_attention`` over the whole cache under ``mask``.  The JAX
      package runs ``gqa_attention`` for all three (``layers.py:364``): the
      function is the same, the dispatch differs.
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, num_heads, num_kv_heads, head_dim)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if kv_cache is None:
        out = gqa_attention(q, k, v, mask)
        return out.reshape(B, S, num_heads * head_dim) @ params["wo"], (k, v)
    k_cache, v_cache = kv_cache
    q = q.to(k_cache.dtype).contiguous()
    if page_table is None and window_mask is None and isinstance(
            cache_offset, int) and cache_offset == 0:
        k, v = k.to(k_cache.dtype), v.to(v_cache.dtype)
        ctx = kops.flash_attention(q, k, v, causal=True)
        if kops._is_dtensor(k_cache):
            update_kv_cache(k_cache, k, 0)
            update_kv_cache(v_cache, v, 0)
        else:
            k_cache[:, :S] = k
            v_cache[:, :S] = v
        out = ctx.to(x.dtype).reshape(B, S, num_heads * head_dim) @ params["wo"]
        return out, (k_cache, v_cache)
    if isinstance(cache_offset, int):
        offset = torch.full((B,), cache_offset, dtype=torch.int32,
                            device=x.device)
    else:
        offset = torch.as_tensor(cache_offset, device=x.device).expand(B)
    if page_table is not None:
        paged_update_kv_cache(k_cache, k, offset, page_table)
        paged_update_kv_cache(v_cache, v, offset, page_table)
        if window_mask is not None:
            ctx = kops.paged_tree_attention(
                q, k_cache, v_cache, page_table,
                offset.to(torch.int32).contiguous(), window_mask)
        else:
            ctx = kops.paged_attention(q, k_cache, v_cache, page_table,
                                       (offset + 1).to(torch.int32).contiguous(),
                                       window=window)
    else:
        update_kv_cache(k_cache, k, offset)
        update_kv_cache(v_cache, v, offset)
        if window_mask is not None:
            ctx = kops.tree_attention(q, k_cache, v_cache,
                                      offset.to(torch.int32).contiguous(),
                                      window_mask)
        elif S == 1:
            ctx = kops.decode_attention(
                q[:, 0], k_cache, v_cache,
                (offset + 1).to(torch.int32).contiguous())[:, None]
        else:
            if mask is None:
                raise ValueError("a contiguous window of T > 1 tokens at "
                                 "per-row offsets needs its mask")
            ctx = gqa_attention(q, k_cache, v_cache, mask)
    out = ctx.to(x.dtype).reshape(B, S, num_heads * head_dim) @ params["wo"]
    return out, (k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / GELU)
# ---------------------------------------------------------------------------

GATED = ("swiglu", "geglu", "reglu")


def gated(gate: torch.Tensor, up: torch.Tensor, activation: str) -> torch.Tensor:
    """The gated unit of a GLU MLP or expert: act(gate) * up."""
    if activation == "swiglu":
        return F.silu(gate) * up
    if activation == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if activation == "reglu":
        return F.relu(gate) * up
    raise ValueError(f"no gated unit for activation {activation}")


def init_mlp(gen, d_model: int, d_ff: int, activation: str,
             dtype=torch.float32) -> Params:
    if activation in GATED:
        return {"w_gate": dense_init(gen, d_model, d_ff, dtype),
                "w_up": dense_init(gen, d_model, d_ff, dtype),
                "w_down": dense_init(gen, d_ff, d_model, dtype)}
    return {"w_up": dense_init(gen, d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype)}


def mlp_apply(params: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    def up(name):
        # the hidden units over model, the tokens as the batch rule says
        # (a no-op without an active mesh): DTensor would otherwise
        # reduce-scatter the partial sums over the tokens, whose flattened
        # (B * S) its next matmul cannot take
        return logical_constraint(x @ params[name], "batch", None, "heads")

    if activation == "swiglu":
        return (F.silu(up("w_gate")) * up("w_up")) @ params["w_down"]
    if activation == "geglu":
        return (F.gelu(up("w_gate"), approximate="tanh")
                * up("w_up")) @ params["w_down"]
    if activation == "reglu":
        return (F.relu(up("w_gate")) * up("w_up")) @ params["w_down"]
    if activation == "gelu":
        return F.gelu(up("w_up"), approximate="tanh") @ params["w_down"]
    raise ValueError(f"unknown activation {activation}")


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based dispatch with capacity)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    activation: str = "swiglu"     # swiglu | geglu | reglu | gelu
    capacity_factor: float = 1.25
    num_shared_experts: int = 0    # always-on shared experts (DeepSeek style)
    shared_d_ff: int = 0
    dense_residual: bool = False   # Arctic-style parallel dense MLP
    dense_d_ff: int = 0


def init_moe(gen, d_model: int, mcfg: MoEConfig, dtype=torch.float32) -> Params:
    """Router (float32), the E experts' stacked (E, d, F) / (E, F, d)
    weights, drawn in ``dtype`` on the generator's device (no float32 copy
    of a full-width expert stack), and the shared / dense-residual MLPs."""
    E, F = mcfg.num_experts, mcfg.d_ff

    def experts(shape, scale):
        w = torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
        return w.mul_(scale)

    p = {
        "router": dense_init(gen, d_model, E, dtype=torch.float32),
        "w_gate": experts((E, d_model, F), 1.0 / math.sqrt(d_model)),
        "w_up": experts((E, d_model, F), 1.0 / math.sqrt(d_model)),
        "w_down": experts((E, F, d_model), 1.0 / math.sqrt(F)),
    }
    if mcfg.num_shared_experts > 0:
        p["shared"] = init_mlp(gen, d_model,
                               mcfg.shared_d_ff or F * mcfg.num_shared_experts,
                               mcfg.activation, dtype)
    if mcfg.dense_residual:
        p["dense"] = init_mlp(gen, d_model, mcfg.dense_d_ff or F,
                              mcfg.activation, dtype)
    return p


def moe_capacity(tokens: int, mcfg: MoEConfig,
                 capacity_factor: float | None = None) -> int:
    """Slots per expert, from shapes on the host: ceil(T K / E * cf), the
    JAX package's float expression (at cf = E / K, the no-drop factor, it
    gives C = T)."""
    cf = capacity_factor if capacity_factor is not None else mcfg.capacity_factor
    return int(math.ceil(tokens * mcfg.top_k / mcfg.num_experts * cf))


def moe_apply(params: Params, x: torch.Tensor, mcfg: MoEConfig,
              capacity_factor: float | None = None,
              router_x: torch.Tensor | None = None, dropless: bool = False,
              count: tuple | None = None):
    """Sort-based top-k MoE dispatch with capacity (GShard style), as the
    JAX package's ``moe_apply``.  x (B, S, d) -> (out (B, S, d), aux), aux
    the load-balancing loss of Switch Transformers.  The router scores
    ``router_x`` (B, S, d) where given (a router placed before attention
    reads the attention's normed input), else ``x``.

    Everything stays on the device and makes no host sync: the capacity C
    comes from shapes; the routed items are sorted by expert with a stable
    ``argsort``, each item's rank in its expert's run is its index minus
    ``searchsorted`` of its expert, and items past C go to the drop bin,
    row E * C of the dispatch buffer.  The experts run as three batched
    products over the (E, C, d) buffer.  The combine undoes the sort with
    the inverse permutation (a gather, deterministic on the card) and sums
    each token's K contributions in float32 over a (T, K, d) view, in a
    fixed order, where the JAX package has ``segment_sum``.

    ``dropless``: no capacity and no drop; the routed rows alone, sorted by
    expert, run as three grouped products (``torch._grouped_mm``) whose
    group ends are ``searchsorted`` on the device (``moe_dropless``), with
    the same combine: the layer at C = T (cf = E / K) without the (E, T, d)
    buffer and its E / K times the routed work.  It needs a bfloat16 input
    on a CUDA device (the card's grouped kernel; on the CPU any dtype) and
    rows 16-byte aligned, and runs the capacity path at C = T otherwise.
    ``count`` = (counts (E,) int32, needed (B, S) bool) writes, for
    tracing, the routed rows of the needed tokens per expert into
    ``counts`` (on the device, no sync).

    A DTensor ``x`` is dispatched by explicit redistribution: the routing
    (top-k, ``argsort``, ``searchsorted``, the dispatch and combine
    scatters, which have no DTensor sharding strategy) runs on every rank
    over all T tokens, all-gathered with the router, so capacity and drops
    are the global ones of the reference; the three expert products run as
    DTensor ``bmm``s of the replicated dispatch buffer with the experts in
    their own placements (experts over ``model``, d over the data axes),
    and the expert outputs are all-gathered back for the combine.  The
    shared and dense-residual MLPs run on ``x`` as it is sharded (a
    DTensor runs the capacity path, at C = T for ``dropless``)."""
    B, S, d = x.shape
    E, K = mcfg.num_experts, mcfg.top_k
    T = B * S
    sharded = kops._is_dtensor(x)
    if dropless and (sharded or not _grouped_ok(x, mcfg)):
        dropless, capacity_factor = False, E / K
    C = moe_capacity(T, mcfg, capacity_factor)
    rx = x if router_x is None else router_x
    if sharded:
        from torch.distributed.tensor import DTensor, Replicate

        mesh = x.device_mesh
        rep = (Replicate(),) * mesh.ndim
        xt = x.redistribute(mesh, rep).to_local().reshape(T, d)
        rt = (xt if router_x is None
              else rx.redistribute(mesh, rep).to_local().reshape(T, d))
        router = params["router"].redistribute(mesh, rep).to_local()
    else:
        xt = x.reshape(T, d)
        rt = rx.reshape(T, d)
        router = params["router"]
    dev = xt.device

    logits = rt.float() @ router.float()                         # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)          # (T, K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # load-balancing aux loss (Switch eq. 4); the one-hot by comparison
    experts_row = torch.arange(E, device=dev)
    me = probs.mean(dim=0)
    ce = (expert_idx[:, :1] == experts_row).float().mean(dim=0)
    aux = E * (me * ce).sum()
    if count is not None:
        counts, needed = count
        counts.zero_()
        counts.index_add_(0, expert_idx.reshape(-1),
                          needed.reshape(T, 1).expand(T, K).reshape(-1)
                          .to(counts.dtype))

    if dropless:
        with (trace.NULL_SPAN if trace.active() is None else trace.span(
                "ops.moe", cat="kernel",
                args={"shape": [T, d], "dtype": str(x.dtype),
                      "backend": "grouped"})):
            y = moe_dropless(params, xt, expert_idx, gate_vals, mcfg)
        return _moe_tail(params, x, y.reshape(B, S, d), mcfg), aux

    flat_expert = expert_idx.reshape(-1)                          # (T*K,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order].contiguous()
    first = torch.searchsorted(sorted_expert, sorted_expert, side="left")
    pos_in_expert = torch.arange(T * K, device=dev) - first
    keep_sorted = pos_in_expert < C
    slot_sorted = torch.where(keep_sorted, sorted_expert * C + pos_in_expert,
                              torch.full((), E * C, device=dev))
    sorted_token = torch.div(order, K, rounding_mode="floor")

    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    # every dropped item lands in row E * C, which nothing reads
    buf.index_copy_(0, slot_sorted, xt.index_select(0, sorted_token))
    buf = buf[:-1].reshape(E, C, d)
    if sharded:
        buf = DTensor.from_local(buf, mesh, rep, run_check=False)
    if mcfg.activation in GATED:
        h = gated(torch.bmm(buf, params["w_gate"]),
                  torch.bmm(buf, params["w_up"]), mcfg.activation)
    else:
        h = F.gelu(torch.bmm(buf, params["w_up"]), approximate="tanh")
    out = torch.bmm(h, params["w_down"])
    if sharded:
        out = out.redistribute(mesh, rep).to_local()
    out_buf = torch.cat([out.reshape(E * C, d),
                         torch.zeros((1, d), dtype=x.dtype, device=dev)])

    # undo the sort: item i of the flat (T, K) order sits at inv[i]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=dev))
    slot = slot_sorted.index_select(0, inv)
    keep = keep_sorted.index_select(0, inv)
    weight = (gate_vals.reshape(-1) * keep).to(x.dtype)
    contrib = out_buf.index_select(0, slot) * weight[:, None]
    y = contrib.reshape(T, K, d).float().sum(dim=1).to(x.dtype)
    y = y.reshape(B, S, d)
    if sharded:
        y = DTensor.from_local(y, mesh, rep, run_check=False)
        y = y.redistribute(mesh, x.placements)
        aux = DTensor.from_local(aux, mesh, rep, run_check=False)
    return _moe_tail(params, x, y, mcfg), aux


def _moe_tail(params: Params, x: torch.Tensor, y: torch.Tensor,
              mcfg: MoEConfig) -> torch.Tensor:
    """The routed experts' output ``y`` plus the shared and dense-residual
    MLPs on ``x``."""
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x, mcfg.activation)
    if "dense" in params:
        y = y + mlp_apply(params["dense"], x, mcfg.activation)
    return y


def _grouped_ok(x: torch.Tensor, mcfg: MoEConfig) -> bool:
    """Whether ``moe_dropless`` runs on ``x``: the card's grouped kernel
    takes bfloat16 (its other dtypes would leave the device for their group
    sizes), the CPU any dtype; the rows of x, the hidden units and the
    expert matrices 16-byte aligned."""
    align = 16 // x.element_size()
    if x.is_cuda and x.dtype != torch.bfloat16:
        return False
    return x.shape[-1] % align == 0 and mcfg.d_ff % align == 0


def moe_dropless(params: Params, xt: torch.Tensor, expert_idx: torch.Tensor,
                 gate_vals: torch.Tensor, mcfg: MoEConfig) -> torch.Tensor:
    """The routed experts of tokens ``xt`` (T, d) at their top-k choices
    ``expert_idx`` / ``gate_vals`` (T, K), dropping none -> (T, d).

    The T * K routed rows are sorted by expert (stable), and each expert
    product is one ``torch._grouped_mm`` over the sorted rows with the
    group ends ``offs`` found by ``searchsorted`` on the device: no host
    sync, no padding, only routed rows computed.  The combine is the
    capacity path's: the inverse permutation gathers each item back, and
    each token's K contributions, weighted, sum in float32 in a fixed
    order."""
    T, d = xt.shape
    E, K = mcfg.num_experts, mcfg.top_k
    dev = xt.device
    flat_expert = expert_idx.reshape(-1)                          # (T*K,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order].contiguous()
    offs = torch.searchsorted(sorted_expert, torch.arange(E, device=dev),
                              right=True).to(torch.int32)
    rows = xt.index_select(0, torch.div(order, K, rounding_mode="floor"))

    def gmm(a, w):
        return torch._grouped_mm(a, w, offs=offs)

    if mcfg.activation in GATED:
        h = gated(gmm(rows, params["w_gate"]), gmm(rows, params["w_up"]),
                  mcfg.activation)
    else:
        h = F.gelu(gmm(rows, params["w_up"]), approximate="tanh")
    out = gmm(h, params["w_down"])                                # sorted
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=dev))
    weight = gate_vals.reshape(-1).to(xt.dtype)
    contrib = out.index_select(0, inv) * weight[:, None]
    return contrib.reshape(T, K, d).float().sum(dim=1).to(xt.dtype)

