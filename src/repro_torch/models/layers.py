"""Dense decoder building blocks on torch tensors.

Functional like the JAX package: parameters are plain dicts of tensors with
the same names and layouts, and projections compute ``x @ W`` with W shaped
(in, out), so parameters carried across from the JAX package need no
transpose.  Only the dense path of the J=1 paged serving slice is here; the
contiguous cache layout, token-tree windows and MoE are not ported yet
(ROADMAP A2, A7, A12).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

Params = Any  # nested dict of tensors


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
    q = q.reshape(B, S, num_heads, head_dim)
    k = k.reshape(B, S, num_kv_heads, head_dim)
    v = v.reshape(B, S, num_kv_heads, head_dim)
    return q, k, v


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None,
                  scale: float | None = None) -> torch.Tensor:
    """Grouped-query attention core over materialized K/V.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D); mask broadcastable to
    (B, KV, G, Sq, Skv) or None.  Returns (B, Sq, H, D).  The serving path
    runs ``ops.paged_attention`` instead; this is the dense formulation
    the tests compare against.
    """
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.full((), -1e30, device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, Sq, H, D)


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------

def new_page_pool(n_layers: int, num_pages: int, page_size: int,
                  num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                  device="cuda") -> torch.Tensor:
    """A zeroed (layers, P, ps, KV, D) page pool.

    Each layer's (P, ps, KV, D) slice is contiguous and is followed in
    memory by one extra (KV, D) slot, the drop bin of
    ``paged_update_kv_cache`` (flat index P * ps, as in the JAX package).
    The slot lies outside the returned view, so shapes and byte accounting
    are those of the JAX pool."""
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
        raise ValueError("page pools must be allocated by new_page_pool "
                         "(each layer carries a trailing drop slot)")
    return pool.as_strided((P * ps + 1,) + rest, (row,) + pool.stride()[2:],
                           pool.storage_offset())


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
    n_slots = page_table.shape[1]
    offset = torch.as_tensor(offset, device=pool.device)
    if offset.dim() == 0:
        offset = offset.expand(B)
    pos = (offset[:, None].to(torch.int64)
           + torch.arange(T, device=pool.device)[None, :])
    slot = torch.div(pos, ps, rounding_mode="floor")
    phys = page_table.to(torch.int64).gather(1, slot.clamp(0, n_slots - 1))
    ok = (phys >= 0) & (slot < n_slots)
    flat = torch.where(ok, phys * ps + pos % ps,
                       torch.full((), P * ps, device=pool.device))
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


def attention_apply(params: Params, x: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int, positions: torch.Tensor,
                    rope_theta: float | None, kv_cache, cache_offset,
                    page_table: torch.Tensor | None):
    """Attention layer of a sequential window through a paged KV cache.

    The window's keys and values are written at ``cache_offset`` through
    ``page_table`` (in place), then ``ops.paged_attention`` attends row t to
    logical positions [0, cache_offset + t].  Returns (out, (k_pool,
    v_pool)).  Caches without a page table (the contiguous layout) are not
    ported yet (ROADMAP A2)."""
    if kv_cache is None or page_table is None:
        raise NotImplementedError(
            "the contiguous cache layout and cache-free attention are not "
            "ported yet (ROADMAP A2); the port serves paged caches")
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, num_heads, num_kv_heads, head_dim)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    k_pool, v_pool = kv_cache
    paged_update_kv_cache(k_pool, k, cache_offset, page_table)
    paged_update_kv_cache(v_pool, v, cache_offset, page_table)
    offset = torch.as_tensor(cache_offset, device=x.device)
    lengths = (offset.expand(B) + 1).to(torch.int32).contiguous()
    ctx = kops.paged_attention(q.to(k_pool.dtype).contiguous(), k_pool,
                               v_pool, page_table, lengths)
    out = ctx.to(x.dtype).reshape(B, S, num_heads * head_dim) @ params["wo"]
    return out, (k_pool, v_pool)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / GELU)
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, activation: str,
             dtype=torch.float32) -> Params:
    if activation in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, d_model, d_ff, dtype),
                "w_up": dense_init(gen, d_model, d_ff, dtype),
                "w_down": dense_init(gen, d_ff, d_model, dtype)}
    return {"w_up": dense_init(gen, d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype)}


def mlp_apply(params: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]
    if activation == "geglu":
        return (F.gelu(x @ params["w_gate"], approximate="tanh")
                * (x @ params["w_up"])) @ params["w_down"]
    if activation == "gelu":
        return F.gelu(x @ params["w_up"], approximate="tanh") @ params["w_down"]
    raise ValueError(f"unknown activation {activation}")
