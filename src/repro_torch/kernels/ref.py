"""Plain PyTorch versions of the kernels on the serving paths.

Each function is the semantic ground truth of one hand-written CUDA kernel
in ``csrc/``: the CPU path of ``ops.py`` runs it, and the card tests hold
the kernel against it on the same inputs.  The functions mirror the JAX
package's oracles operation for operation, with the deliberate differences
noted at ``paged_attention_ref`` and ``paged_tree_attention_ref`` (rows
that see no key; ``decode_attention_ref`` keeps the oracle's answer there)
and at ``decode_attention_quantized_ref`` (its output dtype).
``ssd_decode_ref`` and ``quantize_kv`` have no kernel: they are plain
PyTorch on every device, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Causal (or full) GQA attention of q over k/v: the prefill.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D) -> (B, Sq, H, D).  With
    ``causal`` query i attends kv j <= i + (Skv - Sq) (the bottom-right
    offset: the queries are the last Sq positions).  Masked logits are
    -1e30 and the probabilities are cast to v's dtype before the PV
    product, as in the JAX oracle."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    if causal:
        mask = (torch.arange(Skv, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq))
        logits = torch.where(mask, logits, torch.full((), _NEG,
                                                      device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, Sq, H, D)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """One query step against a contiguous KV cache.

    q: (B, H, D); caches: (B, S, KV, D); lengths: (B,) -> (B, H, D); row b
    attends cache positions [0, lengths_b) (all S when lengths_b >= S).  As
    the JAX oracle, a row with lengths_b <= 0 takes the softmax over all
    -1e30, the mean of its S values, where the kernel returns 0; such rows
    are never committed."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, D)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k_cache).float() * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.long()[:, None])[:, None, None, :]
    logits = torch.where(valid, logits, torch.full((), _NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v_cache)
    return out.reshape(B, H, D)


def decode_attention_quantized_ref(q: torch.Tensor, k_cache: torch.Tensor,
                                   v_cache: torch.Tensor,
                                   k_scale: torch.Tensor,
                                   v_scale: torch.Tensor,
                                   lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over an int8-quantized KV cache.

    k_cache / v_cache: (B, S, KV, D) int8; scales: (B, KV) float32 per-head
    dequant factors.  Dequantize to float32, then run the exact path (the
    kernel fuses the dequant into its tile loads instead).  The JAX oracle
    promotes the whole product to float32; here the result is cast to
    ``q.dtype``, as the Pallas kernel returns it (equal for a float32 q)."""
    k = k_cache.float() * k_scale[:, None, :, None]
    v = v_cache.float() * v_scale[:, None, :, None]
    return decode_attention_ref(q.float(), k, v, lengths).to(q.dtype)


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """Per (batch, kv-head) symmetric int8 quantization of a KV cache:
    (kq, k_scale, vq, v_scale), codes (B, S, KV, D) int8 and scales (B, KV)
    float32.  ``torch.round`` rounds half to even, as ``jnp.round``."""
    def q_one(x):
        xf = x.float()
        scale = xf.abs().amax(dim=(1, 3)) / 127.0
        scale = scale.clamp(min=1e-8)
        q = torch.clamp(torch.round(xf / scale[:, None, :, None]), -127, 127)
        return q.to(torch.int8), scale
    kq, ks = q_one(k)
    vq, vs = q_one(v)
    return kq, ks, vq, vs


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor,
                        scale: float | None = None,
                        window: int = 0) -> torch.Tensor:
    """Decode/window attention through a paged KV cache.

    q: (B, T, H, D) window queries (T=1 decode, T=L+1 verification).
    k_pool / v_pool: (P, ps, KV, D) physical page pools.
    page_table: (B, n_slots) int32, physical page per logical slot (-1 =
        unmapped: those positions are masked out).
    lengths: (B,) valid kv count for query row 0; query row t attends
        logical positions [0, lengths_b + t).
    window: > 0 for a sliding-window layer: row t attends only the last
        ``window`` of those positions, [lengths_b + t - window, lengths_b +
        t); slots wholly below every row's window are never read (-1 there
        is masked like any unmapped slot).
    Returns (B, T, H, D).

    A query row that sees no key at all (an all-(-1) table row: retired or
    padding rows) returns 0, as the attention kernels do.  The JAX oracle
    returns the mean of page 0's values there instead (a softmax over all
    -1e30); such rows are never committed.
    """
    B, T, H, D = q.shape
    P, ps, KV, _ = k_pool.shape
    n_slots = page_table.shape[1]
    S = n_slots * ps
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    safe = page_table.clamp(min=0).long()
    k = k_pool[safe].reshape(B, S, KV, D)
    v = v_pool[safe].reshape(B, S, KV, D)
    qg = q.reshape(B, T, KV, G, D)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k).float() * scale
    kpos = torch.arange(S, device=q.device)
    horizon = lengths.long()[:, None] + torch.arange(T, device=q.device)[None]
    valid = kpos[None, None, :] < horizon[:, :, None]              # (B, T, S)
    if window > 0:
        valid = valid & (kpos[None, None, :] >= horizon[:, :, None] - window)
    mapped = (page_table >= 0).repeat_interleave(ps, dim=1)       # (B, S)
    valid = valid & mapped[:, None, :]
    logits = torch.where(valid[:, None, None], logits,
                         torch.full((), _NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    seen = valid.any(dim=-1)[:, None, None, :, None]              # (B,1,1,T,1)
    probs = torch.where(seen, probs, torch.zeros((), device=q.device))
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
    return out.reshape(B, T, H, D)


def tree_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, lengths: torch.Tensor,
                       win_mask: torch.Tensor,
                       scale: float | None = None) -> torch.Tensor:
    """Token-tree verification window over a contiguous KV cache.

    q: (B, T, H, D) — the T-token tree window (slot 0 the pending token,
        slots 1.. the tree nodes in construction order).
    k_cache / v_cache: (B, S, KV, D); the window's K/V are already written
        at positions [lengths_b, lengths_b + T) (update-then-attend order).
    lengths: (B,) committed kv count — every query row attends [0, lengths_b).
    win_mask: (B, T, T) bool — query row t attends window position
        lengths_b + t' iff win_mask[b, t, t'] (the tree's ancestor-or-self
        matrix; a lower-triangular mask is the sequential causal window).
    Returns (B, T, H, D).  The probabilities are cast to the cache dtype
    before the PV product, as in the JAX oracle.
    """
    B, T, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, T, KV, G, D)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k_cache).float() * scale
    kpos = torch.arange(S, device=q.device)
    base = lengths.long()[:, None]                                 # (B, 1)
    committed = (kpos[None, :] < base)[:, None, :]                 # (B, 1, S)
    w = kpos[None, :] - base                                       # (B, S)
    in_win = (w >= 0) & (w < T)
    idx = w.clamp(0, T - 1)[:, None, :].expand(B, T, S)
    allow = win_mask.bool().gather(2, idx) & in_win[:, None, :]    # (B, T, S)
    valid = committed | allow
    logits = torch.where(valid[:, None, None], logits,
                         torch.full((), _NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v_cache)
    return out.reshape(B, T, H, D)


def paged_tree_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, page_table: torch.Tensor,
                             lengths: torch.Tensor, win_mask: torch.Tensor,
                             scale: float | None = None) -> torch.Tensor:
    """Token-tree verification window through a paged KV cache.

    q: (B, T, H, D) — the T-token tree window (slot 0 the pending token,
        slots 1.. the tree nodes in construction order).
    k_pool / v_pool: (P, ps, KV, D); the window's K/V are already written at
        logical positions [lengths_b, lengths_b + T).
    page_table: (B, n_slots) int32 (-1 = unmapped: masked out).
    lengths: (B,) committed kv count — every query row attends [0, lengths_b).
    win_mask: (B, T, T) bool — query row t attends window position
        lengths_b + t' iff win_mask[b, t, t'] (the tree's ancestor-or-self
        matrix; a lower-triangular mask is ``paged_attention_ref`` at
        lengths + 1).
    Returns (B, T, H, D).

    Unmapped slots are masked and a row that sees no key returns 0, as in
    the Pallas kernel.  The JAX oracle gathers through ``max(table, 0)``
    without a mapped test, so a retired row (all -1, lengths > 0) attends
    page 0 there; such rows are never committed.
    """
    B, T, H, D = q.shape
    P, ps, KV, _ = k_pool.shape
    n_slots = page_table.shape[1]
    S = n_slots * ps
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    safe = page_table.clamp(min=0).long()
    k = k_pool[safe].reshape(B, S, KV, D)
    v = v_pool[safe].reshape(B, S, KV, D)
    qg = q.reshape(B, T, KV, G, D)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k).float() * scale
    kpos = torch.arange(S, device=q.device)
    base = lengths.long()[:, None]                                 # (B, 1)
    committed = (kpos[None, :] < base)[:, None, :]                 # (B, 1, S)
    w = kpos[None, :] - base                                       # (B, S)
    in_win = (w >= 0) & (w < T)
    idx = w.clamp(0, T - 1)[:, None, :].expand(B, T, S)
    allow = win_mask.bool().gather(2, idx) & in_win[:, None, :]    # (B, T, S)
    mapped = (page_table >= 0).repeat_interleave(ps, dim=1)       # (B, S)
    valid = (committed | allow) & mapped[:, None, :]
    logits = torch.where(valid[:, None, None], logits,
                         torch.full((), _NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    seen = valid.any(dim=-1)[:, None, None, :, None]              # (B,1,1,T,1)
    probs = torch.where(seen, probs, torch.zeros((), device=q.device))
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
    return out.reshape(B, T, H, D)


def gather_softmax_prob_ref(logits: torch.Tensor,
                            token_ids: torch.Tensor) -> torch.Tensor:
    """logits: (N, V); token_ids: (N,) -> softmax(logits)[token] (N,)."""
    logits = logits.float()
    m = logits.max(dim=-1, keepdim=True).values
    z = torch.exp(logits - m).sum(dim=-1)
    picked = logits.gather(-1, token_ids.long()[:, None])[:, 0]
    return torch.exp(picked - m[:, 0]) / z


def residual_sample_ref(p: torch.Tensor, q: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """Sample from normalize(max(p - q, 0)) by inverse CDF.

    p, q: (N, V) probability rows; u: (N,) uniforms in [0,1) -> tokens (N,)
    int32.  argmax(p) when the residual is numerically all-zero; when
    rounding leaves ``u * Z`` at or past the last CDF value (nothing
    crosses), the count saturates at V - 1, as in the JAX oracle.
    """
    r = torch.clamp(p.float() - q.float(), min=0.0)
    z = r.sum(dim=-1, keepdim=True)
    degenerate = z[:, 0] <= 0.0
    cdf = torch.cumsum(r, dim=-1)
    target = u.float()[:, None] * z
    token = (cdf <= target).to(torch.int32).sum(dim=-1)
    token = torch.clamp(token, max=p.shape[-1] - 1)
    return torch.where(degenerate, p.argmax(dim=-1).to(torch.int32),
                       token.to(torch.int32))


def fused_verify_sample_ref(target_logits: torch.Tensor,   # (B, L+1, V)
                            draft_tokens: torch.Tensor,    # (B, L) int32
                            draft_probs: torch.Tensor,     # (B, L) p_S
                            q_idx: torch.Tensor,           # (B, L, Vhat)
                            q_val: torch.Tensor,           # (B, L, Vhat)
                            u_accept: torch.Tensor,        # (B, L)
                            u_resid: torch.Tensor,         # (B,)
                            draft_len: torch.Tensor,       # (B,) L_k <= L
                            ):
    """Accept test + prefix count + calibrated residual token.

    p_L of each drafted token, the accept test ``u < min(1, p_L/p_S)``
    masked to ``draft_len``, the prefix-acceptance count, and the residual
    sample at the first rejected position with the sparse SLM row scattered
    dense.  Returns ``(accept (B, L) bool, n_acc (B,) int32, calibrated (B,)
    int32)``; the bonus token stays outside.
    """
    B, L = draft_tokens.shape
    V = target_logits.shape[-1]
    dev = target_logits.device

    flat_logits = target_logits[:, :L].reshape(B * L, V)
    p_target = gather_softmax_prob_ref(
        flat_logits, draft_tokens.reshape(B * L)).reshape(B, L)

    ratio = p_target / torch.clamp(draft_probs.float(), min=1e-30)
    accept = u_accept.float() < torch.clamp(ratio, max=1.0)
    accept = accept & (torch.arange(L, device=dev)[None, :]
                       < draft_len.long()[:, None])
    prefix_ok = torch.cumprod(accept.to(torch.int32), dim=-1)
    n_acc = prefix_ok.sum(dim=-1)

    sel = torch.clamp(n_acc, max=L - 1).long()
    rows = torch.arange(B, device=dev)
    p_rej = torch.softmax(target_logits[rows, sel].float(), dim=-1)
    idx_rej = q_idx[rows, sel].long()
    val_rej = q_val[rows, sel].float()
    q_rej = torch.zeros(B, V, dtype=torch.float32, device=dev)
    q_rej.scatter_add_(1, idx_rej, val_rej)
    calibrated = residual_sample_ref(p_rej, q_rej, u_resid)
    return accept, n_acc.to(torch.int32), calibrated


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality) chunked scan
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] (i >= j),
    -inf above the diagonal."""
    T = x.shape[-1]
    xx = x[..., None].expand(*x.shape, T)            # xx[..., k, j] = x_k
    below = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device),
                       diagonal=-1)                  # keep rows k > col j
    xx = torch.where(below, xx, torch.zeros((), dtype=x.dtype, device=x.device))
    out = torch.cumsum(xx, dim=-2)
    keep = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(keep, out,
                       torch.full((), -math.inf, dtype=x.dtype, device=x.device))


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int = 64,
                 initial_state: torch.Tensor | None = None):
    """Chunked SSD forward (Mamba-2, arXiv:2405.21060 listing 1).

    x:  (b, s, h, p)   head inputs
    dt: (b, s, h)      positive step sizes (softplus already applied)
    A:  (h,)           negative decay rates
    B:  (b, s, g, n)   input projections (g groups, g | h)
    C:  (b, s, g, n)   output projections
    initial_state: (b, h, p, n) float32 or None (zeros).
    Returns (y (b, s, h, p) in x's dtype, final_state (b, h, p, n) float32).
    The sequence must be a chunk multiple (``ops.ssd_scan`` pads).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=2)              # (b, s, h, n)
    Ch = C.repeat_interleave(rep, dim=2)

    xw = (x * dt[..., None]).float()                  # dt-weighted input
    Abar = (A[None, None, :] * dt).float()            # (b, s, h)

    c = s // chunk
    xw = xw.reshape(b, c, chunk, h, p)
    Bh = Bh.reshape(b, c, chunk, h, n).float()
    Ch = Ch.reshape(b, c, chunk, h, n).float()
    Ab = Abar.reshape(b, c, chunk, h).permute(0, 3, 1, 2)   # (b, h, c, l)
    A_cum = torch.cumsum(Ab, dim=-1)                         # (b, h, c, l)

    # intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(Ab))                            # (b, h, c, l, l)
    Y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Ch, Bh, Lmat, xw)

    # chunk end-states
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)        # (b, h, c, l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay_states, xw)

    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=torch.float32,
                                    device=x.device)
    states = torch.cat([initial_state[:, None].float(), states], dim=1)

    # inter-chunk recurrence
    chunk_decay = A_cum[..., -1]                             # (b, h, c)
    padded = torch.nn.functional.pad(chunk_decay, (1, 0))
    decay_chunk = torch.exp(_segsum(padded))                 # (b, h, c+1, c+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # inter-chunk contribution to the outputs
    state_decay_out = torch.exp(A_cum)                       # (b, h, c, l)
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, prev_states,
                         state_decay_out)

    y = (Y_diag + Y_off).reshape(b, s, h, p)
    return y.to(x.dtype), final_state


def ssd_decode_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, state: torch.Tensor):
    """One-token SSD recurrence.

    x: (b, h, p); dt: (b, h); A: (h,); B, C: (b, g, n); state: (b, h, p, n).
    Returns (y (b, h, p) in x's dtype, new_state float32).
    """
    h = x.shape[1]
    rep = h // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1).float()             # (b, h, n)
    Ch = C.repeat_interleave(rep, dim=1).float()
    decay = torch.exp(A[None, :] * dt)                        # (b, h)
    upd = (dt[..., None] * x.float())[..., None] * Bh[:, :, None, :]
    new_state = decay[..., None, None] * state + upd          # (b, h, p, n)
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state
