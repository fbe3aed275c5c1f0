"""Inputs, bounds and timing for holding the CUDA kernels against their plain
versions on the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).

Inputs are made from a seed on the CPU and moved to the device, so a case is
the same on every run.  Bounds follow the on-chip measurement rules: each
input byte read once and each output byte written once, counting only what
this case's data needs (visible pages of each row, the drafted logit rows),
over 3.35 TB/s; operations over the card's peak for the input type; the
bound is the larger of the two.  Peaks are those of one H100 SXM at its
700 W limit (NVIDIA's data sheet).
"""

from __future__ import annotations

import time

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def bound(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# GPU clock cycles of the spin that precedes each timed call (~2 ms at the
# H100's 1.98 GHz); ``time_ms`` doubles it, at most ``SPIN_DOUBLINGS``
# times, while the host takes longer than the spin to enqueue a call
SPIN_CYCLES = 4_000_000
SPIN_DOUBLINGS = 3

# one entry per ``time_ms`` call: (calls whose host enqueue outlasted the
# first spin, calls that still did after the last lengthening, final spin
# cycles)
spin_overruns: list[tuple[int, int, int]] = []


def _spin_ms(cycles: int) -> float:
    """Device time of one ``torch.cuda._sleep(cycles)``, in ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)           # warm: the first spin pays a load
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, iters: int = 50, warmup: int = 5, flush_mb: int = 64) -> float:
    """Mean device time of ``fn()`` in ms from CUDA events around each call,
    with the 50 MB L2 cache flushed (a ``flush_mb`` buffer rewritten)
    between calls, outside the timed window.  Before each call the card
    spins, so the host has enqueued the whole call when the start event
    fires: the window holds device time, not the wrapper's host time (which
    exceeds a small kernel's own).  The host's enqueue of each call is timed
    (``time.perf_counter`` from the spin's enqueue to ``fn()``'s return);
    if any outlasts the spin's device time, the spin is doubled and all
    calls are timed again.  Each call appends its counts to
    ``spin_overruns``."""
    flush = torch.empty(flush_mb << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    cycles, first = SPIN_CYCLES, None
    for attempt in range(SPIN_DOUBLINGS + 1):
        spin_s = 1e-3 * _spin_ms(cycles)
        events, over = [], 0
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(cycles)
            t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            over += time.perf_counter() - t0 > spin_s
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        first = over if first is None else first
        if not over or attempt == SPIN_DOUBLINGS:
            break
        cycles *= 2
    spin_overruns.append((first, over, cycles))
    return sum(s.elapsed_time(e) for s, e in events) / iters


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def paged_case(B, T, H, KV, D, ps, ctx, dtype, device, seed=0, holes=True,
               lengths=None, width=None, window=0):
    """q (B, T, H, D) and pools with contexts of ctx/2..ctx tokens (or the
    rows' ``lengths``) on scattered, non-contiguous pages; slots past each
    row's window stay -1, and with ``holes`` the last row is all -1 (a
    retired row).  ``ctx=1`` is a prefill at offset 0 (lengths 1: row t
    attends [0, t]).  ``width`` sets the table's slots (a serving table is
    max_len / ps wide), else the rows' windows and two more.  ``window`` >
    0 (a sliding-window layer's): slots wholly below each row's first
    query's window are -1, as the serving engine leaves them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if lengths is not None:
        ctx = max(lengths)
    n_slots = width or -(-(ctx + T) // ps) + 2
    P = B * n_slots + 3
    q = torch.randn((B, T, H, D), generator=g)
    kp = torch.randn((P, ps, KV, D), generator=g)
    vp = torch.randn((P, ps, KV, D), generator=g)
    if lengths is None:
        lengths = torch.randint(max(1, ctx // 2), ctx + 1, (B,), generator=g)
    else:
        lengths = torch.tensor(lengths)
    perm = torch.randperm(P, generator=g)
    pt = torch.full((B, n_slots), -1, dtype=torch.int32)
    n = 0
    for b in range(B):
        need = min(n_slots, -(-(int(lengths[b]) + T - 1) // ps))
        pt[b, :need] = perm[n:n + need].to(torch.int32)
        n += need
        if window > 0:
            pt[b, :max(0, int(lengths[b]) - window) // ps] = -1
    if holes and B > 2:
        pt[-1] = -1
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            pt.to(device), lengths.to(device, torch.int32))


# the split of the slot axis at its edges (bf16 splits it): name, the
# ``paged_case`` arguments (B, T, H, KV, D, ps, ctx) and keywords; the
# tables are 64 slots wide, as the serving pools' (1024 tokens of 16)
PAGED_EDGE_CASES = [
    ("one split holds every live slot", (4, 1, 32, 4, 64, 16, 0),
     dict(lengths=[5, 17, 40, 64], width=64, holes=False)),
    ("more splits than live slots", (4, 9, 32, 32, 128, 16, 0),
     dict(lengths=[1, 2, 3, 20], width=64, holes=False)),
    ("lengths 0 and an all-(-1) row", (4, 1, 32, 4, 64, 16, 0),
     dict(lengths=[0, 1, 300, 500], width=64)),
    ("lengths 1, verify window", (8, 9, 32, 32, 128, 16, 0),
     dict(lengths=[1] * 8, width=64)),
    ("verify window T=9, serving table", (8, 9, 32, 32, 128, 16, 512),
     dict(width=64)),
    ("draft step, serving table", (8, 1, 32, 4, 64, 16, 512),
     dict(width=64)),
    ("prefill T=127, serving table", (8, 127, 32, 4, 64, 16, 1),
     dict(width=64)),
]

# B1 with a key window, as the same triples: SmallThinker-21BA3B's window
# layers (window 4096, 28 / 4 heads of 128) at the longctx cell's verify
# window on its serving table, the slots below each row's window freed,
# and a prefill from 0 on 64-row tiles; then a small window on pages of 8
PAGED_WINDOW_CASES = [
    ("st21b verify T=9, window 4096", (24, 9, 28, 4, 128, 16, 12000),
     dict(width=1024, holes=False, window=4096)),
    ("st21b prefill T=8191, window 4096", (1, 8191, 28, 4, 128, 16, 1),
     dict(width=512, holes=False, window=4096)),
    ("window 17, pages of 8, draft step", (4, 1, 8, 2, 64, 8, 300),
     dict(width=64, window=17)),
]


# (rtol, atol) of the kernel against ``paged_attention_held``: float32 is the
# band of ``tests/test_kernels.py``; a bfloat16 output is the kernel's float32
# result rounded once, so it lies within 2**-8 of its own magnitude of the
# float32 answer, and the band is twice that rounding.
PAGED_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (8e-3, 1e-3)}


def paged_attention_held(q, k_pool, v_pool, page_table, lengths, window=0):
    """What the kernel is held against: the plain version in float32 on the
    same inputs (bfloat16 ones upcast exactly), so a bfloat16 output is
    compared with the exact answer, not with one rounded twice more."""
    from .paged_attention import paged_attention_plain

    return paged_attention_plain(q.float(), k_pool.float(), v_pool.float(),
                                 page_table, lengths, window=window)


def _window_keys(ln: int, t: int, s: int, ps: int, window: int) -> int:
    """Keys of slot ``s`` that query row t (horizon ln + t) sees."""
    hi = min(ps, max(0, ln + t - s * ps))
    lo = 0 if window <= 0 else min(ps, max(0, ln + t - window - s * ps))
    return max(0, hi - lo)


def paged_work(q, k_pool, v_pool, page_table, lengths,
               window=0) -> tuple[int, int]:
    """(bytes, operations) paged attention needs for these inputs: q, the
    output, the table and lengths once, plus every K/V page some row can
    see (mapped, below the row's last horizon and, in a ``window``, not
    wholly below its first query's window), across all kv heads; 4*D
    operations (two multiply-adds) per visible (query head, key)."""
    B, T, H, D = q.shape
    P, ps, KV, _ = k_pool.shape
    pt, ln = page_table.cpu().long(), lengths.cpu().long()
    item = q.element_size()
    n_bytes = 2 * q.numel() * item + pt.numel() * 4 + ln.numel() * 4
    ops = 0
    for b in range(B):
        floor = 0 if window <= 0 else int(ln[b]) - window
        live = [s for s in range(pt.shape[1])
                if pt[b, s] >= 0 and s * ps < ln[b] + T - 1
                and (s + 1) * ps > floor]
        n_bytes += 2 * len(live) * ps * KV * D * item
        for t in range(T):
            keys = sum(_window_keys(int(ln[b]), t, s, ps, window)
                       for s in live)
            ops += 4 * H * keys * D
    return n_bytes, ops


def paged_sdpa_inputs(q, k_pool, v_pool, page_table, lengths, window=0):
    """The same attention as one library call's operands: K/V gathered to
    a contiguous (B, H, S, D) view (GQA heads expanded) and a boolean mask
    (a band, with ``window``).  Built once, outside any timing."""
    B, T, H, D = q.shape
    P, ps, KV, _ = k_pool.shape
    n_slots = page_table.shape[1]
    safe = page_table.clamp(min=0).long()
    k = k_pool[safe].reshape(B, n_slots * ps, KV, D)
    v = v_pool[safe].reshape(B, n_slots * ps, KV, D)
    k = k.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
    kpos = torch.arange(n_slots * ps, device=q.device)
    horizon = lengths.long()[:, None] + torch.arange(T, device=q.device)
    mapped = (page_table >= 0).repeat_interleave(ps, dim=1)
    mask = (kpos[None, None] < horizon[:, :, None]) & mapped[:, None]
    if window > 0:
        mask = mask & (kpos[None, None] >= horizon[:, :, None] - window)
    return q.transpose(1, 2).contiguous(), k, v, mask[:, None]


# ---------------------------------------------------------------------------
# fused verify + sample
# ---------------------------------------------------------------------------

def verify_case(B, L, V, vhat, device, seed=0):
    """Verification inputs where accept, reject and full-accept rows all
    occur.  By row b % 4: 0 drafts the target's argmax with a tiny p_S
    (p_L/p_S ~ 1000: every test accepts), 1 and 3 draft the target's argmin
    with p_S = 1 (p_L/p_S ~ 0: rejected at once), 2 drafts the argmax with
    p_S from the uploaded row (left to the data).  Draft lengths are ragged,
    with rows 1, 5, ... at L."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    logits = torch.randn((B, L + 1, V), generator=g) * 3
    p = torch.softmax(logits[:, :L], -1)
    q_idx = torch.stack([torch.stack([torch.randperm(V, generator=g)[:vhat]
                                      for _ in range(L)]) for _ in range(B)])
    q_val = torch.rand((B, L, vhat), generator=g)
    q_val /= q_val.sum(-1, keepdim=True)
    kind = torch.arange(B) % 4
    reject = (kind == 1) | (kind == 3)
    tokens = torch.where(reject[:, None], p.argmin(-1), p.argmax(-1))
    # the drafted token leads the sparse row; a later copy of it is replaced
    dup = q_idx[:, :, 1:] == tokens[..., None]
    q_idx[:, :, 1:][dup] = (tokens[..., None].expand_as(dup)[dup] + 1) % V
    q_idx[:, :, 0] = tokens
    p_tok = p.gather(-1, tokens[..., None])[..., 0]
    probs = torch.where(kind[:, None] == 0, p_tok * 1e-3, q_val[..., 0])
    probs = torch.where(reject[:, None], torch.ones_like(probs), probs)
    u_acc = torch.rand((B, L), generator=g)
    u_res = torch.rand((B,), generator=g)
    dlen = torch.randint(1, L + 1, (B,), generator=g)
    dlen[1::4] = L
    return (logits.to(device), tokens.to(device, torch.int32), probs.to(device),
            q_idx.to(device, torch.int32), q_val.to(device), u_acc.to(device),
            u_res.to(device), dlen.to(device, torch.int32))


def verify_edge_rows(args):
    """``verify_case``'s inputs with the residual's two edge cases on batch
    rows 0 and 1: every drafted row is one-hot (logit 0 at the drafted token
    t, -200 elsewhere: p = 1 at t, 0 past exp's range) and every entry of
    its sparse row is t, the first carrying q(t), the others 0.  Row 0 gives
    q(t) = 1, so max(p - q, 0) is all zero (Z = 0: the token is argmax(p) =
    t); row 1 gives q(t) = 0.5 and u_resid = 1, so u * Z = Z = 0.5 equals
    the last CDF value exactly and nothing crosses (the token is V - 1).  p_S = q(t) <= 1 = p_L: both rows accept every
    drafted token.  Returns new tensors; the inputs stay as they were."""
    logits, tokens, probs, q_idx, q_val, u_acc, u_res, dlen = (
        t.clone() for t in args)
    L = tokens.shape[1]
    for b, qt in ((0, 1.0), (1, 0.5)):
        logits[b, :L] = -200.0
        logits[b, torch.arange(L, device=logits.device), tokens[b].long()] = 0.0
        q_idx[b] = tokens[b][:, None]
        q_val[b] = 0.0
        q_val[b, :, 0] = qt
        probs[b] = qt
    u_res[1] = 1.0
    return logits, tokens, probs, q_idx, q_val, u_acc, u_res, dlen


def verify_work(target_logits, draft_tokens, *rest) -> tuple[int, int]:
    """(bytes, operations): the L drafted logit rows of each batch row once
    plus the small operands and outputs; ~4 float32 operations (max, exp,
    add, compare) per logit."""
    B, L = draft_tokens.shape
    V = target_logits.shape[-1]
    small = sum(t.numel() * t.element_size() for t in (draft_tokens, *rest))
    return B * L * V * 4 + small + B * L + 8 * B, 4 * B * L * V


def residual_boundary_ok(row_args, n_acc: int, tok_a: int, tok_b: int,
                         rel: float = 1e-4) -> bool:
    """Whether two residual samples of ONE batch row differ only because
    u * Z lies within rounding of a CDF step: in float64, every CDF value
    between the two tokens is within ``rel * Z`` of u * Z."""
    logits, _, _, q_idx, q_val, _, u_res, _ = row_args
    L = q_idx.shape[0]
    sel = min(int(n_acc), L - 1)
    p = torch.softmax(logits[sel].double(), -1)
    q = torch.zeros_like(p).index_add_(0, q_idx[sel].long(),
                                       q_val[sel].double())
    return cdf_step_ok(p, q, u_res, tok_a, tok_b, rel)


def compare_verify(kernel_out, plain_out, args) -> dict:
    """Exact-match report of the kernel against the plain version:
    accept and n_acc must be equal; rows whose calibrated token differs
    are listed with whether each is a CDF-boundary case."""
    acc_k, n_k, cal_k = (t.cpu() for t in kernel_out)
    acc_p, n_p, cal_p = (t.cpu() for t in plain_out)
    host = [a.cpu() for a in args]
    diff = (cal_k != cal_p).nonzero().flatten().tolist()
    return {
        # accept / n_acc must match exactly: their largest difference
        "max_abs_err": float(max((acc_k.int() - acc_p.int()).abs().max(),
                                 (n_k - n_p).abs().max())),
        "accept_equal": bool(torch.equal(acc_k, acc_p)),
        "n_acc_equal": bool(torch.equal(n_k, n_p)),
        "calibrated_equal_rows": int((cal_k == cal_p).sum()),
        "calibrated_diff_rows": diff,
        "diff_rows_at_cdf_step": all(
            residual_boundary_ok([a[b] for a in host], int(n_k[b]),
                                 int(cal_k[b]), int(cal_p[b])) for b in diff),
        "n_acc": n_k.tolist(),
        "draft_len": host[-1].tolist(),
    }


# ---------------------------------------------------------------------------
# paged tree attention
# ---------------------------------------------------------------------------

def tree_mask(B: int, J: int, L: int, seed: int = 0) -> torch.Tensor:
    """(B, J*L+1, J*L+1) bool ancestor-or-self window mask of the token trees
    ``build_token_tree`` packs from J random drafts of length L per row.
    Tokens come from a 3-letter alphabet, so drafts share prefixes of every
    length and diverge; the last row drafts L - 2 tokens (dead padding
    nodes)."""
    import numpy as np

    from repro_torch.core.token_tree import build_token_tree

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 3, (B, J, L))
    lengths = np.full(B, L)
    if B > 1 and L > 2:
        lengths[-1] = L - 2
    zeros = np.zeros((B, J, L, 1))
    tree = build_token_tree(toks, zeros[..., 0], zeros.astype(np.int32), zeros,
                            lengths)
    return torch.from_numpy(tree.window_mask().copy())


def tree_case(B, J, L, H, KV, D, ps, ctx, dtype, device, seed=0, holes=True,
              chain=False, lengths=None, width=None):
    """Tree-window inputs (q, k_pool, v_pool, page_table, lengths, win_mask)
    of a T = J*L+1 window: the pools and table of ``paged_case`` at T (each
    row maps its committed ``lengths`` plus the window; ``lengths`` gives
    the rows' committed counts, ``width`` the table's slots), lengths the
    committed count, the mask from ``tree_mask`` (or lower-triangular with
    ``chain``, where the op equals paged attention at lengths + 1)."""
    T = J * L + 1
    q, kp, vp, pt, ln = paged_case(
        B, T, H, KV, D, ps, ctx, dtype, device, seed=seed, holes=holes,
        lengths=None if lengths is None else [n + 1 for n in lengths],
        width=width)
    if chain:
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool)).expand(B, T, T)
    else:
        mask = tree_mask(B, J, L, seed=seed)
    return q, kp, vp, pt, ln - 1, mask.contiguous().to(device)


# tree windows on grids of fewer blocks than SMs, so that the bf16 B3 and
# B6 split their key axis: name, (B, J, L, H, KV, D), the rows' committed
# lengths, and the keys (B3: ``width = keys // ps`` slots of ``tree_case``;
# B6: ``S``); with B > 2 the last row of B3's table is all -1 (it gives 0)
TREE_SPLIT_CASES = [
    ("B=3 KV=4 T=13, length 0, retired row", (3, 2, 6, 4, 4, 64), [0, 100, 50],
     256),
    ("B=2 KV=4 T=13", (2, 2, 6, 4, 4, 64), [30, 200], 256),
    ("T=64 KV=1 G=4", (1, 7, 9, 4, 1, 128), [60], 192),
    ("ragged keys 96, G=4 on 64-row tiles", (2, 2, 6, 8, 2, 64), [0, 83], 96),
    ("D=256 G=8 on 64-row tiles", (2, 2, 6, 8, 1, 256), [40, 150], 256),
]


def tree_attention_held(q, k_pool, v_pool, page_table, lengths, win_mask):
    """The plain version in float32 on the same inputs (as
    ``paged_attention_held``)."""
    from .paged_tree_attention import paged_tree_attention_plain

    return paged_tree_attention_plain(q.float(), k_pool.float(),
                                      v_pool.float(), page_table, lengths,
                                      win_mask)


def _tree_visible(page_table, lengths, win_mask, ps):
    """(B, T, S) bool: the keys each query row sees (mapped, committed or an
    allowed window position), on the host."""
    pt, ln, wm = page_table.cpu().long(), lengths.cpu().long(), win_mask.cpu()
    B, T = wm.shape[:2]
    S = pt.shape[1] * ps
    kpos = torch.arange(S)
    w = kpos[None] - ln[:, None]
    in_win = (w >= 0) & (w < T)
    allow = wm.gather(2, w.clamp(0, T - 1)[:, None].expand(B, T, S))
    mapped = (pt >= 0).repeat_interleave(ps, dim=1)
    return (((kpos[None] < ln[:, None])[:, None] | (allow & in_win[:, None]))
            & mapped[:, None])


def tree_work(q, k_pool, v_pool, page_table, lengths, win_mask):
    """(bytes, operations) tree attention needs for these inputs: q, the
    output, table, lengths and mask once, every K/V page some row can see
    (mapped, below lengths + T) across all kv heads, and 4*D operations per
    visible (query head, key)."""
    B, T, H, D = q.shape
    P, ps, KV, _ = k_pool.shape
    pt, ln = page_table.cpu().long(), lengths.cpu().long()
    item = q.element_size()
    n_bytes = (2 * q.numel() * item + pt.numel() * 4 + ln.numel() * 4
               + win_mask.numel())
    live = ((pt >= 0) & (torch.arange(pt.shape[1])[None] * ps
                         < (ln + T)[:, None])).sum()
    n_bytes += int(live) * 2 * ps * KV * D * item
    ops = 4 * H * D * int(_tree_visible(page_table, lengths, win_mask, ps).sum())
    return n_bytes, ops


def tree_sdpa_inputs(q, k_pool, v_pool, page_table, lengths, win_mask):
    """The same attention as one library call's operands: ``paged_sdpa_inputs``
    with the (B, 1, T, S) boolean mask of the keys each tree row sees.
    Built once, outside any timing."""
    sq, sk, sv, _ = paged_sdpa_inputs(q, k_pool, v_pool, page_table, lengths)
    mask = _tree_visible(page_table, lengths, win_mask, k_pool.shape[1])
    return sq, sk, sv, mask.to(q.device)[:, None]


# ---------------------------------------------------------------------------
# gather softmax prob, residual sample
# ---------------------------------------------------------------------------

# (rtol, atol) of gather_softmax_prob against its plain version: relative
# only, since most picked probabilities are ~1/V and would all pass under an
# absolute band of the same size; 2e-5 is the float32 band of
# ``tests/test_kernels.py`` (the normalizer sums in another order), below
# the 1/V share of one dropped key
GATHER_TOL = (2e-5, 0.0)


def softmax_case(N, V, device, seed=0):
    """(logits (N, V) float32, ids (N,) int32): logits ~ 3 N(0, 1).  Row 0
    picks its argmax, row 1 its argmin; from row 2 on, by n % 4: 2 picks the
    median logit, 3 the logit of rank n // 4 from the top (p ~ 1e-2..1e-4),
    0 and 1 a random one."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    logits = torch.randn((N, V), generator=g) * 3
    ids = torch.randint(0, V, (N,), generator=g)
    order = logits.argsort(-1, descending=True)
    for n in range(N):
        rank = {0: 0, 1: V - 1}.get(n, {2: V // 2, 3: n // 4}.get(n % 4))
        if rank is not None:
            ids[n] = order[n, min(rank, V - 1)]
    return logits.to(device), ids.to(device, torch.int32)


def softmax_work(logits, ids) -> tuple[int, int]:
    """(bytes, operations): every logit once, ids in and probabilities out;
    a compare, an exp and an add per logit."""
    N, V = logits.shape
    return N * V * 4 + 8 * N, 3 * N * V


def residual_case(N, V, device, seed=0, vhat=64):
    """(p, q, u) float32 rows of the calibrated-token step: p a softmax
    row, q a dense row scattered from a top-``vhat`` (at most V) draft
    distribution (as ``verify_tree`` builds it), u uniform.  Row 0 has
    q == p (Z = 0: argmax(p)), row 1 has two tied maxima of p half a row
    apart and q == p (the first index wins), row 2 has u = 1.5 so nothing
    crosses (V - 1); the rest reject with a live residual."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    p = torch.softmax(torch.randn((N, V), generator=g) * 3, -1)
    d = torch.softmax(torch.randn((N, V), generator=g) * 3, -1)
    val, idx = d.topk(min(vhat, V), -1)
    q = torch.zeros_like(p).scatter_add_(1, idx, val / val.sum(-1, keepdim=True))
    u = torch.rand((N,), generator=g)
    q[0] = p[0]
    if N > 1:
        top = p[1].argmax()
        p[1, (top + V // 2) % V] = p[1, top]
        q[1] = p[1]
    if N > 2:
        u[2] = 1.5
    return p.to(device), q.to(device), u.to(device)


def residual_work(p, q, u, tokens) -> tuple[int, int]:
    """(bytes, operations): p and q once, u in and tokens out; sweep 1 does
    a subtract, a max, an add and a compare per entry, sweep 2 a subtract, a
    max and an add per entry up to the crossing (``tokens`` of this run's
    data; rows with a zero residual stop after sweep 1)."""
    N, V = p.shape
    live = ((p - q).clamp(min=0).sum(-1) > 0).cpu()
    swept = int(((tokens.cpu().long() + 1) * live).sum())
    return 2 * N * V * 4 + 8 * N, 4 * N * V + 3 * swept


def cdf_step_ok(p, q, u, tok_a: int, tok_b: int, rel: float = 1e-4) -> bool:
    """Whether two residual samples of ONE row differ only because u * Z
    lies within rounding of a CDF step: in float64, every CDF value between
    the two tokens is within ``rel * Z`` of u * Z."""
    cdf = (p.double() - q.double()).clamp(min=0).cumsum(0)
    z = float(cdf[-1])
    target = float(u) * z
    lo, hi = sorted((int(tok_a), int(tok_b)))
    return bool(((cdf[lo:hi] - target).abs() <= rel * z).all())


def compare_residual(got, want, p, q, u) -> dict:
    """Exact-match report of residual_sample against its plain version:
    rows that differ are listed with whether each is a CDF-step case."""
    got, want = got.cpu(), want.cpu()
    hp, hq, hu = p.cpu(), q.cpu(), u.cpu()
    diff = (got != want).nonzero().flatten().tolist()
    return {
        "max_abs_err": float((got.long() - want.long()).abs().max()),
        "equal_rows": int((got == want).sum()),
        "diff_rows": diff,
        "diff_rows_at_cdf_step": all(
            cdf_step_ok(hp[b], hq[b], hu[b], got[b], want[b]) for b in diff),
        "tokens": got.tolist(),
    }


# ---------------------------------------------------------------------------
# tree attention over a contiguous cache
# ---------------------------------------------------------------------------

def contiguous_tree_case(B, J, L, H, KV, D, S, ctx, dtype, device, seed=0,
                         chain=False, lengths=None):
    """Tree-window inputs (q, k_cache, v_cache, lengths, win_mask) of a
    T = J*L+1 window over (B, S, KV, D) caches: committed lengths of
    ctx/2..ctx tokens (at most S - T, so the window fits) or the rows'
    ``lengths``, the mask from ``tree_mask`` (or lower-triangular with
    ``chain``)."""
    T = J * L + 1
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, T, H, D), generator=g)
    kc = torch.randn((B, S, KV, D), generator=g)
    vc = torch.randn((B, S, KV, D), generator=g)
    if lengths is None:
        lengths = torch.randint(max(0, ctx // 2), min(ctx, S - T) + 1, (B,),
                                generator=g)
    else:
        lengths = torch.tensor(lengths)
    if chain:
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool)).expand(B, T, T)
    else:
        mask = tree_mask(B, J, L, seed=seed)
    return (q.to(device, dtype), kc.to(device, dtype), vc.to(device, dtype),
            lengths.to(device, torch.int32), mask.contiguous().to(device))


def contiguous_tree_held(q, k_cache, v_cache, lengths, win_mask):
    """The plain version in float32 on the same inputs (as
    ``paged_attention_held``)."""
    from .tree_attention import tree_attention_plain

    return tree_attention_plain(q.float(), k_cache.float(), v_cache.float(),
                                lengths, win_mask)


def as_pages(k_cache, v_cache, ps: int = 16):
    """The same keys laid out in pages: (B, S, KV, D) caches as
    (B * S/ps, ps, KV, D) pools and the (B, S/ps) table that maps row b's
    slot s to page b * S/ps + s (a view, no copy)."""
    B, S, KV, D = k_cache.shape
    n = S // ps
    table = torch.arange(B * n, dtype=torch.int32,
                         device=k_cache.device).reshape(B, n)
    return (k_cache.reshape(B * n, ps, KV, D), v_cache.reshape(B * n, ps, KV, D),
            table)


def _contiguous_visible(lengths, win_mask, S):
    """(B, T, S) bool: the keys each query row sees, on the host."""
    ln, wm = lengths.cpu().long(), win_mask.cpu()
    B, T = wm.shape[:2]
    kpos = torch.arange(S)
    w = kpos[None] - ln[:, None]
    in_win = (w >= 0) & (w < T)
    allow = wm.gather(2, w.clamp(0, T - 1)[:, None].expand(B, T, S))
    return (kpos[None] < ln[:, None])[:, None] | (allow & in_win[:, None])


def contiguous_tree_work(q, k_cache, v_cache, lengths, win_mask):
    """(bytes, operations) contiguous tree attention needs for these inputs:
    q, the output, lengths and mask once, the K/V rows below each row's
    window end (min(lengths + T, S)) across all kv heads, and 4*D
    operations per visible (query head, key)."""
    B, T, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    item = q.element_size()
    keys = int((lengths.cpu().long() + T).clamp(max=S).sum())
    n_bytes = (2 * q.numel() * item + lengths.numel() * 4 + win_mask.numel()
               + 2 * keys * KV * D * item)
    ops = 4 * H * D * int(_contiguous_visible(lengths, win_mask, S).sum())
    return n_bytes, ops


def contiguous_tree_sdpa_inputs(q, k_cache, v_cache, lengths, win_mask):
    """The same attention as one library call's operands: (B, H, S, D) K/V
    (GQA heads expanded) and the (B, 1, T, S) boolean mask of the keys each
    row sees.  Built once, outside any timing."""
    B, T, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    k = k_cache.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
    v = v_cache.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
    mask = _contiguous_visible(lengths, win_mask, S).to(q.device)[:, None]
    return q.transpose(1, 2).contiguous(), k, v, mask


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

# (rtol, atol) of the kernel's y against ``ssd_scan_held``: float32 is the
# band of ``tests/test_kernels.py`` for the scan (the kernel and the plain
# version decay by exp(acum_i - acum_j) and exp(segsum) and sum in other
# orders); a bfloat16 y is the kernel's float32 result rounded once, so the
# band is twice one bfloat16 rounding (as ``PAGED_TOL``).  The final state
# is float32 on both routes and keeps the float32 band.
SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (8e-3, 1e-3)}
SSD_STATE_TOL = (1e-4, 1e-4)


def ssd_case(b, s, h, p, g, n, dtype, device, seed=0, init=False):
    """(x, dt, A, B, C, initial_state) with the distributions of the JAX
    package's scan test: x, B, C ~ N(0, 1) in ``dtype``, dt = softplus(N(0,
    1)) and A = -exp(N(0, 1) / 2) in float32, an N(0, 1) float32 initial
    state with ``init`` (else None)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen))
    A = -torch.exp(torch.randn((h,), generator=gen) * 0.5)
    B = torch.randn((b, s, g, n), generator=gen)
    C = torch.randn((b, s, g, n), generator=gen)
    state = torch.randn((b, h, p, n), generator=gen) if init else None
    return (x.to(device, dtype), dt.to(device), A.to(device),
            B.to(device, dtype), C.to(device, dtype),
            None if state is None else state.to(device))


def ssd_scan_held(x, dt, A, B, C, chunk, initial_state=None):
    """The plain version in float32 on the same inputs (bfloat16 ones
    upcast exactly)."""
    from .ssd_scan import ssd_scan_plain

    return ssd_scan_plain(x.float(), dt, A, B.float(), C.float(), chunk=chunk,
                          initial_state=initial_state)


def ssd_work(x, dt, A, B, C, chunk, initial_state=None) -> tuple[int, int]:
    """(bytes, operations) of the chunked scan: x, B, C, dt, A (and the
    initial state) read once, y and the final state written once; per
    chunk, head and batch row the causal scores (Lc(Lc+1)/2 dot products
    of n), their product with x dt (Lc(Lc+1)/2 p), the carried state's
    contribution and update (2 Lc p n), two operations per multiply-add."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    item = x.element_size()
    n_bytes = ((2 * x.numel() + B.numel() + C.numel()) * item
               + dt.numel() * 4 + A.numel() * 4 + b * h * p * n * 4
               * (2 if initial_state is not None else 1))
    n_chunks = s // chunk
    tri = chunk * (chunk + 1) // 2
    ops = 2 * b * h * n_chunks * (tri * (n + p) + 2 * chunk * p * n)
    return n_bytes, ops


# ---------------------------------------------------------------------------
# decode attention and flash attention over contiguous keys
# ---------------------------------------------------------------------------

def decode_case(B, H, KV, D, S, lengths, dtype, device, seed=0):
    """(q (B, H, D), k_cache, v_cache (B, S, KV, D), lengths (B,) int32) of
    one decode step: ``lengths`` is a (lo, hi) range the rows draw from
    (both ends inclusive) or the list of the rows' lengths."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, H, D), generator=g)
    kc = torch.randn((B, S, KV, D), generator=g)
    vc = torch.randn((B, S, KV, D), generator=g)
    if isinstance(lengths, tuple):
        ln = torch.randint(lengths[0], lengths[1] + 1, (B,), generator=g)
    else:
        ln = torch.tensor(lengths)
    return (q.to(device, dtype), kc.to(device, dtype), vc.to(device, dtype),
            ln.to(device, torch.int32))


# name, (B, H, KV, D, S), lengths: bf16 decode attention (B7) on grids of
# fewer blocks than SMs, which split the key axis: a row of length 0 beside
# a long one, G = 8 at D = 80, lengths past S at D = 96, paligemma-3b's
# G = 8 at D = 256
DECODE_SPLIT_CASES = [
    ("a length-0 row, D=128", (2, 32, 4, 128, 1024), [0, 900]),
    ("G=8 at D=80", (2, 8, 1, 80, 320), [300, 65]),
    ("lengths past S at D=96", (2, 8, 2, 96, 200), [250, 3]),
    ("a length-0 row, G=8 at D=256", (2, 8, 1, 256, 1024), [0, 1000]),
]


def decode_attention_held(q, k_cache, v_cache, lengths):
    """The plain version in float32 on the same inputs (as
    ``paged_attention_held``)."""
    from .decode_attention import decode_attention_plain

    return decode_attention_plain(q.float(), k_cache.float(), v_cache.float(),
                                  lengths)


def decode_work(q, k_cache, v_cache, lengths) -> tuple[int, int]:
    """(bytes, operations) decode attention needs for these inputs: q, the
    output and lengths once, the K/V rows below min(lengths, S) of every kv
    head, and 4*D operations per (query head, visible key)."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    item = q.element_size()
    keys = int(lengths.cpu().long().clamp(0, S).sum())
    return (2 * q.numel() * item + lengths.numel() * 4
            + 2 * keys * KV * D * item, 4 * H * D * keys)


def decode_sdpa_inputs(q, k_cache, v_cache, lengths):
    """The same attention as one library call: (q (B, H, 1, D), K/V
    (B, H, S, D) with the GQA heads expanded, keyword arguments with the
    (B, 1, 1, S) boolean mask).  Built once, outside any timing."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    k = k_cache.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
    v = v_cache.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=q.device)[None]
            < lengths.long()[:, None])[:, None, None]
    return q[:, :, None].contiguous(), k, v, {"attn_mask": mask}


def q8_case(B, H, KV, D, S, lengths, dtype, device, seed=0):
    """(q (B, H, D), kq, vq (B, S, KV, D) int8, k_scale, v_scale (B, KV)
    float32, lengths (B,) int32): ``decode_case``'s inputs with its K/V
    quantized by ``ref.quantize_kv``, in the argument order of
    ``ops.decode_attention_q8``.  The unquantized caches are
    ``decode_case`` at the same arguments."""
    from .ref import quantize_kv

    q, kc, vc, ln = decode_case(B, H, KV, D, S, lengths, dtype, device,
                                seed=seed)
    kq, ks, vq, vs = quantize_kv(kc, vc)
    return q, kq, vq, ks, vs, ln


def q8_held(q, k_cache, v_cache, k_scale, v_scale, lengths):
    """The plain version in float32 on the same inputs (as
    ``paged_attention_held``: a bfloat16 q is upcast exactly, and the
    dequantized caches are float32 on both routes)."""
    from .decode_attention_q8 import decode_attention_q8_plain

    return decode_attention_q8_plain(q.float(), k_cache, v_cache, k_scale,
                                     v_scale, lengths)


def q8_work(q, k_cache, v_cache, k_scale, v_scale, lengths) -> tuple[int, int]:
    """(bytes, operations) int8 decode attention needs for these inputs: q,
    the output, lengths and both scales once, the int8 K/V rows below
    min(lengths, S) of every kv head (1 byte an element); 4*D operations per
    (query head, visible key) and one dequant multiply per K/V element
    read."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    item = q.element_size()
    keys = int(lengths.cpu().long().clamp(0, S).sum())
    return (2 * q.numel() * item + lengths.numel() * 4
            + (k_scale.numel() + v_scale.numel()) * 4
            + 2 * keys * KV * D * k_cache.element_size(),
            4 * H * D * keys + 2 * keys * KV * D)


def q8_sdpa_inputs(q, k_cache, v_cache, k_scale, v_scale, lengths):
    """SDPA's operands over the caches dequantized to q's dtype, built once
    outside any timing (``decode_sdpa_inputs`` of the dequantized caches).
    Not the same function: no single PyTorch call reads int8 K/V with
    scales, so this times only the attention a fused library path would
    leave after a dequant pass."""
    k = (k_cache.float() * k_scale[:, None, :, None]).to(q.dtype)
    v = (v_cache.float() * v_scale[:, None, :, None]).to(q.dtype)
    return decode_sdpa_inputs(q, k, v, lengths)


def flash_case(B, Sq, Skv, H, KV, D, dtype, device, seed=0):
    """(q (B, Sq, H, D), k, v (B, Skv, KV, D)) of a prefill."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g)
    k = torch.randn((B, Skv, KV, D), generator=g)
    v = torch.randn((B, Skv, KV, D), generator=g)
    return q.to(device, dtype), k.to(device, dtype), v.to(device, dtype)


def flash_attention_held(q, k, v, causal=True):
    """The plain version in float32 on the same inputs (as
    ``paged_attention_held``)."""
    from .flash_attention import flash_attention_plain

    return flash_attention_plain(q.float(), k.float(), v.float(),
                                 causal=causal)


def flash_work(q, k, v, causal=True) -> tuple[int, int]:
    """(bytes, operations) of the prefill: q, k, v and the output once (the
    last query row sees every key), and 4*D operations per (query head,
    visible key): query i sees min(i + Skv - Sq + 1, Skv) keys when causal."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    item = q.element_size()
    if causal:
        seen = sum(max(0, min(i + Skv - Sq + 1, Skv)) for i in range(Sq))
    else:
        seen = Sq * Skv
    return ((2 * q.numel() + k.numel() + v.numel()) * item,
            4 * B * H * D * seen)


def flash_sdpa_inputs(q, k, v, causal=True):
    """The same attention as one library call: (B, H, S, D) operands with
    the GQA heads expanded and keyword arguments (``is_causal`` when the
    causal diagonal is the top-left one, Sq == Skv; else a boolean mask).
    Built once, outside any timing."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    kk = k.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
    vv = v.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
    if not causal:
        kwargs = {}
    elif Sq == Skv:
        kwargs = {"is_causal": True}
    else:
        kwargs = {"attn_mask": (torch.arange(Skv, device=q.device)[None]
                                <= torch.arange(Sq, device=q.device)[:, None]
                                + (Skv - Sq))}
    return q.transpose(1, 2).contiguous(), kk, vv, kwargs
