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

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def bound(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, iters: int = 50, warmup: int = 5, flush_mb: int = 64) -> float:
    """Mean device time of ``fn()`` in ms from CUDA events around each call,
    with the 50 MB L2 cache flushed (a ``flush_mb`` buffer rewritten)
    between calls, outside the timed window."""
    flush = torch.empty(flush_mb << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def paged_case(B, T, H, KV, D, ps, ctx, dtype, device, seed=0, holes=True):
    """q (B, T, H, D) and pools with contexts of ctx/2..ctx tokens on
    scattered, non-contiguous pages; slots past each row's window stay -1,
    and with ``holes`` the last row is all -1 (a retired row).  ``ctx=1``
    is a prefill at offset 0 (lengths 1: row t attends [0, t])."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_slots = -(-(ctx + T) // ps) + 2
    P = B * n_slots + 3
    q = torch.randn((B, T, H, D), generator=g)
    kp = torch.randn((P, ps, KV, D), generator=g)
    vp = torch.randn((P, ps, KV, D), generator=g)
    lengths = torch.randint(max(1, ctx // 2), ctx + 1, (B,), generator=g)
    perm = torch.randperm(P, generator=g)
    pt = torch.full((B, n_slots), -1, dtype=torch.int32)
    n = 0
    for b in range(B):
        need = -(-(int(lengths[b]) + T - 1) // ps)
        pt[b, :need] = perm[n:n + need].to(torch.int32)
        n += need
    if holes and B > 2:
        pt[-1] = -1
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            pt.to(device), lengths.to(device, torch.int32))


# (rtol, atol) of the kernel against ``paged_attention_held``: float32 is the
# band of ``tests/test_kernels.py``; a bfloat16 output is the kernel's float32
# result rounded once, so it lies within 2**-8 of its own magnitude of the
# float32 answer, and the band is twice that rounding.
PAGED_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (8e-3, 1e-3)}


def paged_attention_held(q, k_pool, v_pool, page_table, lengths):
    """What the kernel is held against: the plain version in float32 on the
    same inputs (bfloat16 ones upcast exactly), so a bfloat16 output is
    compared with the exact answer, not with one rounded twice more."""
    from .paged_attention import paged_attention_plain

    return paged_attention_plain(q.float(), k_pool.float(), v_pool.float(),
                                 page_table, lengths)


def paged_work(q, k_pool, v_pool, page_table, lengths) -> tuple[int, int]:
    """(bytes, operations) paged attention needs for these inputs: q, the
    output, the table and lengths once, plus every K/V page some row can
    see (mapped and below the row's last horizon), across all kv heads;
    4*D operations (two multiply-adds) per visible (query head, key)."""
    B, T, H, D = q.shape
    P, ps, KV, _ = k_pool.shape
    pt, ln = page_table.cpu().long(), lengths.cpu().long()
    item = q.element_size()
    n_bytes = 2 * q.numel() * item + pt.numel() * 4 + ln.numel() * 4
    ops = 0
    for b in range(B):
        live = [s for s in range(pt.shape[1])
                if pt[b, s] >= 0 and s * ps < ln[b] + T - 1]
        n_bytes += 2 * len(live) * ps * KV * D * item
        for t in range(T):
            keys = sum(min(ps, max(0, int(ln[b]) + t - s * ps)) for s in live)
            ops += 4 * H * keys * D
    return n_bytes, ops


def paged_sdpa_inputs(q, k_pool, v_pool, page_table, lengths):
    """The same attention as one library call's operands: K/V gathered to
    a contiguous (B, H, S, D) view (GQA heads expanded) and a boolean mask.
    Built once, outside any timing."""
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
    cdf = (p - q).clamp(min=0).cumsum(0)
    z = float(cdf[-1])
    target = float(u_res) * z
    lo, hi = sorted((int(tok_a), int(tok_b)))
    return bool(((cdf[lo:hi] - target).abs() <= rel * z).all())


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
