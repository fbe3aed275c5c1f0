"""Public entry points of the kernels on the serving paths.

Each op in ``OPS`` dispatches by the device of its tensors, with no switch
and no fallback: a CUDA tensor launches the hand-written CUDA kernel (and
raises if the kernel does not build, take the inputs or launch); a CPU
tensor runs the plain PyTorch version beside the kernel.  Every op keeps two
counters, kernel launches (counted by the wrapper where it launches) and
plain calls (counted here), so a run can show which path it went through.
``ssd_decode`` and ``quantize_kv`` are not among them: neither has a kernel
in the JAX package, and both are plain PyTorch on every device, so "every
plain counter is 0" still means that no kernel was bypassed.
"""

from __future__ import annotations

import torch

from repro_torch import precision as _precision  # noqa: F401  (no TF32)
from repro_torch.obs import trace

from . import decode_attention as _da
from . import decode_attention_q8 as _daq
from . import flash_attention as _fa
from . import fused_verify_sample as _fvs
from . import gather_softmax_prob as _gsp
from . import paged_attention as _pa
from . import paged_tree_attention as _pta
from . import ref as _ref
from . import residual_sample as _rs
from . import ssd_scan as _ssd
from . import tree_attention as _ta

OPS = ("paged_attention", "fused_verify_sample", "paged_tree_attention",
       "gather_softmax_prob", "residual_sample", "tree_attention", "ssd_scan",
       "decode_attention", "flash_attention", "decode_attention_q8")
_MODULES = {"paged_attention": _pa, "fused_verify_sample": _fvs,
            "paged_tree_attention": _pta, "gather_softmax_prob": _gsp,
            "residual_sample": _rs, "tree_attention": _ta, "ssd_scan": _ssd,
            "decode_attention": _da, "flash_attention": _fa,
            "decode_attention_q8": _daq}
_plain_calls = {name: 0 for name in OPS}


def counts() -> dict[str, dict[str, int]]:
    """``{op: {"kernel": launches, "plain": plain calls}}`` since the last
    ``reset_counts``."""
    return {name: {"kernel": _MODULES[name].launches,
                   "plain": _plain_calls[name]} for name in OPS}


def reset_counts() -> None:
    for name in OPS:
        _MODULES[name].launches = 0
        _plain_calls[name] = 0


def _route(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _span(name: str, x: torch.Tensor, route: str):
    """Dispatch span: op name, lead operand shape/dtype and the route taken.
    The args dict is built only when a tracer is installed."""
    if trace.active() is None:
        return trace.NULL_SPAN
    return trace.span(name, cat="kernel",
                      args={"shape": list(x.shape), "dtype": str(x.dtype),
                            "backend": route})


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """Window/decode attention through a paged KV cache.

    q: (B, T, H, D); pools: (P, ps, KV, D); page_table: (B, n_slots) int32
    (-1 = unmapped); lengths: (B,) int32 valid kv count for query row 0 (row
    t attends [0, lengths + t)).  Returns (B, T, H, D).
    """
    route = _route(q)
    with _span("ops.paged_attention", q, route) as sp:
        if route == "cuda":
            out = _pa.paged_attention_cuda(q, k_pool, v_pool, page_table,
                                           lengths)
        else:
            _plain_calls["paged_attention"] += 1
            out = _pa.paged_attention_plain(q, k_pool, v_pool, page_table,
                                            lengths)
        sp.attach(out)
    return out


def fused_verify_sample(target_logits, draft_tokens, draft_probs, q_idx,
                        q_val, u_accept, u_resid, draft_len=None):
    """Accept test + prefix count + calibrated residual token, one launch.

    target_logits: (B, L+1, V) float32; draft_tokens / draft_probs /
    u_accept: (B, L); q_idx / q_val: (B, L, Vhat); u_resid: (B,); draft_len:
    (B,) true lengths (defaults to L).  Uniforms are drawn by the caller.
    Returns ``(accept (B, L) bool, n_acc (B,) int32, calibrated (B,) int32)``.
    """
    B, L = draft_tokens.shape
    if draft_len is None:
        draft_len = torch.full((B,), L, dtype=torch.int32,
                               device=draft_tokens.device)
    route = _route(target_logits)
    with _span("ops.fused_verify_sample", target_logits, route) as sp:
        if route == "cuda":
            out = _fvs.fused_verify_sample_cuda(
                target_logits, draft_tokens, draft_probs, q_idx, q_val,
                u_accept, u_resid, draft_len)
        else:
            _plain_calls["fused_verify_sample"] += 1
            out = _fvs.fused_verify_sample_plain(
                target_logits, draft_tokens, draft_probs, q_idx, q_val,
                u_accept, u_resid, draft_len)
        sp.attach(out[2])
    return out


def paged_tree_attention(q, k_pool, v_pool, page_table, lengths, win_mask):
    """Token-tree window attention through a paged KV cache.

    q: (B, T, H, D) with T <= 64; pools: (P, ps, KV, D); page_table:
    (B, n_slots) int32 (-1 = unmapped); lengths: (B,) int32 committed kv
    count (every row attends [0, lengths)); win_mask: (B, T, T) bool, row t
    also attends window position lengths + t' where win_mask[b, t, t'].
    Returns (B, T, H, D).
    """
    route = _route(q)
    with _span("ops.paged_tree_attention", q, route) as sp:
        if route == "cuda":
            out = _pta.paged_tree_attention_cuda(q, k_pool, v_pool, page_table,
                                                 lengths, win_mask)
        else:
            _plain_calls["paged_tree_attention"] += 1
            out = _pta.paged_tree_attention_plain(q, k_pool, v_pool,
                                                  page_table, lengths,
                                                  win_mask)
        sp.attach(out)
    return out


def gather_softmax_prob(logits, token_ids):
    """logits (N, V) float32; token_ids (N,) int32 -> softmax(logits)[token]
    (N,) float32, without materializing the softmax."""
    route = _route(logits)
    with _span("ops.gather_softmax_prob", logits, route) as sp:
        if route == "cuda":
            out = _gsp.gather_softmax_prob_cuda(logits, token_ids)
        else:
            _plain_calls["gather_softmax_prob"] += 1
            out = _gsp.gather_softmax_prob_plain(logits, token_ids)
        sp.attach(out)
    return out


def residual_sample(p, q, u):
    """p, q (N, V) float32 probability rows; u (N,) float32 uniforms ->
    tokens (N,) int32 from normalize(max(p - q, 0)) by inverse CDF
    (argmax(p) when the residual is all zero)."""
    route = _route(p)
    with _span("ops.residual_sample", p, route) as sp:
        if route == "cuda":
            out = _rs.residual_sample_cuda(p, q, u)
        else:
            _plain_calls["residual_sample"] += 1
            out = _rs.residual_sample_plain(p, q, u)
        sp.attach(out)
    return out


def tree_attention(q, k_cache, v_cache, lengths, win_mask):
    """Token-tree window attention over a contiguous KV cache.

    q: (B, T, H, D) with T <= 64; caches: (B, S, KV, D) with the window
    already written at positions [lengths, lengths + T); lengths: (B,) int32
    committed kv count; win_mask: (B, T, T) bool ancestor-or-self matrix (a
    lower-triangular mask is the sequential causal window).
    Returns (B, T, H, D).
    """
    route = _route(q)
    with _span("ops.tree_attention", q, route) as sp:
        if route == "cuda":
            out = _ta.tree_attention_cuda(q, k_cache, v_cache, lengths,
                                          win_mask)
        else:
            _plain_calls["tree_attention"] += 1
            out = _ta.tree_attention_plain(q, k_cache, v_cache, lengths,
                                           win_mask)
        sp.attach(out)
    return out


def decode_attention(q, k_cache, v_cache, lengths):
    """One query step against a contiguous KV cache.

    q: (B, H, D); caches: (B, S, KV, D); lengths: (B,) int32, row b attends
    positions [0, lengths_b) (all S when lengths_b >= S).  Returns (B, H, D).
    """
    route = _route(q)
    with _span("ops.decode_attention", q, route) as sp:
        if route == "cuda":
            out = _da.decode_attention_cuda(q, k_cache, v_cache, lengths)
        else:
            _plain_calls["decode_attention"] += 1
            out = _da.decode_attention_plain(q, k_cache, v_cache, lengths)
        sp.attach(out)
    return out


def decode_attention_q8(q, k_cache, v_cache, k_scale, v_scale, lengths):
    """One query step against an int8 KV cache with per-head scales.

    q: (B, H, D) float32 or bfloat16; caches: (B, S, KV, D) int8; scales:
    (B, KV) float32 (``quantize_kv``); lengths: (B,) int32, row b attends
    positions [0, lengths_b) (all S when lengths_b >= S).  Returns (B, H, D)
    in q's dtype.
    """
    route = _route(q)
    with _span("ops.decode_attention_q8", q, route) as sp:
        if route == "cuda":
            out = _daq.decode_attention_q8_cuda(q, k_cache, v_cache, k_scale,
                                                v_scale, lengths)
        else:
            _plain_calls["decode_attention_q8"] += 1
            out = _daq.decode_attention_q8_plain(q, k_cache, v_cache, k_scale,
                                                 v_scale, lengths)
        sp.attach(out)
    return out


def quantize_kv(k, v):
    """Per (batch, kv head) symmetric int8 quantization of (B, S, KV, D)
    caches, plain PyTorch on every device (no kernel, no counter).  Returns
    (kq, k_scale, vq, v_scale): int8 codes and (B, KV) float32 scales."""
    with _span("ops.quantize_kv", k, "plain") as sp:
        out = _ref.quantize_kv(k, v)
        sp.attach(out[0])
    return out


def flash_attention(q, k, v, causal: bool = True):
    """Causal (or full) GQA attention: the prefill.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D); with ``causal`` query i
    attends keys j <= i + (Skv - Sq).  Returns (B, Sq, H, D).
    """
    route = _route(q)
    with _span("ops.flash_attention", q, route) as sp:
        if route == "cuda":
            out = _fa.flash_attention_cuda(q, k, v, causal=causal)
        else:
            _plain_calls["flash_attention"] += 1
            out = _fa.flash_attention_plain(q, k, v, causal=causal)
        sp.attach(out)
    return out


def ssd_scan(x, dt, A, B, C, chunk: int = 64, initial_state=None):
    """Chunked SSD forward (see ``ref.ssd_scan_ref`` for shapes).

    The sequence is zero-padded to a chunk multiple on both routes, as in
    the JAX package: dt = 0 padding is exact (decay e^0 = 1, update 0), so
    the final state is untouched.  Returns (y (b, s, h, p), final state
    (b, h, p, n) float32).
    """
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    route = _route(x)
    with _span("ops.ssd_scan", x, route) as sp:
        if route == "cuda":
            y, fs = _ssd.ssd_scan_cuda(
                x.contiguous(), dt.contiguous(), A.contiguous(),
                B.contiguous(), C.contiguous(), chunk=chunk,
                initial_state=(None if initial_state is None
                               else initial_state.contiguous()))
        else:
            _plain_calls["ssd_scan"] += 1
            y, fs = _ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                        initial_state=initial_state)
        sp.attach(y)
    return (y[:, :s] if pad else y), fs


def ssd_decode(x, dt, A, B, C, state):
    """One-token SSD recurrence, plain PyTorch on every device (no kernel,
    no counter).  x (b, h, p); dt (b, h); A (h,); B, C (b, g, n); state
    (b, h, p, n) -> (y (b, h, p), new state float32)."""
    with _span("ops.ssd_decode", x, "plain") as sp:
        out = _ref.ssd_decode_ref(x, dt, A, B, C, state)
        sp.attach(out[0])
    return out
