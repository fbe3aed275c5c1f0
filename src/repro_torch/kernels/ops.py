"""Public entry points of the kernels on the J=1 paged serving path.

Each op dispatches by the device of its tensors, with no switch and no
fallback: a CUDA tensor launches the hand-written CUDA kernel (and raises if
the kernel does not build, take the inputs or launch); a CPU tensor runs
the plain PyTorch version beside the kernel.  Every op keeps two counters,
kernel launches (counted by the wrapper where it launches) and plain calls
(counted here), so a run can show which path it went through.
"""

from __future__ import annotations

import torch

from repro_torch.obs import trace

from . import fused_verify_sample as _fvs
from . import paged_attention as _pa

OPS = ("paged_attention", "fused_verify_sample")
_MODULES = {"paged_attention": _pa, "fused_verify_sample": _fvs}
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
