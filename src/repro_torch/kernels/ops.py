"""Public entry points of the kernels on the serving paths.

Each op in ``OPS`` dispatches by the device of its tensors, with no switch
and no fallback: a CUDA tensor launches the hand-written CUDA kernel (and
raises if the kernel does not build, take the inputs or launch); a CPU
tensor runs the plain PyTorch version beside the kernel.  Every op keeps two
counters, kernel launches (counted by the wrapper where it launches) and
plain calls (counted here), so a run can show which path it went through.
Both tick in Python: an op inside a CUDA graph counts when the graph is
captured (and at the eager run before it), never when it is replayed, so
the compiled round path (``serving/compiled.py``) counts its replays per
step itself (``SpecEngine.step_counts``).
No kernel has a backward (the JAX package has none either): on the card an
op refuses, under grad mode, any floating input that requires grad, rather
than return an output cut from the graph; its plain version on the CPU is
differentiable.

A sharded step hands the ops DTensors.  ``decode_attention``,
``flash_attention``, ``tree_attention``, ``decode_attention_q8``,
``ssd_scan`` and ``ssd_decode`` take them through ``local_map`` (the
counterpart of ``shard_map``): the inputs are first redistributed to
placements on which the op is local (rows over the data axes; kv heads,
and the q heads of their groups, over ``model`` when the kv heads divide
it, else whole over ``model``, which inserts the all-gather of the
reference's sequence-over-model cache fallback; SSD heads over ``model``
when they and their groups split evenly), then the same device dispatch
runs on each rank's shards.  The paged ops and the samplers refuse a
DTensor: no sharded path reaches them.  ``ssd_decode`` and ``quantize_kv``
are not among the ops: neither has a kernel in the JAX package, and both
are plain PyTorch on every device, so "every plain counter is 0" still
means that no kernel was bypassed.
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


_DTENSOR: list = []         # the DTensor class, imported at first use


def _is_dtensor(x) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def _no_dtensor(name: str, x) -> None:
    if _is_dtensor(x):
        raise TypeError(f"ops.{name} takes no DTensor: the sharded steps run "
                        "contiguous caches and no sampler")


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a local map's
    input gradients become DTensor shards that a later reshape views as
    they are, and einsum's backward returns permuted views."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def contiguous_local(fn):
    """``fn`` for ``local_map``: its tensor inputs' gradients and its
    outputs made contiguous (no copy of what already is)."""
    def local(*args):
        args = [_ContiguousGrad.apply(a)
                if isinstance(a, torch.Tensor) and a.requires_grad else a
                for a in args]
        out = fn(*args)
        if isinstance(out, tuple):
            return tuple(o.contiguous() for o in out)
        return out.contiguous()
    return local


def _sharded(op, args, specs, out_specs, rows: int):
    """Run ``op`` on the local shards of DTensor ``args`` through
    ``local_map``.  ``specs`` / ``out_specs`` give each input / output one
    logical name per dim: "rows" (over the data axes, when they divide
    ``rows``), "heads" (over ``model``; the caller names it only where the
    op stays local so) or None; an arg whose spec is None is passed through
    as is (a python value or None).  Plain tensor args are taken as
    replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed import sharding as shd

    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    dp = shd.data_axes(mesh)
    split_rows = bool(dp) and rows % shd.axis_size(mesh, dp) == 0

    def resolve(spec):
        dims = tuple(dp if name == "rows" and split_rows else
                     "model" if name == "heads" else None for name in spec)
        # a list: local_map reads a tuple as one placement list per value
        return list(shd.placements(dims, mesh))

    in_pl, call = [], []
    for a, spec in zip(args, specs):
        if spec is not None and not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        in_pl.append(None if spec is None else resolve(spec))
        call.append(a)
    out_pl = tuple(resolve(o) for o in out_specs)
    fn = local_map(contiguous_local(op),
                   out_placements=out_pl if len(out_pl) > 1 else out_pl[0],
                   in_placements=tuple(in_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(*call)


def _heads(x, n: int, *, shared: int | None = None) -> str | None:
    """"heads" when ``n`` heads split evenly over the ``model`` axis of
    DTensor ``x``'s mesh (and ``shared``, the groups they read, either
    split too or are one group), else None: the op then runs whole over
    ``model`` (for attention, the all-gather of the reference's
    sequence-over-model cache fallback)."""
    from repro_torch.distributed import sharding as shd

    mesh = x.device_mesh
    if "model" not in shd.axis_names(mesh):
        return None
    m = shd.axis_size(mesh, "model")
    ok = n % m == 0 and (shared is None or shared == 1 or shared % m == 0)
    return "heads" if ok else None


def _route(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _no_grad_through(name: str, *tensors) -> None:
    """Raise if a kernel would cut ``tensors`` from the autograd graph: the
    CUDA route writes into a fresh tensor with no ``grad_fn``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.is_floating_point() and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"ops.{name}: an input requires grad, but the CUDA kernel has no "
            "backward (the JAX package has no backward kernel for this op "
            "either); run it under torch.no_grad(), or train on the CPU, "
            "where its plain version is differentiable")


def _span(name: str, x: torch.Tensor, route: str):
    """Dispatch span: op name, lead operand shape/dtype and the route taken.
    The args dict is built only when a tracer is installed."""
    if trace.active() is None:
        return trace.NULL_SPAN
    return trace.span(name, cat="kernel",
                      args={"shape": list(x.shape), "dtype": str(x.dtype),
                            "backend": route})


def paged_attention(q, k_pool, v_pool, page_table, lengths, window=0):
    """Window/decode attention through a paged KV cache.

    q: (B, T, H, D); pools: (P, ps, KV, D); page_table: (B, n_slots) int32
    (-1 = unmapped); lengths: (B,) int32 valid kv count for query row 0 (row
    t attends [0, lengths + t)); ``window`` > 0 (a python int, a sliding-
    window layer's): row t attends only the last ``window`` of those keys.
    Returns (B, T, H, D).
    """
    _no_dtensor("paged_attention", q)
    route = _route(q)
    with _span("ops.paged_attention", q, route) as sp:
        if route == "cuda":
            _no_grad_through("paged_attention", q, k_pool, v_pool)
            out = _pa.paged_attention_cuda(q, k_pool, v_pool, page_table,
                                           lengths, window=window)
        else:
            _plain_calls["paged_attention"] += 1
            out = _pa.paged_attention_plain(q, k_pool, v_pool, page_table,
                                            lengths, window=window)
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
    _no_dtensor("fused_verify_sample", target_logits)
    B, L = draft_tokens.shape
    if draft_len is None:
        draft_len = torch.full((B,), L, dtype=torch.int32,
                               device=draft_tokens.device)
    route = _route(target_logits)
    with _span("ops.fused_verify_sample", target_logits, route) as sp:
        if route == "cuda":
            _no_grad_through("fused_verify_sample", target_logits,
                             draft_probs, q_val, u_accept, u_resid)
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
    _no_dtensor("paged_tree_attention", q)
    route = _route(q)
    with _span("ops.paged_tree_attention", q, route) as sp:
        if route == "cuda":
            _no_grad_through("paged_tree_attention", q, k_pool, v_pool)
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
    _no_dtensor("gather_softmax_prob", logits)
    route = _route(logits)
    with _span("ops.gather_softmax_prob", logits, route) as sp:
        if route == "cuda":
            _no_grad_through("gather_softmax_prob", logits)
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
    _no_dtensor("residual_sample", p)
    route = _route(p)
    with _span("ops.residual_sample", p, route) as sp:
        if route == "cuda":
            _no_grad_through("residual_sample", p, q, u)
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
    if _is_dtensor(q):
        h = _heads(q, k_cache.shape[2])
        att = ("rows", None, h, None)
        return _sharded(tree_attention,
                        (q, k_cache, v_cache, lengths, win_mask),
                        (att, att, att, ("rows",), ("rows", None, None)),
                        (att,), q.shape[0])
    route = _route(q)
    with _span("ops.tree_attention", q, route) as sp:
        if route == "cuda":
            _no_grad_through("tree_attention", q, k_cache, v_cache)
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
    if _is_dtensor(q):
        h = _heads(q, k_cache.shape[2])
        sq, sk = ("rows", h, None), ("rows", None, h, None)
        return _sharded(decode_attention, (q, k_cache, v_cache, lengths),
                        (sq, sk, sk, ("rows",)), (sq,), q.shape[0])
    route = _route(q)
    with _span("ops.decode_attention", q, route) as sp:
        if route == "cuda":
            _no_grad_through("decode_attention", q, k_cache, v_cache)
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
    if _is_dtensor(q):
        h = _heads(q, k_cache.shape[2])
        sq, sk, ss = ("rows", h, None), ("rows", None, h, None), ("rows", h)
        return _sharded(decode_attention_q8,
                        (q, k_cache, v_cache, k_scale, v_scale, lengths),
                        (sq, sk, sk, ss, ss, ("rows",)), (sq,), q.shape[0])
    route = _route(q)
    with _span("ops.decode_attention_q8", q, route) as sp:
        if route == "cuda":
            _no_grad_through("decode_attention_q8", q, k_scale, v_scale)
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
    if _is_dtensor(q):
        h = _heads(q, k.shape[2])
        att = ("rows", None, h, None)
        return _sharded(flash_attention, (q, k, v, causal),
                        (att, att, att, None), (att,), q.shape[0])
    route = _route(q)
    with _span("ops.flash_attention", q, route) as sp:
        if route == "cuda":
            _no_grad_through("flash_attention", q, k, v)
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
    if _is_dtensor(x):
        g = B.shape[2]
        h = _heads(x, x.shape[2], shared=g)
        hg = h if g > 1 else None        # one group: B / C whole
        return _sharded(
            ssd_scan, (x, dt, A, B, C, chunk, initial_state),
            (("rows", None, h, None), ("rows", None, h), (h,),
             ("rows", None, hg, None), ("rows", None, hg, None), None,
             None if initial_state is None else ("rows", h, None, None)),
            (("rows", None, h, None), ("rows", h, None, None)), x.shape[0])
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
            _no_grad_through("ssd_scan", x, dt, A, B, C, initial_state)
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
    (b, h, p, n) -> (y (b, h, p), new state float32).  DTensors go
    through a local map like ``ssd_scan``'s."""
    if _is_dtensor(x):
        g = B.shape[1]
        h = _heads(x, x.shape[1], shared=g)
        hg = h if g > 1 else None
        return _sharded(
            ssd_decode, (x, dt, A, B, C, state),
            (("rows", h, None), ("rows", h), (h,), ("rows", hg, None),
             ("rows", hg, None), ("rows", h, None, None)),
            (("rows", h, None), ("rows", h, None, None)), x.shape[0])
    with _span("ops.ssd_decode", x, "plain") as sp:
        out = _ref.ssd_decode_ref(x, dt, A, B, C, state)
        sp.attach(out[0])
    return out
