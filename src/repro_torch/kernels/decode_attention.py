"""Decode attention over a contiguous KV cache: the CUDA kernel's wrapper
and its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention_pallas``: one query step
of GQA attention over (B, S, KV, D) caches, row b attending positions
``[0, lengths_b)`` (all S when lengths_b >= S).  It runs on every T = 1
window of the contiguous layout: draft steps, the hybrid target's
per-token steps and ``ServingEngine.decode_step``.
``decode_attention_plain`` is the same function in plain PyTorch
(``ref.decode_attention_ref``); ``ops.decode_attention`` picks between the
two by the device of the tensors.

At bfloat16 the kernel is the window body of B1, B3 and B6 at a one-row
window: it splits the key axis (``S`` keys) by
``paged_attention.window_split_plan`` (``split_plan``), from the shapes
alone, through the scratch ``paged_attention`` keeps per device, so it cuts
the keys where ``tree_attention`` would for a one-row window over the same
cache.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .paged_attention import scratch_for, sm_count, window_split_plan
from .ref import decode_attention_ref as decode_attention_plain

__all__ = ["decode_attention_cuda", "decode_attention_plain", "launches",
           "split_plan"]

HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
MAX_GROUP = 16      # query heads per kv head held in one block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made through ``decode_attention_cuda``
launches = 0

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("decode_attention").decode_attention_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def split_plan(q: torch.Tensor, k_cache: torch.Tensor,
               n_sm: int) -> tuple[int, int, int, int]:
    """``(row_tile, row_tiles, n_split, split_keys)`` of the bf16 kernel:
    ``window_split_plan`` over the cache's ``S`` keys for the G = H / KV
    query heads of a kv head (one 16-row tile), from the shapes alone."""
    B, H, _ = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    return window_split_plan(B, KV, H // KV, S, n_sm)


def bf16_split(q: torch.Tensor, k_cache: torch.Tensor):
    """``(n_split, split_keys, part, tickets)`` of a bf16 launch on the card
    (B7, and B9 over int8 rows): ``split_plan`` and, with more than one
    split, the per-device scratch of its partials (else None, None)."""
    B, _, D = q.shape
    KV = k_cache.shape[2]
    row_tile, _, n_split, split_keys = split_plan(q, k_cache, sm_count(q.device))
    part = tickets = None
    if n_split > 1:
        part, tickets = scratch_for(
            q.device, B * KV * n_split * row_tile * (D + 2), B * KV)
    return n_split, split_keys, part, tickets


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_attention_cuda: {msg}")


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, D); caches (B, S, KV, D); lengths (B,) int32 -> (B, H, D).
    A row with lengths <= 0 returns 0.  Launches the CUDA kernel on the
    current stream; raises on anything the kernel does not take."""
    global launches
    tensors = (q, k_cache, v_cache, lengths)
    _check(all(t.is_cuda for t in tensors), "all tensors must be on a CUDA device")
    _check(len({t.device for t in tensors}) == 1, "tensors on different devices")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _check(q.dtype in _DTYPES and k_cache.dtype == q.dtype
           and v_cache.dtype == q.dtype,
           f"q/caches must share float32 or bfloat16, got {q.dtype}, "
           f"{k_cache.dtype}, {v_cache.dtype}")
    _check(lengths.dtype == torch.int32, "lengths must be int32")
    _check(q.dim() == 3 and k_cache.dim() == 4
           and k_cache.shape == v_cache.shape,
           "q must be (B, H, D) and the caches (B, S, KV, D)")
    B, H, D = q.shape
    Bk, S, KV, Dk = k_cache.shape
    _check(Bk == B and lengths.shape == (B,),
           f"caches of batch {Bk} and lengths {tuple(lengths.shape)} for q "
           f"of batch {B}")
    _check(Dk == D and D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    _check(H % KV == 0 and H // KV <= MAX_GROUP,
           f"{H} query heads over {KV} kv heads: need a multiple, at most "
           f"{MAX_GROUP} per kv head")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache)),
           "q and the caches must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    n_split, split_keys, part, tickets = 1, 1, None, None
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            n_split, split_keys, part, tickets = bf16_split(q, k_cache)
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                       lengths.data_ptr(), out.data_ptr(),
                       None if part is None else part.data_ptr(),
                       None if tickets is None else tickets.data_ptr(),
                       B, H, KV, D, S, n_split, split_keys, _DTYPES[q.dtype],
                       1.0 / math.sqrt(D), stream)
    build.check(err, "decode_attention")
    launches += 1
    return out
