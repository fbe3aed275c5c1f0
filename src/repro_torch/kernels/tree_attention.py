"""Token-tree window attention over a contiguous KV cache: the CUDA kernel's
wrapper and its plain version.

The kernel (``csrc/tree_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.tree_attention.tree_attention_pallas``: GQA attention of a
T-token tree window over (B, S, KV, D) caches, query row t attending the
committed positions ``[0, lengths_b)`` plus the window positions
``lengths_b + t'`` its ancestor mask ``win_mask[b, t, t']`` allows.  It runs
on every target layer of a multi-draft tree round on the contiguous layout.
``tree_attention_plain`` is the same function in plain PyTorch
(``ref.tree_attention_ref``); ``ops.tree_attention`` picks between the two
by the device of the tensors.

At bfloat16 the kernel is ``paged_tree_attention``'s with the page table
replaced by the cache row: it splits the key axis (``S`` keys) by the same
``paged_attention.window_split_plan``, so the same keys laid out in pages
are cut and walked alike, through the scratch ``paged_attention`` keeps per
device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .paged_attention import scratch_for, sm_count, window_split_plan
from .ref import tree_attention_ref as tree_attention_plain

__all__ = ["tree_attention_cuda", "tree_attention_plain", "launches",
           "split_plan"]

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_T = 64          # one 64-bit ancestor word per window row
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made through ``tree_attention_cuda``
launches = 0

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("tree_attention").tree_attention_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def split_plan(q: torch.Tensor, k_cache: torch.Tensor,
               n_sm: int) -> tuple[int, int, int, int]:
    """``(row_tile, row_tiles, n_split, split_keys)`` of the bf16 kernel:
    ``window_split_plan`` over the cache's ``S`` keys, from the shapes
    alone."""
    B, T, H, _ = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    return window_split_plan(B, KV, T * (H // KV), S, n_sm)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"tree_attention_cuda: {msg}")


def tree_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, lengths: torch.Tensor,
                        win_mask: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, D); caches (B, S, KV, D); lengths (B,) int32 committed
    counts; win_mask (B, T, T) bool, T <= 64 -> (B, T, H, D).  Launches the
    CUDA kernel on the current stream; raises on anything the kernel does
    not take."""
    global launches
    tensors = (q, k_cache, v_cache, lengths, win_mask)
    _check(all(t.is_cuda for t in tensors), "all tensors must be on a CUDA device")
    _check(len({t.device for t in tensors}) == 1, "tensors on different devices")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _check(q.dtype in _DTYPES and k_cache.dtype == q.dtype
           and v_cache.dtype == q.dtype,
           f"q/caches must share float32 or bfloat16, got {q.dtype}, "
           f"{k_cache.dtype}, {v_cache.dtype}")
    _check(lengths.dtype == torch.int32, "lengths must be int32")
    _check(win_mask.dtype == torch.bool, "win_mask must be bool")
    _check(q.dim() == 4 and k_cache.dim() == 4
           and k_cache.shape == v_cache.shape,
           "q must be (B, T, H, D) and the caches (B, S, KV, D)")
    B, T, H, D = q.shape
    Bk, S, KV, Dk = k_cache.shape
    _check(1 <= T <= MAX_T, f"window of {T} tokens: the kernel takes at most "
           f"{MAX_T} (one 64-bit ancestor word per row)")
    _check(Bk == B, f"cache batch {Bk} != q batch {B}")
    _check(Dk == D and D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    _check(H % KV == 0, f"{H} query heads not a multiple of {KV} kv heads")
    _check(lengths.shape == (B,) and win_mask.shape == (B, T, T),
           "lengths (B,), win_mask (B, T, T)")
    _check(q.dtype == torch.float32
           or all(t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache)),
           "bfloat16 q and caches must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    row_tile, n_split, split_keys = 0, 1, 1
    part = tickets = None
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            row_tile, row_tiles, n_split, split_keys = split_plan(
                q, k_cache, sm_count(q.device))
            if n_split > 1:
                n_part = B * KV * row_tiles * n_split * row_tile
                part, tickets = scratch_for(q.device, n_part * (D + 2),
                                            B * KV * row_tiles)
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                       lengths.data_ptr(), win_mask.data_ptr(), out.data_ptr(),
                       None if part is None else part.data_ptr(),
                       None if tickets is None else tickets.data_ptr(),
                       B, T, H, KV, D, S, row_tile, n_split, split_keys,
                       _DTYPES[q.dtype], 1.0 / math.sqrt(D), stream)
    build.check(err, "tree_attention")
    launches += 1
    return out
