"""Paged token-tree window attention: the CUDA kernel's wrapper and its
plain version.

The kernel (``csrc/paged_tree_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.tree_attention.paged_tree_attention_pallas``: GQA attention
of a T-token tree window through a page table, query row t attending the
committed positions ``[0, lengths_b)`` plus the window positions
``lengths_b + t'`` its ancestor mask ``win_mask[b, t, t']`` allows, unmapped
(-1) slots skipped.  It runs on every target layer of a multi-draft tree
round.  ``paged_tree_attention_plain`` is the same function in plain
PyTorch (``ref.paged_tree_attention_ref``); ``ops.paged_tree_attention``
picks between the two by the device of the tensors.

At bfloat16 the kernel is B1's tensor-core body with the tree mask; it
splits the key axis (``n_slots * ps`` keys) by
``paged_attention.window_split_plan`` only when the grid has fewer blocks
than SMs, through the scratch ``paged_attention`` keeps per device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .paged_attention import scratch_for, sm_count, window_split_plan
from .ref import paged_tree_attention_ref as paged_tree_attention_plain

__all__ = ["paged_tree_attention_cuda", "paged_tree_attention_plain",
           "launches", "split_plan"]

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_PAGE_SIZE = 32
MAX_T = 64          # one 64-bit ancestor word per window row
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made through ``paged_tree_attention_cuda``
launches = 0

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("paged_tree_attention").paged_tree_attention_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def split_plan(q: torch.Tensor, k_pool: torch.Tensor, page_table: torch.Tensor,
               n_sm: int) -> tuple[int, int, int, int]:
    """``(row_tile, row_tiles, n_split, split_keys)`` of the bf16 kernel:
    ``window_split_plan`` over the table's ``n_slots * ps`` keys, from the
    shapes alone."""
    B, T, H, _ = q.shape
    ps, KV = k_pool.shape[1], k_pool.shape[2]
    return window_split_plan(B, KV, T * (H // KV), page_table.shape[1] * ps,
                             n_sm)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_tree_attention_cuda: {msg}")


def paged_tree_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, page_table: torch.Tensor,
                              lengths: torch.Tensor,
                              win_mask: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, D); pools (P, ps, KV, D); page_table (B, n_slots) int32;
    lengths (B,) int32 committed counts; win_mask (B, T, T) bool, T <= 64 ->
    (B, T, H, D).  Launches the CUDA kernel on the current stream; raises on
    anything the kernel does not take."""
    global launches
    tensors = (q, k_pool, v_pool, page_table, lengths, win_mask)
    _check(all(t.is_cuda for t in tensors), "all tensors must be on a CUDA device")
    _check(len({t.device for t in tensors}) == 1, "tensors on different devices")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _check(q.dtype in _DTYPES and k_pool.dtype == q.dtype
           and v_pool.dtype == q.dtype,
           f"q/pools must share float32 or bfloat16, got {q.dtype}, "
           f"{k_pool.dtype}, {v_pool.dtype}")
    _check(page_table.dtype == torch.int32 and lengths.dtype == torch.int32,
           "page_table and lengths must be int32")
    _check(win_mask.dtype == torch.bool, "win_mask must be bool")
    _check(q.dim() == 4 and k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
           "q must be (B, T, H, D) and the pools (P, ps, KV, D)")
    B, T, H, D = q.shape
    P, ps, KV, Dk = k_pool.shape
    _check(1 <= T <= MAX_T, f"window of {T} tokens: the kernel takes at most "
           f"{MAX_T} (one 64-bit ancestor word per row)")
    _check(Dk == D and D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    _check(H % KV == 0, f"{H} query heads not a multiple of {KV} kv heads")
    _check(1 <= ps <= MAX_PAGE_SIZE, f"page size {ps} not in [1, {MAX_PAGE_SIZE}]")
    _check(page_table.dim() == 2 and page_table.shape[0] == B
           and lengths.shape == (B,) and win_mask.shape == (B, T, T),
           "page_table (B, n_slots), lengths (B,), win_mask (B, T, T)")
    _check(q.dtype == torch.float32
           or all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool)),
           "bfloat16 q and pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    n_slots = page_table.shape[1]
    row_tile, n_split, split_keys = 0, 1, 1
    part = tickets = None
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            row_tile, row_tiles, n_split, split_keys = split_plan(
                q, k_pool, page_table, sm_count(q.device))
            if n_split > 1:
                n_part = B * KV * row_tiles * n_split * row_tile
                part, tickets = scratch_for(q.device, n_part * (D + 2),
                                            B * KV * row_tiles)
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                       page_table.data_ptr(), lengths.data_ptr(),
                       win_mask.data_ptr(), out.data_ptr(),
                       None if part is None else part.data_ptr(),
                       None if tickets is None else tickets.data_ptr(),
                       B, T, H, KV, D, ps, n_slots, row_tile, n_split,
                       split_keys, _DTYPES[q.dtype], 1.0 / math.sqrt(D),
                       stream)
    build.check(err, "paged_tree_attention")
    launches += 1
    return out
