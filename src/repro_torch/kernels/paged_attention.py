"""Paged window attention: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/paged_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.paged_attention.paged_attention_pallas``: GQA attention of
a T-token query window through a page table, row t attending logical
positions ``[0, lengths_b + t)``, unmapped (-1) slots skipped.  It runs on
every prefill, draft step and verification window of the paged serving
path.  ``paged_attention_plain`` is the same function in plain PyTorch
(``ref.paged_attention_ref``); ``ops.paged_attention`` picks between the
two by the device of the tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import paged_attention_ref as paged_attention_plain

__all__ = ["paged_attention_cuda", "paged_attention_plain", "launches"]

HEAD_DIMS = (16, 32, 64, 128)
MAX_PAGE_SIZE = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made through ``paged_attention_cuda``
launches = 0

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("paged_attention").paged_attention_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, D); pools (P, ps, KV, D); page_table (B, n_slots) int32;
    lengths (B,) int32 -> (B, T, H, D).  Launches the CUDA kernel on the
    current stream; raises on anything the kernel does not take."""
    global launches
    tensors = (q, k_pool, v_pool, page_table, lengths)
    _check(all(t.is_cuda for t in tensors), "all tensors must be on a CUDA device")
    _check(len({t.device for t in tensors}) == 1, "tensors on different devices")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _check(q.dtype in _DTYPES and k_pool.dtype == q.dtype
           and v_pool.dtype == q.dtype,
           f"q/pools must share float32 or bfloat16, got {q.dtype}, "
           f"{k_pool.dtype}, {v_pool.dtype}")
    _check(page_table.dtype == torch.int32 and lengths.dtype == torch.int32,
           "page_table and lengths must be int32")
    _check(q.dim() == 4 and k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
           "q must be (B, T, H, D) and the pools (P, ps, KV, D)")
    B, T, H, D = q.shape
    P, ps, KV, Dk = k_pool.shape
    _check(Dk == D and D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    _check(H % KV == 0, f"{H} query heads not a multiple of {KV} kv heads")
    _check(1 <= ps <= MAX_PAGE_SIZE, f"page size {ps} not in [1, {MAX_PAGE_SIZE}]")
    _check(page_table.dim() == 2 and page_table.shape[0] == B
           and lengths.shape == (B,), "page_table (B, n_slots), lengths (B,)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                       page_table.data_ptr(), lengths.data_ptr(),
                       out.data_ptr(), B, T, H, KV, D, ps,
                       page_table.shape[1], _DTYPES[q.dtype],
                       1.0 / math.sqrt(D), stream)
    build.check(err, "paged_attention")
    launches += 1
    return out
