"""Decode attention over an int8 KV cache: the CUDA kernel's wrapper and its
plain version.

The kernel (``decode_attention_q8_launch`` in ``csrc/decode_attention.cu``)
replaces the Pallas TPU kernel
``repro.kernels.decode_attention.decode_attention_q8_pallas``: one query
step of GQA attention over (B, S, KV, D) int8 caches with float32 scales
(B, KV), one per (batch row, kv head).  Row b attends ``[0, min(lengths_b,
S))``; a row with lengths_b <= 0 returns 0.  The output has q's dtype.
``decode_attention_q8_plain`` is the same function in plain PyTorch
(``ref.decode_attention_quantized_ref``); ``ops.decode_attention_q8`` picks
between the two by the device of the tensors, and ``ops.quantize_kv`` makes
the caches and scales.

With a bfloat16 q the kernel is bf16 ``decode_attention`` (B7) over int8
rows: the window body of B1/B3/B6/B7 with the codes turned into bf16 in
shared memory, ``k_scale`` in the score scale and ``v_scale`` on the
output, and B7's split of the key axis (``decode_attention.bf16_split``).
At unit scales it equals B7 on ``codes.to(bfloat16)`` bit for bit.  With a
float32 q it dequantizes on the tile load of B7's float32 kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .decode_attention import HEAD_DIMS, MAX_GROUP, bf16_split
from .ref import decode_attention_quantized_ref as decode_attention_q8_plain

__all__ = ["decode_attention_q8_cuda", "decode_attention_q8_plain", "launches"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made through ``decode_attention_q8_cuda``
launches = 0

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("decode_attention").decode_attention_q8_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_attention_q8_cuda: {msg}")


def decode_attention_q8_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, D) float32 or bfloat16; caches (B, S, KV, D) int8; scales
    (B, KV) float32; lengths (B,) int32 -> (B, H, D) in q's dtype.  A row
    with lengths <= 0 returns 0.  Launches the CUDA kernel on the current
    stream; raises on anything the kernel does not take."""
    global launches
    tensors = (q, k_cache, v_cache, k_scale, v_scale, lengths)
    _check(all(t.is_cuda for t in tensors), "all tensors must be on a CUDA device")
    _check(len({t.device for t in tensors}) == 1, "tensors on different devices")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _check(q.dtype in _DTYPES, f"q must be float32 or bfloat16, got {q.dtype}")
    _check(k_cache.dtype == torch.int8 and v_cache.dtype == torch.int8,
           f"the caches must be int8, got {k_cache.dtype}, {v_cache.dtype}")
    _check(lengths.dtype == torch.int32, "lengths must be int32")
    _check(q.dim() == 3 and k_cache.dim() == 4
           and k_cache.shape == v_cache.shape,
           "q must be (B, H, D) and the caches (B, S, KV, D), of one shape")
    B, H, D = q.shape
    Bk, S, KV, Dk = k_cache.shape
    _check(Bk == B and lengths.shape == (B,),
           f"caches of batch {Bk} and lengths {tuple(lengths.shape)} for q "
           f"of batch {B}")
    _check(all(s.dtype == torch.float32 and s.shape == (B, KV)
               for s in (k_scale, v_scale)),
           f"the scales must be float32 ({B}, {KV}), got {k_scale.dtype} "
           f"{tuple(k_scale.shape)}, {v_scale.dtype} {tuple(v_scale.shape)}")
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
                       k_scale.data_ptr(), v_scale.data_ptr(),
                       lengths.data_ptr(), out.data_ptr(),
                       None if part is None else part.data_ptr(),
                       None if tickets is None else tickets.data_ptr(),
                       B, H, KV, D, S, n_split, split_keys, _DTYPES[q.dtype],
                       1.0 / math.sqrt(D), stream)
    build.check(err, "decode_attention_q8")
    launches += 1
    return out
