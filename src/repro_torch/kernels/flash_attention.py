"""Causal GQA attention of a query block over its keys (the prefill): the
CUDA kernel's wrapper and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``: q (B, Sq, H, D)
against k, v (B, Skv, KV, D), query i attending keys
``j <= i + (Skv - Sq)`` with ``causal`` (else all of them).  It runs on the
contiguous prefill at offset 0 of the dense models and of the hybrid's
shared attention block, over the window's own keys.
``flash_attention_plain`` is the same function in plain PyTorch
(``ref.flash_attention_ref``); ``ops.flash_attention`` picks between the
two by the device of the tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import flash_attention_ref as flash_attention_plain

__all__ = ["flash_attention_cuda", "flash_attention_plain", "launches"]

HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made through ``flash_attention_cuda``
launches = 0

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("flash_attention").flash_attention_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, KV, D) -> (B, Sq, H, D); with
    ``causal`` Sq <= Skv.  Launches the CUDA kernel on the current stream;
    raises on anything the kernel does not take."""
    global launches
    tensors = (q, k, v)
    _check(all(t.is_cuda for t in tensors), "all tensors must be on a CUDA device")
    _check(len({t.device for t in tensors}) == 1, "tensors on different devices")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _check(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"q/k/v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, "
           f"{v.dtype}")
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
           "q must be (B, Sq, H, D) and k, v (B, Skv, KV, D)")
    B, Sq, H, D = q.shape
    Bk, Skv, KV, Dk = k.shape
    _check(Bk == B, f"k/v batch {Bk} != q batch {B}")
    _check(Dk == D and D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    _check(H % KV == 0, f"{H} query heads not a multiple of {KV} kv heads")
    _check(not causal or Sq <= Skv,
           f"causal attention of {Sq} queries over {Skv} keys: the first "
           f"{Sq - Skv} rows would see no key")
    _check(all(t.data_ptr() % 16 == 0 for t in tensors),
           "q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), B, Sq, Skv, H, KV, D, int(causal),
                       _DTYPES[q.dtype], 1.0 / math.sqrt(D), stream)
    build.check(err, "flash_attention")
    launches += 1
    return out
