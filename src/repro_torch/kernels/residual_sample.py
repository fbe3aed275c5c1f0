"""Residual-distribution inverse-CDF sampler: the CUDA kernel's wrapper and
its plain version.

The kernel (``csrc/residual_sample.cu``) replaces the Pallas TPU kernel
``repro.kernels.residual_sample.residual_sample_pallas``: the calibrated
token of paper eq. 5, drawn from ``normalize(max(p - q, 0))`` by inverse CDF
with the caller's uniform, ``argmax(p)`` (first index on ties) when the
residual is all zero and ``V - 1`` when nothing crosses, as the JAX oracle
does.  It runs once per tree round (``verify_tree``) and in the dense branch
of ``verify_drafts``.  ``residual_sample_plain`` is the same function in
plain PyTorch (``ref.residual_sample_ref``); ``ops.residual_sample`` picks
between the two by the device of the tensors.

The kernel cuts each row's vocabulary into ``C`` chunks
(``fused_verify_sample.row_split_plan``, from the shapes and the SM count
alone), one block a (row, chunk); the last block of a row to finish (a
ticket per row in ``scratch_for``'s buffers) adds the chunks' masses in
chunk order and scans the crossing chunk, in the same ordinary launch.
``C = 1`` (one block a row, no scratch) once the rows outnumber the SMs.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .fused_verify_sample import row_split_plan
from .paged_attention import scratch_for, sm_count
from .ref import residual_sample_ref as residual_sample_plain

__all__ = ["residual_sample_cuda", "residual_sample_plain", "launches"]

# kernel launches made through ``residual_sample_cuda``
launches = 0

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("residual_sample").residual_sample_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        _fn = fn
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"residual_sample_cuda: {msg}")


def residual_sample_cuda(p: torch.Tensor, q: torch.Tensor,
                         u: torch.Tensor) -> torch.Tensor:
    """p, q (N, V) float32; u (N,) float32 -> tokens (N,) int32.  Launches
    the CUDA kernel on the current stream; raises on anything the kernel
    does not take."""
    global launches
    tensors = (p, q, u)
    _check(all(t.is_cuda for t in tensors), "all tensors must be on a CUDA device")
    _check(len({t.device for t in tensors}) == 1, "tensors on different devices")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _check(all(t.dtype == torch.float32 for t in tensors),
           "p, q and u must be float32")
    _check(p.dim() == 2 and q.shape == p.shape and u.shape == p.shape[:1],
           "p, q (N, V), u (N,)")
    N, V = p.shape
    out = torch.empty((N,), dtype=torch.int32, device=p.device)
    if N == 0:
        return out
    _check(V >= 1, "empty vocabulary")
    dev = p.device
    with torch.cuda.device(dev):
        C, chunk = row_split_plan(N, V, sm_count(dev))
        scratch = tickets = None
        if C > 1:
            scratch, tickets = scratch_for(dev, 3 * N * C, N)
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(p.data_ptr(), q.data_ptr(), u.data_ptr(), out.data_ptr(),
                       N, V, C, chunk,
                       None if scratch is None else scratch.data_ptr(),
                       None if tickets is None else tickets.data_ptr(), stream)
    build.check(err, "residual_sample")
    launches += 1
    return out
