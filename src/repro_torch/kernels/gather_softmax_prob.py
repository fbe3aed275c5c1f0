"""Fused softmax + token gather: the CUDA kernel's wrapper and its plain
version.

The kernel (``csrc/gather_softmax_prob.cu``) replaces the Pallas TPU kernel
``repro.kernels.gather_softmax_prob.gather_softmax_prob_pallas``:
``softmax(logits[n])[ids[n]]`` per row in one pass over the vocabulary,
without writing the (N, V) softmax.  It runs once per tree round on every
tree node (``verify_tree``) and in the dense branch of ``verify_drafts``.
``gather_softmax_prob_plain`` is the same function in plain PyTorch
(``ref.gather_softmax_prob_ref``); ``ops.gather_softmax_prob`` picks between
the two by the device of the tensors.

The kernel cuts each row's vocabulary into ``C`` chunks
(``fused_verify_sample.row_split_plan``, from the shapes and the SM count
alone), one block a (row, chunk); the last block of a row to finish merges
the chunks' partials (a ticket per row in ``scratch_for``'s buffers) in the
same ordinary launch.  ``C = 1`` (one block a row, no scratch) once the rows
outnumber the SMs.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .fused_verify_sample import row_split_plan
from .paged_attention import scratch_for, sm_count
from .ref import gather_softmax_prob_ref as gather_softmax_prob_plain

__all__ = ["gather_softmax_prob_cuda", "gather_softmax_prob_plain", "launches"]

# kernel launches made through ``gather_softmax_prob_cuda``
launches = 0

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("gather_softmax_prob").gather_softmax_prob_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        _fn = fn
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"gather_softmax_prob_cuda: {msg}")


def gather_softmax_prob_cuda(logits: torch.Tensor,
                             token_ids: torch.Tensor) -> torch.Tensor:
    """logits (N, V) float32; token_ids (N,) int32 -> (N,) float32.
    Launches the CUDA kernel on the current stream; raises on anything the
    kernel does not take."""
    global launches
    _check(logits.is_cuda and token_ids.is_cuda,
           "all tensors must be on a CUDA device")
    _check(logits.device == token_ids.device, "tensors on different devices")
    _check(logits.is_contiguous() and token_ids.is_contiguous(),
           "tensors must be contiguous")
    _check(logits.dtype == torch.float32, f"logits must be float32, got {logits.dtype}")
    _check(token_ids.dtype == torch.int32, "token_ids must be int32")
    _check(logits.dim() == 2 and token_ids.shape == logits.shape[:1],
           "logits (N, V), token_ids (N,)")
    N, V = logits.shape
    out = torch.empty((N,), dtype=torch.float32, device=logits.device)
    if N == 0:
        return out
    _check(V >= 1, "empty vocabulary")
    dev = logits.device
    with torch.cuda.device(dev):
        C, chunk = row_split_plan(N, V, sm_count(dev))
        part = tickets = None
        if C > 1:
            part, tickets = scratch_for(dev, 2 * N * C, N)
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(logits.data_ptr(), token_ids.data_ptr(), out.data_ptr(),
                       N, V, C, chunk, None if part is None else part.data_ptr(),
                       None if tickets is None else tickets.data_ptr(), stream)
    build.check(err, "gather_softmax_prob")
    launches += 1
    return out
