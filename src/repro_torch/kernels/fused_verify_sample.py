"""Fused draft verification + calibrated sampling: the CUDA kernel's wrapper
and its plain version.

The kernel (``csrc/fused_verify_sample.cu``) replaces the Pallas TPU kernel
``repro.kernels.fused_verify_sample.fused_verify_sample_pallas``: the
accept test ``u < min(1, p_L/p_S)`` of every drafted token masked to
``draft_len``, the prefix-acceptance count, and the calibrated residual
token at the first rejected position, in one launch, without writing the
dense residual distribution to device memory.  It runs once per J=1
verification round.  ``fused_verify_sample_plain`` is the same function in
plain PyTorch (``ref.fused_verify_sample_ref``); ``ops.fused_verify_sample``
picks between the two by the device of the tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import fused_verify_sample_ref as fused_verify_sample_plain

__all__ = ["fused_verify_sample_cuda", "fused_verify_sample_plain", "launches"]

MAX_L = 64
# the sorted sparse row (8 bytes an entry) shares the 48 KB of shared memory
# a launch gets with the kernel's static arrays (784 bytes; 1 KB kept)
MAX_VHAT = (48 * 1024 - 1024) // 8

# kernel launches made through ``fused_verify_sample_cuda``
launches = 0

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("fused_verify_sample").fused_verify_sample_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4)
        _fn = fn
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_verify_sample_cuda: {msg}")


def fused_verify_sample_cuda(target_logits, draft_tokens, draft_probs, q_idx,
                             q_val, u_accept, u_resid, draft_len):
    """target_logits (B, L+1, V) float32; draft_tokens (B, L) int32;
    draft_probs / u_accept (B, L) float32; q_idx / q_val (B, L, Vhat) int32 /
    float32; u_resid (B,) float32; draft_len (B,) int32.  Returns
    ``(accept (B, L) bool, n_acc (B,) int32, calibrated (B,) int32)``.
    Launches the CUDA kernel on the current stream; raises on anything the
    kernel does not take."""
    global launches
    tensors = (target_logits, draft_tokens, draft_probs, q_idx, q_val,
               u_accept, u_resid, draft_len)
    _check(all(t.is_cuda for t in tensors), "all tensors must be on a CUDA device")
    _check(len({t.device for t in tensors}) == 1, "tensors on different devices")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _check(target_logits.dtype == torch.float32 and draft_probs.dtype == torch.float32
           and q_val.dtype == torch.float32 and u_accept.dtype == torch.float32
           and u_resid.dtype == torch.float32,
           "logits, probabilities and uniforms must be float32")
    _check(draft_tokens.dtype == torch.int32 and q_idx.dtype == torch.int32
           and draft_len.dtype == torch.int32, "token ids and lengths must be int32")
    _check(target_logits.dim() == 3 and draft_tokens.dim() == 2,
           "target_logits (B, L+1, V), draft_tokens (B, L)")
    B, Lp1, V = target_logits.shape
    L = draft_tokens.shape[1]
    vhat = q_idx.shape[-1]
    _check(draft_tokens.shape[0] == B and 1 <= L <= MAX_L and Lp1 >= L,
           f"window of {L} drafted tokens (max {MAX_L}) over {Lp1} logit rows")
    _check(draft_probs.shape == (B, L) and u_accept.shape == (B, L)
           and u_resid.shape == (B,) and draft_len.shape == (B,),
           "p_S / u_accept (B, L), u_resid / draft_len (B,)")
    _check(q_idx.shape == (B, L, vhat) and q_val.shape == (B, L, vhat)
           and 1 <= vhat <= MAX_VHAT, f"sparse rows (B, L, Vhat <= {MAX_VHAT})")
    dev = target_logits.device
    accept = torch.empty((B, L), dtype=torch.bool, device=dev)
    n_acc = torch.empty((B,), dtype=torch.int32, device=dev)
    calibrated = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return accept, n_acc, calibrated
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(target_logits.data_ptr(), B, Lp1, V,
                       draft_tokens.data_ptr(), draft_probs.data_ptr(),
                       q_idx.data_ptr(), q_val.data_ptr(), vhat,
                       u_accept.data_ptr(), u_resid.data_ptr(),
                       draft_len.data_ptr(), L, accept.data_ptr(),
                       n_acc.data_ptr(), calibrated.data_ptr(), stream)
    build.check(err, "fused_verify_sample")
    launches += 1
    return accept, n_acc, calibrated
