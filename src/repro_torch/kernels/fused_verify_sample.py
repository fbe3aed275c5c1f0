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

The kernel cuts each batch row's vocabulary into ``C`` chunks
(``vocab_split_plan``, from the shapes and the SM count alone), one block a
(chunk, row), phases joined by barriers of each row's blocks under a
cooperative launch;
``C = 1`` (an ordinary launch, one block a row) once B alone fills the SMs.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .paged_attention import scratch_for, sm_count
from .ref import fused_verify_sample_ref as fused_verify_sample_plain

__all__ = ["fused_verify_sample_cuda", "fused_verify_sample_plain", "launches",
           "row_split_plan", "vocab_split_plan"]

MAX_L = 64
# the sorted sparse row (8 bytes an entry) shares the 48 KB of shared memory
# a launch gets with the kernel's static arrays (852 bytes; 1 KB kept)
MAX_VHAT = (48 * 1024 - 1024) // 8
# fewest vocab entries a chunk of the split holds (unless V itself is fewer)
MIN_CHUNK = 64

# kernel launches made through ``fused_verify_sample_cuda``
launches = 0

_fn = None
_blocks_fn = None
_resident: dict[tuple[int, int], int] = {}


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("fused_verify_sample").fused_verify_sample_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 6)
        _fn = fn
    return _fn


def vocab_split_plan(B: int, V: int, n_sm: int,
                     resident: int) -> tuple[int, int]:
    """``(C, chunk)``: each batch row's V entries cut into C chunks of
    ``chunk`` (the last one shorter), chunk k holding ``[k * chunk, min((k
    + 1) * chunk, V))``, from the shapes alone.  C is the most chunks that
    keep B * C within the SMs (one wave) and within ``resident``, the blocks
    the card holds at once (the cooperative launch's limit), with at least
    ``MIN_CHUNK`` entries a chunk; so C = 1 once B alone fills the SMs.
    Every entry lies in exactly one chunk, and none is empty."""
    want = max(1, min(n_sm, resident) // max(B, 1))
    n = max(1, min(want, V // MIN_CHUNK))
    chunk = -(-V // n)
    return -(-V // chunk), chunk


def vocab_split_ranges(V: int, C: int, chunk: int) -> list[tuple[int, int]]:
    """The vocab range ``[first, end)`` of each chunk, as the kernel walks
    it."""
    return [(k * chunk, min(k * chunk + chunk, V)) for k in range(C)]


# blocks a SM the split of the two sampler kernels (gather_softmax_prob,
# residual_sample) aims at: where the attention splits gained
ROW_BLOCKS_PER_SM = 2
# fewest vocab entries a sampler chunk holds (unless V itself is fewer):
# one entry a thread of their 256-thread blocks
ROW_MIN_CHUNK = 256


def row_split_plan(N: int, V: int, n_sm: int) -> tuple[int, int]:
    """``(C, chunk)`` of ``gather_softmax_prob`` and ``residual_sample``:
    each of the N rows' V entries cut into C chunks of ``chunk`` (a multiple
    of 4, so a 16-byte-aligned row stays aligned at every chunk edge; the
    last chunk shorter), walked as ``vocab_split_ranges`` gives them, from
    the shapes alone.  N * C is about ``ROW_BLOCKS_PER_SM`` blocks a SM, one
    wave, with at least ``ROW_MIN_CHUNK`` entries a chunk; so C = 1 once the
    N rows outnumber the SMs (at 2 blocks a SM).  No block waits for
    another (the last of a row to finish merges), so no resident-block cap
    applies.  Every entry lies in exactly one chunk, and none is empty."""
    want = max(1, ROW_BLOCKS_PER_SM * n_sm // max(N, 1))
    n = max(1, min(want, V // ROW_MIN_CHUNK))
    chunk = -(-V // n)
    chunk = -(-chunk // 4) * 4
    return -(-V // chunk), chunk


def resident_blocks(device: torch.device, vhat: int) -> int:
    """Blocks of the kernel the device holds at once with ``vhat`` sparse
    entries a row (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` times
    the SMs), read once per (device, vhat)."""
    global _blocks_fn
    key = (device.index, vhat)
    if key not in _resident:
        if _blocks_fn is None:
            fn = build.library("fused_verify_sample").fused_verify_sample_blocks_per_sm
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
            _blocks_fn = fn
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            build.check(_blocks_fn(vhat, ctypes.byref(per_sm)),
                        "fused_verify_sample occupancy")
        _resident[key] = per_sm.value * sm_count(device)
    return _resident[key]


def split_plan(target_logits: torch.Tensor, q_idx: torch.Tensor) -> tuple[int, int]:
    """``vocab_split_plan`` of a call on the card."""
    B, _, V = target_logits.shape
    dev = target_logits.device
    return vocab_split_plan(B, V, sm_count(dev),
                            resident_blocks(dev, q_idx.shape[-1]))


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
        C, chunk = split_plan(target_logits, q_idx)
        scratch, tickets = scratch_for(dev, B * (L * (2 * C + 1) + 3 * C), B)
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(target_logits.data_ptr(), B, Lp1, V,
                       draft_tokens.data_ptr(), draft_probs.data_ptr(),
                       q_idx.data_ptr(), q_val.data_ptr(), vhat,
                       u_accept.data_ptr(), u_resid.data_ptr(),
                       draft_len.data_ptr(), L, C, chunk, scratch.data_ptr(),
                       tickets.data_ptr(), accept.data_ptr(), n_acc.data_ptr(),
                       calibrated.data_ptr(), stream)
    build.check(err, "fused_verify_sample")
    launches += 1
    return accept, n_acc, calibrated
