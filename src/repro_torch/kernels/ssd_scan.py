"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``repro.kernels.ssd_scan.ssd_scan_pallas``: the chunked state-space-duality
scan of every Mamba-2 layer's full-sequence forward (the prefill of SSM and
hybrid models), returning y and the final recurrent state.
``ssd_scan_plain`` is the same function in plain PyTorch
(``ref.ssd_scan_ref``); ``ops.ssd_scan`` pads the sequence to a chunk
multiple and picks between the two by the device of the tensors.

At bfloat16 the kernel runs its chunk products on the tensor cores, one
block per (b, h, slice of the head dim p): ``split_plan`` picks the slice
from the shapes alone, cutting p only when the grid would have fewer blocks
than SMs.  It takes p a multiple of 16, a state width n in ``TC_STATES``
and chunks of at most ``TC_MAX_CHUNK`` steps, which every config has.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .paged_attention import sm_count
from .ref import ssd_scan_ref as ssd_scan_plain

__all__ = ["ssd_scan_cuda", "ssd_scan_plain", "launches", "split_plan"]

MAX_SMEM_BYTES = 232_448     # dynamic shared memory a block may use (H100)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 tensor-core kernel's widths: P-slices of a block, state widths,
# the longest chunk a stage holds (``csrc/ssd_scan.cu``)
P_BLOCKS = (64, 32, 16)
TC_STATES = (16, 32, 64, 128)
TC_MAX_CHUNK = 64

# kernel launches made through ``ssd_scan_cuda``
launches = 0

_fns = None


def _entries():
    global _fns
    if _fns is None:
        lib = build.library("ssd_scan")
        fn = lib.ssd_scan_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        smem = lib.ssd_scan_smem_bytes
        smem.restype = ctypes.c_longlong
        smem.argtypes = [ctypes.c_int] * 3
        _fns = fn, smem
    return _fns


def split_plan(b: int, h: int, p: int, n_sm: int) -> tuple[int, int]:
    """``(p_block, n_slices)`` of the bf16 kernel: the widest of
    ``P_BLOCKS`` that divides ``p`` (a multiple of 16), halved while the
    grid of ``b * h * n_slices`` blocks has fewer blocks than SMs and the
    slice is wider than 16.  Slice s holds head-dim columns
    ``[s * p_block, (s + 1) * p_block)``: each column once."""
    p_block = next(c for c in P_BLOCKS if p % c == 0)
    while p_block > P_BLOCKS[-1] and b * h * (p // p_block) < n_sm:
        p_block //= 2
    return p_block, p // p_block


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_scan_cuda: {msg}")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int = 64,
                  initial_state: torch.Tensor | None = None):
    """x (b, s, h, p); dt (b, s, h) float32; A (h,) float32; B, C
    (b, s, g, n) of x's dtype; initial_state (b, h, p, n) float32 or None;
    s a multiple of ``chunk`` -> (y (b, s, h, p) of x's dtype, final state
    (b, h, p, n) float32).  Launches the CUDA kernel on the current stream;
    raises on anything the kernel does not take."""
    global launches
    tensors = [x, dt, A, B, C] + ([] if initial_state is None
                                  else [initial_state])
    _check(all(t.is_cuda for t in tensors), "all tensors must be on a CUDA device")
    _check(len({t.device for t in tensors}) == 1, "tensors on different devices")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _check(x.dtype in _DTYPES and B.dtype == x.dtype and C.dtype == x.dtype,
           f"x, B and C must share float32 or bfloat16, got {x.dtype}, "
           f"{B.dtype}, {C.dtype}")
    _check(dt.dtype == torch.float32 and A.dtype == torch.float32,
           "dt and A must be float32")
    _check(x.dim() == 4 and B.dim() == 4 and B.shape == C.shape,
           "x must be (b, s, h, p) and B, C (b, s, g, n)")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    _check(dt.shape == (b, s, h) and A.shape == (h,)
           and B.shape[:2] == (b, s), "dt (b, s, h), A (h,), B/C (b, s, g, n)")
    _check(g >= 1 and h % g == 0, f"{h} heads not a multiple of {g} groups")
    _check(chunk >= 1 and s % chunk == 0,
           f"sequence {s} not a multiple of chunk {chunk} (ops.ssd_scan pads)")
    if initial_state is not None:
        _check(initial_state.dtype == torch.float32
               and initial_state.shape == (b, h, p, n),
               "initial_state must be (b, h, p, n) float32")
    if x.dtype == torch.bfloat16:
        _check(p % 16 == 0 and n in TC_STATES and chunk <= TC_MAX_CHUNK,
               f"bfloat16 takes p a multiple of 16, n in {TC_STATES} and "
               f"chunk <= {TC_MAX_CHUNK}, got p={p}, n={n}, chunk={chunk}")
        _check(all(t.data_ptr() % 16 == 0 for t in (x, B, C))
               and (initial_state is None
                    or initial_state.data_ptr() % 8 == 0),
               "bfloat16 x, B and C must be 16-byte aligned, the initial "
               "state 8-byte aligned")
    fn, smem = _entries()
    p_block = 0
    if x.dtype == torch.float32:
        need = int(smem(p, n, chunk))
        _check(need <= MAX_SMEM_BYTES, f"p={p}, n={n}, chunk={chunk} need "
               f"{need} bytes of shared memory, above the {MAX_SMEM_BYTES} a "
               f"block has")
    y = torch.empty_like(x)
    fs = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, (fs.zero_() if initial_state is None
                   else fs.copy_(initial_state))
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            p_block, _ = split_plan(b, h, p, sm_count(x.device))
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(),
                 None if initial_state is None else initial_state.data_ptr(),
                 y.data_ptr(), fs.data_ptr(), b, s, h, p, g, n, chunk,
                 p_block, _DTYPES[x.dtype], stream)
    build.check(err, "ssd_scan")
    launches += 1
    return y, fs
