"""Paged window attention: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/paged_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.paged_attention.paged_attention_pallas``: GQA attention of
a T-token query window through a page table, row t attending logical
positions ``[0, lengths_b + t)`` (with ``window`` > 0, a sliding-window
layer's, only the last ``window`` of them), unmapped (-1) slots skipped.  It
runs on
every prefill, draft step and verification window of the paged serving
path.  ``paged_attention_plain`` is the same function in plain PyTorch
(``ref.paged_attention_ref``); ``ops.paged_attention`` picks between the
two by the device of the tensors.

At bfloat16 the kernel splits the page-table slots across blocks:
``split_plan`` picks the row tile and the number of splits from shapes
alone (never from ``lengths``, which would cost a host sync), and the
last block of each tile to finish merges the splits' partials in the same
launch, through a scratch buffer this module keeps per device.  The tree
kernels (``paged_tree_attention``, ``tree_attention``) and bf16
``decode_attention`` run the same kernel body and split their key axis by
``window_split_plan``, in whole 64-key chunks; they share this module's
scratch and SM count.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import paged_attention_ref as paged_attention_plain

__all__ = ["paged_attention_cuda", "paged_attention_plain", "launches",
           "scratch_buffers", "scratch_for", "sm_count", "split_plan",
           "split_ranges", "window_slots", "window_split_plan",
           "window_split_ranges"]

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_PAGE_SIZE = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the bf16 kernel's split of the slot axis (``split_plan``): a grid of fewer
# than SPLIT_BELOW blocks per SM is split to ~BLOCKS_PER_SM blocks per SM,
# each split at least MIN_SPLIT_KEYS keys of the table (one chunk of the
# kernel's walk, CHUNK_KEYS logical key positions: ``KC`` in
# ``csrc/window_attention_bf16.cuh``).  On the H100 a grid that already
# fills the SMs (the verify window, 256 blocks) only lost to a split: the
# walk is bound by the bytes it reads, and a split adds partial writes and
# a merge (``tools/paged_split_sweep.py``).
BLOCKS_PER_SM = 2
SPLIT_BELOW = 1.0
CHUNK_KEYS = 64
MIN_SPLIT_KEYS = CHUNK_KEYS

# kernel launches made through ``paged_attention_cuda``
launches = 0

_fn = None
_sm_counts: dict[int, int] = {}
# per device index: (float32 partials, int32 tickets), grown as needed; the
# kernel leaves every ticket at 0.  One stream uses them at a time.
_scratch: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def split_plan(B: int, KV: int, rows: int, n_slots: int, ps: int,
               n_sm: int) -> tuple[int, int, int, int]:
    """``(row_tile, row_tiles, n_split, split_slots)`` of the bf16 kernel
    for ``rows`` = T * G query rows per kv head: 16-row tiles when they fit
    (draft and verify windows), else 64; then, if the grid has fewer than
    ``SPLIT_BELOW`` blocks per SM, enough splits of the ``n_slots`` slots
    that it has ~``BLOCKS_PER_SM``, each split at least ``MIN_SPLIT_KEYS``
    keys of the table.  Split s holds slots
    ``[s * split_slots, min((s + 1) * split_slots, n_slots))``
    (``split_ranges``): every slot once, and no split without a slot."""
    row_tile = 16 if rows <= 16 else 64
    row_tiles = -(-rows // row_tile)
    blocks = B * KV * row_tiles
    want = 1
    if blocks < SPLIT_BELOW * n_sm:
        want = -(-BLOCKS_PER_SM * n_sm // blocks)
    n = max(1, min(want, n_slots * ps // MIN_SPLIT_KEYS, n_slots))
    split_slots = max(1, -(-n_slots // n))
    n_split = max(1, -(-n_slots // split_slots))
    return row_tile, row_tiles, n_split, split_slots


def window_slots(n_slots: int, ps: int, window: int, T: int,
                 row_tile: int) -> int:
    """The slots a tile of a sliding-window call can see, counted from the
    slot of its first row's lowest key: its keys run from that key to the
    last row's horizon, ``window`` plus at most ``min(T, row_tile) - 1``
    positions, which span at most one slot more than they fill.  The whole
    table (``n_slots``) without a window."""
    if window <= 0:
        return n_slots
    span = window + min(T, row_tile) - 1
    return min(n_slots, -(-span // ps) + 1)


def split_ranges(n_slots: int, n_split: int,
                 split_slots: int) -> list[tuple[int, int]]:
    """The slot range ``[first, end)`` of each split, as the kernel walks it
    (before clipping to the tile's horizon)."""
    return [(s * split_slots, min(s * split_slots + split_slots, n_slots))
            for s in range(n_split)]


def window_split_plan(B: int, KV: int, rows: int, n_keys: int,
                      n_sm: int) -> tuple[int, int, int, int]:
    """``(row_tile, row_tiles, n_split, split_keys)`` of the bf16 tree
    kernels for ``rows`` = T * G query rows per kv head over ``n_keys`` key
    positions (``n_slots * ps`` through a page table, ``S`` in a contiguous
    cache): the row tile of ``split_plan``; then, if the grid has fewer than
    ``SPLIT_BELOW`` blocks per SM, enough splits that it has
    ~``BLOCKS_PER_SM``, each a run of whole ``CHUNK_KEYS``-key chunks.
    Split s holds keys ``[s * split_keys, min((s + 1) * split_keys,
    n_keys))`` (``window_split_ranges``): every key once, no split without
    a key, and the same cuts for any two layouts of the same ``n_keys``."""
    row_tile = 16 if rows <= 16 else 64
    row_tiles = -(-rows // row_tile)
    blocks = B * KV * row_tiles
    n_chunks = -(-n_keys // CHUNK_KEYS)
    want = 1
    if blocks < SPLIT_BELOW * n_sm:
        want = -(-BLOCKS_PER_SM * n_sm // blocks)
    n = max(1, min(want, n_chunks))
    split_chunks = -(-n_chunks // n)
    n_split = max(1, -(-n_chunks // split_chunks))
    return row_tile, row_tiles, n_split, split_chunks * CHUNK_KEYS


def window_split_ranges(n_keys: int, n_split: int,
                        split_keys: int) -> list[tuple[int, int]]:
    """The key range ``[first, end)`` of each split, as the tree kernels
    walk it (before clipping to the tile's horizon)."""
    return [(s * split_keys, min(s * split_keys + split_keys, n_keys))
            for s in range(n_split)]


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device, read once and cached."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        props = torch.cuda.get_device_properties(idx)
        _sm_counts[idx] = props.multi_processor_count
    return _sm_counts[idx]


def scratch_for(device: torch.device, n_floats: int,
                n_tickets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-device split scratch of the bf16 window kernels (B1, B3, B6,
    B7, B9), of ``fused_verify_sample`` (B2) and of the samplers (B4, B5):
    at least ``n_floats`` float32 partials and ``n_tickets`` int32 tickets,
    grown as needed.  Every launch leaves its tickets at 0, and launches on
    one stream use the buffers in turn."""
    part, tickets = _scratch.get(device.index, (None, None))
    if part is None or part.numel() < n_floats:
        part = torch.empty(n_floats, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    _scratch[device.index] = (part, tickets)
    return part, tickets


def scratch_buffers() -> tuple[torch.Tensor, ...]:
    """Every split scratch tensor in use now.  A CUDA graph captured with
    them holds a reference: ``scratch_for`` replaces a buffer it grows,
    which would free the memory the graph's launches write."""
    return tuple(t for pair in _scratch.values() for t in pair)


def _entry():
    global _fn
    if _fn is None:
        fn = build.library("paged_attention").paged_attention_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor, window: int = 0) -> torch.Tensor:
    """q (B, T, H, D); pools (P, ps, KV, D); page_table (B, n_slots) int32;
    lengths (B,) int32 -> (B, T, H, D).  ``window`` > 0: row t sees only
    keys ``[lengths_b + t - window, lengths_b + t)``, and at bfloat16 the
    split plan covers the ``window_slots`` from each tile's lowest key.
    Launches the CUDA kernel on the current stream; raises on anything the
    kernel does not take."""
    window = int(window)
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
    _check(window >= 0, f"window {window} must be >= 0 (0: none)")
    _check(q.dtype == torch.float32
           or all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool)),
           "bfloat16 q and pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    n_slots = page_table.shape[1]
    row_tile, n_split, split_slots = 0, 1, 1
    part = tickets = None
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            rows = T * (H // KV)
            seen = window_slots(n_slots, ps, window, T,
                                16 if rows <= 16 else 64)
            row_tile, row_tiles, n_split, split_slots = split_plan(
                B, KV, rows, seen, ps, sm_count(q.device))
            if n_split > 1:
                n_part = B * KV * row_tiles * n_split * row_tile
                part, tickets = scratch_for(q.device, n_part * (D + 2),
                                            B * KV * row_tiles)
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                       page_table.data_ptr(), lengths.data_ptr(),
                       out.data_ptr(),
                       None if part is None else part.data_ptr(),
                       None if tickets is None else tickets.data_ptr(),
                       B, T, H, KV, D, ps, n_slots, row_tile, n_split,
                       split_slots, window, _DTYPES[q.dtype],
                       1.0 / math.sqrt(D), stream)
    build.check(err, "paged_attention")
    launches += 1
    return out
