"""Cache utilities for the serving runtime (torch port).

  * snapshot selection — SSM-state rollback after speculative verification
  * byte accounting — admission control / placement decisions
  * ``PagedKVCache`` — page allocator + per-stream page tables for serving a
    *changing* stream population out of one preallocated pool

The allocator is host-side python and identical to the JAX package's; the
device-side page-table mirror is a torch int32 tensor flushed by dirty
rows.
"""

from __future__ import annotations

import numpy as np
import torch


def host_to_device(array, device) -> torch.Tensor:
    """Copy a host array to ``device`` without waiting on the device.

    A blocking ``.to("cuda")`` from pageable memory synchronizes the stream
    after the copy, which would add a hidden host sync to every round; the
    copy goes through pinned memory with ``non_blocking=True`` instead (the
    pinned block is held until the copy has run).  On the CPU the array's
    memory is shared, not copied."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def select_snapshots(snapshots: dict, idx: torch.Tensor,
                     batch_axes: dict) -> dict:
    """Per-row snapshot selection, on the device.

    snapshots: cache leaves with a leading step axis T (the stacked caches
    of ``forward_window(..., return_snapshots=True)``).
    idx: (B,) step index to keep for each row (clamped to [0, T-1]).
    batch_axes: leaf key -> batch axis in the UNSTACKED cache layout.

    Returns a cache dict (no leading T) where row b carries the state after
    step idx[b], each leaf a fresh contiguous tensor.
    """
    T = next(iter(snapshots.values())).shape[0]
    idx = idx.long().clamp(0, T - 1)
    rows = torch.arange(idx.shape[0], device=idx.device)
    out = {}
    for key, leaf in snapshots.items():
        ba = batch_axes[key]
        moved = leaf.movedim(ba + 1, 0)                 # (B, T, ...)
        out[key] = moved[rows, idx].movedim(0, ba).contiguous()
    return out


def merge_snapshot_into_cache(cache: dict, selected: dict,
                              keys=("ssm", "conv")) -> dict:
    """Overwrite the recurrent-state leaves of ``cache`` with rolled-back
    versions, keeping attention KV leaves (mask-managed) as they are."""
    out = dict(cache)
    for k in keys:
        if k in selected:
            out[k] = selected[k]
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def cache_bytes(cache) -> int:
    return sum(int(np.prod(x.shape)) * x.element_size() for x in _leaves(cache))


def needs_state_rollback(cfg) -> bool:
    """Whether the family carries recurrent state that speculative rejection
    must roll back (attention KV is rollback-free under position masking)."""
    return cfg.family in ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# Paged KV-cache management
# ---------------------------------------------------------------------------

class PagePoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied from the page pool.

    Admission control is expected to query ``can_allocate`` / ``free_bytes``
    BEFORE committing a stream, so in a well-behaved cell this only fires on
    mid-round growth past the reservation headroom."""


class PagedKVCache:
    """Free-list page allocator with per-stream page tables.

    The model owns the page *pool* (``init_paged_cache``: every attention
    leaf shaped ``(layers, num_pages, page_size, KV, D)``); this manager owns
    the *mapping*: which physical pages back which logical positions of which
    stream.  All allocator state is host-side python; the view handed to
    ``forward_window`` is the ``(B, pages_per_stream)`` int32 page-table
    slice for the rows in the batch, on ``device`` (``-1`` marks unmapped
    slots; model-side writes there are dropped and reads are masked).

    A stream's table may have holes at its front: ``release_below`` returns
    the pages wholly below a position (a sliding-window layer's keys no
    query will see again) and leaves -1 in their slots.
    """

    def __init__(self, num_pages: int, page_size: int,
                 pages_per_stream: int, bytes_per_page: int = 0,
                 device="cuda"):
        if num_pages <= 0 or page_size <= 0 or pages_per_stream <= 0:
            raise ValueError("num_pages, page_size, pages_per_stream must be "
                             "positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.pages_per_stream = int(pages_per_stream)
        self.bytes_per_page = int(bytes_per_page)
        self.device = torch.device(device)
        # LIFO free list: recently-returned (hot) pages are reused first
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._tables: dict[int, list[int]] = {}   # stream -> physical pages
        self._lengths: dict[int, int] = {}        # stream -> valid token count
        self._floor: dict[int, int] = {}          # stream -> leading -1 slots
        # device-side page-table mirror: (rows + 1, pages_per_stream) int32
        # on ``device``, the last row an all--1 sentinel for padding/unknown
        # rows; mutations mark their row dirty and ``device_table`` uploads
        # only the dirty rows
        self._dev: torch.Tensor | None = None
        self._dev_rows = 0                        # row capacity of _dev
        self._dirty: set[int] = set()

    # -- capacity queries ----------------------------------------------------

    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    @property
    def num_allocated_pages(self) -> int:
        return self.num_pages - len(self._free)

    def pages_for(self, length: int) -> int:
        """Pages needed to hold ``length`` tokens (0 tokens -> 0 pages)."""
        return -(-max(int(length), 0) // self.page_size)

    def can_allocate(self, length: int) -> bool:
        """Whether a NEW stream of ``length`` tokens fits right now."""
        need = self.pages_for(length)
        return need <= min(len(self._free), self.pages_per_stream)

    def free_bytes(self) -> int:
        return len(self._free) * self.bytes_per_page

    def used_bytes(self) -> int:
        return self.num_allocated_pages * self.bytes_per_page

    # -- stream lifecycle ----------------------------------------------------

    def alloc_stream(self, stream: int, length: int) -> None:
        """Map a new stream and reserve pages for its first ``length`` tokens."""
        if stream in self._tables:
            raise ValueError(f"stream {stream} already allocated")
        self._tables[stream] = []
        self._lengths[stream] = 0
        self._floor[stream] = 0
        try:
            self.extend(stream, length)
        except PagePoolExhausted:
            self.free_stream(stream)
            raise

    def extend(self, stream: int, new_length: int) -> None:
        """Grow ``stream``'s mapping to cover ``new_length`` tokens."""
        table = self._tables[stream]
        need = self.pages_for(new_length)
        if need > self.pages_per_stream:
            raise PagePoolExhausted(
                f"stream {stream}: {new_length} tokens need {need} pages > "
                f"pages_per_stream={self.pages_per_stream} (max_len)")
        grow = need - len(table)
        if grow > len(self._free):
            raise PagePoolExhausted(
                f"stream {stream}: need {grow} pages, pool has "
                f"{len(self._free)} free of {self.num_pages}")
        for _ in range(max(grow, 0)):
            table.append(self._free.pop())
        if grow > 0:
            self._dirty.add(int(stream))
        self._lengths[stream] = max(self._lengths[stream], int(new_length))

    def truncate(self, stream: int, new_length: int) -> int:
        """Shrink ``stream`` to ``new_length`` tokens, returning whole pages
        past the new tail to the pool.  Returns the number of pages freed."""
        table = self._tables[stream]
        keep = self.pages_for(new_length)
        freed = 0
        while len(table) > keep:
            page = table.pop()
            if page >= 0:
                self._free.append(page)
                freed += 1
        self._floor[stream] = min(self._floor[stream], len(table))
        if freed > 0:
            self._dirty.add(int(stream))
        self._lengths[stream] = int(new_length)
        return freed

    def free_stream(self, stream: int) -> int:
        """Unmap a stream entirely; every page returns to the pool."""
        table = [p for p in self._tables.pop(stream) if p >= 0]
        self._lengths.pop(stream)
        self._floor.pop(stream)
        self._free.extend(reversed(table))
        self._dirty.add(int(stream))
        return len(table)

    def release_below(self, stream: int, position: int) -> int:
        """Return to the pool every page of ``stream`` that lies wholly
        below logical ``position``; their slots become -1.  Returns the
        number of pages freed."""
        table = self._tables[stream]
        floor = self._floor[stream]
        end = min(max(int(position), 0) // self.page_size, len(table))
        for s in range(floor, end):
            self._free.append(table[s])
            table[s] = -1
        if end <= floor:
            return 0
        self._floor[stream] = end
        self._dirty.add(int(stream))
        return end - floor

    def held(self, stream: int) -> int:
        """Pages ``stream`` maps now: its slots past the freed front."""
        return len(self._tables[stream]) - self._floor[stream]

    # -- views ---------------------------------------------------------------

    def streams(self) -> list[int]:
        return sorted(self._tables)

    def length(self, stream: int) -> int:
        return self._lengths[stream]

    def page_table(self, streams) -> np.ndarray:
        """(len(streams), pages_per_stream) int32 physical-page table; -1
        marks unmapped slots.  Unknown streams map to an all--1 row."""
        out = np.full((len(streams), self.pages_per_stream), -1, np.int32)
        for i, s in enumerate(streams):
            pages = self._tables.get(s, ())
            out[i, :len(pages)] = pages
        return out

    def device_table(self, streams) -> torch.Tensor:
        """Device-resident page table for ``streams``, maintained
        incrementally: the rows dirtied since the last flush are uploaded
        in one copy and written into the persistent mirror, then the
        requested rows are gathered on the device.  ``-1`` padding entries
        and rows the mirror has never seen gather the all--1 sentinel row.
        """
        hi = max((int(s) for s in streams if int(s) >= 0), default=-1)
        hi = max(hi, max(self._tables, default=-1))
        need_rows = hi + 1
        if self._dev is None or need_rows > self._dev_rows:
            # (re)build the whole mirror at a doubled row capacity
            cap = max(8, self._dev_rows)
            while cap < need_rows:
                cap *= 2
            full = self.page_table(range(cap + 1))     # row cap: sentinel
            self._dev = host_to_device(full, self.device)
            self._dev_rows = cap
            self._dirty.clear()
        elif self._dirty:
            rows = sorted(r for r in self._dirty if r < self._dev_rows)
            if rows:
                vals = host_to_device(self.page_table(rows), self.device)
                idx = host_to_device(np.asarray(rows, np.int64), self.device)
                self._dev.index_copy_(0, idx, vals)
            self._dirty.clear()
        sel = np.asarray([int(s) if 0 <= int(s) < self._dev_rows
                          else self._dev_rows for s in streams], np.int64)
        return self._dev.index_select(0, host_to_device(sel, self.device))

    def check_invariants(self) -> None:
        """Every page is either free or mapped exactly once (leak/double-free
        detector)."""
        mapped = [p for t in self._tables.values() for p in t if p >= 0]
        seen = set(mapped) | set(self._free)
        assert len(mapped) + len(self._free) == self.num_pages, \
            f"leak: {len(mapped)} mapped + {len(self._free)} free != " \
            f"{self.num_pages}"
        assert len(seen) == self.num_pages, "page mapped twice or lost"


def paged_pool_bytes_per_page(pool) -> int:
    """Bytes one physical page costs across every leaf/layer of a paged pool
    (leaves shaped (layers, num_pages, page_size, ...))."""
    total = 0
    for leaf in _leaves(pool):
        num_pages = leaf.shape[1]
        total += int(np.prod(leaf.shape)) * leaf.element_size() // num_pages
    return total
