"""Speculative decoding engine: SLM drafting + LLM batched verification on
real model weights (the compute core of Multi-SPIN, paper Fig. 1).

One ``SpecEngine`` drives B concurrent streams (one per edge device).  Each
J=1 round (paper Fig. 2):

  2. drafting       — ``generate_drafts`` on the draft model (per-stream
                       heterogeneous lengths, zero-padded to the window)
  4. verification   — ONE ``forward_window`` of the target model over
                       [pending, d_1 .. d_L] followed by the exact accept
                       test and residual/bonus token (``verify_drafts``)
  5. state update   — an on-device commit, one host fetch, and the pages of
                       rejected tokens handed back to the pool

Two cache layouts, as in the JAX package:

  * ``cache_kind="contiguous"`` (the default) — (B, max_len) slabs fixed at
    ``start()``; the stream population can never change.  SSM (``mamba2``)
    and hybrid (``zamba2``) targets run here only, their recurrent state
    rolled back per row to the accepted position after verification.
  * ``cache_kind="paged"`` — both models' KV lives in fixed-size pages of a
    preallocated pool (``PagedKVCache``): streams may join after
    ``start()`` (``add_streams``) and leave (``retire_stream``), and
    admission is bounded by the page pool (``can_admit``).  A target with
    sliding-window layers (``models/layer_pattern.py``) keeps their K/V in
    a third pool, ``w_pages``, sized to the window: each live row holds the
    pages its window can still read, the rest go back after every commit
    and admission.

``draft_width`` J > 1 runs the multi-draft TOKEN-TREE round instead
(``_spin_round_tree``): J drafts per stream packed into a
prefix-deduplicated tree, scored in ONE ancestor-masked target pass, the
longest accepted root-to-leaf path committed.  Randomness is an input: each
round consumes one ``core.draws.RoundDraws`` (J=1) or ``TreeDraws``.

The J=1 round is three steps, ``draft_rows`` / ``verify_rows`` /
``commit_rows``, which also run on row subsets of a paged engine (``-1``
padding rows included): the core of continuous batching
(``serving/continuous.py``).

``compile_mode`` (``serving/compiled.py``): the J=1 round's draft, verify
and commit steps are one body each in every mode.  ``"eager"`` (the
default, or ``REPRO_COMPILE``) runs them op by op; ``"jit"`` and
``"jit+donate"`` as CUDA graphs captured once per (step, n, L) bucket and
replayed, ``warmup`` capturing them ahead of serving (on the CPU the same
step functions run as they are).  Tree rounds stay eager in every mode,
and SSM/hybrid models refuse the compiled modes, as in the reference.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.draws import RoundDraws, TreeDraws
from repro_torch.core.drafting import (
    DraftResult,
    generate_draft_forest,
)
from repro_torch.core.token_tree import TreeScratch, build_token_tree
from repro_torch.core.verification import (
    VerifyResult,
    verify_drafts,
    verify_tree,
)
from repro_torch.models import build_model
from repro_torch.models.layer_pattern import is_windowed
from repro_torch.models.layers import gather_kv_window, scatter_kv_window
from repro_torch.models.transformer import strip_view
from repro_torch.obs import trace

from .compiled import (
    COMPILE_MODES,
    STEPS,
    build_round_steps,
    setup_compilation_cache,
)
from .kv_cache import (
    PagedKVCache,
    PagePoolExhausted,
    cache_bytes,
    host_to_device,
    merge_snapshot_into_cache,
    needs_state_rollback,
    paged_pool_bytes_per_page,
    select_snapshots,
)

CACHE_KINDS = ("contiguous", "paged")

# what ``_host_fetch`` packs into 32-bit words: float32 by bit view, integers
# by value (the int64 ones are token ids, counts and positions, below 2**31)
_FETCH_DTYPES = (torch.float32, torch.int64, torch.int32, torch.int16,
                 torch.int8, torch.uint8, torch.bool)


def _span(name: str, args: dict | None = None):
    """Engine-phase span (``cat="engine"``): the round's phases and the
    parts of an admission."""
    if trace.active() is None:
        return trace.NULL_SPAN
    return trace.span(name, cat="engine", args=args)


@dataclasses.dataclass
class StreamState:
    """Per-batch serving state (B streams)."""

    pending: torch.Tensor     # (B,) last committed token, not yet in caches
    target_pos: torch.Tensor  # (B,) target-cache fill level
    draft_pos: torch.Tensor   # (B,) draft-cache fill level
    committed: list           # python-side committed token lists (B)


@dataclasses.dataclass
class RoundTicket:
    """In-flight round work for a row subset, between dispatch and commit.

    Produced by ``draft_rows``, completed by ``verify_rows``, consumed by
    ``commit_rows``.  Everything on it is host metadata or a tensor whose
    producing launches were only enqueued: holding a ticket never waits on
    the device, so a continuous-batching engine can dispatch the next
    round's drafting while this ticket's verification is still running.

    ``rows`` may contain ``-1`` padding entries (batch-shape bucketing):
    their page-table rows are all ``-1`` — cache writes dropped, reads
    masked — and ``commit_rows`` skips them unconditionally.
    """

    rows: list | None             # engine rows; None = the full batch
    lengths: np.ndarray           # per-row planned draft lengths
    L: int                        # the dispatched window length (max/bucket)
    freeze: np.ndarray            # per-row do-not-advance mask
    pending: torch.Tensor         # (n,) pending tokens at dispatch
    target_pos: torch.Tensor      # (n,) target positions at dispatch
    draft: object | None = None   # DraftResult from generate_drafts
    res: object | None = None     # VerifyResult from verify_drafts


class SpecEngine:
    """Speculative-decoding engine for B device streams: a small draft
    model proposes tokens, a large target model batch-verifies them, and
    both models' KV caches advance only over committed tokens.

    ``spin_round`` is one protocol round; ``draft_rows`` / ``verify_rows``
    / ``commit_rows`` are the same J=1 round in its three pieces, on the
    full batch or (paged) on any row subset.  Tensors
    live on ``device`` (the card unless the caller asks for the CPU);
    attention, the SSD scan and verification dispatch through
    ``kernels.ops``.

    ``cache_kind``: ``"contiguous"`` (default) fixes the batch at
    ``start()``; ``"paged"`` serves churn from a pooled ``PagedKVCache``
    (streams join after start, retire, recycle rows).

    ``tree_commit``: how the accepted branch of a tree round reaches the
    caches.  ``"scatter"`` (default) gathers the winning branch's K/V from
    the already-written tree window (target) and the winning run's window
    snapshot (draft) and scatters it to the committed positions — no extra
    forward pass; ``"repair"`` re-forwards [pending, accepted path] through
    both models.  Both commit identical tokens.

    ``compile_mode``: ``"eager"`` (default: ``REPRO_COMPILE``, else eager),
    ``"jit"`` or ``"jit+donate"`` — the J=1 round's steps as CUDA graphs
    (``serving/compiled.py``); ``compile_cache`` the kernel build directory
    that outlives the process (``setup_compilation_cache``)."""

    def __init__(self, target_cfg: ModelConfig, draft_cfg: ModelConfig,
                 max_len: int = 512, cache_dtype=torch.float32,
                 cache_kind: str = "contiguous", page_size: int = 16,
                 num_pages: int | None = None, tree_commit: str = "scatter",
                 compile_mode: str | None = None,
                 compile_cache: str | None = None, device="cuda"):
        assert target_cfg.vocab_size == draft_cfg.vocab_size, \
            "SLM/LLM pair must share a vocabulary"
        if tree_commit not in ("scatter", "repair"):
            raise ValueError("tree_commit must be 'scatter' or 'repair'")
        if cache_kind not in CACHE_KINDS:
            raise ValueError(f"cache_kind must be one of {CACHE_KINDS}")
        if cache_kind == "paged" and (needs_state_rollback(target_cfg)
                                      or needs_state_rollback(draft_cfg)):
            raise NotImplementedError(
                "paged caches cover attention KV only; SSM/hybrid recurrent "
                "state is O(1) per stream and needs no paging (ROADMAP)")
        if is_windowed(draft_cfg):
            raise NotImplementedError("a draft with sliding-window layers")
        if is_windowed(target_cfg) and cache_kind != "paged":
            raise NotImplementedError(
                "a target with sliding-window layers serves on paged caches "
                "only: its window pages below the window go back to their "
                "pool, and a contiguous slab holds every position")
        if compile_mode is None:
            compile_mode = os.environ.get("REPRO_COMPILE", "eager")
        if compile_mode not in COMPILE_MODES:
            raise ValueError(f"compile_mode must be one of {COMPILE_MODES}, "
                             f"got {compile_mode!r}")
        if compile_mode != "eager" and (needs_state_rollback(target_cfg)
                                        or needs_state_rollback(draft_cfg)):
            raise NotImplementedError(
                "compiled round steps cover attention models; SSM/hybrid "
                "snapshot rollback re-enters python between the target pass "
                "and the cache merge (ROADMAP open items)")
        self.device = torch.device(device)
        self.target_cfg = target_cfg
        self.draft_cfg = draft_cfg
        self.target = build_model(target_cfg, device=self.device)
        self.draft = build_model(draft_cfg, device=self.device)
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.cache_kind = cache_kind
        self.tree_commit = tree_commit
        self.page_size = int(page_size)
        self.pages_per_stream = -(-max_len // self.page_size)
        self.num_pages = num_pages
        self.t_params = None
        self.d_params = None
        self.t_pages: PagedKVCache | None = None
        self.d_pages: PagedKVCache | None = None
        # a windowed target's window-layer pool: its key window and pages
        self.window = int(getattr(target_cfg, "sliding_window", 0)
                          if is_windowed(target_cfg) else 0)
        self.w_pages: PagedKVCache | None = None
        self.window_pages = 0
        self._free_rows: list[int] = []
        self._retired: set[int] = set()
        # compiled round path (serving/compiled.py): ``step_shapes`` collects
        # every (step, n, L) built — the hook fires once per capture, not
        # per call; ``warmup()`` builds the buckets ahead of serving
        self.compile_mode = compile_mode
        if compile_mode != "eager":
            setup_compilation_cache(compile_cache)
        self.step_shapes: set[tuple] = set()
        self.on_step_trace = None
        self._steps = build_round_steps(self.target, self.draft,
                                        mode=compile_mode,
                                        record=self._record_step)
        # host-transfer accounting: every blocking device->host fetch on the
        # round path funnels through ``_host_fetch`` and bumps this
        self.host_syncs = 0
        # the splice's blocking fetches of every admission (``add_streams``)
        self.admit_syncs = 0
        # host-side accepted counts of the last commit
        self.last_accepted: np.ndarray | None = None
        self._tree_scratch = TreeScratch()

    def _record_step(self, shape: tuple) -> None:
        self.step_shapes.add(shape)
        if self.on_step_trace is not None:
            self.on_step_trace(shape)

    def step_counts(self) -> dict:
        """``{step: {"captures": n, "replays": n}}`` of the compiled round
        steps since the last ``start()`` (zeros in eager mode and on the
        CPU, where no graph is made).  The kernels' own counters tick only
        when a step is captured, so these show that the path ran through
        the graphs."""
        g = self._steps.graphs
        return {s: {"captures": g.captures[s] if g else 0,
                    "replays": g.replays[s] if g else 0} for s in STEPS}

    def _host_fetch(self, *values: torch.Tensor):
        """Blocking device->host fetch, counted.  The ONE per-round call
        site of a J=1 round is the packed commit emission in
        ``commit_rows``; tree rounds add the host-side trie build and
        (repair mode) the accepted-depth fetch.  Several tensors travel as
        one transfer: each is flattened to 32-bit words (float32 by bit
        view, integers by value), the words concatenated and copied once,
        and the arrays rebuilt on the host."""
        self.host_syncs += 1
        trace.incr("engine.host_sync")
        if len(values) == 1:
            return values[0].cpu().numpy()
        for v in values:
            if v.dtype not in _FETCH_DTYPES:
                raise TypeError(f"_host_fetch packs float32 and integer "
                                f"tensors of at most 32 bits, not {v.dtype}")
        words = [v.reshape(-1).view(torch.int32) if v.dtype == torch.float32
                 else v.reshape(-1).to(torch.int32) for v in values]
        flat = torch.cat(words).cpu().numpy()
        out, i = [], 0
        for v in values:
            chunk = flat[i:i + v.numel()]
            i += v.numel()
            if v.dtype == torch.float32:
                chunk = chunk.view(np.float32)
            out.append(chunk.reshape(tuple(v.shape)))
        return tuple(out)

    # ------------------------------------------------------------------

    def init_params(self, seed: int = 0):
        """Random weights for both models from one seeded generator on the
        engine's device (the JAX package splits one PRNG key instead)."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.t_params = self.target.init(gen)
        self.d_params = self.draft.init(gen)
        return self.t_params, self.d_params

    def start(self, prompts) -> StreamState:
        """Prefill both models on the prompts (B, M).  The last prompt token
        becomes the pending token.  Paged engines size the pool when
        ``num_pages`` was not given: 2x the pages the start batch needs at
        max_len."""
        prompts = torch.as_tensor(prompts, device=self.device)
        B, M = prompts.shape
        self._free_rows, self._retired = [], set()
        if self._steps.graphs is not None:
            # a graph replays on the caches it was captured on: the new
            # caches get graphs of their own
            self._steps = build_round_steps(self.target, self.draft,
                                            mode=self.compile_mode,
                                            record=self._record_step)
        if self.cache_kind == "contiguous":
            self.t_cache = self.target.init_cache(B, self.max_len,
                                                  self.cache_dtype)
            self.d_cache = self.draft.init_cache(B, self.max_len,
                                                 self.cache_dtype)
            _, self.t_cache, _ = self.target.prefill(
                self.t_params, prompts[:, :-1], self.t_cache)
            _, self.d_cache, _ = self.draft.prefill(
                self.d_params, prompts[:, :-1], self.d_cache)
            pnp = prompts.cpu().numpy()
            return StreamState(
                pending=prompts[:, -1].contiguous(),
                target_pos=torch.full((B,), M - 1, dtype=torch.int32,
                                      device=self.device),
                draft_pos=torch.full((B,), M - 1, dtype=torch.int32,
                                     device=self.device),
                committed=[list(pnp[b]) for b in range(B)])
        if self.num_pages is None:
            self.num_pages = 2 * B * self.pages_per_stream
        if self.window:
            self.window_pages = self.window_pool_pages()
        self.t_cache = self.target.init_paged_cache(
            self.num_pages, self.page_size, self.cache_dtype,
            window_pages=self.window_pages or None)
        self.d_cache = self.draft.init_paged_cache(
            self.num_pages, self.page_size, self.cache_dtype)
        full = {k: v for k, v in self.t_cache.items()
                if not k.startswith("win_")}
        self.t_pages = PagedKVCache(
            self.num_pages, self.page_size, self.pages_per_stream,
            paged_pool_bytes_per_page(full), device=self.device)
        if self.window:
            self.w_pages = PagedKVCache(
                self.window_pages, self.page_size, self.pages_per_stream,
                paged_pool_bytes_per_page(
                    {k: self.t_cache[k] for k in ("win_k", "win_v")}),
                device=self.device)
        self.d_pages = PagedKVCache(
            self.num_pages, self.page_size, self.pages_per_stream,
            paged_pool_bytes_per_page(self.d_cache), device=self.device)
        state = StreamState(
            pending=torch.zeros((0,), dtype=prompts.dtype, device=self.device),
            target_pos=torch.zeros((0,), dtype=torch.int32, device=self.device),
            draft_pos=torch.zeros((0,), dtype=torch.int32, device=self.device),
            committed=[])
        state, _ = self.add_streams(state, prompts)
        return state

    # ------------------------------------------------------------------
    # dynamic stream admission
    # ------------------------------------------------------------------

    def window_pool_pages(self) -> int:
        """Pages of a windowed target's window pool, from the engine's own
        sizes: each of the ``num_pages / pages_per_stream`` rows the main
        pools hold at ``max_len`` gets the pages a window of ``window`` keys
        and a round window of up to ``page_size`` tokens can span, and one
        admission's prefill (``pages_per_stream``: all its positions are
        written before the pages below its window go back) comes on top;
        never more than ``num_pages``."""
        rows = max(1, self.num_pages // self.pages_per_stream)
        per_row = -(-(self.window + self.page_size) // self.page_size) + 1
        return min(self.num_pages, rows * per_row + self.pages_per_stream)

    def _pools(self) -> list[PagedKVCache]:
        return [m for m in (self.t_pages, self.d_pages, self.w_pages)
                if m is not None]

    def can_admit(self, length: int) -> bool:
        """Whether EVERY page pool can map a new stream of ``length``
        tokens right now (a pure query); never on a contiguous engine."""
        if self.cache_kind != "paged":
            return False
        return all(m.can_allocate(length) for m in self._pools())

    def pool_stats(self) -> dict:
        """Byte-level accounting for placement / admission decisions.
        ``free_pages`` is ``num_pages`` exactly when every pool is empty: a
        window pool counts its mapped pages against ``num_pages``."""
        if self.cache_kind != "paged":
            return {"cache_bytes": cache_bytes(self.t_cache)
                    + cache_bytes(self.d_cache)}
        pools = self._pools()
        return {
            "cache_bytes": cache_bytes(self.t_cache) + cache_bytes(self.d_cache),
            "free_bytes": sum(m.free_bytes() for m in pools),
            "used_bytes": sum(m.used_bytes() for m in pools),
            "free_pages": min(self.num_pages - m.num_allocated_pages
                              for m in pools),
        }

    def _release_window(self, rows) -> None:
        """Hand back every window page wholly below the window of each
        live row of ``rows`` = [(row, committed length C)]: the row's next
        query, at position C, sees keys from C - window + 1.  Host work
        only; one span ``engine.window_free`` (args ``freed``, ``held``:
        the window pages those rows hold after it, ``rows``: how many)."""
        if self.w_pages is None:
            return
        with _span("engine.window_free") as sp:
            freed = held = n = 0
            for b, C in rows:
                if b < 0 or b in self._retired:
                    continue
                freed += self.w_pages.release_below(b, C - self.window + 1)
                held += self.w_pages.held(b)
                n += 1
            sp.set(freed=freed, held=held, rows=n)
            trace.incr("engine.window_pages_freed", freed)

    def prompt_bucket(self, M: int) -> int:
        """Power-of-two bucket (min 8, capped at ``max_len``) for paged
        prefill shapes."""
        b = 8
        while b < M:
            b *= 2
        return max(M, min(b, self.max_len))

    def add_streams(self, state: StreamState, prompts):
        """Admit ``prompts`` (n, M) as new streams.

        Retired batch rows are recycled first; otherwise the batch grows.
        Pages come from the pool (``PagePoolExhausted`` when it is out of
        memory — call ``can_admit`` first).  The prefill runs at the
        power-of-two ``prompt_bucket`` shape; the padding's pages return to
        the pool right after.  Returns ``(new_state, rows)``."""
        if self.cache_kind != "paged":
            raise RuntimeError(
                "contiguous caches are fixed at start(); construct the "
                "engine with cache_kind='paged' to serve churn")
        prompts = torch.as_tensor(prompts, device=self.device)
        n, M = prompts.shape
        Mb = self.prompt_bucket(M)
        tracer = trace.active()
        if tracer is None:
            return self._admit(state, prompts, Mb, trace.NULL_SPAN)
        syncs0 = self.admit_syncs
        with tracer.span("engine.admit", cat="engine",
                         args={"n": int(n), "M": int(M), "bucket": Mb}) as sp:
            new_state, rows = self._admit(state, prompts, Mb, sp)
            sp.set(rows=list(rows), syncs=self.admit_syncs - syncs0)
        return new_state, rows

    def _admit(self, state: StreamState, prompts: torch.Tensor, Mb: int,
               sp) -> tuple[StreamState, list]:
        """``add_streams``'s body in its three child spans: the pages, the
        prefill, the splice.  ``sp`` is the ``engine.admit`` span (the null
        span when no tracer is installed); on a CUDA device a traced
        admission times both prefills with a pair of events and sets their
        ``device_ms`` on it."""
        n, M = prompts.shape
        B = state.pending.shape[0]
        with _span("engine.admit_pages"):
            rows = []
            for _ in range(n):
                row = self._free_rows.pop(0) if self._free_rows else B + len(
                    [r for r in rows if r >= B])
                rows.append(row)
            allocated = []
            try:
                for row in rows:
                    for mgr in self._pools():
                        mgr.alloc_stream(row, Mb - 1)
                        allocated.append((mgr, row))
            except Exception:
                for mgr, row in allocated:
                    mgr.free_stream(row)
                self._free_rows = sorted(set(self._free_rows)
                                         | {r for r in rows if r < B})
                raise
            self._retired -= set(rows)

        events = None
        with _span("engine.admit_prefill"):
            # prefill ONLY the new rows, right-padded to the bucket with the
            # last prompt token: the pad K/V lands at positions >= M-1, which
            # every later window write covers before attention can reach it
            if Mb > M:
                padded = torch.cat([prompts,
                                    prompts[:, -1:].repeat(1, Mb - M)], dim=1)
            else:
                padded = prompts
            t_view = dict(self.t_cache, pages=self.t_pages.device_table(rows))
            if self.w_pages is not None:
                t_view["win_pages"] = self.w_pages.device_table(rows)
            d_view = dict(self.d_cache, pages=self.d_pages.device_table(rows))
            if sp is not trace.NULL_SPAN and self.device.type == "cuda":
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            _, t_view, _ = self.target.prefill(self.t_params, padded[:, :-1],
                                               t_view)
            _, d_view, _ = self.draft.prefill(self.d_params, padded[:, :-1],
                                              d_view)
            if events is not None:
                events[1].record()
            self.t_cache = strip_view(t_view)
            self.d_cache = strip_view(d_view)
            if Mb > M:
                for row in rows:
                    for mgr in self._pools():
                        mgr.truncate(row, M - 1)
            self._release_window([(row, M - 1) for row in rows])

        # splice the new rows into the batched state (admission-time host
        # copies, outside the round's one fetch)
        with _span("engine.admit_splice"):
            n_grow = max(0, max(r + 1 for r in rows) - B) if rows else 0
            pnp = self._admit_fetch(prompts)
            if events is not None:
                # the fetch drained the stream: both events have run
                sp.set(device_ms=events[0].elapsed_time(events[1]))
            pending = np.concatenate([self._admit_fetch(state.pending),
                                      np.zeros(n_grow, pnp.dtype)])
            tpos = np.concatenate([self._admit_fetch(state.target_pos),
                                   np.zeros(n_grow, np.int32)])
            dpos = np.concatenate([self._admit_fetch(state.draft_pos),
                                   np.zeros(n_grow, np.int32)])
            committed = list(state.committed) + [None] * n_grow
            for i, row in enumerate(rows):
                pending[row] = pnp[i, -1]
                tpos[row] = dpos[row] = M - 1
                committed[row] = list(pnp[i])
            new_state = StreamState(
                pending=host_to_device(pending, self.device),
                target_pos=host_to_device(tpos.astype(np.int32), self.device),
                draft_pos=host_to_device(dpos.astype(np.int32), self.device),
                committed=committed)
        return new_state, rows

    def _admit_fetch(self, value: torch.Tensor) -> np.ndarray:
        """Blocking device->host copy of an admission's splice, counted in
        ``admit_syncs`` and the tracer counter ``engine.admit_sync``, apart
        from the round path's ``host_syncs``."""
        self.admit_syncs += 1
        trace.incr("engine.admit_sync")
        return value.cpu().numpy()

    def retire_stream(self, row: int) -> None:
        """Return every page of ``row`` to the pool and recycle the batch
        slot.  The row keeps riding batched forwards frozen (writes through
        its emptied page table are dropped) until a new stream reuses it."""
        if self.cache_kind != "paged":
            raise RuntimeError("contiguous engines cannot retire streams")
        if row in self._retired:
            return
        tracer = trace.active()
        with (trace.NULL_SPAN if tracer is None else
              tracer.span("engine.retire", cat="engine", args={"row": row})):
            for mgr in self._pools():
                mgr.free_stream(row)
            self._retired.add(row)
            self._free_rows.append(row)
            self._free_rows.sort()

    def _grow_pages(self, state: StreamState, rows, frz: np.ndarray,
                    t_len: int, d_len: int) -> None:
        """Extend the page mappings of every live row of ``rows`` to cover
        the round's window (``t_len`` target and ``d_len`` draft positions
        past the committed prefix), clamped at the stream ceiling (window
        writes past max_len drop) and atomic: a pool-dry failure rolls every
        grown row back and re-raises ``PagePoolExhausted``.  Positions come
        from the host-side committed lists (target_pos == draft_pos ==
        len(committed) - 1), so growing the mapping costs no device read."""
        cap = self.pages_per_stream * self.page_size
        grown: list[tuple[int, int, int]] = []
        with _span("engine.page_alloc", {"B": len(frz), "W": t_len}):
            try:
                for i, b in enumerate(rows):
                    if frz[i]:
                        continue
                    pos_b = len(state.committed[b]) - 1
                    grown.append((b, [m.length(b) for m in self._pools()]))
                    self.t_pages.extend(b, min(pos_b + t_len, cap))
                    self.d_pages.extend(b, min(pos_b + d_len, cap))
                    if self.w_pages is not None:
                        self.w_pages.extend(b, min(pos_b + t_len, cap))
            except PagePoolExhausted:
                for b, old in grown:
                    for mgr, n in zip(self._pools(), old):
                        mgr.truncate(b, n)
                raise

    def warmup(self, state: StreamState, buckets, vhat: int = 64):
        """Build (capture) the draft, verify and commit steps at the given
        (n, L) buckets, so serving never captures mid-round.

        Call after ``start()``.  Each bucket's steps are built from zero
        inputs at exactly the shapes and dtypes of the real dispatch; a
        capture records work and runs none.  Returns ``(state, info)``,
        ``info`` mapping each bucket to its seconds; callers MUST adopt
        the returned state: in ``jit+donate`` mode it lives in the commit
        graph's donated buffers (same values).

        Paged engines warm against the real pools under an all--1 page
        table: the eager run before each capture writes only to the drop
        slot.  Contiguous engines capture on their real caches (a graph
        replays on the addresses it was captured on) and run the eager
        warm-up on a throwaway cache; their buckets must be the full batch.
        No-op in eager mode."""
        if self._steps.graphs is None:
            return state, {}
        paged = self.cache_kind == "paged"
        B = int(state.pending.shape[0])
        dev = self.device
        V = self.target_cfg.vocab_size
        info: dict[tuple[int, int], float] = {}

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        for n, L in sorted({(int(n), int(L)) for n, L in buckets}):
            t0 = time.perf_counter()
            if paged:
                pt = torch.full((n, self.pages_per_stream), -1,
                                dtype=torch.int32, device=dev)
                warm_d = warm_t = None
            else:
                if n != B:
                    raise ValueError(
                        f"contiguous caches run full-batch rounds only: "
                        f"bucket ({n}, {L}) for a batch of {B}")
                pt = None
                warm_d = self.draft.init_cache(n, self.max_len,
                                               self.cache_dtype)
                warm_t = self.target.init_cache(n, self.max_len,
                                                self.cache_dtype)
            pending = zeros(n, dtype=state.pending.dtype)
            f32 = torch.float32
            w_pt = pt if self.w_pages is not None else None
            self._steps.draft(self.d_params, self.d_cache, pt, pending,
                              zeros(n), zeros(L, n, vhat, dtype=f32), L=L,
                              vhat=vhat, warm_kv=warm_d, run=False)
            self._steps.verify(
                self.t_params, self.t_cache, pt, w_pt, pending, zeros(n, L),
                zeros(n, L, dtype=f32) + 1, zeros(n, L, vhat),
                zeros(n, L, vhat, dtype=f32) + 1 / vhat, zeros(n),
                zeros(n) + L, zeros(n, L, dtype=f32), zeros(n, dtype=f32),
                zeros(n, V, dtype=f32), warm_kv=warm_t, run=False)
            # a no-op commit: every slot skipped
            pend, tpos, dpos, _ = self._steps.commit(
                state.pending, state.target_pos, state.draft_pos,
                zeros(n) - 1, torch.ones(n, dtype=torch.bool, device=dev),
                zeros(n, L + 1), zeros(n), run=False)
            state = StreamState(pending=pend, target_pos=tpos,
                                draft_pos=dpos, committed=state.committed)
            del warm_d, warm_t
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            info[(n, L)] = time.perf_counter() - t0
        return state, info

    # ------------------------------------------------------------------
    # round steps (reusable on row subsets — the continuous engine's core)
    # ------------------------------------------------------------------

    def _ticket_rows(self, ticket: RoundTicket) -> list:
        return (list(range(len(ticket.freeze))) if ticket.rows is None
                else ticket.rows)

    def draft_rows(self, state: StreamState, rows, lengths,
                   draft_gumbel: torch.Tensor, vhat: int = 64, freeze=None,
                   pad_to: int = 0) -> RoundTicket:
        """Dispatch SLM drafting for a row subset; returns a ``RoundTicket``.

        ``rows=None`` drafts the full batch (the only form a contiguous
        engine runs).  A paged engine takes any subset, ``-1`` padding
        entries included (all--1 page-table rows: cache writes dropped,
        outputs discarded at commit), so a continuous engine can bucket
        batch shapes.  ``-1`` entries and retired rows are frozen.
        ``pad_to`` forces the dispatched window length (length-bucket
        shaping); acceptance is still capped at the true per-row
        ``lengths`` by the verifier.  ``draft_gumbel`` (L, n, vhat) is the
        noise of the L draft steps, L = max(lengths.max(), pad_to).

        On a paged engine the page mappings of live rows are extended to
        cover the L+1 verification window up front, atomically: a pool-dry
        failure rolls every grown row back and re-raises
        ``PagePoolExhausted``.  Nothing here waits on the device."""
        if needs_state_rollback(self.draft_cfg):
            raise NotImplementedError(
                "SSM draft models need snapshot drafting; assigned pairs use "
                "attention SLMs (DESIGN.md §Arch-applicability)")
        paged = self.cache_kind == "paged"
        full = rows is None
        if not paged and not full:
            raise RuntimeError("contiguous caches run full-batch rounds "
                               "only; row subsets need cache_kind='paged'")
        row_list = (list(range(int(state.pending.shape[0]))) if full
                    else [int(r) for r in rows])
        n = len(row_list)
        lengths = np.asarray(lengths, dtype=np.int64)
        frz = (np.zeros(n, dtype=bool) if freeze is None
               else np.asarray(freeze, dtype=bool).copy())
        for i, b in enumerate(row_list):
            if b < 0 or b in self._retired:
                frz[i] = True
        L = max(int(lengths.max()), int(pad_to))
        d_pt = None
        if paged:
            self._grow_pages(state, row_list, frz, L + 1, L + 1)
            d_pt = self.d_pages.device_table(row_list)

        if full:
            pending, dpos, tpos = (state.pending, state.draft_pos,
                                   state.target_pos)
        else:
            # the rows' pending tokens and positions, ``-1`` rows zeroed
            idx = host_to_device(np.asarray([max(b, 0) for b in row_list],
                                            np.int64), self.device)
            live = host_to_device(np.asarray([b >= 0 for b in row_list]),
                                  self.device)

            def gather(x):
                return torch.where(live, x.index_select(0, idx),
                                   torch.zeros((), dtype=x.dtype,
                                               device=x.device))

            pending, dpos, tpos = (gather(state.pending),
                                   gather(state.draft_pos),
                                   gather(state.target_pos))

        # --- step 2: distributed drafting (SLM) ---
        # one graph per (n, L) bucket in a compiled mode, the page table a
        # static input; the draft KV is written in place in every mode
        with _span("engine.draft", {"B": n, "L": L}) as sp:
            draft_res = DraftResult(*self._steps.draft(
                self.d_params, self.d_cache, d_pt, pending, dpos,
                draft_gumbel, L=L, vhat=vhat), cache=None)
            sp.attach(draft_res.tokens)
        return RoundTicket(rows=None if full else row_list, lengths=lengths,
                           L=L, freeze=frz, pending=pending, target_pos=tpos,
                           draft=draft_res)

    def verify_rows(self, ticket: RoundTicket, u_accept: torch.Tensor,
                    u_resid: torch.Tensor,
                    bonus_gumbel: torch.Tensor) -> RoundTicket:
        """Dispatch the batched target pass + exact accept/reject for a
        drafted ticket, with the uniforms (n, L), (n,) and the bonus noise
        (n, V) of its rows.  The pending tokens and positions come from the
        ticket, so other tickets may commit in between.  An SSM/hybrid
        target keeps its state after every window step and each row is
        rolled back to the step of its accepted prefix.  Nothing here waits
        on the device: ``commit_rows`` is the one sync point."""
        row_list = self._ticket_rows(ticket)
        n = len(row_list)
        draft_res = ticket.draft
        draft_len = host_to_device(np.asarray(ticket.lengths, np.int32),
                                   self.device)
        t_pt = (self.t_pages.device_table(row_list)
                if self.cache_kind == "paged" else None)
        w_pt = (self.w_pages.device_table(row_list)
                if self.w_pages is not None else None)
        if not needs_state_rollback(self.target_cfg):
            # --- step 4: batched verification (LLM) ---
            # the target pass AND the accept test, one step (compiled: one
            # graph per (n, L) bucket); the target KV is written in place
            with _span("engine.verify_step",
                       {"B": n, "W": ticket.L + 1}) as sp:
                res = VerifyResult(*self._steps.verify(
                    self.t_params, self.t_cache, t_pt, w_pt, ticket.pending,
                    draft_res.tokens, draft_res.probs, draft_res.q_idx,
                    draft_res.q_val, ticket.target_pos, draft_len, u_accept,
                    u_resid, bonus_gumbel))
                sp.attach(res.accept_counts)
            ticket.res = res
            return ticket

        # an SSM/hybrid target (eager only): the target pass keeps a state
        # snapshot per window step, and each row rolls back to its own
        window = torch.cat([ticket.pending[:, None].to(draft_res.tokens.dtype),
                            draft_res.tokens], dim=1)          # (n, L+1)
        with _span("engine.target_pass", {"B": n, "W": ticket.L + 1}) as sp:
            logits, t_cache, snaps = self.target.forward_window(
                self.t_params, window, self.t_cache, ticket.target_pos,
                return_snapshots=True)
            sp.attach(logits)

        with _span("engine.verify_tokens", {"B": n, "L": ticket.L}) as sp:
            res = verify_drafts(draft_res.tokens, draft_res.probs, logits,
                                draft_res.q_idx, draft_res.q_val, u_accept,
                                u_resid, bonus_gumbel, draft_len=draft_len)
            sp.attach(res.accept_counts)

        # row b processed [pending, d_1 .. d_n]: snapshot n (the state after
        # window[:, :n+1]) is the one its accepted prefix keeps
        sel = select_snapshots(snaps, res.accept_counts,
                               self.target.CACHE_BATCH_AXES)
        self.t_cache = merge_snapshot_into_cache(t_cache, sel)
        ticket.res = res
        return ticket

    def commit_rows(self, state: StreamState, ticket: RoundTicket,
                    skip=None):
        """Land a verified ticket — THE host sync point of a round.

        ``commit_step`` updates pending / target_pos / draft_pos on device
        for the ticket's rows only; the one blocking fetch is the packed
        ``(n, L+2)`` emission that extends the host-side committed lists
        and (paged) drives the page-pool truncation.  ``skip`` (aligned
        with the ticket's rows) marks members that must NOT commit —
        streams retired while the batch was in flight; frozen rows, rows
        retired through the engine and ``-1`` padding rows are skipped
        too, so a mid-verify disconnect never corrupts the rest of the
        batch.  Returns ``(new_state, accepted)``: accepted counts incl.
        the bonus token, 0 for skipped rows, aligned with the ticket.
        ``last_accepted`` keeps them after a full-batch commit and is None
        after a row subset's, as in the reference."""
        row_list = self._ticket_rows(ticket)
        n = len(row_list)
        res = ticket.res
        skip_np = (np.zeros(n, dtype=bool) if skip is None
                   else np.asarray(skip, dtype=bool).copy())
        skip_np |= ticket.freeze
        for i, b in enumerate(row_list):
            if b < 0 or b in self._retired:
                skip_np[i] = True
        with _span("engine.commit", {"B": n}):
            rows_dev = host_to_device(np.asarray(row_list, np.int32),
                                      self.device)
            skip_dev = host_to_device(skip_np, self.device)
            pend, tpos, dpos, emission = self._steps.commit(
                state.pending, state.target_pos, state.draft_pos, rows_dev,
                skip_dev, res.output_tokens, res.accept_counts)
            pack = self._host_fetch(emission)    # the ONE host sync
            if self._steps.graphs is not None:
                # the fetch drained the stream: time the steps' replays
                self._steps.graphs.settle()
            accepted = pack[:, 0].astype(np.int64)
            with _span("engine.page_free", {"B": n}):
                for i, b in enumerate(row_list):
                    adv = int(pack[i, 0])
                    if adv == 0:
                        continue
                    state.committed[b].extend(pack[i, 1:1 + adv].tolist())
                    if self.cache_kind == "paged":
                        # speculative rejection hands pages straight back
                        new_len = len(state.committed[b]) - 1
                        for mgr in self._pools():
                            mgr.truncate(b, new_len)
            if self.w_pages is not None:
                self._release_window([(b, len(state.committed[b]) - 1)
                                      for b in row_list if b >= 0])
        self.last_accepted = accepted if ticket.rows is None else None
        new_state = StreamState(pending=pend, target_pos=tpos,
                                draft_pos=dpos, committed=state.committed)
        return new_state, accepted

    def spin_round(self, state: StreamState, lengths: np.ndarray,
                   draws: RoundDraws | TreeDraws, vhat: int = 64,
                   freeze: np.ndarray | None = None, draft_width: int = 1,
                   tree: bool | None = None):
        """One Multi-SPIN round with per-stream draft lengths (zero-padded to
        the max).  ``draws`` holds the round's randomness at
        (L = max(lengths), B = batch rows, vhat, V).  Returns (state,
        VerifyResult, DraftResult).

        ``draft_width`` J > 1 runs the TOKEN-TREE round instead (the
        ``multidraft`` scheme, ``_spin_round_tree``) and takes ``TreeDraws``
        of width J.  ``tree=True`` forces the tree machinery at J = 1: given
        a sequential round's ``RoundDraws`` it commits bit-identical tokens
        to the sequential path (tested), so it is only useful for testing.

        ``freeze`` marks streams that must NOT advance this round.  Frozen
        rows still ride through the batched forwards but commit nothing;
        their stale window writes land in their own slack slots (or drop,
        for retired rows).  SSM/hybrid targets would need a pre-window
        state restore and refuse frozen rows.  On a paged engine, live rows
        extend their page mappings to cover the window up front and hand
        back every page past the accepted prefix afterwards."""
        if tree is None:
            tree = draft_width > 1
        if tree:
            if isinstance(draws, RoundDraws):
                draws = TreeDraws.from_round(draws)
            return self._spin_round_tree(state, lengths, draws, vhat=vhat,
                                         freeze=freeze, J=int(draft_width))
        B = int(state.pending.shape[0])
        frz = (np.zeros(B, dtype=bool) if freeze is None
               else np.asarray(freeze, dtype=bool).copy())
        if self._retired:
            frz[list(self._retired)] = True
        if frz.any() and needs_state_rollback(self.target_cfg):
            raise NotImplementedError(
                "freezing streams of an SSM/hybrid target needs a pre-window "
                "state snapshot (see ROADMAP open items)")
        # the lockstep round IS the three continuous steps on the full batch
        # (same dispatch shapes and draws -> identical tokens)
        ticket = self.draft_rows(state, None, lengths, draws.draft_gumbel,
                                 vhat=vhat, freeze=frz)
        ticket = self.verify_rows(ticket, draws.u_accept, draws.u_resid,
                                  draws.bonus_gumbel)
        new_state, _ = self.commit_rows(state, ticket)
        return new_state, ticket.res, ticket.draft

    # ------------------------------------------------------------------
    # token-tree multi-draft round (SpecInfer-style verification)
    # ------------------------------------------------------------------

    def _upload(self, array) -> torch.Tensor:
        """A host array on the device, as a copy: on the CPU
        ``host_to_device`` shares memory, and the trie arrays alias the
        ``TreeScratch`` pool that the next round's build overwrites."""
        return host_to_device(np.array(array, copy=True), self.device)

    def _spin_round_tree(self, state: StreamState, lengths: np.ndarray,
                         draws: TreeDraws, vhat: int,
                         freeze: np.ndarray | None, J: int):
        """One multi-draft round: J drafts per stream, packed into a
        prefix-deduplicated token tree, scored in ONE ancestor-masked target
        pass, longest accepted root-to-leaf path committed.

        Cache discipline: the W+1 tree window (W = J * L) occupies target
        positions [pos, pos + W] in construction order while each node keeps
        its tree DEPTH as rope position; after acceptance the winning
        branch's K/V are SCATTERED from their tree-window positions (target)
        and the winning run's window snapshot (draft) into the committed
        positions — ``tree_commit="repair"`` instead re-forwards [pending,
        accepted path] through both models (committed tokens are identical
        either way: they are decided before the cache fix-up).  On a paged
        engine every page past the accepted prefix (all dead branches) goes
        back to the pool.
        At J = 1 the tree is a chain, the window IS the sequential window,
        and no fix-up runs.  Host syncs per round: 2 (scatter, or J = 1),
        3 (repair, J > 1).
        """
        if self.window:
            raise NotImplementedError(
                "token-tree rounds of a target with sliding-window layers: "
                "a tree node's key window would follow its depth, not its "
                "cache slot, and the tree kernels have no key window")
        for role, cfg in (("target", self.target_cfg),
                          ("draft", self.draft_cfg)):
            # DecoderLM families only: the ancestor-masked window needs
            # pointer-rollback attention caches and the forward_window
            # (window_mask=, window_depth=) signature; SSM/hybrid state
            # cannot be pointer-rolled, enc-dec lacks the masked window
            if cfg.family not in ("dense", "moe", "vlm"):
                raise NotImplementedError(
                    f"tree verification needs an attention decoder "
                    f"({role} family {cfg.family!r}): divergent branches "
                    f"commit by pointer rollback and one ancestor-masked "
                    f"window pass (see ROADMAP open items)")
        if draws.J != J:
            raise ValueError(f"draws of width {draws.J} for a J={J} round")
        B = int(state.pending.shape[0])
        lengths = np.asarray(lengths, dtype=np.int64)
        frz_np = (np.zeros(B, dtype=bool) if freeze is None
                  else np.asarray(freeze, dtype=bool).copy())
        if self._retired:
            frz_np[list(self._retired)] = True
        L = int(lengths.max())
        W = J * L
        if tuple(draws.u_accept.shape) != (B, W):
            raise ValueError(f"tree accept uniforms {tuple(draws.u_accept.shape)}"
                             f" != (B={B}, W={W})")

        paged = self.cache_kind == "paged"
        t_cache, d_cache, t_pt, d_pt = self.t_cache, self.d_cache, None, None
        if paged:
            # the TARGET maps the whole W+1 tree window up front; the draft
            # side only ever holds one run (L+1) — repair fits under both
            self._grow_pages(state, range(B), frz_np, W + 1, L + 1)
            t_pt = self.t_pages.device_table(range(B))
            d_pt = self.d_pages.device_table(range(B))
            t_cache = dict(t_cache, pages=t_pt)
            d_cache = dict(d_cache, pages=d_pt)

        # --- step 2: J drafting runs per stream (SLM) ---
        scatter = self.tree_commit == "scatter" and J > 1
        with _span("engine.draft_forest", {"B": B, "L": L, "J": J}) as sp:
            forest = generate_draft_forest(self.draft, self.d_params, d_cache,
                                           state.pending, state.draft_pos,
                                           L, J, draws.draft_gumbel,
                                           vhat=vhat, keep_windows=scatter)
            sp.attach(forest.tokens)
        d_cache = forest.cache

        # --- pack into the prefix-deduplicated tree (host-side) ---
        with _span("engine.tree_build", {"B": B, "L": L, "J": J}):
            # ONE transfer brings everything the trie build needs
            tok_np, p_np, qi_np, qv_np, pend_np = self._host_fetch(
                forest.tokens, forest.probs, forest.q_idx, forest.q_val,
                state.pending)
            ttree = build_token_tree(tok_np, p_np, qi_np, qv_np, lengths,
                                     scratch=self._tree_scratch)
            window = self._upload(
                ttree.window_tokens(pend_np).astype(np.int32))   # (B, W+1)
            wmask = self._upload(ttree.window_mask())
            wdepth = self._upload(ttree.window_depth().astype(np.int32))
            paths = self._upload(ttree.paths)
            tree_args = [self._upload(a) for a in (
                ttree.tokens, ttree.parents, ttree.depth, ttree.probs)]
            tree_q = [self._upload(a) for a in (ttree.q_idx, ttree.q_val)]
            draft_len = self._upload(lengths.astype(np.int32))

        # --- step 4: ONE ancestor-masked target pass over the whole tree ---
        with _span("engine.target_pass", {"B": B, "W": W + 1, "J": J}) as sp:
            logits, t_cache = self.target.forward_window(
                self.t_params, window, t_cache, state.target_pos,
                window_mask=wmask, window_depth=wdepth)
            sp.attach(logits)

        with _span("engine.verify_tokens", {"B": B, "L": L, "J": J}) as sp:
            res = verify_tree(*tree_args, paths, logits, *tree_q, draft_len,
                              draws.u_accept, draws.u_resid,
                              draws.bonus_gumbel)
            sp.attach(res.accept_counts)

        # --- step 5a: land the accepted path's K/V (a J=1 chain already IS
        # the sequential window: nothing to move)
        frz = self._upload(frz_np)
        if scatter:
            # the ancestor-masked target pass ALREADY computed the accepted
            # path's K/V (each tree node conditions on exactly its
            # root-to-node path): move the winning branch's rows from their
            # tree-window positions into the committed positions.  Sources
            # and destinations overlap (src >= dst), so the rows are
            # gathered into a fresh tensor before the scatter.  Every leaf
            # of the target's own cache moves (a MoE stack's ``dense_k`` /
            # ``dense_v`` too, which a dense draft does not have: the JAX
            # package moves only the leaves the draft also holds), and
            # every leaf of the draft's from its winning run's snapshot.
            with _span("engine.kv_commit", {"B": B, "L": L, "J": J}) as sp:
                rows = torch.arange(B, device=self.device)
                win_rows = res.winner.long()
                path_w = paths.long().gather(
                    1, win_rows[:, None, None].expand(B, 1, L))[:, 0]  # (B, L)
                col = torch.arange(L, device=self.device)[None, :]
                keep = ((col < res.accept_counts[:, None]) & (path_w >= 0)
                        & ~frz[:, None])
                src_t = state.target_pos[:, None].long() + 1 + path_w.clamp(min=0)
                dst_t = state.target_pos[:, None].long() + 1 + col
                dst_d = state.draft_pos[:, None].long() + 1 + col
                for leaf in strip_view(t_cache):
                    vals = gather_kv_window(t_cache[leaf], src_t, page_table=t_pt)
                    scatter_kv_window(t_cache[leaf], vals, dst_t, keep,
                                      page_table=t_pt)
                for leaf, snap in forest.windows.items():
                    win = snap[:, rows, win_rows]                  # (Ln,B,L,KV,D)
                    scatter_kv_window(d_cache[leaf], win, dst_d, keep,
                                      page_table=d_pt)
                sp.attach(t_cache["k"])
        elif J > 1:
            # repair forward (the reference path): one plain causal window
            # over [pending, accepted path] rewrites the surviving positions
            n_max = int(self._host_fetch(res.accept_counts).max())
            repair = torch.cat(
                [state.pending[:, None].to(res.output_tokens.dtype),
                 res.output_tokens[:, :n_max]], dim=1)           # (B, n_max+1)
            with _span("engine.cache_repair", {"B": B, "n": n_max + 1}) as sp:
                _, t_cache = self.target.forward_window(
                    self.t_params, repair, t_cache, state.target_pos)
                _, d_cache = self.draft.forward_window(
                    self.d_params, repair, d_cache, state.draft_pos)
                sp.attach(t_cache["k"])
        self.t_cache = strip_view(t_cache)
        self.d_cache = strip_view(d_cache)

        # --- step 5b: commit + rollback (as the sequential round) ---
        zero = torch.zeros((), dtype=res.accept_counts.dtype, device=self.device)
        adv = torch.where(frz, zero, 1 + res.accept_counts)
        new_target_pos = state.target_pos + adv.to(state.target_pos.dtype)
        new_draft_pos = state.draft_pos + adv.to(state.draft_pos.dtype)
        sampled = res.output_tokens.gather(
            1, res.accept_counts.long()[:, None])[:, 0]
        new_pending = torch.where(frz, state.pending,
                                  sampled.to(state.pending.dtype))

        # one transfer lands the commit on the host (tokens + counts;
        # positions for the page truncation ride along)
        out_np, n_np, ntp, ndp = self._host_fetch(
            res.output_tokens, res.accept_counts, new_target_pos,
            new_draft_pos)
        self.last_accepted = np.where(frz_np, 0, n_np + 1).astype(np.int64)
        for b in range(B):
            if not frz_np[b]:
                state.committed[b].extend(out_np[b, :n_np[b] + 1].tolist())

        if paged:
            # every page past the accepted prefix — all dead branches of the
            # tree — returns to the pool here
            with _span("engine.page_free", {"B": B}):
                for b in range(B):
                    if not frz_np[b]:
                        self.t_pages.truncate(b, int(ntp[b]))
                        self.d_pages.truncate(b, int(ndp[b]))

        new_state = StreamState(pending=new_pending, target_pos=new_target_pos,
                                draft_pos=new_draft_pos,
                                committed=state.committed)
        return new_state, res, forest
