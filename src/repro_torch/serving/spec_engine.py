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
    admission is bounded by the page pool (``can_admit``).

``draft_width`` J > 1 runs the multi-draft TOKEN-TREE round instead
(``_spin_round_tree``): J drafts per stream packed into a
prefix-deduplicated tree, scored in ONE ancestor-masked target pass, the
longest accepted root-to-leaf path committed.  Randomness is an input: each
round consumes one ``core.draws.RoundDraws`` (J=1) or ``TreeDraws``.

The J=1 round is three steps, ``draft_rows`` / ``verify_rows`` /
``commit_rows``, which also run on row subsets of a paged engine (``-1``
padding rows included): the core of continuous batching
(``serving/continuous.py``).

The port runs eagerly: the compiled modes raise ``NotImplementedError``
(ROADMAP A9), and ``warmup`` returns at once, as the reference's does in
eager mode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.draws import RoundDraws, TreeDraws
from repro_torch.core.drafting import generate_draft_forest, generate_drafts
from repro_torch.core.token_tree import TreeScratch, build_token_tree
from repro_torch.core.verification import verify_drafts, verify_tree
from repro_torch.models import build_model
from repro_torch.models.layers import gather_kv_window, scatter_kv_window
from repro_torch.models.transformer import strip_view
from repro_torch.obs import trace

from .compiled import COMPILE_MODES, commit_step
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
    """Engine-phase span (``cat="engine"``), once per round."""
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
    both models.  Both commit identical tokens."""

    def __init__(self, target_cfg: ModelConfig, draft_cfg: ModelConfig,
                 max_len: int = 512, cache_dtype=torch.float32,
                 cache_kind: str = "contiguous", page_size: int = 16,
                 num_pages: int | None = None, tree_commit: str = "scatter",
                 compile_mode: str | None = None, device="cuda"):
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
        compile_mode = compile_mode or "eager"
        if compile_mode != "eager":
            raise NotImplementedError(
                f"compile mode {compile_mode!r} is not ported yet (ROADMAP A9); "
                f"the port runs {COMPILE_MODES}")
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
        self._free_rows: list[int] = []
        self._retired: set[int] = set()
        # host-transfer accounting: every blocking device->host fetch on the
        # round path funnels through ``_host_fetch`` and bumps this
        self.host_syncs = 0
        # host-side accepted counts of the last commit
        self.last_accepted: np.ndarray | None = None
        self._tree_scratch = TreeScratch()

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
        self.t_cache = self.target.init_paged_cache(
            self.num_pages, self.page_size, self.cache_dtype)
        self.d_cache = self.draft.init_paged_cache(
            self.num_pages, self.page_size, self.cache_dtype)
        self.t_pages = PagedKVCache(
            self.num_pages, self.page_size, self.pages_per_stream,
            paged_pool_bytes_per_page(self.t_cache), device=self.device)
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

    def can_admit(self, length: int) -> bool:
        """Whether BOTH page pools can map a new stream of ``length`` tokens
        right now (a pure query); never on a contiguous engine."""
        if self.cache_kind != "paged":
            return False
        return (self.t_pages.can_allocate(length)
                and self.d_pages.can_allocate(length))

    def pool_stats(self) -> dict:
        """Byte-level accounting for placement / admission decisions."""
        if self.cache_kind != "paged":
            return {"cache_bytes": cache_bytes(self.t_cache)
                    + cache_bytes(self.d_cache)}
        return {
            "cache_bytes": cache_bytes(self.t_cache) + cache_bytes(self.d_cache),
            "free_bytes": self.t_pages.free_bytes() + self.d_pages.free_bytes(),
            "used_bytes": self.t_pages.used_bytes() + self.d_pages.used_bytes(),
            "free_pages": min(self.t_pages.num_free_pages,
                              self.d_pages.num_free_pages),
        }

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
        B = state.pending.shape[0]
        rows = []
        for _ in range(n):
            row = self._free_rows.pop(0) if self._free_rows else B + len(
                [r for r in rows if r >= B])
            rows.append(row)
        allocated = []
        try:
            for row in rows:
                self.t_pages.alloc_stream(row, Mb - 1)
                allocated.append((self.t_pages, row))
                self.d_pages.alloc_stream(row, Mb - 1)
                allocated.append((self.d_pages, row))
        except Exception:
            for mgr, row in allocated:
                mgr.free_stream(row)
            self._free_rows = sorted(set(self._free_rows)
                                     | {r for r in rows if r < B})
            raise
        self._retired -= set(rows)

        # prefill ONLY the new rows, right-padded to the bucket with the
        # last prompt token: the pad K/V lands at positions >= M-1, which
        # every later window write covers before attention can reach it
        if Mb > M:
            padded = torch.cat([prompts, prompts[:, -1:].repeat(1, Mb - M)],
                               dim=1)
        else:
            padded = prompts
        t_view = dict(self.t_cache, pages=self.t_pages.device_table(rows))
        d_view = dict(self.d_cache, pages=self.d_pages.device_table(rows))
        _, t_view, _ = self.target.prefill(self.t_params, padded[:, :-1],
                                           t_view)
        _, d_view, _ = self.draft.prefill(self.d_params, padded[:, :-1],
                                          d_view)
        self.t_cache = strip_view(t_view)
        self.d_cache = strip_view(d_view)
        if Mb > M:
            for row in rows:
                self.t_pages.truncate(row, M - 1)
                self.d_pages.truncate(row, M - 1)

        # splice the new rows into the batched state (admission-time host
        # copies, outside the round's one fetch)
        n_grow = max(0, max(r + 1 for r in rows) - B) if rows else 0
        pnp = prompts.cpu().numpy()
        pending = np.concatenate([state.pending.cpu().numpy(),
                                  np.zeros(n_grow, pnp.dtype)])
        tpos = np.concatenate([state.target_pos.cpu().numpy(),
                               np.zeros(n_grow, np.int32)])
        dpos = np.concatenate([state.draft_pos.cpu().numpy(),
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

    def retire_stream(self, row: int) -> None:
        """Return every page of ``row`` to the pool and recycle the batch
        slot.  The row keeps riding batched forwards frozen (writes through
        its emptied page table are dropped) until a new stream reuses it."""
        if self.cache_kind != "paged":
            raise RuntimeError("contiguous engines cannot retire streams")
        if row in self._retired:
            return
        self.t_pages.free_stream(row)
        self.d_pages.free_stream(row)
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
                    grown.append((b, self.t_pages.length(b),
                                  self.d_pages.length(b)))
                    self.t_pages.extend(b, min(pos_b + t_len, cap))
                    self.d_pages.extend(b, min(pos_b + d_len, cap))
            except PagePoolExhausted:
                for b, t_old, d_old in grown:
                    self.t_pages.truncate(b, t_old)
                    self.d_pages.truncate(b, d_old)
                raise

    def warmup(self, state: StreamState, buckets, vhat: int = 64):
        """Pre-build the round steps at the given (B, L) buckets.  The port
        runs eagerly (the compiled modes are refused in the constructor,
        ROADMAP A9), so there is nothing to build: returns ``(state, {})``,
        as the reference's eager engine does."""
        return state, {}

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
        d_cache = self.d_cache
        if paged:
            self._grow_pages(state, row_list, frz, L + 1, L + 1)
            d_cache = dict(d_cache, pages=self.d_pages.device_table(row_list))

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
        with _span("engine.draft", {"B": n, "L": L}) as sp:
            draft_res = generate_drafts(self.draft, self.d_params, d_cache,
                                        pending, dpos, L, draft_gumbel,
                                        vhat=vhat)
            self.d_cache = strip_view(draft_res.cache)
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
        t_cache = self.t_cache
        if self.cache_kind == "paged":
            t_cache = dict(t_cache, pages=self.t_pages.device_table(row_list))

        # --- step 4: batched verification (LLM) ---
        window = torch.cat([ticket.pending[:, None].to(draft_res.tokens.dtype),
                            draft_res.tokens], dim=1)          # (n, L+1)
        with _span("engine.target_pass", {"B": n, "W": ticket.L + 1}) as sp:
            if needs_state_rollback(self.target_cfg):
                logits, t_cache, snaps = self.target.forward_window(
                    self.t_params, window, t_cache, ticket.target_pos,
                    return_snapshots=True)
            else:
                logits, t_cache = self.target.forward_window(
                    self.t_params, window, t_cache, ticket.target_pos)
                snaps = None
            sp.attach(logits)

        with _span("engine.verify_tokens", {"B": n, "L": ticket.L}) as sp:
            res = verify_drafts(draft_res.tokens, draft_res.probs, logits,
                                draft_res.q_idx, draft_res.q_val, u_accept,
                                u_resid, bonus_gumbel, draft_len=draft_len)
            sp.attach(res.accept_counts)

        # row b processed [pending, d_1 .. d_n]: snapshot n (the state after
        # window[:, :n+1]) is the one its accepted prefix keeps
        if snaps is not None:
            sel = select_snapshots(snaps, res.accept_counts,
                                   self.target.CACHE_BATCH_AXES)
            t_cache = merge_snapshot_into_cache(t_cache, sel)
        self.t_cache = strip_view(t_cache)
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
            pend, tpos, dpos, emission = commit_step(
                state.pending, state.target_pos, state.draft_pos, rows_dev,
                skip_dev, res.output_tokens, res.accept_counts)
            pack = self._host_fetch(emission)    # the ONE host sync
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
                        self.t_pages.truncate(b, new_len)
                        self.d_pages.truncate(b, new_len)
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
        for role, cfg in (("target", self.target_cfg),
                          ("draft", self.draft_cfg)):
            # dense decoders only: the ancestor-masked window needs
            # pointer-rollback attention caches and the forward_window
            # (window_mask=, window_depth=) signature
            if cfg.family != "dense":
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
            # gathered into a fresh tensor before the scatter.
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
                for leaf in forest.windows:
                    vals = gather_kv_window(t_cache[leaf], src_t, page_table=t_pt)
                    scatter_kv_window(t_cache[leaf], vals, dst_t, keep,
                                      page_table=t_pt)
                    win = forest.windows[leaf][:, rows, win_rows]  # (Ln,B,L,KV,D)
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
