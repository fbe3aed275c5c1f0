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

Both models' KV lives in fixed-size pages of a preallocated pool
(``PagedKVCache``): streams may join after ``start()`` (``add_streams``)
and leave (``retire_stream``), and admission is bounded by the page pool
(``can_admit``).  Randomness is an input: each round consumes one
``core.draws.RoundDraws``.

Not ported yet, each raising ``NotImplementedError``: the contiguous cache
layout (ROADMAP A2), token-tree rounds J > 1 (A7), compiled modes and
``warmup`` (A9), SSM/hybrid models (A13).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.draws import RoundDraws
from repro_torch.core.drafting import generate_drafts
from repro_torch.core.verification import verify_drafts
from repro_torch.models import build_model
from repro_torch.models.transformer import strip_view
from repro_torch.obs import trace

from .compiled import COMPILE_MODES, commit_step
from .kv_cache import (
    PagedKVCache,
    PagePoolExhausted,
    cache_bytes,
    host_to_device,
    needs_state_rollback,
    paged_pool_bytes_per_page,
)

CACHE_KINDS = ("paged",)


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
    """In-flight round work for the whole batch, between dispatch and commit.

    Produced by ``draft_rows``, completed by ``verify_rows``, consumed by
    ``commit_rows``."""

    lengths: np.ndarray           # per-row planned draft lengths
    L: int                        # the dispatched window length (max)
    freeze: np.ndarray            # per-row do-not-advance mask
    draft: object | None = None   # DraftResult from generate_drafts
    res: object | None = None     # VerifyResult from verify_drafts


class SpecEngine:
    """Speculative-decoding engine for B device streams: a small draft
    model proposes tokens, a large target model batch-verifies them, and
    both models' KV caches advance only over committed tokens.

    ``spin_round`` is one protocol round; ``draft_rows`` / ``verify_rows``
    / ``commit_rows`` are the same round in its three pieces.  Tensors
    live on ``device`` (the card unless the caller asks for the CPU);
    attention and verification dispatch through ``kernels.ops``."""

    def __init__(self, target_cfg: ModelConfig, draft_cfg: ModelConfig,
                 max_len: int = 512, cache_dtype=torch.float32,
                 cache_kind: str = "paged", page_size: int = 16,
                 num_pages: int | None = None, compile_mode: str | None = None,
                 device="cuda"):
        assert target_cfg.vocab_size == draft_cfg.vocab_size, \
            "SLM/LLM pair must share a vocabulary"
        if cache_kind == "contiguous":
            raise NotImplementedError(
                "the contiguous cache layout is not ported yet (ROADMAP A2); "
                "use cache_kind='paged'")
        if cache_kind not in CACHE_KINDS:
            raise ValueError(f"cache_kind must be one of {CACHE_KINDS}")
        if needs_state_rollback(target_cfg) or needs_state_rollback(draft_cfg):
            raise NotImplementedError(
                "SSM/hybrid models are not ported yet (ROADMAP A13)")
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

    def _host_fetch(self, value: torch.Tensor) -> np.ndarray:
        """Blocking device->host fetch.  The ONE per-round call site is the
        packed commit emission in ``commit_rows``."""
        self.host_syncs += 1
        trace.incr("engine.host_sync")
        return value.cpu().numpy()

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
        becomes the pending token.  Sizes the pool when ``num_pages`` was not
        given: 2x the pages the start batch needs at max_len."""
        prompts = torch.as_tensor(prompts, device=self.device)
        B, M = prompts.shape
        self._free_rows, self._retired = [], set()
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
        right now (a pure query)."""
        return (self.t_pages.can_allocate(length)
                and self.d_pages.can_allocate(length))

    def pool_stats(self) -> dict:
        """Byte-level accounting for placement / admission decisions."""
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
        if row in self._retired:
            return
        self.t_pages.free_stream(row)
        self.d_pages.free_stream(row)
        self._retired.add(row)
        self._free_rows.append(row)
        self._free_rows.sort()

    def warmup(self, state: StreamState, buckets, vhat: int = 64):
        raise NotImplementedError(
            "warmup pre-compiles the compiled round steps, which are not "
            "ported yet (ROADMAP A9)")

    # ------------------------------------------------------------------
    # round steps (the full batch; row subsets come with ROADMAP A8)
    # ------------------------------------------------------------------

    def draft_rows(self, state: StreamState, lengths,
                   draft_gumbel: torch.Tensor, vhat: int = 64,
                   freeze=None) -> RoundTicket:
        """Dispatch SLM drafting for every batch row; returns a
        ``RoundTicket``.

        ``draft_gumbel`` (L, B, vhat) is the Gumbel noise of the L draft
        steps, L = max(lengths).  Retired rows are frozen.  Page mappings of
        live rows are extended to cover the L+1 verification window up
        front, atomically: a pool-dry failure rolls every grown row back and
        re-raises ``PagePoolExhausted``.  Nothing here waits on the
        device."""
        B = int(state.pending.shape[0])
        lengths = np.asarray(lengths, dtype=np.int64)
        frz = (np.zeros(B, dtype=bool) if freeze is None
               else np.asarray(freeze, dtype=bool).copy())
        if self._retired:
            frz[list(self._retired)] = True
        L = int(lengths.max())

        # growth is clamped at the stream ceiling (window writes past
        # max_len drop) and atomic.  Positions come from the host-side
        # committed lists (target_pos == draft_pos == len(committed) - 1),
        # so growing the mapping costs no device read.
        cap = self.pages_per_stream * self.page_size
        grown: list[tuple[int, int, int]] = []
        with _span("engine.page_alloc", {"B": B, "L": L}):
            try:
                for b in range(B):
                    if frz[b]:
                        continue
                    pos_b = len(state.committed[b]) - 1
                    grown.append((b, self.t_pages.length(b),
                                  self.d_pages.length(b)))
                    self.t_pages.extend(b, min(pos_b + L + 1, cap))
                    self.d_pages.extend(b, min(pos_b + L + 1, cap))
            except PagePoolExhausted:
                for b, t_len, d_len in grown:
                    self.t_pages.truncate(b, t_len)
                    self.d_pages.truncate(b, d_len)
                raise
        d_pt = self.d_pages.device_table(range(B))

        # --- step 2: distributed drafting (SLM) ---
        with _span("engine.draft", {"B": B, "L": L}) as sp:
            draft_res = generate_drafts(self.draft, self.d_params,
                                        dict(self.d_cache, pages=d_pt),
                                        state.pending, state.draft_pos, L,
                                        draft_gumbel, vhat=vhat)
            self.d_cache = strip_view(draft_res.cache)
            sp.attach(draft_res.tokens)
        return RoundTicket(lengths=lengths, L=L, freeze=frz, draft=draft_res)

    def verify_rows(self, state: StreamState, ticket: RoundTicket,
                    u_accept: torch.Tensor, u_resid: torch.Tensor,
                    bonus_gumbel: torch.Tensor) -> RoundTicket:
        """Dispatch the batched target pass + exact accept/reject for a
        drafted ticket, with the round's uniforms and bonus noise.  Nothing
        here waits on the device: ``commit_rows`` is the one sync point."""
        B = len(ticket.freeze)
        draft_res = ticket.draft
        t_pt = self.t_pages.device_table(range(B))
        draft_len = host_to_device(np.asarray(ticket.lengths, np.int32),
                                   self.device)
        t_cache = dict(self.t_cache, pages=t_pt)

        # --- step 4: batched verification (LLM) ---
        window = torch.cat([state.pending[:, None].to(draft_res.tokens.dtype),
                            draft_res.tokens], dim=1)          # (B, L+1)
        with _span("engine.target_pass", {"B": B, "W": ticket.L + 1}) as sp:
            logits, t_cache = self.target.forward_window(
                self.t_params, window, t_cache, state.target_pos)
            sp.attach(logits)

        with _span("engine.verify_tokens", {"B": B, "L": ticket.L}) as sp:
            res = verify_drafts(draft_res.tokens, draft_res.probs, logits,
                                draft_res.q_idx, draft_res.q_val, u_accept,
                                u_resid, bonus_gumbel, draft_len=draft_len)
            sp.attach(res.accept_counts)
        self.t_cache = strip_view(t_cache)
        ticket.res = res
        return ticket

    def commit_rows(self, state: StreamState, ticket: RoundTicket):
        """Land a verified ticket — THE host sync point of a round.

        ``commit_step`` updates pending / target_pos / draft_pos on device
        for every row not frozen; the one blocking fetch is the packed
        ``(B, L+2)`` emission that extends the host-side committed lists
        and drives the page-pool truncation.  Returns ``(new_state,
        accepted)``: accepted counts incl. the bonus token, 0 for frozen
        rows."""
        B = len(ticket.freeze)
        res = ticket.res
        with _span("engine.commit", {"B": B}):
            rows_dev = host_to_device(np.arange(B, dtype=np.int32),
                                      self.device)
            skip_dev = host_to_device(ticket.freeze, self.device)
            pend, tpos, dpos, emission = commit_step(
                state.pending, state.target_pos, state.draft_pos, rows_dev,
                skip_dev, res.output_tokens, res.accept_counts)
            pack = self._host_fetch(emission)    # the ONE host sync
            accepted = pack[:, 0].astype(np.int64)
            with _span("engine.page_free", {"B": B}):
                for b in range(B):
                    adv = int(pack[b, 0])
                    if adv == 0:
                        continue
                    state.committed[b].extend(pack[b, 1:1 + adv].tolist())
                    # speculative rejection hands pages straight back
                    new_len = len(state.committed[b]) - 1
                    self.t_pages.truncate(b, new_len)
                    self.d_pages.truncate(b, new_len)
        self.last_accepted = accepted
        new_state = StreamState(pending=pend, target_pos=tpos,
                                draft_pos=dpos, committed=state.committed)
        return new_state, accepted

    def spin_round(self, state: StreamState, lengths: np.ndarray,
                   draws: RoundDraws, vhat: int = 64,
                   freeze: np.ndarray | None = None, draft_width: int = 1,
                   tree: bool | None = None):
        """One Multi-SPIN round with per-stream draft lengths (zero-padded to
        the max).  ``draws`` holds the round's randomness at
        (L = max(lengths), B = batch rows, vhat, V).  Returns (state,
        VerifyResult, DraftResult).

        ``freeze`` marks streams that must NOT advance this round.  Frozen
        rows still ride through the batched forwards but commit nothing;
        their stale window writes land in their own slack slots (or drop,
        for retired rows).  Live rows extend their page mappings to cover
        the L+1 window up front and hand back every page past the accepted
        prefix afterwards.  ``draft_width`` J > 1 (token trees) is not
        ported yet (ROADMAP A7)."""
        if draft_width > 1 or tree:
            raise NotImplementedError(
                "token-tree rounds (draft_width > 1) are not ported yet "
                "(ROADMAP A7)")
        ticket = self.draft_rows(state, lengths, draws.draft_gumbel,
                                 vhat=vhat, freeze=freeze)
        ticket = self.verify_rows(state, ticket, draws.u_accept,
                                  draws.u_resid, draws.bonus_gumbel)
        new_state, _ = self.commit_rows(state, ticket)
        return new_state, ticket.res, ticket.draft
