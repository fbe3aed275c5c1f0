"""Continuous-batching engine: per-stream round state machines with
drafting overlapped against in-flight verification (the port of
``repro.serving.continuous``).

The lockstep ``SpecEngine.spin_round`` makes every stream draft, then every
stream verify — one slow stream stalls the whole cell.  This module removes
the barrier:

  * every stream runs its own round state machine
    (``DRAFTING -> READY -> VERIFYING -> COMMITTING``, terminal ``FINISHED``
    / ``RETIRED``; every transition is validated, and ``retire`` is legal
    from ANY state and always returns the stream's pages);
  * a ``BatchAssembler`` packs verification windows from whichever READY
    streams exist, bucketed to power-of-two batch/length shapes so churny
    ready-sets bound the number of distinct dispatch shapes (``shapes`` +
    ``on_assemble_trace`` make that count testable);
  * dispatch is asynchronous end to end: drafting for the next round is
    enqueued while the previous verification batch is still running on the
    card, with no intermediate wait — the only host sync is the commit,
    applied when a batch's results are complete (a ``torch.cuda.Event``
    recorded after the verification, polled with ``query()``; on the CPU a
    batch is complete when its dispatch returns), with ``max_inflight`` as
    the backpressure bound.

Every launch stays on the current (default) CUDA stream.  A stream retired
mid-verify hands its pages back while its batch is still running; work
enqueued later into those pages (a new stream's prefill) runs after the
batch by stream order, where the reference relies on immutable arrays.

Randomness is an input (``core.draws.KeyedDraws``): dispatch ``seq`` of a
draft group takes the draft half ``(seed, ("fold", seq), ("split", 0))``
and keeps the verify half ``(..., ("split", 1))``; a batch merged from
several draft groups verifies with the whole ``(seed, ("fold", seq'))``;
a caller's key ``k`` is split into ``(k, ("split", 0|1))`` — the
reference's key discipline, per dispatch.

Correctness anchor: with the barrier forced — ``max_inflight=1``,
``exact_shapes=True`` (a single bucket) — every dispatch has the lockstep
shapes, so committed tokens are identical to ``spin_round`` given the same
draws (tested).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.core.draws import KeyedDraws
from repro_torch.obs import trace

from .spec_engine import PagePoolExhausted, RoundTicket, SpecEngine, _span

# ---------------------------------------------------------------------------
# per-stream round state machine
# ---------------------------------------------------------------------------

DRAFTING = "DRAFTING"       # draft dispatch owed (or in flight on device)
READY = "READY"             # drafted; waiting for a verification batch slot
VERIFYING = "VERIFYING"     # member of an in-flight verification batch
COMMITTING = "COMMITTING"   # batch results landed; commit being applied
FINISHED = "FINISHED"       # token budget reached
RETIRED = "RETIRED"         # pages returned; terminal

PHASES = (DRAFTING, READY, VERIFYING, COMMITTING, FINISHED, RETIRED)

# every phase may retire (disconnects happen at any point of a round and
# must return pages immediately); the round cycle itself is strict
_LEGAL = {
    DRAFTING: {READY, RETIRED},
    READY: {VERIFYING, RETIRED},
    VERIFYING: {COMMITTING, RETIRED},
    COMMITTING: {DRAFTING, FINISHED, RETIRED},
    FINISHED: {RETIRED},
    RETIRED: set(),
}


class IllegalTransition(ValueError):
    """A state-machine transition outside ``_LEGAL`` — always a caller bug,
    never a load condition, so it raises instead of being swallowed."""


@dataclasses.dataclass
class StreamFSM:
    """One stream's round state machine (keyed by engine row)."""

    row: int
    length: int = 4               # planned draft length for the next round
    budget: int | None = None     # tokens to generate before FINISHED
    phase: str = DRAFTING
    generated: int = 0            # committed tokens (bonus included)
    rounds: int = 0

    def to(self, phase: str) -> "StreamFSM":
        if phase not in _LEGAL[self.phase]:
            raise IllegalTransition(
                f"stream row={self.row}: {self.phase} -> {phase} "
                f"(legal: {sorted(_LEGAL[self.phase])})")
        self.phase = phase
        return self

    @property
    def live(self) -> bool:
        return self.phase not in (FINISHED, RETIRED)


# ---------------------------------------------------------------------------
# verification-batch assembly (shape bucketing)
# ---------------------------------------------------------------------------

def _pow2_bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class BatchAssembler:
    """Packs READY streams into verification batches at bucketed shapes.

    Shapes are ``(batch_bucket, length_bucket)`` powers of two (batch from
    ``min_batch``, length from ``min_len``) so arbitrary ready-set churn
    dispatches at most one shape per bucket pair instead of one per
    distinct (K, L).  ``exact=True`` disables all padding — every batch is
    dispatched at its true (K, L); the forced-barrier parity mode.

    ``shapes`` records every distinct dispatched shape and
    ``on_assemble_trace`` (when set) fires once per NEW shape, so tests
    can bound the shape count under churn.
    """

    def __init__(self, max_batch: int | None = None, exact: bool = False,
                 min_batch: int = 1, min_len: int = 4):
        self.max_batch = max_batch
        self.exact = exact
        self.min_batch = int(min_batch)
        self.min_len = int(min_len)
        self.shapes: set[tuple[int, int]] = set()
        self.on_assemble_trace = None

    def length_bucket(self, L: int) -> int:
        return int(L) if self.exact else _pow2_bucket(int(L), self.min_len)

    def batch_bucket(self, K: int) -> int:
        if self.exact:
            return int(K)
        b = _pow2_bucket(int(K), self.min_batch)
        return min(b, self.max_batch) if self.max_batch else b

    def record(self, shape: tuple[int, int]) -> None:
        if shape not in self.shapes:
            self.shapes.add(shape)
            if self.on_assemble_trace is not None:
                self.on_assemble_trace(shape)

    def assemble(self, ready: list) -> list[list]:
        """Group READY members — ``(member, length)`` pairs — into batches:
        one batch per length bucket, split at ``max_batch``.  Returns the
        member groups; the caller pads each to its batch bucket and
        dispatches.  Order within a bucket is preserved (FIFO fairness)."""
        by_len: dict[int, list] = {}
        for member, L in ready:
            by_len.setdefault(self.length_bucket(int(L)), []).append(member)
        batches = []
        for Lb in sorted(by_len):
            members = by_len[Lb]
            cap = self.max_batch or len(members)
            for i in range(0, len(members), cap):
                chunk = members[i:i + cap]
                self.record((self.batch_bucket(len(chunk)), Lb))
                batches.append(chunk)
        return batches


# ---------------------------------------------------------------------------
# the continuous engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CommitEvent:
    """One landed verification batch (the continuous analogue of a round)."""

    rows: list[int]
    accepted: np.ndarray          # per member, bonus incl.; 0 = skipped
    occupancy: float              # live members / dispatched batch bucket
    seq: int                      # dispatch sequence number of the batch


@dataclasses.dataclass
class _Batch:
    """In-flight verification batch: the ticket plus its member FSMs."""

    ticket: RoundTicket
    members: list[StreamFSM]
    seq: int
    bucket: int                   # padded batch size actually dispatched
    done: torch.cuda.Event | None = None   # recorded after the verification


class ContinuousEngine:
    """Drives a paged ``SpecEngine`` with per-stream state machines and
    overlapped draft/verify dispatch.

    Two driving modes share all machinery:

      * **self-paced** (``add_stream`` + ``step``/``drain``) — the engine
        grows rounds for every live stream, assembling batches from
        whichever streams are READY each tick;
      * **externally paced** (``dispatch_round`` + ``commit``) — the caller
        (``ContinuousBackend`` under the cell's ``schedule="continuous"``
        event simulation) decides membership and timing; the engine
        supplies async dispatch, FSM safety, and shape bucketing.

    ``max_inflight`` bounds uncommitted verification batches: 1 forces the
    lockstep barrier (with ``exact_shapes=True`` this reproduces
    ``spin_round`` given the same draws); 2+ lets the next round's drafting
    dispatch while verification is still on the card.

    ``seed`` is the root of every key path; ``draws`` (default
    ``KeyedDraws`` on the engine's device) turns a path into tensors.
    """

    def __init__(self, engine: SpecEngine, state, seed: int = 0,
                 vhat: int = 64, max_inflight: int = 2,
                 max_batch: int | None = None, exact_shapes: bool = False,
                 draws: KeyedDraws | None = None):
        if engine.cache_kind != "paged":
            raise ValueError("continuous batching needs cache_kind='paged' "
                             "(row subsets + page reclaim per commit)")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.engine = engine
        self.state = state
        self.seed = int(seed)
        self.draws = draws if draws is not None else KeyedDraws(engine.device)
        self.vhat = vhat
        self.max_inflight = int(max_inflight)
        self.assembler = BatchAssembler(max_batch=max_batch,
                                        exact=exact_shapes)
        self.fsm: dict[int, StreamFSM] = {}
        self._inflight: deque[_Batch] = deque()
        self._seq = 0                     # key-derivation dispatch counter
        # draft tickets awaiting batch assembly: fsm.row -> (ticket, i, kv)
        self._ready: dict[int, tuple] = {}
        self.commits: list[CommitEvent] = []

    def warmup(self, batch_sizes, lengths) -> dict:
        """Build (capture) the engine's round steps at every (batch,
        length) bucket this engine's ``BatchAssembler`` would emit for the
        given populations, so no bucket is captured mid-round; no-op on
        eager engines.  Adopts the engine's returned state (a jit+donate
        commit keeps the state in its donated buffers).  Draft tickets
        hold copies of a draft graph's outputs, so several tickets of one
        bucket may be alive at once (``max_inflight`` > 1)."""
        buckets = {(self.assembler.batch_bucket(int(b)),
                    self.assembler.length_bucket(int(L)))
                   for b in batch_sizes for L in lengths}
        self.state, info = self.engine.warmup(self.state, sorted(buckets),
                                              vhat=self.vhat)
        return info

    # -- stream lifecycle ----------------------------------------------

    def add_stream(self, row: int, length: int = 4,
                   budget: int | None = None) -> StreamFSM:
        """Register engine row ``row`` (already prefilled via ``start`` /
        ``add_streams``) as a live stream drafting ``length`` tokens per
        round until ``budget`` generated tokens (None = externally paced)."""
        fsm = StreamFSM(row=int(row), length=int(length), budget=budget)
        self.fsm[int(row)] = fsm
        return fsm

    def retire(self, row: int) -> None:
        """Retire from ANY phase: pages return to the pool immediately and
        an in-flight batch holding this stream skips it at commit (the
        batch's work is ahead of any later use of the pages on the one
        CUDA stream, so it is unaffected)."""
        fsm = self.fsm.get(int(row))
        if fsm is None or fsm.phase == RETIRED:
            return
        fsm.to(RETIRED)
        self._ready.pop(fsm.row, None)
        self.engine.retire_stream(fsm.row)

    @property
    def done(self) -> bool:
        return (not self._inflight
                and all(not f.live for f in self.fsm.values()))

    def ready_depth(self) -> int:
        return len(self._ready)

    # -- keys ----------------------------------------------------------

    def _next_keys(self):
        """Per-dispatch key pair, lockstep-compatible: dispatch ``seq``
        folds into the root and splits draft/verify halves like
        ``spin_round``'s per-round split."""
        k = (self.seed, ("fold", self._seq))
        self._seq += 1
        return k + (("split", 0),), k + (("split", 1),)

    # -- dispatch (async, no host sync) --------------------------------

    def _dispatch_draft_group(self, members: list[StreamFSM], lengths,
                              key=None):
        """Draft one group (one length bucket): rows padded to the batch
        bucket with ``-1`` sentinels, window padded to the length bucket.
        Marks members READY holding their slice of the group ticket."""
        Lb = self.assembler.length_bucket(int(np.max(lengths)))
        Bb = self.assembler.batch_bucket(len(members))
        self.assembler.record((Bb, Lb))
        if key is None:
            kd, kv = self._next_keys()
        else:
            kd, kv = (int(key), ("split", 0)), (int(key), ("split", 1))
        rows = [f.row for f in members] + [-1] * (Bb - len(members))
        lens = np.concatenate([np.asarray(lengths, np.int64),
                               np.ones(Bb - len(members), np.int64)])
        args = None if trace.active() is None else {
            "B": Bb, "K": len(members), "L": Lb}
        with _span("engine.dispatch_draft", args):
            gumbel = self.draws.draft(kd, Lb, Bb, self.vhat)
            ticket = self.engine.draft_rows(
                self.state, rows, lens, gumbel.to(self.engine.device),
                vhat=self.vhat, pad_to=Lb)
        for i, f in enumerate(members):
            f.to(READY)
            self._ready[f.row] = (ticket, i, kv)
        return ticket

    def _merge_members(self, members: list[StreamFSM]):
        """Build a verification ticket for READY ``members``, regathering
        their draft rows (members may come from different draft groups —
        packing from whichever streams are ready).  When the members are
        exactly one whole draft group in order, the group ticket is reused
        as-is (no gather, and the group's verify-key half keeps the
        lockstep key discipline)."""
        first_ticket, _, kv = self._ready[members[0].row]
        held = [self._ready[f.row] for f in members]
        idxs = [i for _, i, _ in held]
        same_group = all(t is first_ticket for t, _, _ in held)
        if (same_group and len(members) == len(first_ticket.freeze)
                and idxs == list(range(len(members)))):
            return first_ticket, kv
        Lb = self.assembler.length_bucket(max(t.L for t, _, _ in held))
        Bb = self.assembler.batch_bucket(len(members))
        self.assembler.record((Bb, Lb))

        def gather(field):
            parts = []
            for t, i, _ in held:
                row = getattr(t.draft, field)[i]
                if row.shape[0] < Lb:     # mixed length buckets: right-pad
                    row = torch.cat([row, row.new_zeros(
                        (Lb - row.shape[0],) + tuple(row.shape[1:]))])
                parts.append(row)
            pad = [torch.zeros_like(parts[0])] * (Bb - len(parts))
            return torch.stack(parts + pad)

        draft = dataclasses.replace(
            first_ticket.draft, tokens=gather("tokens"),
            probs=gather("probs"), q_idx=gather("q_idx"),
            q_val=gather("q_val"))
        rows = [f.row for f in members] + [-1] * (Bb - len(members))
        lens = np.array([int(t.lengths[i]) for t, i, _ in held]
                        + [1] * (Bb - len(members)), np.int64)

        def column(field):
            parts = [getattr(t, field)[i:i + 1] for t, i, _ in held]
            z = parts[0].new_zeros(Bb - len(members))
            return torch.cat(parts + [z])

        frz = np.array([False] * len(members)
                       + [True] * (Bb - len(members)))
        ticket = RoundTicket(rows=rows, lengths=lens, L=Lb, freeze=frz,
                             pending=column("pending"),
                             target_pos=column("target_pos"), draft=draft)
        kv = (self.seed, ("fold", self._seq))
        self._seq += 1
        return ticket, kv

    def _dispatch_verify(self, members: list[StreamFSM], key=None):
        args = None if trace.active() is None else {
            "K": len(members), "rows": [f.row for f in members]}
        with _span("engine.dispatch_verify", args):
            ticket, kv = self._merge_members(members)
            n = len(ticket.freeze)
            u_accept, u_resid, bonus = self.draws.verify(
                key if key is not None else kv, n, ticket.L,
                self.engine.target_cfg.vocab_size)
            dev = self.engine.device
            ticket = self.engine.verify_rows(ticket, u_accept.to(dev),
                                             u_resid.to(dev), bonus.to(dev))
            done = None
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        for f in members:
            self._ready.pop(f.row, None)
            f.to(VERIFYING)
        batch = _Batch(ticket=ticket, members=members, seq=self._seq,
                       bucket=len(ticket.freeze), done=done)
        self._inflight.append(batch)
        return batch

    # -- commit (the only host sync) ------------------------------------

    @staticmethod
    def _result_ready(batch: _Batch) -> bool:
        """Whether the batch's verification has completed on the card (an
        event poll, no wait); a CPU batch is complete once dispatched."""
        return batch.done is None or bool(batch.done.query())

    def _commit_batch(self, batch: _Batch) -> CommitEvent:
        skip = np.zeros(len(batch.ticket.freeze), dtype=bool)
        for i, f in enumerate(batch.members):
            if f.phase == RETIRED:        # retired mid-verify: skip, pages
                skip[i] = True            # already returned by retire()
            else:
                f.to(COMMITTING)
        args = None if trace.active() is None else {
            "K": len(batch.members), "seq": batch.seq}
        with _span("engine.commit_batch", args):
            self.state, accepted = self.engine.commit_rows(
                self.state, batch.ticket, skip=skip)
        live = 0
        for i, f in enumerate(batch.members):
            if f.phase == RETIRED:
                continue
            live += 1
            f.generated += int(accepted[i])
            f.rounds += 1
            if f.budget is not None and f.generated >= f.budget:
                f.to(FINISHED)
            else:
                f.to(DRAFTING)
        ev = CommitEvent(rows=[f.row for f in batch.members],
                         accepted=accepted[:len(batch.members)],
                         occupancy=live / batch.bucket if batch.bucket else 0.0,
                         seq=batch.seq)
        self.commits.append(ev)
        return ev

    # -- externally paced API (ContinuousBackend) ------------------------

    def ensure_stream(self, row: int, length: int = 4) -> StreamFSM:
        fsm = self.fsm.get(int(row))
        if fsm is None or not fsm.live:
            fsm = self.add_stream(row, length=length)
        return fsm

    def dispatch_round(self, rows, lengths, key=None) -> _Batch:
        """Draft + verify one externally chosen batch (async end to end);
        the caller later lands it with ``commit``.  The whole group goes
        through DRAFTING -> READY -> VERIFYING in one dispatch chain — the
        overlap with other in-flight batches comes from the caller
        dispatching before collecting.  ``key`` (an integer seed) replaces
        the dispatch counter's key pair by its two halves."""
        lengths = np.asarray(lengths, dtype=np.int64)
        members = [self.ensure_stream(r, int(length))
                   for r, length in zip(rows, lengths)]
        self._dispatch_draft_group(members, lengths, key=key)
        return self._dispatch_verify(members)

    def commit(self, batch: _Batch) -> np.ndarray:
        """Land a dispatched batch; returns accepted counts aligned with
        its rows (0 for streams retired mid-flight)."""
        self._inflight.remove(batch)
        return self._commit_batch(batch).accepted

    # -- self-paced mode ------------------------------------------------

    def step(self) -> list[CommitEvent]:
        """One tick: land completed batches, dispatch drafting for every
        DRAFTING stream, assemble verification batches from the READY set,
        and apply ``max_inflight`` backpressure.  Returns the commits."""
        events = []
        # completion callbacks: commit every batch whose results are ready
        # (no blocking — an event query is a poll)
        while self._inflight and self._result_ready(self._inflight[0]):
            events.append(self._commit_batch(self._inflight.popleft()))
        # draft next rounds while verification batches are still in flight
        drafting = [f for f in self.fsm.values() if f.phase == DRAFTING]
        if drafting:
            groups = self.assembler.assemble(
                [(f, f.length) for f in drafting])
            for g in groups:
                try:
                    self._dispatch_draft_group(
                        g, np.array([f.length for f in g], np.int64))
                except PagePoolExhausted:
                    # pool dry: hold the group in DRAFTING; in-flight
                    # commits below return pages for the next tick
                    break
        ready = [f for f in self.fsm.values() if f.phase == READY]
        dispatched = False
        if ready and len(self._inflight) < self.max_inflight:
            for g in self.assembler.assemble([(f, f.length) for f in ready]):
                self._dispatch_verify(g)
                dispatched = True
                if len(self._inflight) >= self.max_inflight:
                    break
        # backpressure: at the pipeline depth bound the oldest batch lands
        while len(self._inflight) > self.max_inflight - 1 and (
                len(self._inflight) >= self.max_inflight or not dispatched):
            events.append(self._commit_batch(self._inflight.popleft()))
            if len(self._inflight) < self.max_inflight:
                break
        if not events and not dispatched and not drafting and self._inflight:
            # nothing else can make progress: force the oldest commit
            events.append(self._commit_batch(self._inflight.popleft()))
        return events

    def drain(self, max_ticks: int = 100_000) -> list[CommitEvent]:
        """Run ``step`` until every stream is FINISHED/RETIRED."""
        for _ in range(max_ticks):
            if self.done:
                return self.commits
            self.step()
        raise RuntimeError("continuous drain did not converge "
                           f"(phases: {[f.phase for f in self.fsm.values()]})")
