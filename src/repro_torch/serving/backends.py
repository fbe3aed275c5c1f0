"""Pluggable verification backends for the Multi-SPIN cell (protocol step 4).

The round loop is backend-agnostic: planning, latency bookkeeping, deadline
masking, and estimator feedback live in ``MultiSpinCell``; only the
draft-then-verify compute differs between

  * ``SyntheticBackend`` — acceptance outcomes drawn Bernoulli(alpha_k)
    (the paper's analytic regime; a verbatim copy of the JAX package's);
  * ``EngineBackend``    — the port's ``SpecEngine`` drafting and
    batch-verifying on model weights, on the card or the CPU;
  * ``ContinuousBackend`` — the same engine through the continuous-batching
    engine, dispatch and commit split (``verify_async`` / ``collect``).

Backends may expose three lifecycle hooks the cell calls around admission:

  * ``bind(requests)``      — requests were admitted (map them to compute rows)
  * ``can_admit(request)``  — admission-control predicate (page-pool capacity)
  * ``release(requests)``   — requests retired or left (return their memory)
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.obs import trace


@runtime_checkable
class VerificationBackend(Protocol):
    """One Multi-SPIN verification step for the cell's active set.

    ``verify`` receives the planned draft lengths (one per active request,
    in scheduler order) and returns the realized accepted token counts
    INCLUDING the bonus token, i.e. values in [1, L_k + 1].  ``mask``
    (when given, aligned with ``requests``) marks deadline-dropped devices
    False: the caller zeroes their accepted counts, and stateful backends
    must not advance their streams; stateless backends may ignore it.
    ``draft_width`` (the plan's multi-draft J) is only passed when J > 1 —
    single-draft backends need not accept the keyword.
    """

    def verify(self, lengths: np.ndarray, requests: Sequence,
               rng: np.random.Generator, key=None,
               mask: np.ndarray | None = None) -> np.ndarray: ...


class SyntheticBackend:
    """Bernoulli(alpha) acceptance draws from the requests' true task
    acceptance rates (``Request.alpha``).  The estimator, when enabled,
    only informs planning — draws always use the true rates.  ``mask`` is
    ignored: draws are stateless, and drawing the full set preserves the
    legacy protocol's exact rng stream under deadline masking.

    ``draft_width`` J > 1 draws J independent runs per device and keeps the
    longest (the server verifies all J drafts and commits the best — the
    ``multidraft`` scheme's acceptance model)."""

    def verify(self, lengths: np.ndarray, requests: Sequence,
               rng: np.random.Generator, key=None,
               mask: np.ndarray | None = None,
               draft_width: int = 1) -> np.ndarray:
        lengths = np.asarray(lengths, dtype=np.int64)
        K = len(lengths)
        true_alpha = np.array([r.alpha for r in requests])
        # (K, J, L) fills C-order, so J == 1 consumes the exact legacy
        # rng stream of the (K, L) draw
        u = rng.random((K, int(draft_width), int(lengths.max())))
        pos_ok = np.arange(int(lengths.max()))[None, None, :] \
            < lengths[:, None, None]
        acc = (u < true_alpha[:, None, None]) & pos_ok
        n = np.max(np.sum(np.cumprod(acc, axis=-1), axis=-1), axis=-1)
        return n + 1


class EngineBackend:
    """Real-model verification through the port's ``SpecEngine``.

    Requests map onto engine rows in admission order (the cell calls
    ``bind`` as requests are admitted).  The first B requests take the B
    streams prefilled by ``engine.start()``.  On a paged engine every later
    request is admitted dynamically — ``engine.add_streams`` prefills its
    prompt into pooled pages (recycling retired rows first) — and
    ``can_admit`` gates the cell's admission on true page-pool capacity.  A
    contiguous engine is full once the start rows are bound: later
    requests are not servable (the cell rejects them), and mapping one
    raises "engine batch exhausted".

    Rows whose request is not in this call's active set ride through the
    batched forward frozen: they commit nothing and their positions do not
    advance.  ``release`` returns the pages of retired/left requests.

    Randomness: each round takes ONE integer from the cell's numpy ``rng``
    (as the JAX backend does for its PRNG key), so the cell's rng stream and
    every plan stay aligned with the reference.  By default that integer
    seeds a ``torch.Generator`` on the engine's device
    (``RoundDraws.sample``, or ``TreeDraws.sample`` for a multi-draft round
    of width J > 1); ``draws_fn(seed, B, L, vhat, V)`` replaces it with a
    caller's own ``RoundDraws``, and ``draws_fn(seed, B, L, vhat, V, J=J)``
    with its ``TreeDraws`` (the parity tests replay the JAX package's draws
    this way).  Synthetic prompts (requests without
    ``prompt``) come from a ``torch.Generator`` seeded by the rid.
    """

    def __init__(self, engine, state, vhat: int = 64,
                 admit_headroom: int = 32,
                 keep_finished_tokens: bool = False, draws_fn=None):
        self.engine = engine
        self.state = state
        self.vhat = vhat
        self.admit_headroom = admit_headroom
        self.draws_fn = draws_fn
        # with this flag a finished request's generated suffix is kept as a
        # tombstone until ``drop_finished``
        self.keep_finished_tokens = keep_finished_tokens
        self._finished_tokens: dict[int, list[int]] = {}
        self._row_of: dict[int, int] = {}
        self._prompt_len_of: dict[int, int] = {}
        self._start_rows = int(state.pending.shape[0])
        self._next_start_row = 0
        # engine.host_syncs delta across the last verify call
        self.last_round_host_syncs: int | None = None

    @property
    def batch_size(self) -> int:
        return int(self.state.pending.shape[0])

    @property
    def dynamic(self) -> bool:
        return getattr(self.engine, "cache_kind", "contiguous") == "paged"

    # -- lifecycle hooks (called by the cell) ---------------------------

    def servable(self, request) -> bool:
        """Whether the request can EVER run on this engine.  Paged: the
        prompt plus one generated token has to fit a stream.  Contiguous:
        rows are never freed, so only the start batch is served."""
        if not self.dynamic:
            return (request.rid in self._row_of
                    or self._next_start_row < self._start_rows)
        return self._prompt_len(request) + 1 <= self.engine.max_len

    def can_admit(self, request) -> bool:
        """True while start() streams remain unbound; afterwards defer to
        the engine's page pools, asking for the bucketed prefill extent or
        the prompt plus one verification window, clamped to max_len."""
        if self._next_start_row < self._start_rows:
            return True
        if not self.dynamic:
            return False
        p = self._prompt_len(request)
        length = min(max(p + self.admit_headroom, self.engine.prompt_bucket(p)),
                     self.engine.max_len)
        return self.engine.can_admit(length)

    def bind(self, requests: Sequence) -> None:
        """Pre-register engine rows for ``requests`` in admission order."""
        for r in requests:
            self._row(r)

    def release(self, requests: Sequence) -> None:
        """Hand the engine rows of retired/departed requests back: their
        pages return to the pool and the rows become recyclable."""
        for r in requests:
            if self.keep_finished_tokens and r.rid in self._row_of:
                self._finished_tokens[r.rid] = self.stream_tokens(r.rid)
            if not self.dynamic:
                continue
            row = self._row_of.pop(r.rid, None)
            if row is not None:
                self.engine.retire_stream(row)

    # -- telemetry / streaming accessors --------------------------------

    def pool_stats(self) -> dict:
        return self.engine.pool_stats()

    def stream_tokens(self, rid: int) -> list[int]:
        """The committed tokens a request has GENERATED so far (prompt
        excluded); [] for unknown rids."""
        row = self._row_of.get(rid)
        if row is None:
            return list(self._finished_tokens.get(rid, []))
        toks = self.state.committed[row]
        return [int(t) for t in toks[self._prompt_len_of[rid]:]]

    def drop_finished(self, rid: int) -> None:
        self._finished_tokens.pop(rid, None)

    # -- row mapping ----------------------------------------------------

    def _prompt_len(self, r) -> int:
        if getattr(r, "prompt", None) is not None:
            return len(r.prompt)
        return max(int(r.prompt_len), 2)

    def _prompt_tokens(self, r):
        """The request's prompt, or a deterministic synthetic one from a
        ``torch.Generator`` seeded by the rid."""
        import torch

        dev = self.engine.device
        if getattr(r, "prompt", None) is not None:
            return torch.as_tensor(list(r.prompt), dtype=torch.int32,
                                   device=dev)
        gen = torch.Generator(device=dev).manual_seed(r.rid ^ 0x5eed)
        vocab = self.engine.target_cfg.vocab_size
        return torch.randint(0, vocab, (self._prompt_len(r),), generator=gen,
                             device=dev, dtype=torch.int32)

    def _row(self, r) -> int:
        if r.rid not in self._row_of:
            self._prompt_len_of[r.rid] = self._prompt_len(r)
            if self._next_start_row < self._start_rows:
                self._row_of[r.rid] = self._next_start_row
                self._next_start_row += 1
            elif self.dynamic:
                self.state, rows = self.engine.add_streams(
                    self.state, self._prompt_tokens(r)[None, :])
                self._row_of[r.rid] = rows[0]
            else:
                raise ValueError(
                    f"engine batch exhausted: {self.batch_size} contiguous "
                    f"streams, cannot map new request rid={r.rid} "
                    "(cache_kind='paged' serves churn)")
        return self._row_of[r.rid]

    # -- the verification step ------------------------------------------

    def _draws(self, seed: int, B: int, L: int, J: int):
        from repro_torch.core.draws import RoundDraws, TreeDraws

        V = self.engine.target_cfg.vocab_size
        dev = self.engine.device
        if self.draws_fn is not None:
            kw = {} if J == 1 else {"J": J}
            return self.draws_fn(seed, B, L, self.vhat, V, **kw).to(dev)
        if J == 1:
            return RoundDraws.sample(seed, B, L, self.vhat, V, device=dev)
        return TreeDraws.sample(seed, B, J, L, self.vhat, V, device=dev)

    def verify(self, lengths: np.ndarray, requests: Sequence,
               rng: np.random.Generator, key=None,
               mask: np.ndarray | None = None,
               draft_width: int = 1) -> np.ndarray:
        """One round for ``requests``.  ``key`` (an integer seed) replaces
        the draw from ``rng``.  ``draft_width`` J > 1 runs the engine's
        token-tree round."""
        J = int(draft_width)
        lengths = np.asarray(lengths, dtype=np.int64)
        rows = [self._row(r) for r in requests]
        B = self.batch_size
        full = np.ones(B, dtype=np.int64)
        full[rows] = lengths
        freeze = np.ones(B, dtype=bool)
        freeze[rows] = False
        if mask is not None:
            # deadline-dropped devices report nothing this round: their
            # engine streams must not advance with discarded tokens
            freeze[np.asarray(rows)[~np.asarray(mask, dtype=bool)]] = True
        seed = int(rng.integers(2 ** 31)) if key is None else int(key)
        draws = self._draws(seed, B, int(full.max()), J)
        args = None if trace.active() is None else {
            "B": B, "K": len(rows), "L_max": int(lengths.max()),
            "J": J}
        h0 = int(getattr(self.engine, "host_syncs", 0))
        with trace.span("engine.verify", cat="engine", args=args) as sp:
            self.state, res, _ = self.engine.spin_round(
                self.state, full, draws, vhat=self.vhat, freeze=freeze,
                draft_width=J)
            sp.attach(res.output_len)
        self.last_round_host_syncs = \
            int(getattr(self.engine, "host_syncs", 0)) - h0
        # the commit's packed emission already landed the accepted counts on
        # host (0 for frozen rows), so reading them costs no device fetch;
        # after a row-subset commit the engine keeps none, and the round's
        # output lengths are read instead
        accepted = getattr(self.engine, "last_accepted", None)
        if accepted is not None and len(accepted) == B:
            return np.asarray(accepted, dtype=np.int64)[rows]
        return res.output_len.cpu().numpy().astype(np.int64)[rows]


class ContinuousBackend(EngineBackend):
    """``EngineBackend`` driven through the continuous-batching engine
    (``serving.continuous.ContinuousEngine``): verification batches are
    dispatched asynchronously and landed later, so the cell's
    ``schedule="continuous"`` mode can overlap the next round's drafting
    with verification still in flight.

    The split API is

      * ``verify_async(lengths, requests, ...)`` — draft + verify dispatch
        for exactly these requests (shape-bucketed; async, no host sync);
        returns an opaque in-flight batch handle;
      * ``collect(handle)`` — land the batch: the ONLY host sync; commits
        accepted tokens, truncates rejected-draft pages, returns accepted
        counts aligned with the handle's requests (0 for streams that
        retired mid-flight).

    ``verify`` (the plain protocol method) is dispatch + immediate collect,
    so this backend also drops into the sync/pipelined schedules unchanged.
    Engine state lives in the continuous engine; ``self.state`` is a view
    onto it so every inherited accessor (``stream_tokens``, ``add_streams``
    binding, pool stats) stays correct.

    Randomness: the continuous engine derives each dispatch's draws from
    ``seed`` and its dispatch counter (``draws``, default
    ``core.draws.KeyedDraws`` on the engine's device); the cell's numpy
    ``rng`` is never drawn from, as in the reference.
    """

    def __init__(self, engine, state, vhat: int = 64,
                 admit_headroom: int = 32,
                 keep_finished_tokens: bool = False,
                 max_inflight: int = 2, max_batch: int | None = None,
                 exact_shapes: bool = False, seed: int = 0, draws=None):
        from .continuous import ContinuousEngine

        # cont must exist before super().__init__ assigns self.state
        # (the property below delegates into it)
        self.cont = ContinuousEngine(
            engine, state, seed, vhat=vhat, max_inflight=max_inflight,
            max_batch=max_batch, exact_shapes=exact_shapes, draws=draws)
        super().__init__(engine, state, vhat=vhat,
                         admit_headroom=admit_headroom,
                         keep_finished_tokens=keep_finished_tokens)

    @property
    def state(self):
        return self.cont.state

    @state.setter
    def state(self, value):
        self.cont.state = value

    def ready_depth(self) -> int:
        return self.cont.ready_depth()

    def verify_async(self, lengths: np.ndarray, requests: Sequence,
                     rng: np.random.Generator = None, key=None):
        """Dispatch one draft+verify chain for ``requests`` without any
        host synchronization; pair with ``collect``.  ``rng`` is not drawn
        from; ``key`` (an integer seed) replaces the dispatch counter's."""
        lengths = np.asarray(lengths, dtype=np.int64)
        rows = [self._row(r) for r in requests]
        return self.cont.dispatch_round(rows, lengths, key=key)

    def collect(self, handle) -> np.ndarray:
        """Land an in-flight batch (host sync + commit + page reclaim)."""
        h0 = int(getattr(self.engine, "host_syncs", 0))
        out = np.asarray(self.cont.commit(handle), dtype=np.int64)
        self.last_round_host_syncs = \
            int(getattr(self.engine, "host_syncs", 0)) - h0
        return out

    def verify(self, lengths: np.ndarray, requests: Sequence,
               rng: np.random.Generator, key=None,
               mask: np.ndarray | None = None,
               draft_width: int = 1) -> np.ndarray:
        if int(draft_width) > 1:
            raise NotImplementedError(
                "continuous batching is single-draft (J=1); multidraft "
                "token trees run on the lockstep EngineBackend")
        lengths = np.asarray(lengths, dtype=np.int64)
        if mask is not None:
            keep = np.asarray(mask, dtype=bool)
            out = np.zeros(len(requests), dtype=np.int64)
            if keep.any():
                sub = [r for r, m in zip(requests, keep) if m]
                out[keep] = self.collect(
                    self.verify_async(lengths[keep], sub, rng, key=key))
            return out
        return self.collect(self.verify_async(lengths, requests, rng,
                                              key=key))

    def release(self, requests: Sequence) -> None:
        """Retire through the state machines first (legal from any phase;
        an in-flight batch holding the stream skips it at commit), then the
        inherited bookkeeping (tombstones, row-map cleanup)."""
        for r in requests:
            row = self._row_of.get(r.rid)
            if row is not None:
                self.cont.retire(row)
        super().release(requests)
