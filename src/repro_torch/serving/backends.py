"""Pluggable verification backends for the Multi-SPIN cell (protocol step 4).

The round loop is backend-agnostic: planning, latency bookkeeping, deadline
masking, and estimator feedback live in ``MultiSpinCell``; only the
draft-then-verify compute differs between

  * ``SyntheticBackend`` — acceptance outcomes drawn Bernoulli(alpha_k)
    (the paper's analytic regime; a verbatim copy of the JAX package's);
  * ``EngineBackend``    — the port's ``SpecEngine`` drafting and
    batch-verifying on model weights, on the card or the CPU.

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
    """Real-model verification through the port's paged ``SpecEngine``.

    Requests map onto engine rows in admission order (the cell calls
    ``bind`` as requests are admitted).  The first B requests take the B
    streams prefilled by ``engine.start()``; every later request is admitted
    dynamically — ``engine.add_streams`` prefills its prompt into pooled
    pages (recycling retired rows first) — and ``can_admit`` gates the
    cell's admission on true page-pool capacity.

    Rows whose request is not in this call's active set ride through the
    batched forward frozen: they commit nothing and their positions do not
    advance.  ``release`` returns the pages of retired/left requests.

    Randomness: each round takes ONE integer from the cell's numpy ``rng``
    (as the JAX backend does for its PRNG key), so the cell's rng stream and
    every plan stay aligned with the reference.  By default that integer
    seeds a ``torch.Generator`` on the engine's device
    (``RoundDraws.sample``); ``draws_fn(seed, B, L, vhat, V)`` replaces it
    with a caller's own ``RoundDraws`` (the parity tests replay the JAX
    package's draws this way).  Synthetic prompts (requests without
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
        return getattr(self.engine, "cache_kind", "paged") == "paged"

    # -- lifecycle hooks (called by the cell) ---------------------------

    def servable(self, request) -> bool:
        """Whether the request can EVER run on this engine: the prompt plus
        one generated token has to fit a stream."""
        return self._prompt_len(request) + 1 <= self.engine.max_len

    def can_admit(self, request) -> bool:
        """True while start() streams remain unbound; afterwards defer to
        the engine's page pools, asking for the bucketed prefill extent or
        the prompt plus one verification window, clamped to max_len."""
        if self._next_start_row < self._start_rows:
            return True
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
            else:
                self.state, rows = self.engine.add_streams(
                    self.state, self._prompt_tokens(r)[None, :])
                self._row_of[r.rid] = rows[0]
        return self._row_of[r.rid]

    # -- the verification step ------------------------------------------

    def _draws(self, seed: int, B: int, L: int):
        from repro_torch.core.draws import RoundDraws

        V = self.engine.target_cfg.vocab_size
        if self.draws_fn is not None:
            return self.draws_fn(seed, B, L, self.vhat, V).to(self.engine.device)
        return RoundDraws.sample(seed, B, L, self.vhat, V,
                                 device=self.engine.device)

    def verify(self, lengths: np.ndarray, requests: Sequence,
               rng: np.random.Generator, key=None,
               mask: np.ndarray | None = None,
               draft_width: int = 1) -> np.ndarray:
        """One round for ``requests``.  ``key`` (an integer seed) replaces
        the draw from ``rng``."""
        if int(draft_width) > 1:
            raise NotImplementedError(
                "token-tree rounds (draft_width > 1) are not ported yet "
                "(ROADMAP A7)")
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
        draws = self._draws(seed, B, int(full.max()))
        args = None if trace.active() is None else {
            "B": B, "K": len(rows), "L_max": int(lengths.max()),
            "J": int(draft_width)}
        h0 = int(getattr(self.engine, "host_syncs", 0))
        with trace.span("engine.verify", cat="engine", args=args) as sp:
            self.state, res, _ = self.engine.spin_round(
                self.state, full, draws, vhat=self.vhat, freeze=freeze)
            sp.attach(res.output_len)
        self.last_round_host_syncs = \
            int(getattr(self.engine, "host_syncs", 0)) - h0
        # the commit's packed emission already landed the accepted counts on
        # host (0 for frozen rows), so reading them costs no device fetch
        return np.asarray(self.engine.last_accepted, dtype=np.int64)[rows]


class ContinuousBackend(EngineBackend):
    """Continuous batching through the engine is not ported yet
    (ROADMAP A8)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "continuous batching is not ported yet (ROADMAP A8)")
