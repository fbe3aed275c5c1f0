"""Real-time telemetry for the Multi-SPIN serving stack.

``MetricsHub`` attaches to a ``MultiSpinCell`` through the cell's narrow
listener surface (``cell.add_listener``) and turns every executed round —
its ``RoundRecord``, the backend's ``pool_stats()`` snapshot riding on it,
and the scheduler's running stats — into one typed ``RoundMetrics`` event:

  * acceptance rate (per-position, bonus token excluded),
  * per-device goodput and the executed multi-draft width J,
  * the DiP-SD-style round breakdown t_draft / t_upload / t_ver / t_round,
  * page-pool occupancy (paged engines; zeros for synthetic backends),
  * queue depth, admitted / rejected / completed counters,
  * BOTH running goodput views (`goodput_committed` vs `goodput_capped` —
    see ``MultiSpinCell.summary`` for why there are two).

Events land in a bounded ring buffer (``window`` rounds), feed running
aggregates, and optionally append to a JSONL trace sink.  ``/metrics`` is
served from ``prometheus_text()`` (text exposition format, stdlib only)
and ``/v1/stats`` from ``snapshot()``.

The dependency is strictly one-way: this module imports nothing from the
gateway server and the cell imports nothing from here — the WISP-style
per-stream SLO/latency telemetry is attachable to ANY cell, batch or live.

All mutating entry points take an internal lock because the gateway steps
the cell on a worker thread while scrapes run on the event loop.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque

import numpy as np


@dataclasses.dataclass
class RoundMetrics:
    """One executed round, flattened for dashboards and the JSONL trace."""

    round_idx: int
    host_time_s: float            # wall-clock since hub attach (host seconds)
    host_dt_s: float              # host seconds since the previous round
    scheme: str
    schedule: str
    n_planned: int                # requests the round planned for
    n_active: int                 # ... that survived the deadline mask
    queue_depth: int              # requests waiting for a batch slot
    draft_width: int              # executed multi-draft J
    drafted_tokens: int           # sum of planned per-device lengths
    accepted_tokens: int          # realized accepted incl. bonus
    acceptance: float             # per-position rate, bonus excluded
    t_draft: float                # phase maxima (simulated seconds)
    t_upload: float
    t_ver: float
    t_round: float
    realized_goodput: float       # this round, tokens / t_round
    predicted_goodput: float      # the plan's prediction
    per_device_goodput: dict      # rid -> accepted / t_round (participants)
    goodput_committed: float      # running, raw accepted / protocol wall
    goodput_capped: float         # running, per-request capped (scheduler)
    pool_free_pages: int          # 0 when the backend has no page pool
    pool_used_bytes: int
    pool_free_bytes: int
    pool_occupancy: float         # used / (used + free), 0.0 without a pool
    admitted_total: int
    rejected_total: int
    completed_total: int
    # verification-batch fill (participants / max_batch) — the continuous
    # assembler's dispatch-early-vs-wait trade, 1.0 for full sync cohorts
    batch_occupancy: float = 0.0
    # continuous schedule: READY streams waiting when this batch dispatched
    ready_depth: int = 0


class _Histogram:
    """Fixed-bound histogram in Prometheus exposition shape: cumulative
    ``_bucket{le=...}`` counts plus ``_sum`` / ``_count``.  Bounds are set
    at construction (Prometheus histograms cannot rebucket); the caller
    holds the hub lock around ``observe`` and ``exposition``."""

    def __init__(self, bounds):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)   # last slot = +Inf
        self.sum = 0.0
        self.n = 0

    def observe(self, value: float):
        v = float(value)
        self.sum += v
        self.n += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def exposition(self, name: str, help_: str) -> list[str]:
        lines = [f"# HELP {name} {help_}", f"# TYPE {name} histogram"]
        cum = 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            lines.append(f'{name}_bucket{{le="{format(b, "g")}"}} {cum}')
        cum += self.counts[-1]
        lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{name}_sum {self.sum:.6f}")
        lines.append(f"{name}_count {self.n}")
        return lines


# simulated seconds; spans TTFTs of a lightly loaded synthetic cell
# (~0.1 s) through deep-queue engine sessions (tens of seconds)
_TTFT_BOUNDS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
_ROUND_BOUNDS = (0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2)


class MetricsHub:
    """Round-granular metrics aggregator + Prometheus exporter + JSONL sink.

    Usage::

        hub = MetricsHub(window=512, trace_path="trace.jsonl")
        hub.attach(cell)          # registers as a cell listener
        cell.run(...)             # or the gateway steps it live
        print(hub.prometheus_text())
        hub.close()
    """

    def __init__(self, window: int = 512, trace_path: str | None = None):
        self._lock = threading.Lock()
        self.ring: deque[RoundMetrics] = deque(maxlen=int(window))
        self.trace_path = trace_path
        self._trace_file = None
        self._cell = None
        self._t0 = time.monotonic()
        self._last_round_t = None
        # running totals (events survive the ring's eviction)
        self.rounds_total = 0
        self.tokens_committed_total = 0
        self.drafted_total = 0
        self.accepted_positions_total = 0   # accepted minus bonus
        self.admitted_total = 0
        self.rejected_total = 0
        self.sim_seconds_total = 0.0
        # distribution families (simulated seconds)
        self.hist_round = _Histogram(_ROUND_BOUNDS)
        self.hist_ttft = _Histogram(_TTFT_BOUNDS)
        self._ttft_seen = 0   # scheduler ttft_s entries already observed

    # -- lifecycle -------------------------------------------------------

    def attach(self, cell) -> "MetricsHub":
        """Register on the cell's listener surface; keeps a reference for
        scheduler-stats and queue-depth reads at event time."""
        self._cell = cell
        cell.add_listener(self)
        self._t0 = time.monotonic()
        return self

    def close(self):
        with self._lock:
            if self._trace_file is not None:
                self._trace_file.close()
                self._trace_file = None

    # -- cell listener surface ------------------------------------------

    def on_admit(self, requests):
        with self._lock:
            self.admitted_total += len(requests)

    def on_reject(self, request):
        with self._lock:
            self.rejected_total += 1

    def on_round(self, rec):
        """Flatten one RoundRecord into a RoundMetrics event (called by the
        cell after retirement, possibly from the gateway's step thread)."""
        cell = self._cell
        lengths = np.asarray(rec.lengths, dtype=np.int64)
        accepted = np.asarray(rec.accepted, dtype=np.int64)
        active = np.asarray(rec.active, dtype=bool)
        drafted = int(lengths[active].sum())
        positions = int(np.maximum(accepted - 1, 0)[active].sum())
        pool = rec.pool_stats or {}
        used = int(pool.get("used_bytes", 0))
        free = int(pool.get("free_bytes", 0))
        now = time.monotonic()
        with self._lock:
            host_dt = (now - self._last_round_t
                       if self._last_round_t is not None else 0.0)
            self._last_round_t = now
            self.rounds_total += 1
            self.tokens_committed_total += int(accepted.sum())
            self.drafted_total += drafted
            self.accepted_positions_total += positions
            self.sim_seconds_total += float(rec.t_round)
            stats = cell.scheduler.stats if cell is not None else None
            self.hist_round.observe(float(rec.t_round))
            if stats is not None:
                # the scheduler appends a TTFT when a stream first commits;
                # observe only the entries new since the last round
                for v in stats.ttft_s[self._ttft_seen:]:
                    self.hist_ttft.observe(float(v))
                self._ttft_seen = len(stats.ttft_s)
            rm = RoundMetrics(
                round_idx=self.rounds_total - 1,
                host_time_s=now - self._t0,
                host_dt_s=host_dt,
                scheme=cell.config.scheme if cell is not None else "",
                schedule=cell.config.schedule if cell is not None else "",
                n_planned=int(len(lengths)),
                n_active=int(active.sum()),
                # the record carries the post-admission depth the round
                # actually saw; reading the live queue here raced the
                # gateway's step thread and could disagree with /v1/stats
                queue_depth=(rec.queue_depth
                             if rec.queue_depth is not None
                             else len(cell.scheduler.queue)
                             if cell is not None else 0),
                draft_width=int(rec.draft_width),
                drafted_tokens=drafted,
                accepted_tokens=int(accepted.sum()),
                acceptance=positions / drafted if drafted else 0.0,
                t_draft=float(rec.t_draft),
                t_upload=float(rec.t_upload),
                t_ver=float(rec.t_ver),
                t_round=float(rec.t_round),
                realized_goodput=float(rec.realized_goodput),
                predicted_goodput=float(rec.predicted_goodput),
                per_device_goodput={
                    int(r): float(a) / float(rec.t_round)
                    for r, a, ok in zip(rec.rids, accepted, active)
                    if ok and rec.t_round > 0},
                goodput_committed=(self.tokens_committed_total
                                   / self.sim_seconds_total
                                   if self.sim_seconds_total else 0.0),
                goodput_capped=stats.goodput if stats is not None else 0.0,
                pool_free_pages=int(pool.get("free_pages", 0)),
                pool_used_bytes=used,
                pool_free_bytes=free,
                pool_occupancy=used / (used + free) if used + free else 0.0,
                admitted_total=self.admitted_total,
                rejected_total=self.rejected_total,
                completed_total=stats.completed if stats is not None else 0,
                batch_occupancy=float(rec.batch_occupancy or 0.0),
                ready_depth=int(rec.ready_depth or 0),
            )
            self.ring.append(rm)
            self._trace(rm)

    def _trace(self, rm: RoundMetrics):
        if self.trace_path is None:
            return
        if self._trace_file is None:
            self._trace_file = open(self.trace_path, "a")
        self._trace_file.write(json.dumps(dataclasses.asdict(rm)) + "\n")
        self._trace_file.flush()

    # -- read side -------------------------------------------------------

    @property
    def latest(self) -> RoundMetrics | None:
        with self._lock:
            return self.ring[-1] if self.ring else None

    def window_acceptance(self) -> float:
        """Acceptance rate over the ring window (per position, no bonus)."""
        with self._lock:
            drafted = sum(m.drafted_tokens for m in self.ring)
            positions = sum(
                m.accepted_tokens - m.n_active for m in self.ring)
            return max(positions, 0) / drafted if drafted else 0.0

    def snapshot(self) -> dict:
        """The ``/v1/stats`` payload: running aggregates + the last round +
        simulated-time TTFT percentiles from the scheduler."""
        last = self.latest
        with self._lock:
            out = {
                "rounds_total": self.rounds_total,
                "tokens_committed_total": self.tokens_committed_total,
                "admitted_total": self.admitted_total,
                "rejected_total": self.rejected_total,
                "acceptance_total": (self.accepted_positions_total
                                     / self.drafted_total
                                     if self.drafted_total else 0.0),
                "sim_seconds_total": self.sim_seconds_total,
                "window": len(self.ring),
            }
        out["acceptance_window"] = self.window_acceptance()
        out["last_round"] = dataclasses.asdict(last) if last else None
        cell = self._cell
        if cell is not None:
            out["scheduler"] = {
                "completed": cell.scheduler.stats.completed,
                "total_tokens": cell.scheduler.stats.total_tokens,
                "total_rounds": cell.scheduler.stats.total_rounds,
                "wall_time": cell.scheduler.stats.wall_time,
                "goodput_capped": cell.scheduler.stats.goodput,
                "queue_depth": len(cell.scheduler.queue),
                "active": len(cell.scheduler.active),
                "hol_wait_max": cell.scheduler.stats.hol_wait_max,
            }
            ttfts = sorted(cell.scheduler.stats.ttft_s)
            if ttfts:
                from repro_torch.serving.gateway.loadgen import percentile
                out["ttft_sim_s"] = {"p50": percentile(ttfts, 50),
                                     "p95": percentile(ttfts, 95),
                                     "p99": percentile(ttfts, 99),
                                     "n": len(ttfts)}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition of the current state (the `/metrics`
        endpoint).  Gauges reflect the LAST round; counters are running."""
        last = self.latest
        cell = self._cell
        lines = []

        def metric(name, value, help_, type_="gauge", labels=None):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {type_}")
            if labels is None:
                lines.append(f"{name} {value}")
            else:
                for lab, v in labels:
                    lines.append(f"{name}{{{lab}}} {v}")

        with self._lock:
            rounds = self.rounds_total
            tokens = self.tokens_committed_total
            admitted = self.admitted_total
            rejected = self.rejected_total
            hist_lines = (
                self.hist_ttft.exposition(
                    "multispin_ttft_seconds",
                    "simulated time-to-first-token per stream")
                + self.hist_round.exposition(
                    "multispin_round_seconds",
                    "simulated wall seconds per protocol round"))
        metric("multispin_rounds_total", rounds,
               "executed protocol rounds", "counter")
        metric("multispin_tokens_committed_total", tokens,
               "committed tokens incl. bonus (uncapped)", "counter")
        metric("multispin_requests_admitted_total", admitted,
               "requests admitted into the active set", "counter")
        metric("multispin_requests_rejected_total", rejected,
               "permanently-unservable requests evicted", "counter")
        if cell is not None:
            metric("multispin_requests_completed_total",
                   cell.scheduler.stats.completed,
                   "requests that reached their token budget", "counter")
            metric("multispin_tokens_capped_total",
                   cell.scheduler.stats.total_tokens,
                   "committed tokens capped at per-request budgets",
                   "counter")
            metric("multispin_queue_depth", len(cell.scheduler.queue),
                   "requests waiting for a batch slot")
            metric("multispin_active_streams", len(cell.scheduler.active),
                   "requests in the verification batch")
        metric("multispin_acceptance_rate",
               f"{self.window_acceptance():.6f}",
               "per-position draft acceptance over the ring window")
        lines.extend(hist_lines)
        if last is not None:
            metric("multispin_draft_width", last.draft_width,
                   "multi-draft J executed by the last round")
            metric("multispin_goodput_committed_tokens_per_s",
                   f"{last.goodput_committed:.6f}",
                   "running raw-committed goodput (protocol view)")
            metric("multispin_goodput_capped_tokens_per_s",
                   f"{last.goodput_capped:.6f}",
                   "running budget-capped goodput (serving view)")
            metric("multispin_round_phase_seconds", None,
                   "last round's simulated phase breakdown",
                   labels=[(f'phase="{p}"', f"{v:.6f}") for p, v in (
                       ("draft", last.t_draft), ("upload", last.t_upload),
                       ("verify", last.t_ver), ("total", last.t_round))])
            metric("multispin_batch_occupancy",
                   f"{last.batch_occupancy:.6f}",
                   "last verification batch's fill: participants / max_batch")
            metric("multispin_ready_queue_depth", last.ready_depth,
                   "drafted streams awaiting batch assembly (continuous)")
            metric("multispin_pool_free_pages", last.pool_free_pages,
                   "KV page-pool free pages (0 without a paged engine)")
            metric("multispin_pool_occupancy",
                   f"{last.pool_occupancy:.6f}",
                   "KV page-pool used fraction (0 without a paged engine)")
            if last.per_device_goodput:
                metric("multispin_device_goodput_tokens_per_s", None,
                       "last round's per-device goodput",
                       labels=[(f'rid="{rid}"', f"{g:.6f}")
                               for rid, g in
                               sorted(last.per_device_goodput.items())])
        return "\n".join(lines) + "\n"
