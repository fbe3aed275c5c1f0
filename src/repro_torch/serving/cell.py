"""The Multi-SPIN cell: one session object for the whole serving stack.

``MultiSpinCell`` owns the paper's full loop (Sec. III-A, Fig. 2) — plan,
draft, upload, batch-verify, feedback — plus the request lifecycle around
it: admission from a queue, per-request channel state, online acceptance
estimation, deadline-based straggler masking, retirement, and device
join/leave with automatic re-planning.  Compute is pluggable through
``repro.serving.backends`` (synthetic Bernoulli draws or a real JAX
``SpecEngine``), and the round schedule is selectable (``sync`` — the
paper's synchronized rounds — or ``pipelined`` — half-batches overlapping
draft/upload with verification, backend-agnostic).

Construction is one ``CellConfig`` (JSON-serializable) and one call::

    cfg = CellConfig(scheme="hete", max_batch=8)
    cell = MultiSpinCell(cfg)
    cell.submit(Request(rid=0, prompt_len=8, max_new_tokens=64,
                        alpha=0.8, T_S=0.009))
    rec = cell.step()          # one protocol round
    print(cell.summary())

The device list is never frozen: every round plans against the
scheduler's CURRENT active set, so retirements, joins, and drops can
never diverge from the controller's view.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core.channel import (
    ChannelConfig,
    ChannelState,
    sample_average_gains,
    sample_rayleigh_gains,
    spectrum_efficiency,
)
from repro_torch.core.controller import (
    AcceptanceEstimator,
    MultiSpinController,
    VerificationLatencyModel,
)
from repro_torch.core.schemes import available_schemes, get_scheme
from repro_torch.obs import trace
from repro_torch.serving.backends import SyntheticBackend, VerificationBackend
from repro_torch.serving.scheduler import Request, RoundScheduler

SCHEDULES = ("sync", "pipelined", "continuous")


@dataclasses.dataclass
class RoundRecord:
    """Full bookkeeping of one executed round (sync or pipelined half)."""

    lengths: np.ndarray
    bandwidth: np.ndarray
    accepted: np.ndarray          # realized accepted tokens (incl. bonus)
    t_ma: float
    t_ver: float
    t_round: float
    predicted_goodput: float
    realized_goodput: float
    active: np.ndarray            # device participation mask
    rids: np.ndarray | None = None  # request ids, scheduler order
    draft_width: int = 1          # multi-draft J the plan executed with
    # per-phase breakdown of the multi-access phase (telemetry satellite):
    # each is the MAX over deadline survivors of that phase alone, so the
    # phases overlap across devices and t_draft + t_upload >= t_ma in
    # general (equality when one straggler dominates both phases).
    # Server-drafting schemes fold their whole latency into t_draft.
    t_draft: float = 0.0
    t_upload: float = 0.0
    # backend memory snapshot taken AFTER this round retired its finished
    # requests (the occupancy the next admission decision sees); None for
    # backends without a pool_stats hook (synthetic draws)
    pool_stats: dict | None = None
    # POST-admission scheduler queue depth at record time — the depth the
    # next admission decision actually sees, matching /v1/stats (telemetry
    # previously re-read the live queue off-thread)
    queue_depth: int | None = None
    # verification-batch fill: participating devices / max_batch (continuous
    # batches are assembled from whichever streams are READY, so this is
    # the direct cost signal of dispatching early vs waiting for stragglers)
    batch_occupancy: float | None = None
    # continuous schedule only: streams drafted-and-waiting when this batch
    # dispatched (depth of the READY queue the assembler packs from)
    ready_depth: int | None = None
    # blocking device->host fetches the engine performed landing this round
    # (the compiled round path commits with exactly ONE — the packed token
    # emission); None for backends without host-transfer accounting
    n_host_syncs: int | None = None


@dataclasses.dataclass
class CellConfig:
    """Everything needed to stand up a Multi-SPIN cell, in one JSON-able
    record: scheme + controller search settings, wireless channel, the
    verification latency model, scheduler capacity, and lifecycle knobs."""

    scheme: str = "hete"
    scheme_params: dict = dataclasses.field(default_factory=dict)
    channel: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)
    t_ver_fix: float = 0.035              # T_ver(K) = t_fix + K t_lin (eq. 7)
    t_ver_lin: float = 0.0177
    t_draft_fix: float | None = None      # Cen-SPIN server drafting per token:
    t_draft_lin: float | None = None      # None -> 0.15*t_ver_fix / 0.6*t_ver_lin
                                          # (A100-class SLM, Fig.-6 convention)
    L_max: int = 25
    L_fixed: int = 8
    n_phi: int = 40
    n_lam: int = 40
    max_batch: int = 8
    use_estimator: bool = False
    deadline_factor: float | None = None  # straggler deadline x median latency
    schedule: str = "sync"                # "sync" | "pipelined" | "continuous"
    # continuous schedule: verification batches allowed in flight at once
    # (1 forces the lockstep barrier; 2+ overlaps drafting with verify)
    max_inflight: int = 2
    seed: int = 0

    def __post_init__(self):
        if self.scheme not in available_schemes():
            raise ValueError(f"unknown scheme {self.scheme!r}; available: "
                             f"{', '.join(available_schemes())}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, "
                             f"got {self.schedule!r}")
        cls = get_scheme(self.scheme)
        if cls.capabilities.single_user_only and self.max_batch != 1:
            raise ValueError(
                f"scheme {self.scheme!r} is single-user (capability "
                f"'single_user_only'): it serves exactly one device, so "
                f"max_batch must be 1, got {self.max_batch}")
        if cls.capabilities.server_drafting and self.schedule == "pipelined":
            raise ValueError(
                f"scheme {self.scheme!r} drafts on the server (capability "
                f"'server_drafting'): the pipelined schedule would overlap "
                f"the server's own drafting with its own verification — "
                f"use schedule='sync'")
        if self.schedule == "continuous":
            if cls.capabilities.server_drafting:
                raise ValueError(
                    f"scheme {self.scheme!r} drafts on the server: continuous "
                    f"batching overlaps device drafting with in-flight "
                    f"verification, which a server-drafting scheme cannot — "
                    f"use schedule='sync'")
            if cls.capabilities.multi_draft:
                raise ValueError(
                    f"scheme {self.scheme!r} is multi-draft: token-tree "
                    f"verification runs lockstep rounds — use "
                    f"schedule='sync'")
            if self.deadline_factor is not None:
                raise ValueError(
                    "continuous batching makes deadline_factor redundant: "
                    "stragglers no longer block a cohort (batches are "
                    "assembled from whichever streams are ready), so "
                    "straggler masking must be None")
        if self.max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, "
                             f"got {self.max_inflight}")
        # validate scheme_params against the scheme's declared schema now,
        # not at first plan() (build_controller repeats this cheaply)
        self.build_controller()

    # -- serialization ---------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CellConfig":
        d = dict(d)
        if isinstance(d.get("channel"), dict):
            d["channel"] = ChannelConfig(**d["channel"])
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "CellConfig":
        return cls.from_dict(json.loads(s))

    # -- factories -------------------------------------------------------

    def build_controller(self) -> MultiSpinController:
        t_draft = VerificationLatencyModel(
            self.t_draft_fix if self.t_draft_fix is not None
            else 0.15 * self.t_ver_fix,
            self.t_draft_lin if self.t_draft_lin is not None
            else 0.6 * self.t_ver_lin)
        return MultiSpinController(
            scheme=self.scheme, scheme_params=dict(self.scheme_params),
            q_tok_bits=self.channel.q_tok_bits,
            bandwidth_hz=self.channel.total_bandwidth_hz,
            t_ver_model=VerificationLatencyModel(self.t_ver_fix,
                                                 self.t_ver_lin),
            t_draft_model=t_draft,
            L_max=self.L_max, L_fixed=self.L_fixed,
            n_phi=self.n_phi, n_lam=self.n_lam,
            deadline_factor=self.deadline_factor)


class MultiSpinCell:
    """Session object running the Multi-SPIN protocol over a live request
    set with a pluggable verification backend.

    Each ``step()`` is one protocol round: assemble a ``CellObservation``
    over the scheduler's current active set, let the configured scheme
    plan it into a ``RoundPlan`` (draft lengths, bandwidth shares, draft
    width J), execute the round through the backend, and fold the results
    into the online acceptance estimator, channel state, and per-request
    accounting.  ``submit``/``leave`` mutate the live set between rounds;
    admission is gated by the backend's ``can_admit``.  Telemetry attaches
    through ``add_listener`` (``on_admit``/``on_reject``/``on_round``)
    without the cell importing it.  See docs/architecture.md for the full
    request lifecycle."""

    def __init__(self, config: CellConfig,
                 backend: VerificationBackend | None = None,
                 rng: np.random.Generator | None = None):
        self.config = config
        self.rng = rng if rng is not None else np.random.default_rng(config.seed)
        self.controller = config.build_controller()
        self.backend = backend if backend is not None else SyntheticBackend()
        self.scheduler = RoundScheduler(max_batch=config.max_batch)
        self.estimator = (AcceptanceEstimator(0) if config.use_estimator
                          else None)
        # Per-request channel state, row-aligned with scheduler.active.
        # Kept as explicit arrays (not one ChannelState) so rows can be
        # spliced on join/leave without redrawing surviving devices' fading
        # — which also preserves the legacy protocol's exact draw order.
        self.avg_gains = np.zeros(0)
        self.gains = np.zeros(0)
        self.rates = np.zeros(0)
        self.history: list[RoundRecord] = []
        self.rejected: list[Request] = []   # permanently-unservable requests
        # narrow observer surface (telemetry/gateway attach from outside;
        # the cell never imports them): objects with any of the optional
        # methods on_admit(requests) / on_reject(request) / on_round(record)
        self._listeners: list = []
        self._round_idx = 0
        self._pending_ver = 0.0      # pipelined: verification still in flight
        self._pending_rids: set[int] = set()   # whose tokens it verifies
        self._drained_ver = 0.0      # trailing in-flight work already drained
        self._pipe_parity = 0
        # continuous schedule: the event-driven simulated timeline.
        # _cont_ready maps rid -> draft bookkeeping for streams that have
        # dispatched drafting and become READY at ready_at; _cont_inflight
        # holds dispatched verification batches until their done_at.
        self._cont_now = 0.0
        self._cont_last_commit = 0.0
        self._cont_server_free = 0.0
        self._cont_ready: dict[int, dict] = {}
        self._cont_inflight: list[dict] = []

    # ------------------------------------------------------------------
    # observers (telemetry hook surface)
    # ------------------------------------------------------------------

    def add_listener(self, listener):
        """Attach an observer.  The cell calls the observer's OPTIONAL
        methods at lifecycle points — ``on_admit(requests)`` when requests
        enter the active set, ``on_reject(request)`` when a permanently
        unservable request is evicted, ``on_round(record)`` after every
        executed round (post-retirement, so scheduler stats are current).
        This keeps the dependency one-way: ``MetricsHub``/the gateway
        import the cell, never the reverse.  Returns the listener."""
        self._listeners.append(listener)
        return listener

    def remove_listener(self, listener):
        self._listeners.remove(listener)

    def _emit(self, event: str, *args):
        for listener in self._listeners:
            fn = getattr(listener, event, None)
            if fn is not None:
                fn(*args)

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> int:
        """Queue a request (device asking to join the cell)."""
        self.scheduler.submit(req)
        return req.rid

    def admit(self) -> list[Request]:
        """Fill free batch slots; provision channel + estimator rows for the
        devices that just joined.  Called automatically by ``step``.

        Backends with an ``can_admit`` hook (the paged engine) gate
        admission on true memory capacity: a join is refused only when the
        page pool cannot hold the request — it then waits in the queue."""
        # config.max_batch is the single source of truth for capacity (it can
        # be resized at runtime); the scheduler just mirrors it
        self.scheduler.max_batch = self.config.max_batch
        before = len(self.scheduler.active)
        # bind as each request is admitted (not after the loop) so every
        # can_admit query sees the capacity its predecessors consumed;
        # requests that can NEVER be served are evicted into self.rejected
        # rather than wedging the FIFO
        bind = getattr(self.backend, "bind", None)
        active = self.scheduler.admit(
            can_admit=getattr(self.backend, "can_admit", None),
            on_admit=(lambda r: bind([r])) if bind is not None else None,
            servable=getattr(self.backend, "servable", None),
            on_reject=self._reject)
        n_new = len(active) - before
        if n_new:
            new_avg = sample_average_gains(self.config.channel, n_new, self.rng)
            self.avg_gains = np.concatenate([self.avg_gains, new_avg])
            self.gains = np.concatenate(
                [self.gains, sample_rayleigh_gains(new_avg, self.rng)])
            self.rates = spectrum_efficiency(self.config.channel, self.gains)
            if self.estimator is not None:
                self.estimator.extend(n_new)
            self._emit("on_admit", active[before:])
        return active

    def _reject(self, req: Request):
        """Evict a permanently-unservable request (loudly: recorded AND
        surfaced to listeners, so the gateway can answer the client)."""
        self.rejected.append(req)
        self._emit("on_reject", req)

    def leave(self, rid: int) -> Request:
        """Permanent device failure / disconnect: drop the request and its
        channel + estimator rows; the next round re-plans for survivors."""
        idx = next((i for i, r in enumerate(self.scheduler.active)
                    if r.rid == rid), None)
        if idx is None:
            raise KeyError(f"rid {rid} not in the active set")
        req = self.scheduler.active.pop(idx)
        req.done = True
        keep = np.ones(len(self.scheduler.active) + 1, dtype=bool)
        keep[idx] = False
        self._drop_rows(keep)
        self._release([req])
        return req

    def _release(self, done: list[Request]):
        """Hand retired/departed requests back to the backend (paged engines
        return their streams' pages to the pool)."""
        release = getattr(self.backend, "release", None)
        if done and release is not None:
            release(done)

    def _drop_rows(self, keep: np.ndarray):
        """Splice out the channel + estimator rows of departing devices."""
        self.avg_gains = self.avg_gains[keep]
        self.gains = self.gains[keep]
        self.rates = self.rates[keep]
        if self.estimator is not None:
            self.estimator.keep(keep)

    def _retire(self, active_reqs: list[Request], accepted: np.ndarray,
                round_time: float, participated: np.ndarray | None = None):
        self.scheduler.complete_round(accepted, round_time,
                                      participated=participated)
        keep = np.array([not r.done for r in active_reqs], dtype=bool)
        if not keep.all():
            self._drop_rows(keep)
            self._release([r for r in active_reqs if r.done])

    # ------------------------------------------------------------------
    # channel + planning view
    # ------------------------------------------------------------------

    def _refade(self):
        """New small-scale block-fading realization, same large-scale gains."""
        self.gains = sample_rayleigh_gains(self.avg_gains, self.rng)
        self.rates = spectrum_efficiency(self.config.channel, self.gains)

    @property
    def channel(self) -> ChannelState:
        """Current fading block as a ``ChannelState`` view."""
        return ChannelState(cfg=self.config.channel, avg_gains=self.avg_gains,
                            gains=self.gains, rates=self.rates)

    def load_channel(self, state: ChannelState):
        """Install an externally measured fading block for the active set
        (row-aligned).  Benchmarks replay a recorded ``ChannelState`` so a
        cell-planned round sees bit-identical rates to a direct solve."""
        active = self.admit()
        rates = np.asarray(state.rates, dtype=np.float64)
        if len(rates) != len(active):
            raise ValueError(f"channel state holds {len(rates)} devices, "
                             f"cell has {len(active)} active")
        self.avg_gains = np.asarray(state.avg_gains, dtype=np.float64).copy()
        self.gains = np.asarray(state.gains, dtype=np.float64).copy()
        self.rates = rates.copy()

    def planning_alphas(self, active_reqs: list[Request]) -> np.ndarray:
        """Acceptance rates the controller plans with: online estimates when
        enabled, else the requests' declared task profiles."""
        if self.estimator is not None:
            return self.estimator.alpha_hat
        return np.array([r.alpha for r in active_reqs])

    def _planning_view(self, refade: bool):
        active_reqs = self.admit()
        if not active_reqs:
            raise RuntimeError("plan() with no active requests")
        if refade:
            self._refade()
        t_slm = np.array([r.T_S for r in active_reqs])
        return self.planning_alphas(active_reqs), t_slm

    def plan(self, refade: bool = True):
        """Admit + refade + solve draft control for the current active set
        WITHOUT executing the round.  Analytic benchmarks and sweeps use
        this to query the configured scheme at a live channel realization
        (``refade=False`` plans at the installed fading block — see
        ``load_channel``)."""
        alphas, t_slm = self._planning_view(refade)
        return self.controller.plan(alphas, t_slm, self.rates)

    def plan_pipelined(self, refade: bool = True) -> dict:
        """Two-half-batch pipelined plan for the current active set:
        ``{goodput, period, halves: [RoundPlan]}`` (steady-state period
        ``max(T_ma, T_ver)`` per half — see ``core.beyond.pipelined_plan``)."""
        alphas, t_slm = self._planning_view(refade)
        return self.controller.plan_pipelined(alphas, t_slm, self.rates)

    # ------------------------------------------------------------------
    # the round loop
    # ------------------------------------------------------------------

    def _deadline_mask(self, per_dev_lat: np.ndarray) -> np.ndarray:
        """Straggler masking, identical for both schedules: devices whose
        draft+upload exceeds ``deadline_factor`` x the (participating-set)
        median are dropped from this round's verification.  All-dropped
        degenerates to all-kept (the round must produce something)."""
        active = np.ones(len(per_dev_lat), dtype=bool)
        if self.config.deadline_factor is not None:
            deadline = self.config.deadline_factor * np.median(per_dev_lat)
            active = per_dev_lat <= deadline
            if not active.any():
                active[:] = True
        return active

    def step(self, key=None) -> RoundRecord | None:
        """Run one protocol round (or one pipelined half-round).  Returns
        ``None`` when the cell is idle (no queued or active requests).

        With a tracer installed (``repro.obs.trace``) each round executes
        under a ``cell.step`` span whose args carry the round index, the
        participating rids, and the SIMULATED phase breakdown
        (t_draft/t_upload/t_ver/t_round) — per-request trace correlation
        keys off the rids, and summing the phase args across spans
        reproduces ``summary()``'s seconds_draft/upload/verify."""
        active_reqs = self.admit()
        if not active_reqs:
            # idle: in-flight work (pipelined trailing verification, or
            # continuous batches whose streams all departed) completes while
            # nothing overlaps it — drain it so a later resume does not
            # overlap work that already finished
            if self._pending_ver:
                # bill the drain to the scheduler too, so stats.goodput
                # agrees with summary() once the session completes
                self.scheduler.stats.wall_time += self._pending_ver
                self.scheduler.clock += self._pending_ver
            self._drained_ver += self._pending_ver
            self._pending_ver = 0.0
            self._pending_rids = set()
            if self._cont_inflight:
                self._drain_continuous()
            return None
        args = None if trace.active() is None else {
            "schedule": self.config.schedule, "scheme": self.config.scheme}
        with trace.span("cell.step", cat="cell", args=args) as sp:
            if self.config.schedule == "pipelined":
                rec = self._step_pipelined(active_reqs, key)
            elif self.config.schedule == "continuous":
                rec = self._step_continuous(active_reqs, key)
            else:
                rec = self._step_sync(active_reqs, key)
            if sp is not trace.NULL_SPAN:
                sp.set(round=len(self.history) - 1,
                       rids=[int(r) for r in rec.rids],
                       t_draft=rec.t_draft, t_upload=rec.t_upload,
                       t_ver=rec.t_ver, t_round=rec.t_round)
        return rec

    def _latency_components(self, plan, lengths: np.ndarray,
                            t_slm: np.ndarray, rates: np.ndarray):
        """``(draft, upload)`` per-device latency split: L_k T_k^S on-device
        drafting and L_k Q/(B_k r_k) uplink.  Server-drafting schemes
        (Cen-SPIN) provide their own per-device model and have no uplink to
        straggle on — their whole latency counts as the draft phase.
        Telemetry wants the phases separately (DiP-SD-style round
        breakdowns); the round loop sums them."""
        if plan.per_device_latency is not None:
            draft = np.asarray(plan.per_device_latency, dtype=np.float64)
            return draft, np.zeros_like(draft)
        bandwidth = np.asarray(plan.bandwidth, dtype=np.float64)
        lengths = np.asarray(lengths, dtype=np.float64)
        draft = lengths * np.asarray(t_slm, dtype=np.float64)
        upload = lengths * self.controller.q_tok_bits \
            / np.maximum(bandwidth * rates, 1e-9)
        return draft, upload

    def _per_device_latency(self, plan, lengths: np.ndarray,
                            t_slm: np.ndarray,
                            rates: np.ndarray) -> np.ndarray:
        """Total draft+upload latency per device (deadline masking input)."""
        draft, upload = self._latency_components(plan, lengths, t_slm, rates)
        return draft + upload

    def _pool_stats(self) -> dict | None:
        """Backend memory snapshot (paged engines: page-pool occupancy),
        None when the backend has no ``pool_stats`` hook."""
        ps = getattr(self.backend, "pool_stats", None)
        return ps() if callable(ps) else None

    def _host_syncs(self) -> int | None:
        """Blocking device->host fetches the backend's engine performed for
        the round just landed; None without host-transfer accounting."""
        v = getattr(self.backend, "last_round_host_syncs", None)
        return int(v) if v is not None else None

    def _verify(self, plan, lengths, requests, key, mask) -> np.ndarray:
        """Backend verification call; the multi-draft width J rides along
        only when the plan asks for it (custom single-draft backends keep
        the narrow signature)."""
        kw = {} if plan.draft_width == 1 else {"draft_width": plan.draft_width}
        return np.asarray(
            self.backend.verify(lengths, requests, self.rng, key=key,
                                mask=mask, **kw), dtype=np.int64)

    def _step_sync(self, active_reqs: list[Request], key=None) -> RoundRecord:
        # --- step 1: system configuration ---
        self._refade()
        t_slm = np.array([r.T_S for r in active_reqs])
        with trace.span("cell.plan", cat="cell"):
            plan = self.controller.plan(self.planning_alphas(active_reqs),
                                        t_slm, self.rates)
        lengths = np.asarray(plan.lengths, dtype=np.int64)
        bandwidth = np.asarray(plan.bandwidth, dtype=np.float64)

        # --- steps 2-3: drafting + upload latency (straggler-limited) ---
        draft_lat, upload_lat = self._latency_components(plan, lengths, t_slm,
                                                         self.rates)
        per_dev_lat = draft_lat + upload_lat
        active = self._deadline_mask(per_dev_lat)
        t_ma = float(np.max(per_dev_lat[active]))

        # --- step 4: batched verification (pluggable backend) ---
        K_active = int(active.sum())
        t_ver = (float(plan.t_ver) if plan.t_ver is not None
                 else self.controller.t_ver_model(K_active))
        with trace.span("cell.verify", cat="cell"):
            accepted = self._verify(plan, lengths, active_reqs, key, active)
        accepted = np.where(active, accepted, 0)

        # --- step 5: feedback / estimator update (active devices only:
        # a deadline-dropped device reported nothing, not a rejection) ---
        if self.estimator is not None:
            self.estimator.update(np.maximum(accepted - 1, 0), lengths,
                                  mask=active)

        t_round = t_ma + t_ver
        rec = RoundRecord(
            lengths=lengths, bandwidth=bandwidth, accepted=accepted,
            t_ma=t_ma, t_ver=t_ver, t_round=t_round,
            predicted_goodput=plan.goodput,
            realized_goodput=float(np.sum(accepted) / t_round),
            active=active,
            rids=np.array([r.rid for r in active_reqs]),
            draft_width=int(plan.draft_width),
            t_draft=float(np.max(draft_lat[active])),
            t_upload=float(np.max(upload_lat[active])),
            queue_depth=len(self.scheduler.queue),
            batch_occupancy=float(active.sum()) / self.config.max_batch,
        )
        self.history.append(rec)
        self._round_idx += 1
        self._retire(active_reqs, accepted, t_round)
        rec.pool_stats = self._pool_stats()
        rec.n_host_syncs = self._host_syncs()
        self._emit("on_round", rec)
        return rec

    def _step_pipelined(self, active_reqs: list[Request],
                        key=None) -> RoundRecord:
        """Beyond-paper pipelined schedule: while one half-batch drafts and
        uploads, the server verifies the other half; wall-clock per half-round
        is max(T_ma(current half), T_ver(other half)).  Works with any
        backend (the legacy ``run_pipelined`` was a synthetic-only fork)."""
        K = len(active_reqs)
        self._refade()
        alphas_all = self.planning_alphas(active_reqs)
        t_slm_all = np.array([r.T_S for r in active_reqs])
        order = np.argsort([r.alpha for r in active_reqs], kind="stable")
        halves = [order[0::2], order[1::2]]
        h = halves[self._pipe_parity % 2]
        if len(h) == 0:
            h = halves[0]
        self._pipe_parity += 1

        with trace.span("cell.plan", cat="cell"):
            plan = self.controller.plan(alphas_all[h], t_slm_all[h],
                                        self.rates[h])
        lengths_h = np.asarray(plan.lengths, dtype=np.int64)
        bandwidth_h = np.asarray(plan.bandwidth, dtype=np.float64)
        draft_h, upload_h = self._latency_components(plan, lengths_h,
                                                     t_slm_all[h],
                                                     self.rates[h])
        per_dev = draft_h + upload_h
        # straggler masking within the half — same policy as the sync
        # schedule (this previously ignored deadline_factor entirely)
        ok_h = self._deadline_mask(per_dev)
        t_ma = float(np.max(per_dev[ok_h]))
        h_rids = {active_reqs[j].rid for j in h}
        if self._pending_rids & h_rids:
            # a device in this half still awaits its own verification
            # (K == 1, or churn reshuffled the halves): it cannot draft
            # before that result returns, so this step runs serial
            step_time = t_ma + self._pending_ver
        else:
            # overlap with the OTHER half's verification still in flight
            step_time = max(t_ma, self._pending_ver)
        # like the sync schedule, verification is billed for the deadline
        # SURVIVORS only (dropped devices uploaded nothing to verify)
        t_ver = (float(plan.t_ver) if plan.t_ver is not None
                 else self.controller.t_ver_model(int(ok_h.sum())))
        self._pending_ver = t_ver
        self._pending_rids = h_rids

        with trace.span("cell.verify", cat="cell"):
            accepted_h = self._verify(plan, lengths_h,
                                      [active_reqs[j] for j in h], key, ok_h)
        accepted_h = np.where(ok_h, accepted_h, 0)

        participated = np.zeros(K, dtype=bool)
        participated[h] = True                 # drafted this half-round
        mask = np.zeros(K, dtype=bool)
        mask[h] = ok_h                         # ... and met the deadline
        accepted = np.zeros(K, dtype=np.int64)
        accepted[h] = accepted_h
        lengths = np.zeros(K, dtype=np.int64)
        lengths[h] = lengths_h
        bandwidth = np.zeros(K, dtype=np.float64)
        bandwidth[h] = bandwidth_h
        if self.estimator is not None:
            self.estimator.update(np.maximum(accepted - 1, 0),
                                  np.maximum(lengths, 1), mask=mask)

        rec = RoundRecord(
            lengths=lengths, bandwidth=bandwidth, accepted=accepted,
            t_ma=t_ma, t_ver=t_ver, t_round=step_time,
            predicted_goodput=plan.goodput,
            realized_goodput=float(np.sum(accepted) / step_time),
            active=mask,
            rids=np.array([r.rid for r in active_reqs]),
            draft_width=int(plan.draft_width),
            t_draft=float(np.max(draft_h[ok_h])),
            t_upload=float(np.max(upload_h[ok_h])),
            queue_depth=len(self.scheduler.queue),
            batch_occupancy=float(mask.sum()) / self.config.max_batch,
        )
        self.history.append(rec)
        self._round_idx += 1
        self._retire(active_reqs, accepted, step_time,
                     participated=participated)
        rec.pool_stats = self._pool_stats()
        rec.n_host_syncs = self._host_syncs()
        self._emit("on_round", rec)
        return rec

    def _step_continuous(self, active_reqs: list[Request],
                         key=None) -> RoundRecord:
        """Continuous batching: per-stream rounds with no cohort barrier.

        Event-driven simulated timeline, one committed verification batch
        per ``step``:

          1. every stream not already drafting/in-flight dispatches its next
             draft NOW (planned by the configured scheme over exactly that
             subset) and becomes READY at ``now + draft + upload``;
          2. while fewer than ``max_inflight`` batches are in flight, the
             (sequential) verification server packs a batch from whichever
             streams are READY when it frees up — at most ``max_batch``,
             earliest-ready first — and dispatches it; with a
             ``ContinuousBackend`` the dispatch is genuinely asynchronous
             (``verify_async``; results land in step 3);
          3. the earliest-finishing batch commits: the clock jumps to its
             completion, its streams' tokens are accepted, and those streams
             re-enter drafting on the next step.

        ``t_round`` is the inter-commit gap, so ``summary()`` wall-clock
        telescopes to the timeline's end exactly like the other schedules.
        A slow drafter now delays only its own stream — the batch occupancy
        / goodput trade is visible per record (``batch_occupancy``,
        ``ready_depth``)."""
        rid_to_i = {r.rid: i for i, r in enumerate(active_reqs)}
        # drop READY bookkeeping of departed streams (leave() mid-draft)
        self._cont_ready = {rid: e for rid, e in self._cont_ready.items()
                            if rid in rid_to_i}
        busy = set(self._cont_ready)
        for b in self._cont_inflight:
            busy.update(b["rids"])

        # --- 1. dispatch drafting for every idle stream -----------------
        starters = [i for i, r in enumerate(active_reqs) if r.rid not in busy]
        if starters:
            self._refade()
            alphas = self.planning_alphas(active_reqs)
            t_slm = np.array([r.T_S for r in active_reqs])
            sub = np.asarray(starters)
            with trace.span("cell.plan", cat="cell"):
                plan = self.controller.plan(alphas[sub], t_slm[sub],
                                            self.rates[sub])
            lengths = np.asarray(plan.lengths, dtype=np.int64)
            bw = np.asarray(plan.bandwidth, dtype=np.float64)
            draft, upload = self._latency_components(
                plan, lengths, t_slm[sub], self.rates[sub])
            for j, i in enumerate(starters):
                self._cont_ready[active_reqs[i].rid] = {
                    "ready_at": self._cont_now + draft[j] + upload[j],
                    "length": int(lengths[j]), "bw": float(bw[j]),
                    "draft": float(draft[j]), "upload": float(upload[j]),
                    "predicted": float(plan.goodput),
                }

        # --- 2. assemble + dispatch verification batches ----------------
        while (self._cont_ready
               and len(self._cont_inflight) < self.config.max_inflight):
            t_start = max(min(e["ready_at"]
                              for e in self._cont_ready.values()),
                          self._cont_server_free)
            members = sorted(
                (rid for rid, e in self._cont_ready.items()
                 if e["ready_at"] <= t_start),
                key=lambda rid: (self._cont_ready[rid]["ready_at"], rid),
            )[:self.config.max_batch]
            entries = [self._cont_ready.pop(rid) for rid in members]
            reqs = [active_reqs[rid_to_i[rid]] for rid in members]
            lens = np.array([e["length"] for e in entries], dtype=np.int64)
            t_ver = self.controller.t_ver_model(len(members))
            args = None if trace.active() is None else {
                "K": len(members), "rids": [int(r) for r in members],
                "ready_depth": len(self._cont_ready)}
            with trace.span("cell.dispatch", cat="cell", args=args):
                verify_async = getattr(self.backend, "verify_async", None)
                if verify_async is not None:
                    handle, accepted = verify_async(lens, reqs, self.rng,
                                                    key=key), None
                else:
                    handle, accepted = None, np.asarray(
                        self.backend.verify(lens, reqs, self.rng, key=key),
                        dtype=np.int64)
            self._cont_server_free = t_start + t_ver
            self._cont_inflight.append({
                "rids": list(members), "lengths": lens,
                "bw": np.array([e["bw"] for e in entries]),
                "t_ver": float(t_ver), "done_at": t_start + t_ver,
                "t_draft": max(e["draft"] for e in entries),
                "t_upload": max(e["upload"] for e in entries),
                "t_ma": max(e["draft"] + e["upload"] for e in entries),
                "predicted": float(np.mean([e["predicted"]
                                            for e in entries])),
                "ready_depth": len(self._cont_ready),
                "handle": handle, "accepted": accepted,
            })

        # --- 3. commit the earliest-finishing batch ---------------------
        batch = min(self._cont_inflight, key=lambda b: b["done_at"])
        self._cont_inflight.remove(batch)
        self._cont_now = batch["done_at"]
        t_round = self._cont_now - self._cont_last_commit
        self._cont_last_commit = self._cont_now
        if batch["accepted"] is None:
            with trace.span("cell.verify", cat="cell"):
                acc_members = np.asarray(self.backend.collect(batch["handle"]),
                                         dtype=np.int64)
        else:
            acc_members = batch["accepted"]

        K = len(active_reqs)
        accepted = np.zeros(K, dtype=np.int64)
        lengths = np.zeros(K, dtype=np.int64)
        bandwidth = np.zeros(K, dtype=np.float64)
        participated = np.zeros(K, dtype=bool)
        for j, rid in enumerate(batch["rids"]):
            i = rid_to_i.get(rid)
            if i is None:           # departed mid-verify: tokens discarded
                continue
            accepted[i] = acc_members[j]
            lengths[i] = batch["lengths"][j]
            bandwidth[i] = batch["bw"][j]
            participated[i] = True
        if self.estimator is not None:
            self.estimator.update(np.maximum(accepted - 1, 0),
                                  np.maximum(lengths, 1), mask=participated)

        rec = RoundRecord(
            lengths=lengths, bandwidth=bandwidth, accepted=accepted,
            t_ma=float(batch["t_ma"]), t_ver=batch["t_ver"],
            t_round=float(t_round),
            predicted_goodput=batch["predicted"],
            realized_goodput=float(np.sum(accepted) / t_round)
            if t_round > 0 else 0.0,
            active=participated,
            rids=np.array([r.rid for r in active_reqs]),
            t_draft=float(batch["t_draft"]),
            t_upload=float(batch["t_upload"]),
            queue_depth=len(self.scheduler.queue),
            batch_occupancy=len(batch["rids"]) / self.config.max_batch,
            ready_depth=int(batch["ready_depth"]),
        )
        self.history.append(rec)
        self._round_idx += 1
        self._retire(active_reqs, accepted, float(t_round),
                     participated=participated)
        rec.pool_stats = self._pool_stats()
        rec.n_host_syncs = self._host_syncs()
        self._emit("on_round", rec)
        return rec

    def _drain_continuous(self):
        """Every stream departed with verification batches still in flight:
        land them (returning engine results to the host) and bill the
        trailing timeline so ``summary()`` and the scheduler agree."""
        t_end = max(b["done_at"] for b in self._cont_inflight)
        for b in self._cont_inflight:
            if b["accepted"] is None:
                self.backend.collect(b["handle"])
        extra = max(0.0, t_end - self._cont_last_commit)
        self.scheduler.stats.wall_time += extra
        self.scheduler.clock += extra
        self._drained_ver += extra
        self._cont_inflight = []
        self._cont_ready = {}
        self._cont_now = max(self._cont_now, t_end)
        self._cont_last_commit = self._cont_now

    # ------------------------------------------------------------------
    # driving loops
    # ------------------------------------------------------------------

    def run(self, n_rounds: int | None = None) -> dict:
        """Run up to ``n_rounds`` rounds (or until idle when ``None``)."""
        i = 0
        while n_rounds is None or i < n_rounds:
            if self.step() is None:
                break
            i += 1
        return self.summary()

    def drain(self) -> dict:
        """Run until every submitted request has retired."""
        return self.run(None)

    @property
    def idle(self) -> bool:
        return self.scheduler.idle

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------

    def summary(self) -> dict:
        """Protocol-level accounting over all executed rounds.

        Goodput has TWO legitimate views and this is the one place exposing
        both (telemetry reports them side by side rather than two subtly
        different numbers from two code paths):

        * ``goodput_committed`` (alias ``goodput``) — every token the
          protocol committed (``RoundRecord.accepted``, bonus included,
          even past a request's ``max_new_tokens`` budget in its final
          round) over the protocol wall-clock INCLUDING the pipelined
          trailing-verification drain.  The paper's protocol-efficiency
          view.
        * ``goodput_capped`` — ``scheduler.stats``' per-request view: each
          request stops counting at its ``max_new_tokens`` budget, over the
          scheduler's billed wall time (idle drains are billed there too,
          so for a completed session the denominators agree and any gap is
          purely the final-round overshoot in the numerator).  The
          user-visible serving throughput.

        ``seconds_draft``/``seconds_upload``/``seconds_verify`` sum the
        per-phase maxima across rounds (phases overlap across devices, so
        draft+upload >= the multi-access wall share)."""
        total_tokens = float(sum(np.sum(r.accepted) for r in self.history))
        total_time = float(sum(r.t_round for r in self.history))
        total_time += self._pending_ver + self._drained_ver
        goodput = total_tokens / total_time if total_time else 0.0
        out = {
            "rounds": len(self.history),
            "tokens": total_tokens,
            "seconds": total_time,
            "goodput": goodput,
            "goodput_committed": goodput,
            "goodput_capped": self.scheduler.stats.goodput,
            "seconds_draft": float(sum(r.t_draft for r in self.history)),
            "seconds_upload": float(sum(r.t_upload for r in self.history)),
            "seconds_verify": float(sum(r.t_ver for r in self.history)),
        }
        if self.history:
            out["mean_predicted_goodput"] = float(np.mean(
                [r.predicted_goodput for r in self.history]))
        return out

    # ------------------------------------------------------------------
    # fault tolerance: checkpoint/restore of the protocol state
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "round_idx": self._round_idx,
            "avg_gains": np.asarray(self.avg_gains).copy(),
            "alpha_hat": (self.estimator.alpha_hat
                          if self.estimator is not None else None),
        }

    def load_state_dict(self, state: dict):
        self.admit()
        avg = np.asarray(state["avg_gains"], dtype=np.float64)
        if len(avg) != len(self.scheduler.active):
            raise ValueError(
                f"checkpoint holds {len(avg)} devices, cell has "
                f"{len(self.scheduler.active)} active")
        self._round_idx = state["round_idx"]
        self.avg_gains = avg.copy()
        self._refade()
        if state.get("alpha_hat") is not None and self.estimator is not None:
            self.estimator.alpha_hat = state["alpha_hat"]
