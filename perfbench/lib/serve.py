"""One cell of the benchmark: the port's Multi-SPIN cell serving a closed
loop of edge devices, from set-up through the measured window.

The path under test is the program's own: ``MultiSpinCell.step`` ->
``EngineBackend.verify`` -> ``SpecEngine`` on a paged cache (admission
through ``add_streams``, the round's draft, verify and commit steps through
``serving/compiled.py``, ``retire_stream`` at completion).  The benchmark
gives it weights, prompts and the round draws, all from the seed, and reads
its records, spans and counters.

Set-up: weights on the device, the engine, each device's first request
admitted by the cell's first round, the prefill shapes the mix reaches and
the compiled steps at (K, L) for L = 1 .. L_max built.  The window then
runs rounds until ``seconds`` have passed; each round is timed on the host
clock and ends in the engine's one host sync (the commit's fetch).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from . import weights
from .config import models
from .seeds import derive
from .traffic import Traffic

_TINY = torch.finfo(torch.float32).tiny
SYNCED_SPANS = frozenset({"engine.draft", "engine.verify_step",
                          "engine.commit"})


def _gumbel(gen, shape, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device).clamp_(min=_TINY)
    return -torch.log(-torch.log(u))


class Draws:
    """The engine's ``draws_fn``: one round's draws from the round's seed,
    on the device.  Greedy rows get zero noise and accept uniforms of 0:
    every draft token is then accepted (p_target > 0), drafts are the
    draft's argmax and the bonus token the target's.  ``log`` keeps
    (seed, B, L) of every round, so the check can draw ``u_resid`` again:
    it is the first draw of the round's generator."""

    def __init__(self, device, greedy_rows):
        self.device = torch.device(device)
        self.greedy_rows = greedy_rows
        self.log: list[tuple[int, int, int]] = []
        self._mask_key = None
        self._mask = None

    def _mask_for(self, rows: frozenset, B: int) -> torch.Tensor:
        if self._mask_key != (rows, B):
            host = torch.zeros(B, dtype=torch.bool)
            host[sorted(rows)] = True
            if self.device.type == "cuda":
                host = host.pin_memory()
            self._mask = host.to(self.device, non_blocking=True)
            self._mask_key = (rows, B)
        return self._mask

    @staticmethod
    def u_resid(seed: int, B: int, device) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        return torch.rand(B, generator=gen, device=device)

    def __call__(self, seed, B, L, vhat, V):
        from repro_torch.core.draws import RoundDraws

        self.log.append((int(seed), int(B), int(L)))
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        u_resid = torch.rand(B, generator=gen, device=dev)
        u_accept = torch.rand((B, L), generator=gen, device=dev)
        g_draft = _gumbel(gen, (L, B, vhat), dev)
        g_bonus = _gumbel(gen, (B, V), dev)
        rows = self.greedy_rows()
        if rows:
            m = self._mask_for(rows, B)
            u_accept.masked_fill_(m[:, None], 0.0)
            g_draft.masked_fill_(m[None, :, None], 0.0)
            g_bonus.masked_fill_(m[:, None], 0.0)
        return RoundDraws(draft_gumbel=g_draft, u_accept=u_accept,
                          u_resid=u_resid, bonus_gumbel=g_bonus)


@dataclasses.dataclass
class Tracked:
    """The benchmark's view of one request."""

    req: object
    spec: object
    submit_t: float
    row: int | None = None
    ttft: float | None = None
    first_round: int | None = None
    finished: bool = False


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CellRun:
    """Set-up and window of one cell for one seed."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 cache_dir: str | None):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = torch.device(device)
        self.cache_dir = cache_dir
        self.dep = cfg["deployment"]
        self.target, self.draft = models(cfg)
        self.reqs: dict[int, Tracked] = {}
        self.greedy_active: set[int] = set()
        self.admits: list[tuple[int, int, float]] = []
        self._rid = 0

    # -- requests -----------------------------------------------------------

    def _request(self, spec):
        from repro_torch.serving.scheduler import Request

        rid = self._rid
        self._rid += 1
        req = Request(rid=rid, prompt_len=spec.prompt_len,
                      max_new_tokens=spec.max_new_tokens,
                      alpha=float(self.traffic.alpha[spec.device]),
                      T_S=float(self.traffic.T_S[spec.device]),
                      prompt=self.traffic.prompt(spec))
        return req

    def _submit(self, spec) -> None:
        req = self._request(spec)
        self.reqs[req.rid] = Tracked(req=req, spec=spec,
                                     submit_t=time.perf_counter())
        if spec.greedy:
            self.greedy_active.add(req.rid)
        self.cell.submit(req)

    def _greedy_rows(self) -> frozenset:
        """Rows of the active greedy requests.  Called at draw time, after
        the round's admissions and before its releases, it also books each
        request's engine row from the backend's row map (rid -> row)."""
        rows = self.backend._row_of
        for rid, row in rows.items():
            tr = self.reqs.get(rid)
            if tr is not None and tr.row is None:
                tr.row = row
        return frozenset(rows[r] for r in self.greedy_active if r in rows)

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.serving.backends import EngineBackend
        from repro_torch.serving.cell import CellConfig, MultiSpinCell
        from repro_torch.serving.spec_engine import SpecEngine

        dev, dep, mix = self.device, self.dep, self.mix
        self.traffic = Traffic(mix, self.seed,
                               token_limit=self.cfg["assumed"]["token_id_limit"],
                               max_len=mix["max_len"])
        K, max_len, ps = self.traffic.K, int(mix["max_len"]), int(dep["page_size"])
        (at, tm), (ad, dm) = self.target, self.draft
        self.raw_t = weights.make(self.target, self.seed, "target", dev)
        self.raw_d = weights.make(self.draft, self.seed, "draft", dev)
        self.num_pages = K * math.ceil(max_len / ps)
        engine = SpecEngine(at.port_config(tm), ad.port_config(dm),
                            max_len=max_len, cache_dtype=torch.bfloat16,
                            cache_kind="paged", page_size=ps,
                            num_pages=self.num_pages,
                            compile_mode=dep["compile_mode"],
                            compile_cache=self.cache_dir, device=dev)
        engine.t_params = at.port_tree(tm, self.raw_t)
        engine.d_params = ad.port_tree(dm, self.raw_d)
        self.engine = engine
        first = self.traffic.initial()
        # the first request's stream: the start row its admission binds to
        state = engine.start(torch.tensor([self.traffic.prompt(first[0])],
                                          dtype=torch.int32, device=dev))
        # the prefill shapes the mix reaches, on a page table of -1 rows
        # (every write goes to the pools' drop slot)
        pt = torch.full((1, engine.pages_per_stream), -1, dtype=torch.int32,
                        device=dev)
        for b in self.traffic.prefill_buckets(engine.prompt_bucket):
            toks = torch.zeros((1, b - 1), dtype=torch.int32, device=dev)
            engine.target.prefill(engine.t_params, toks,
                                  dict(engine.t_cache, pages=pt))
            engine.draft.prefill(engine.d_params, toks,
                                 dict(engine.d_cache, pages=pt))
        self.draws = Draws(dev, self._greedy_rows)
        self.backend = EngineBackend(engine, state, vhat=int(dep["vhat"]),
                                     keep_finished_tokens=True,
                                     draws_fn=self.draws)
        self.cell = MultiSpinCell(CellConfig(
            scheme=dep["scheme"], max_batch=K, L_max=int(dep["L_max"]),
            use_estimator=False, schedule="sync",
            seed=derive(self.seed, "cell")), self.backend)
        for spec in first:
            self._submit(spec)
        rec = self.cell.step()
        self._after_round(rec, time.perf_counter())
        if engine.compile_mode != "eager":
            self.backend.state, self.warm = engine.warmup(
                self.backend.state,
                [(self.backend.batch_size, L)
                 for L in range(1, int(dep["L_max"]) + 1)])
        _sync(dev)
        self.captures_at_window = self._captures()

    def _captures(self) -> int:
        return sum(v["captures"] for v in self.engine.step_counts().values())

    # -- rounds ---------------------------------------------------------------

    def _after_round(self, rec, t: float) -> None:
        """Book the round: rows, first tokens, completions; a device whose
        request finished sends its next one at once (no think time)."""
        r = len(self.cell.history) - 1
        for rid in rec.rids:
            tr = self.reqs[int(rid)]
            if tr.ttft is None:
                tr.ttft = t - tr.submit_t
                tr.first_round = r
            if tr.req.done and not tr.finished:
                tr.finished = True
                self.greedy_active.discard(tr.req.rid)
                nxt = self.traffic.next(tr.spec.device)
                if nxt is not None:
                    self._submit(nxt)

    def round(self):
        from repro_torch.obs import trace

        t0 = time.perf_counter()
        rec = self.cell.step()
        t1 = time.perf_counter()
        with trace.span("bench.book", cat="bench"):
            self._after_round(rec, t1)
        return rec, t0, t1

    def window(self, seconds: float, max_rounds: int | None = None) -> dict:
        """Rounds until ``seconds`` have passed (or ``max_rounds`` ran)."""
        stats = self.cell.scheduler.stats
        _sync(self.device)
        tok0 = stats.total_tokens
        r0 = len(self.cell.history)
        t_start = time.perf_counter()
        times = []
        while True:
            rec, t0, t1 = self.round()
            times.append(t1 - t0)
            if t1 - t_start >= seconds or (max_rounds
                                           and len(times) >= max_rounds):
                break
        t_end = time.perf_counter()
        ttft = [tr.ttft for tr in self.reqs.values()
                if tr.first_round is not None and tr.first_round >= r0]
        served = {int(rid) for rec in self.cell.history[r0:]
                  for rid in rec.rids}
        return {"seconds": t_end - t_start, "round_s": times,
                "tokens": stats.total_tokens - tok0, "ttft_s": ttft,
                "rounds": (r0, len(self.cell.history)),
                "attempted": len(served),
                "failed": len(self.cell.rejected),
                "captures": self._captures() - self.captures_at_window}

    # -- the traced run's instruments ------------------------------------------

    def wrap_admission(self) -> None:
        """Time each admission (``engine.add_streams``) to its end on the
        device: the benchmark's own wrapper and span, on the traced run
        only; ``admit_sync = False`` keeps the span and drops the
        synchronise (the profiled stretch)."""
        from repro_torch.obs import trace

        engine = self.engine
        inner = engine.add_streams
        self.admit_sync = True

        def timed(state, prompts):
            t0 = time.perf_counter()
            with trace.span("bench.admit", cat="bench"):
                out = inner(state, prompts)
                if not self.admit_sync:
                    return out
                _sync(self.device)
            n, M = (int(s) for s in torch.as_tensor(prompts).shape)
            self.admits.append((M, engine.prompt_bucket(M),
                                time.perf_counter() - t0))
            return out

        engine.add_streams = timed

    def round_rows(self, rec) -> dict:
        """Per round: each active row's offset before the round, the
        window L and the admissions' prefill buckets (from the host's
        committed lists: no device read)."""
        committed = self.backend.state.committed
        r = len(self.cell.history) - 1
        pos, buckets = [], []
        for i, rid in enumerate(rec.rids):
            tr = self.reqs[int(rid)]
            pos.append(len(committed[tr.row]) - 1 - int(rec.accepted[i]))
            if tr.first_round == r:
                buckets.append(self.engine.prompt_bucket(tr.req.prompt_len))
        return {"pos": pos, "lengths": [int(x) for x in rec.lengths],
                "L": int(np.max(rec.lengths)), "buckets": buckets,
                "prompts": [self.reqs[int(rid)].req.prompt_len
                            for rid in rec.rids
                            if self.reqs[int(rid)].first_round == r]}
