"""Concurrent-client load generator for the Multi-SPIN gateway.

Two loop disciplines, selected by ``LoadGenConfig.mode``:

* ``"open"`` — arrivals are INDEPENDENT of service: request k is fired at
  the k-th point of a Poisson process regardless of how many earlier
  requests are still in flight, so queueing delay shows up in the measured
  TTFT/latency instead of being hidden by a feedback loop.  The right model
  for externally driven traffic (rate sweeps, overload probing).
* ``"closed"`` — ``n_clients`` PERSISTENT clients each hold one SSE session
  at a time: finish a request, think for ``think_time_s`` (exponential,
  like classic closed-loop generators), fire the next, until the shared
  budget of ``n_requests`` is spent.  Concurrency is pinned at
  ``n_clients`` by construction — the steady-state regime the
  continuous-batching engine overlaps rounds under, and the harness
  ``bench_continuous`` drives (real concurrent clients replacing the old
  one-shot burst).

Per request we draw a prompt length and a token budget from configured
choice sets, tag an optional deadline, and drive one SSE session through
``GatewayClient``.  Reported: per-request TTFT (send -> first round event,
REAL wall seconds) and end-to-end latency percentiles, sum goodput
(streamed tokens / wall), deadline hit counts, and error counts
(ROADMAP items 2-3; WISP motivates the per-stream SLO view).

Stdlib only (asyncio + random).
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import time

from repro_torch.serving.gateway.client import GatewayClient


def percentile(xs, q: float) -> float:
    """Linear-interpolation percentile (numpy's default method) over an
    already-or-not sorted sequence; pure python so the gateway stack stays
    stdlib-only.  ``q`` in [0, 100]."""
    if not xs:
        raise ValueError("percentile of empty sequence")
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    rank = (q / 100.0) * (len(s) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    frac = rank - lo
    return float(s[lo] * (1.0 - frac) + s[hi] * frac)


def summarize(xs) -> dict:
    """{p50, p90, p95, p99, mean, max, n} of a latency sample (empty-safe)."""
    if not xs:
        return {"p50": 0.0, "p90": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0,
                "max": 0.0, "n": 0}
    return {
        "p50": percentile(xs, 50), "p90": percentile(xs, 90),
        "p95": percentile(xs, 95), "p99": percentile(xs, 99),
        "mean": sum(xs) / len(xs),
        "max": float(max(xs)), "n": len(xs),
    }


@dataclasses.dataclass
class LoadGenConfig:
    mode: str = "open"                      # "open" | "closed"
    rate_per_s: float = 8.0                 # open: Poisson arrival rate
    n_clients: int = 4                      # closed: persistent SSE clients
    # closed: mean exponential think time between one client's requests
    # (0 = back-to-back)
    think_time_s: float = 0.0
    n_requests: int = 16                    # total budget, both modes
    prompt_len_choices: tuple = (8, 12, 16)
    max_new_tokens_choices: tuple = (8, 16, 32)
    alpha_choices: tuple = (0.71, 0.74, 0.86)
    T_S: float = 0.009
    T_S_jitter: tuple = (0.85, 1.15)        # uniform factor on T_S
    deadline_s: float | None = None         # per-request SLO tag (real wall)
    timeout_s: float = 120.0                # per-request hard abort
    seed: int = 0


@dataclasses.dataclass
class RequestRecord:
    idx: int
    rid: int | None
    arrival_s: float                        # scheduled arrival offset
    ttft_s: float | None
    latency_s: float | None
    tokens: int
    rounds: int
    deadline_s: float | None
    deadline_met: bool | None
    error: str | None


async def _one_request(client: GatewayClient, cfg: LoadGenConfig,
                       rng: random.Random, idx: int,
                       arrival_s: float) -> RequestRecord:
    fields = dict(
        prompt_len=rng.choice(cfg.prompt_len_choices),
        max_new_tokens=rng.choice(cfg.max_new_tokens_choices),
        alpha=rng.choice(cfg.alpha_choices),
        T_S=cfg.T_S * rng.uniform(*cfg.T_S_jitter),
        tag=f"loadgen-{idx}",
    )
    rec = RequestRecord(idx=idx, rid=None, arrival_s=arrival_s, ttft_s=None,
                        latency_s=None, tokens=0, rounds=0,
                        deadline_s=cfg.deadline_s, deadline_met=None,
                        error=None)
    try:
        res = await asyncio.wait_for(client.generate(**fields),
                                     timeout=cfg.timeout_s)
    except asyncio.TimeoutError:
        rec.error = "timeout"
        return rec
    except (OSError, ConnectionError) as e:
        rec.error = f"{type(e).__name__}: {e}"
        return rec
    rec.rid = res.rid
    rec.ttft_s = res.ttft_s
    rec.latency_s = res.latency_s
    rec.tokens = len(res.tokens)
    rec.rounds = res.n_rounds
    rec.error = res.error
    if cfg.deadline_s is not None and res.latency_s is not None:
        rec.deadline_met = res.latency_s <= cfg.deadline_s
    return rec


async def _run_open(client: GatewayClient, cfg: LoadGenConfig,
                    rng: random.Random, t0: float) -> list[RequestRecord]:
    # draw ALL arrival offsets up front (open loop: the schedule does not
    # depend on service times)
    arrivals, t = [], 0.0
    for _ in range(cfg.n_requests):
        t += rng.expovariate(cfg.rate_per_s)
        arrivals.append(t)

    async def fire(idx, arrival):
        await asyncio.sleep(max(0.0, arrival - (time.monotonic() - t0)))
        per_req_rng = random.Random(cfg.seed * 100003 + idx)
        return await _one_request(client, cfg, per_req_rng, idx, arrival)

    return list(await asyncio.gather(
        *(fire(i, a) for i, a in enumerate(arrivals))))


async def _run_closed(client: GatewayClient, cfg: LoadGenConfig,
                      rng: random.Random, t0: float) -> list[RequestRecord]:
    # n_clients persistent workers share one request counter: each holds at
    # most one SSE session, thinks, then takes the next index — fixed
    # concurrency, service-dependent arrivals (the closed-loop discipline)
    counter = {"next": 0}
    records: list[RequestRecord] = []

    async def worker(c: int):
        think_rng = random.Random(cfg.seed * 7919 + c)
        while True:
            idx = counter["next"]
            if idx >= cfg.n_requests:
                return
            counter["next"] = idx + 1
            per_req_rng = random.Random(cfg.seed * 100003 + idx)
            records.append(await _one_request(
                client, cfg, per_req_rng, idx,
                arrival_s=time.monotonic() - t0))
            if cfg.think_time_s > 0 and counter["next"] < cfg.n_requests:
                await asyncio.sleep(
                    think_rng.expovariate(1.0 / cfg.think_time_s))

    await asyncio.gather(*(worker(c)
                           for c in range(max(1, cfg.n_clients))))
    records.sort(key=lambda r: r.idx)
    return records


async def run_loadgen(host: str, port: int,
                      cfg: LoadGenConfig | None = None) -> dict:
    """Drive the configured load at a live gateway; returns the report."""
    cfg = cfg or LoadGenConfig()
    if cfg.mode not in ("open", "closed"):
        raise ValueError(f"mode must be 'open' or 'closed', got {cfg.mode!r}")
    rng = random.Random(cfg.seed)
    client = GatewayClient(host, port)
    t0 = time.monotonic()
    if cfg.mode == "closed":
        records = await _run_closed(client, cfg, rng, t0)
    else:
        records = await _run_open(client, cfg, rng, t0)
    wall = time.monotonic() - t0

    ok = [r for r in records if r.error is None]
    report = {
        "mode": cfg.mode,
        "n_clients": cfg.n_clients if cfg.mode == "closed" else None,
        "n_requests": cfg.n_requests,
        "n_ok": len(ok),
        "n_error": len(records) - len(ok),
        "errors": sorted({r.error for r in records if r.error}),
        "wall_s": wall,
        "tokens": sum(r.tokens for r in records),
        "tokens_per_s": sum(r.tokens for r in records) / wall if wall else 0.0,
        "ttft_s": summarize([r.ttft_s for r in ok if r.ttft_s is not None]),
        "latency_s": summarize(
            [r.latency_s for r in ok if r.latency_s is not None]),
        "records": [dataclasses.asdict(r) for r in records],
    }
    if cfg.deadline_s is not None:
        tagged = [r for r in ok if r.deadline_met is not None]
        report["deadline_s"] = cfg.deadline_s
        report["deadline_met"] = sum(r.deadline_met for r in tagged)
        report["deadline_missed"] = sum(not r.deadline_met for r in tagged)
    return report
