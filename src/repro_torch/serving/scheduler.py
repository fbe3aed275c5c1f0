"""Round-granular request scheduler for the Multi-SPIN cell.

The paper's protocol serves K devices per round; real cells have churn:
requests finish (EOS / max_tokens) and new devices join.  The scheduler keeps
the verification batch full (continuous batching at ROUND granularity — the
natural analogue of token-level continuous batching under synchronized
batched verification), tracks per-request accounting, and exposes the
device-profile view the controller plans against.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    task: str = ""
    alpha: float = 0.8            # task-profile acceptance estimate
    T_S: float = 0.03             # device compute speed
    prompt: tuple | None = None   # prompt tokens (engine-backed admission
                                  # after start(); None -> synthetic prompt)
    generated: int = 0
    rounds: int = 0
    done: bool = False
    submit_time: float = 0.0
    first_token_time: float = 0.0  # clock at first committed token (TTFT)
    finish_time: float = 0.0


@dataclasses.dataclass
class SchedulerStats:
    completed: int = 0
    total_tokens: int = 0
    total_rounds: int = 0
    wall_time: float = 0.0
    # per-request time-to-first-token in SIMULATED seconds (queue wait +
    # the rounds until the first commit), appended as each request first
    # produces; telemetry reports percentiles over this
    ttft_s: list = dataclasses.field(default_factory=list)
    # head-of-line blocking: the longest any SERVABLE request has so far
    # waited at the FIFO head (simulated seconds).  Capacity-blocked heads
    # hold the whole queue behind them — this is the tail cost the
    # continuous engine's per-stream rounds attack; unservable heads are
    # evicted and never counted
    hol_wait_max: float = 0.0

    @property
    def goodput(self) -> float:
        return self.total_tokens / self.wall_time if self.wall_time else 0.0


class RoundScheduler:
    """Admission + retirement around the Multi-SPIN round loop."""

    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self.queue: deque[Request] = deque()
        self.active: list[Request] = []
        self.stats = SchedulerStats()
        self.clock = 0.0

    def submit(self, req: Request):
        req.submit_time = self.clock
        self.queue.append(req)

    def admit(self, can_admit=None, on_admit=None, servable=None,
              on_reject=None) -> list[Request]:
        """Fill free batch slots from the queue; returns the active set.

        ``can_admit`` (when given) is the backend's admission-control
        predicate — e.g. page-pool capacity.  Admission stays FIFO: a
        capacity-blocked head request waits at the front rather than being
        jumped, so a large request cannot starve behind a stream of small
        ones.  A head that can NEVER be served (``servable(req)`` False —
        prompt longer than the engine's max stream length, or a contiguous
        batch with no rows left) is evicted instead: marked done and handed
        to ``on_reject`` — it must not wedge the FIFO forever.  ``on_admit``
        fires per admitted request BEFORE the next capacity query, so each
        admission consumes its backend resources (page allocation) and
        ``can_admit`` always sees the true remainder."""
        while len(self.active) < self.max_batch and self.queue:
            head = self.queue[0]
            if servable is not None and not servable(head):
                self.queue.popleft()
                head.done = True
                head.finish_time = self.clock
                if on_reject is not None:
                    on_reject(head)
                continue
            if can_admit is not None and not can_admit(head):
                break
            self.active.append(self.queue.popleft())
            if on_admit is not None:
                on_admit(head)
        if self.queue:
            # whatever still heads the queue is servable (unservable heads
            # were evicted above) but blocked — by capacity or a full batch
            self.stats.hol_wait_max = max(
                self.stats.hol_wait_max,
                self.clock - self.queue[0].submit_time)
        return self.active

    def device_profiles(self):
        """(alphas, T_S) of the active set for the controller."""
        return (np.array([r.alpha for r in self.active]),
                np.array([r.T_S for r in self.active]))

    def complete_round(self, accepted: np.ndarray, round_time: float,
                       participated: np.ndarray | None = None):
        """Account one round; retire requests that reached their budget.

        ``participated`` (when given, aligned with the active set) marks
        which requests actually took part — the off half of a pipelined
        half-round sits out and must not accrue a per-request round."""
        self.clock += round_time
        self.stats.total_rounds += 1
        self.stats.wall_time += round_time
        still = []
        for i, (req, n) in enumerate(zip(self.active, accepted)):
            produced = int(min(n, req.max_new_tokens - req.generated))
            if produced > 0 and req.generated == 0:
                req.first_token_time = self.clock
                self.stats.ttft_s.append(self.clock - req.submit_time)
            req.generated += produced
            if participated is None or participated[i]:
                req.rounds += 1
            self.stats.total_tokens += produced
            if req.generated >= req.max_new_tokens:
                req.done = True
                req.finish_time = self.clock
                self.stats.completed += 1
            else:
                still.append(req)
        self.active = still

    @property
    def idle(self) -> bool:
        return not self.active and not self.queue
