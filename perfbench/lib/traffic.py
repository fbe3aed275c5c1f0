"""The one traffic generator: reads a mix's parameters
(``perfbench/traffic/<mix>.json``) and yields the requests of a closed loop
of edge devices.

A mix fixes the devices (count, acceptance rates, drafting speeds), the
prompt and output length distributions, the share of greedy requests and
how many requests a device sends.  Sizes are drawn by stratified quantiles:
every block of ``block`` requests holds the same prompt and output lengths
and the same number of greedy requests, which a seed only orders and
pairs.  So any two runs of one mix do the same amount of work per block.

A mix that names a ``trace_seed`` orders and pairs its sizes, marks its
greedy requests and deals its device profiles from that seed alone: every
run seed then sends the same trace of sizes, and the run seed draws only
the contents (prompt token ids here; weights, the channel and the round
draws elsewhere).  In a closed loop the order of sizes decides when
admissions bunch up, which sets a latency tail; a fixed trace keeps that
from changing with the seed.

Greedy requests are decoded with all their noise at zero and every draft
token accepted (``Draws`` in ``lib/serve.py``): their tokens are the draft's
and the target's greedy choices, which the reference can judge one by one.

The arithmetic of the device profiles (acceptance rates from a fixed set,
``T_S`` = base x U(lo, hi)) follows the cell's own defaults and
``serving/gateway/loadgen.py``; nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .seeds import derive


def _inverse_cdf(spec: dict, q: np.ndarray) -> np.ndarray:
    """Lengths at the quantiles ``q`` of a ``uniform`` or ``loguniform``
    distribution over [lo, hi] (integers, both ends included)."""
    lo, hi = float(spec["lo"]), float(spec["hi"])
    if spec["dist"] == "uniform":
        x = lo + q * (hi - lo)
    elif spec["dist"] == "loguniform":
        x = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


@dataclasses.dataclass
class Spec:
    """One request before it is sent."""

    index: int          # order of creation: names its prompt's stream
    device: int
    prompt_len: int
    max_new_tokens: int
    greedy: bool


class Traffic:
    """Requests of one mix for one seed.

    ``initial()`` gives each device its first request; ``next(device)`` the
    device's next one once the last has finished (None when the device
    sends no more).  ``prompt(spec)`` makes the prompt's token ids from the
    seed and the request's index alone, so a prompt does not depend on the
    order in which the system finishes requests."""

    def __init__(self, mix: dict, seed: int, token_limit: int, max_len: int):
        self.mix = mix
        self.seed = int(seed)
        self.token_limit = int(token_limit)
        self.max_len = int(max_len)
        self.K = int(mix["devices"])
        trace_seed = mix.get("trace_seed")
        self.rng = np.random.default_rng(
            derive(seed, "traffic") if trace_seed is None
            else derive(trace_seed, "trace"))
        alphas = list(mix["alpha"])
        if self.K % len(alphas):
            raise ValueError("devices must be a multiple of the alpha set")
        self.alpha = self.rng.permutation(
            np.repeat(np.asarray(alphas, np.float64), self.K // len(alphas)))
        ts = mix["T_S"]
        q = (np.arange(self.K) + 0.5) / self.K
        self.T_S = self.rng.permutation(
            ts["base"] * (ts["lo"] + q * (ts["hi"] - ts["lo"])))
        self.per_device = mix.get("requests_per_device")
        self.sent = np.zeros(self.K, np.int64)
        self._queue: list[tuple[int, int, bool]] = []
        self._count = 0

    # -- sizes ------------------------------------------------------------

    def _output_len(self, prompt_len: int, spec_out: dict) -> int:
        if spec_out["dist"] == "fill":
            return self.max_len - prompt_len - int(spec_out["margin"])
        raise ValueError(f"unknown output distribution {spec_out['dist']!r}")

    def _block(self, S: int) -> list[tuple[int, int, bool]]:
        """S (prompt, output, greedy) triples at the S quantiles of each
        distribution, paired and ordered by the seed."""
        q = (np.arange(S) + 0.5) / S
        prompts = _inverse_cdf(self.mix["prompt"], q)
        out = self.mix["output"]
        n_greedy = int(round(S * float(self.mix["greedy_share"])))
        if self.mix.get("greedy_order") == "shortest":
            # greedy requests take the shortest prompts: they commit a whole
            # draft a round and need the room to keep decoding
            greedy = np.arange(S) < n_greedy
        else:
            greedy = self.rng.permutation(np.arange(S) < n_greedy)
        if out["dist"] == "fill":
            outputs = np.array([self._output_len(int(p), out)
                                for p in prompts])
        else:
            outputs = self.rng.permutation(_inverse_cdf(out, q))
        order = self.rng.permutation(S)
        return [(int(prompts[i]), int(outputs[i]), bool(greedy[i]))
                for i in order]

    def _take(self, device: int) -> Spec:
        if not self._queue:
            self._queue = self._block(int(self.mix["block"]))
        p, o, g = self._queue.pop(0)
        spec = Spec(index=self._count, device=device, prompt_len=p,
                    max_new_tokens=o, greedy=g)
        self._count += 1
        self.sent[device] += 1
        return spec

    # -- the loop -----------------------------------------------------------

    def initial(self) -> list[Spec]:
        if self.per_device is not None:
            # one block covers every device's sessions at once
            self._queue = self._block(self.K)
        return [self._take(d) for d in range(self.K)]

    def next(self, device: int) -> Spec | None:
        if self.per_device is not None and self.sent[device] >= self.per_device:
            return None
        return self._take(device)

    def prompt(self, spec: Spec) -> list[int]:
        rng = np.random.default_rng(derive(self.seed, "prompt", spec.index))
        return rng.integers(0, self.token_limit, spec.prompt_len).tolist()

    def prompt_lengths(self) -> list[int]:
        """Every prompt length the mix sends: a block's quantiles (each
        block holds the same lengths)."""
        S = self.K if self.per_device is not None else int(self.mix["block"])
        return sorted(set(_inverse_cdf(self.mix["prompt"],
                                       (np.arange(S) + 0.5) / S).tolist()))

    def prefill_buckets(self, bucket) -> list[int]:
        """The prefill shapes the mix reaches, through the engine's own
        ``bucket(M)`` (its power-of-two rule)."""
        return sorted({int(bucket(m)) for m in self.prompt_lengths()})
