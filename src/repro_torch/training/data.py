"""Synthetic data pipeline.

Two roles:

1. LM training batches — an order-2 Markov token source with Zipfian
   marginals: enough structure that a ~100M model demonstrably learns
   (loss decreases) within a few hundred CPU steps, fully deterministic
   per (seed, step) so data-parallel workers never need coordination and
   restarts resume bit-exactly.

2. Multi-SPIN task mixtures — prompt streams labeled with the paper's four
   task types (Table I); each task induces a characteristic SLM/LLM
   acceptance rate via per-task draft-temperature perturbation
   (benchmarks/bench_acceptance.py calibrates these to Table I means).
"""

from __future__ import annotations

import dataclasses

import numpy as np

TASK_TYPES = ("mbpp", "gsm8k", "mtbench", "squad")

# Paper Table I means (Llama-2 pair / Qwen3.5 pair)
TABLE_I = {
    "llama2": {"mbpp": 0.8582, "gsm8k": 0.7390, "mtbench": 0.7393, "squad": 0.7126},
    "qwen35": {"mbpp": 0.8100, "gsm8k": 0.9340, "mtbench": 0.9318, "squad": 0.9650},
}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLMDataset:
    """Deterministic order-2 Markov stream with Zipfian unigram marginals."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # Zipfian unigram distribution
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self.unigram = (ranks ** -cfg.zipf_a)
        self.unigram /= self.unigram.sum()
        # hidden low-rank bigram structure: token t -> shift pattern
        self.n_states = 16
        self.state_shift = rng.integers(0, V, self.n_states)
        self.state_of = rng.integers(0, self.n_states, V)

    def batch(self, step: int) -> dict:
        """Batch for a global step — pure function of (seed, step)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        base = rng.choice(V, size=(B, S), p=self.unigram)
        out = np.empty((B, S), dtype=np.int64)
        out[:, 0] = base[:, 0]
        for t in range(1, S):
            # half the tokens follow the deterministic state pattern
            follow = rng.random(B) < 0.5
            pattern = (self.state_shift[self.state_of[out[:, t - 1]]]
                       + out[:, t - 1]) % V
            out[:, t] = np.where(follow, pattern, base[:, t])
        return {"tokens": out.astype(np.int32)}

    def shard(self, batch: dict, worker: int, num_workers: int) -> dict:
        B = batch["tokens"].shape[0]
        per = B // num_workers
        return {k: v[worker * per:(worker + 1) * per] for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class TaskProfile:
    """Per-task drafting characteristics for the Multi-SPIN simulator."""

    name: str
    alpha_llama2: float
    alpha_qwen35: float
    draft_temperature: float  # SLM perturbation inducing the acceptance gap


def task_profiles() -> list[TaskProfile]:
    return [
        TaskProfile("mbpp", TABLE_I["llama2"]["mbpp"], TABLE_I["qwen35"]["mbpp"], 1.10),
        TaskProfile("gsm8k", TABLE_I["llama2"]["gsm8k"], TABLE_I["qwen35"]["gsm8k"], 1.25),
        TaskProfile("mtbench", TABLE_I["llama2"]["mtbench"], TABLE_I["qwen35"]["mtbench"], 1.25),
        TaskProfile("squad", TABLE_I["llama2"]["squad"], TABLE_I["qwen35"]["squad"], 1.30),
    ]


def sample_device_tasks(K: int, rng: np.random.Generator) -> list[TaskProfile]:
    """i.i.d. task assignment across devices (paper Sec. VI-A1)."""
    profiles = task_profiles()
    return [profiles[i] for i in rng.integers(0, len(profiles), K)]


def sample_prompts(vocab: int, K: int, length: int,
                   rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, vocab, (K, length)).astype(np.int32)
