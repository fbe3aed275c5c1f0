"""AdamW with cosine schedule, global-norm clipping, decoupled weight decay.

The port of ``repro.training.optimizer``: plain functions over the
parameter tree (nested dicts and lists of tensors), no ``torch.optim``, so
that the state stays ``{"m", "v", "step"}`` with ``m`` / ``v`` shaped like
the parameters and ``step`` a 0-d int32 tensor, and a checkpoint of it
crosses to the JAX package (``bridge.params_to_jax``) and back.  The
schedule and the bias corrections are float32 tensors, as the reference
computes them (python float64 powers would give other bits); every update
is elementwise in float32.  Optimizer-state dtype is float32 or bfloat16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import precision as _precision  # noqa: F401  (no TF32)

Params = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    state_dtype: str = "float32"


def tree_map(fn, tree: Params, *rest: Params) -> Params:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Params) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay -> floor at min_lr_ratio (float32)."""
    step = step.to(torch.float32)
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.learning_rate * cos)


def init_optimizer(cfg: OptimizerConfig, params: Params) -> Params:
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.state_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    leaves = tree_leaves(params)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def apply_gradients(cfg: OptimizerConfig, params: Params, grads: Params,
                    state: Params):
    """One AdamW step.  Returns (params, state, metrics): new tensors, the
    inputs untouched (no in-place update), metrics ``grad_norm`` (before
    clipping) and ``lr`` as 0-d float32 tensors."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        update = update + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * update
        return new_p.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    # leaves of ``out`` are (p, m, v) tuples: pick each field by mapping
    # over the parameter tree, whose leaves end where the tuples start
    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_params = tree_map(lambda p, o: o[0], params, out)
    new_state = {
        "m": tree_map(lambda p, o: o[1], params, out),
        "v": tree_map(lambda p, o: o[2], params, out),
        "step": step,
    }
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
