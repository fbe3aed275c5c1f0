"""A decoder whose layers differ in their attention, as a port-only config.

``LayerPatternConfig`` is a frozen ``ModelConfig`` (family ``dense`` or
``moe``) with what varies by layer: a sliding key window on some layers
(``window_layers``, ``sliding_window`` keys), rotary embeddings on some and
none on the others (``rope_layers``: a NoPE layer), and where an MoE
layer's router reads (``router_input``: ``"mlp_norm"``, the layer's MLP
input as usual, or ``"attn_norm"``, the attention's normed input, for a
router placed before attention).  ``configs/`` stays a verbatim copy of the
JAX package's; this class is the port's own, and ``DecoderLM`` reads it
through ``layer_windows`` / ``layer_rope`` / ``router_input``, which give
a plain ``ModelConfig``'s uniform layers.

A windowed model keeps the K/V of its window layers in a pool of its own
(``win_k`` / ``win_v``, viewed through ``win_pages``) that the serving
engine sizes to the window and frees below it; the K/V of its full layers
stay in ``k`` / ``v``.  It runs on paged caches and J=1 windows only: the
contiguous layout and token-tree windows refuse it.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

ROUTER_INPUTS = ("mlp_norm", "attn_norm")


@dataclasses.dataclass(frozen=True)
class LayerPatternConfig(ModelConfig):
    sliding_window: int = 0           # keys a window layer's query sees
    window_layers: tuple = ()         # per layer: True = sliding window
    rope_layers: tuple = ()           # per layer: True = RoPE, False = NoPE
    router_input: str = "mlp_norm"    # mlp_norm | attn_norm

    def __post_init__(self):
        super().__post_init__()
        for name in ("window_layers", "rope_layers"):
            v = tuple(bool(b) for b in getattr(self, name))
            if v and len(v) != self.num_layers:
                raise ValueError(f"{name} has {len(v)} entries for "
                                 f"{self.num_layers} layers")
            object.__setattr__(self, name, v)
        if any(self.window_layers) and self.sliding_window <= 0:
            raise ValueError("window layers need sliding_window > 0")
        if self.router_input not in ROUTER_INPUTS:
            raise ValueError(f"router_input must be one of {ROUTER_INPUTS}")
        if any(self.window_layers) and self.first_k_dense:
            raise ValueError("window layers in a stack with leading dense "
                             "blocks are not supported")


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Per layer, its key window (0: full attention)."""
    flags = getattr(cfg, "window_layers", ())
    w = int(getattr(cfg, "sliding_window", 0))
    return [w if f else 0 for f in flags] or [0] * cfg.num_layers


def layer_rope(cfg: ModelConfig) -> list[bool]:
    """Per layer, whether it applies rotary embeddings (all, unless
    ``rope_theta`` is None)."""
    flags = getattr(cfg, "rope_layers", ())
    on = cfg.rope_theta is not None
    return [on and f for f in flags] or [on] * cfg.num_layers


def router_input(cfg: ModelConfig) -> str:
    return getattr(cfg, "router_input", "mlp_norm")


def is_windowed(cfg: ModelConfig) -> bool:
    return any(layer_windows(cfg))
