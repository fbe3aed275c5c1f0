"""Model dispatch for the port: ``build_model(cfg, device)``.

``family`` "dense", "moe" and "vlm" build a ``DecoderLM``, "ssm" a
``MambaLM``, "hybrid" a ``HybridLM`` and "audio" an ``EncDecLM``, as the
JAX package's ``build_model``.  ``input_specs`` and ``cache_specs`` belong
to the dry run (ROADMAP A17).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from .encdec import EncDecLM
from .hybrid import HybridLM
from .ssm import MambaLM
from .transformer import DecoderLM


def build_model(cfg: ModelConfig, device="cuda"):
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, device=device)
    if cfg.family == "ssm":
        return MambaLM(cfg, device=device)
    if cfg.family == "hybrid":
        return HybridLM(cfg, device=device)
    if cfg.family == "audio":
        return EncDecLM(cfg, device=device)
    raise ValueError(f"unknown family {cfg.family}")


def has_prefix_embeds(cfg: ModelConfig) -> bool:
    return cfg.family in ("vlm", "audio")


def prefix_len(cfg: ModelConfig) -> int:
    if cfg.family == "vlm":
        return cfg.num_patches
    if cfg.family == "audio":
        return cfg.encoder_seq_len
    return 0
