"""Model dispatch for the port: ``build_model(cfg, device)``.

``family="dense"`` builds a ``DecoderLM``, ``"ssm"`` a ``MambaLM`` and
``"hybrid"`` a ``HybridLM``; the other families raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from .hybrid import HybridLM
from .ssm import MambaLM
from .transformer import DecoderLM

_NOT_PORTED = {
    "moe": "MoE stacks (ROADMAP A12)",
    "vlm": "VLM prefix embeddings (ROADMAP A14)",
    "audio": "encoder-decoder models (ROADMAP A14)",
}


def build_model(cfg: ModelConfig, device="cuda"):
    if cfg.family == "dense":
        return DecoderLM(cfg, device=device)
    if cfg.family == "ssm":
        return MambaLM(cfg, device=device)
    if cfg.family == "hybrid":
        return HybridLM(cfg, device=device)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r}: {_NOT_PORTED[cfg.family]} not ported yet")
    raise ValueError(f"unknown family {cfg.family}")
