"""Model dispatch for the port: ``build_model(cfg, device)``.

Only ``family="dense"`` is ported (all four paper models are dense); the
other families raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from .transformer import DecoderLM

_NOT_PORTED = {
    "moe": "MoE stacks (ROADMAP A12)",
    "ssm": "SSM models (ROADMAP A13)",
    "hybrid": "SSM/attention hybrids (ROADMAP A13)",
    "vlm": "VLM prefix embeddings (ROADMAP A14)",
    "audio": "encoder-decoder models (ROADMAP A14)",
}


def build_model(cfg: ModelConfig, device="cuda"):
    if cfg.family == "dense":
        return DecoderLM(cfg, device=device)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r}: {_NOT_PORTED[cfg.family]} not ported yet")
    raise ValueError(f"unknown family {cfg.family}")
