"""Model dispatch for the port: ``build_model(cfg, device)``.

``family`` "dense", "moe" and "vlm" build a ``DecoderLM``, "ssm" a
``MambaLM``, "hybrid" a ``HybridLM`` and "audio" an ``EncDecLM``, as the
JAX package's ``build_model``.  ``input_specs(cfg, shape)`` and
``cache_specs(cfg, shape)`` yield the stand-ins of the dry run's step
inputs: tensors on the ``meta`` device (the counterpart of
``jax.ShapeDtypeStruct``), with the reference's keys, shapes and dtypes.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, InputShape, ModelConfig

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


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape | str,
                compute_dtype=torch.bfloat16, per_pod_batch: bool = False,
                draft_window: int = 0) -> dict:
    """Meta-tensor stand-ins for one (arch x shape) cell.

    * train/prefill: {"tokens", ["prefix_embeds"]}
    * decode:       {"tokens" (B, 1+draft_window), "pos" (B,)} (cache specs
      are produced separately since they depend on the model object)
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    specs = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = _meta((B, S), torch.int32)
        if cfg.family == "vlm":
            specs["prefix_embeds"] = _meta((B, cfg.num_patches, cfg.d_model),
                                           compute_dtype)
        elif cfg.family == "audio":
            specs["prefix_embeds"] = _meta(
                (B, cfg.encoder_seq_len, cfg.d_model), compute_dtype)
    else:  # decode
        T = 1 + draft_window
        specs["tokens"] = _meta((B, T), torch.int32)
        specs["pos"] = _meta((B,), torch.int32)
    return specs


def cache_specs(cfg: ModelConfig, shape: InputShape | str,
                dtype=torch.bfloat16) -> dict:
    """Meta-tensor stand-ins of the KV/SSM cache for a decode cell: the
    model's own ``init_cache`` under ``FakeTensorMode``, nothing
    allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if isinstance(shape, str):
        shape = SHAPES[shape]
    max_len = shape.seq_len + prefix_len(cfg)
    with FakeTensorMode():
        cache = build_model(cfg, device="cpu").init_cache(
            shape.global_batch, max_len, dtype)
    return {k: _meta(v.shape, v.dtype) for k, v in cache.items()}
