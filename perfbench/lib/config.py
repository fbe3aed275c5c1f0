"""A configuration file (``perfbench/configs/<name>.json``) read into what
the harness needs: the target's and the draft's dims in Hugging Face's
keys as published, and the deployment.

The file keeps the target's published ``config.json`` keys at its top
level and the draft's under ``draft``; ``reduced`` names every key changed
from the source.  Qwen2 blocks carry a bias on q, k and v; that is the
architecture's, not a config key, and the file states it under
``assumed``."""

from __future__ import annotations

import dataclasses

from perfbench.costs.dense import Dims


@dataclasses.dataclass(frozen=True)
class Model(Dims):
    tied: bool = False
    qkv_bias: bool = True
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    name: str = ""


def model_from_hf(hf: dict, name: str, qkv_bias: bool) -> Model:
    heads = int(hf["num_attention_heads"])
    return Model(layers=int(hf["num_hidden_layers"]),
                 d=int(hf["hidden_size"]), heads=heads,
                 kv_heads=int(hf["num_key_value_heads"]),
                 head_dim=int(hf.get("head_dim",
                                     int(hf["hidden_size"]) // heads)),
                 d_ff=int(hf["intermediate_size"]),
                 vocab=int(hf["vocab_size"]),
                 tied=bool(hf["tie_word_embeddings"]), qkv_bias=qkv_bias,
                 rope_theta=float(hf["rope_theta"]),
                 rms_eps=float(hf["rms_norm_eps"]), name=name)


def models(cfg: dict) -> tuple[Model, Model]:
    """``(target, draft)`` of a configuration file."""
    bias = bool(cfg["assumed"]["qkv_bias"])
    return (model_from_hf(cfg, cfg["target_name"], bias),
            model_from_hf(cfg["draft"], cfg["draft"]["name"], bias))


def port_config(m: Model, dtype: str = "bfloat16"):
    """The port's ``ModelConfig`` for a model (the port's own class: the
    engine is built from it)."""
    from repro_torch.configs.base import ModelConfig

    if m.rms_eps != 1e-6:
        raise ValueError("the port's RMSNorm uses eps 1e-6")
    return ModelConfig(name=m.name, family="dense", num_layers=m.layers,
                       d_model=m.d, num_heads=m.heads,
                       num_kv_heads=m.kv_heads, head_dim=m.head_dim,
                       d_ff=m.d_ff, vocab_size=m.vocab, activation="swiglu",
                       qkv_bias=m.qkv_bias, rope_theta=m.rope_theta,
                       tie_embeddings=m.tied, param_dtype=dtype,
                       compute_dtype=dtype)
