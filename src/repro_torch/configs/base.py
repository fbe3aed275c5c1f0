"""Architecture config system and the assigned input-shape sets.

Every assigned architecture (plus the paper's own SLM/LLM pairs) is expressed
as a ``ModelConfig``; ``repro.models.model_zoo.build_model`` dispatches on
``family``.  ``smoke()`` derives a CPU-runnable reduced config of the same
family for tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

_REGISTRY: dict[str, "ModelConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # defaults to d_model // num_heads
    activation: str = "swiglu"
    norm: str = "rmsnorm"
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    dense_residual: bool = False
    first_k_dense: int = 0            # leading dense layers in a MoE stack
    capacity_factor: float = 1.25
    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_ngroups: int = 1
    ssm_chunk: int = 64
    # --- hybrid (Zamba2): shared attn block every `hybrid_group` ssm layers ---
    hybrid_group: int = 6
    # --- encoder-decoder (Whisper) ---
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500       # precomputed frame embeddings (stub frontend)
    # --- VLM (PaliGemma) ---
    num_patches: int = 0              # prepended patch embeddings (stub frontend)
    # --- numerics / lowering ---
    scan_unroll: bool = False      # unroll layer scans (cost-probe lowering)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_sub_quadratic(self) -> bool:
        """Whether the arch supports the long_500k shape (SSM state instead of
        quadratic-cost full-attention KV growth in compute)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are (or contain) autoregressive decoders

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4 if self.family == "hybrid" else 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=257,
            encoder_seq_len=12 if self.num_encoder_layers else 1500,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            num_patches=8 if self.num_patches else 0,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
        )
        if self.num_experts:
            kw.update(num_experts=4, top_k=min(self.top_k, 2), moe_d_ff=32,
                      shared_d_ff=64 if self.num_shared_experts else 0)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
        if self.family == "hybrid":
            kw.update(hybrid_group=2)
        return self.replace(**kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_architectures() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


ASSIGNED_ARCHS = [
    "phi4-mini-3.8b", "gemma-7b", "qwen2.5-3b", "deepseek-7b", "paligemma-3b",
    "zamba2-2.7b", "moonshot-v1-16b-a3b", "arctic-480b", "whisper-large-v3",
    "mamba2-130m",
]

PAPER_ARCHS = ["tinyllama-1.1b", "llama2-7b", "qwen3.5-0.8b", "qwen3.5-27b"]


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """The assigned shape cells that actually lower for this arch.

    long_500k requires sub-quadratic attention (DESIGN.md §Arch-applicability);
    full-attention archs record the cell as skipped.
    """
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_sub_quadratic:
        out.append("long_500k")
    return out


def _ensure_loaded():
    # importing the config modules populates the registry
    from . import archs  # noqa: F401
