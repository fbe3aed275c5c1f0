"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

Simplification (DESIGN.md §Arch-applicability): the shared transformer block
(full attention + MLP, one set of weights) is applied after every
``hybrid_group`` Mamba2 layers; each invocation owns its KV cache.  Zamba2's
per-invocation LoRA adapters are folded into the shared weights.
"""

from .base import ModelConfig, register

ZAMBA2_2P7B = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    activation="swiglu",
    rope_theta=10000.0,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    hybrid_group=6,
))
