"""arctic-480b — MoE 128e top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base]."""

from .base import ModelConfig, register

ARCTIC_480B = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,              # dense-residual path
    vocab_size=32000,
    activation="swiglu",
    rope_theta=10000.0,
    num_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
))
