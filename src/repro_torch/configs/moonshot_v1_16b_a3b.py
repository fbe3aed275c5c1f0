"""moonshot-v1-16b-a3b — MoE 64e top-6 (Moonlight / kimi)
[hf:moonshotai/Moonlight-16B-A3B; hf]."""

from .base import ModelConfig, register

MOONSHOT_16B = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=11264,             # dense layers / shared path
    vocab_size=163840,
    activation="swiglu",
    rope_theta=50000.0,
    num_experts=64,
    top_k=6,
    moe_d_ff=1408,
    num_shared_experts=2,
    shared_d_ff=2816,
    first_k_dense=1,
))
