"""phi4-mini-3.8b — dense, RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""

from .base import ModelConfig, register

PHI4_MINI = register(ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    activation="swiglu",
    rope_theta=10000.0,
))
