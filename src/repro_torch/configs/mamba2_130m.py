"""mamba2-130m — attention-free SSD (state-space duality) [arXiv:2405.21060]."""

from .base import ModelConfig, register

MAMBA2_130M = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=24,             # SSD heads: d_inner / ssm_head_dim
    num_kv_heads=24,
    d_ff=0,                   # attention-free, no FFN (per assignment)
    vocab_size=50280,
    activation="swiglu",
    rope_theta=None,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
))
