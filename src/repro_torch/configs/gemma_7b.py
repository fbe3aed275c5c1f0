"""gemma-7b — dense, GeGLU, head_dim=256 [arXiv:2403.08295; hf]."""

from .base import ModelConfig, register

GEMMA_7B = register(ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    rope_theta=10000.0,
    tie_embeddings=True,
))
