"""paligemma-3b — VLM: SigLIP patch frontend (stub) + Gemma-2B backbone
[arXiv:2407.07726; hf].

The modality frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings of shape (batch, num_patches, d_model) that the
backbone prepends to the text sequence.
"""

from .base import ModelConfig, register

PALIGEMMA_3B = register(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    activation="geglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    num_patches=256,
))
