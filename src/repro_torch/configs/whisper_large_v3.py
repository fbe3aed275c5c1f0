"""whisper-large-v3 — encoder-decoder audio model [arXiv:2212.04356].

The conv frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (batch, encoder_seq_len, d_model).  Decode shapes
exercise the text decoder (self-attn KV cache + fixed cross-attn KV).
"""

from .base import ModelConfig, register

WHISPER_LARGE_V3 = register(ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,            # decoder layers
    num_encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    activation="gelu",
    norm="layernorm",
    rope_theta=None,          # whisper uses learned positions
    encoder_seq_len=1500,
))
