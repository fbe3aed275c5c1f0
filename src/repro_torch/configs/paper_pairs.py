"""The paper's own SLM/LLM pairs (Sec. VI-A1).

TinyLlama-1.1B + Llama-2-7B, and Qwen3.5-0.8B + Qwen3.5-27B.  The Qwen3.5
checkpoints are not publicly released; dimensions follow Qwen-family scaling
(DESIGN.md §Assumptions).  llama2-7b is dimension-identical to the original.
"""

from .base import ModelConfig, register

TINYLLAMA_1P1B = register(ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    activation="swiglu",
))

LLAMA2_7B = register(ModelConfig(
    name="llama2-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    activation="swiglu",
))

QWEN35_0P8B = register(ModelConfig(
    name="qwen3.5-0.8b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1000000.0,
))

QWEN35_27B = register(ModelConfig(
    name="qwen3.5-27b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1000000.0,
))
