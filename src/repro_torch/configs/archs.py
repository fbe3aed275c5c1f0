"""Import side-effect module: populates the architecture registry."""

from . import (  # noqa: F401
    arctic_480b,
    deepseek_7b,
    gemma_7b,
    mamba2_130m,
    moonshot_v1_16b_a3b,
    paligemma_3b,
    paper_pairs,
    phi4_mini_3p8b,
    qwen25_3b,
    whisper_large_v3,
    zamba2_2p7b,
)
