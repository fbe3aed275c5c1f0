"""Model zoo of the port: dense / MoE / SSM / hybrid / enc-dec / VLM
backbones on torch tensors."""

from .model_zoo import (  # noqa: F401
    build_model,
    cache_specs,
    has_prefix_embeds,
    input_specs,
)
