"""Model zoo of the port: dense / MoE / SSM / hybrid / enc-dec / VLM
backbones on torch tensors."""

from .model_zoo import build_model, has_prefix_embeds  # noqa: F401
