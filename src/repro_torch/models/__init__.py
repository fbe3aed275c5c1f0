"""Model zoo of the port: the dense decoder on torch tensors."""

from .model_zoo import build_model  # noqa: F401
