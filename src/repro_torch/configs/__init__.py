"""Architecture configs: 10 assigned archs + the paper's model pairs."""

from .base import (  # noqa: F401
    ASSIGNED_ARCHS,
    PAPER_ARCHS,
    SHAPES,
    InputShape,
    ModelConfig,
    applicable_shapes,
    get_config,
    list_architectures,
)
