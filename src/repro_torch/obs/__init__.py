"""Observability primitives of the port (stdlib only): the span tracer."""

from repro_torch.obs.trace import (
    NULL_SPAN,
    Span,
    Tracer,
    active,
    install,
    span,
    tracing,
    uninstall,
)

__all__ = [
    "NULL_SPAN",
    "Span",
    "Tracer",
    "active",
    "install",
    "span",
    "tracing",
    "uninstall",
]
