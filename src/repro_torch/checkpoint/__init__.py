"""Fault-tolerant checkpointing (msgpack + zstd or zlib, atomic, async)."""

from .checkpoint import CheckpointManager, load, save  # noqa: F401
