"""Serving runtime of the port: Multi-SPIN cell, verification backends,
the speculative engine, the plain decoding engine, the page allocator, the
scheduler.  The engines and the page allocator import torch and are
resolved lazily, so the cell, backends and scheduler stay torch-free."""

from .backends import (  # noqa: F401
    EngineBackend,
    SyntheticBackend,
    VerificationBackend,
)
from .cell import CellConfig, MultiSpinCell, RoundRecord  # noqa: F401
from .scheduler import Request, RoundScheduler, SchedulerStats  # noqa: F401

_LAZY = {"SpecEngine": "spec_engine", "StreamState": "spec_engine",
         "ServingEngine": "engine", "EngineState": "engine",
         "PagedKVCache": "kv_cache", "PagePoolExhausted": "kv_cache"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
