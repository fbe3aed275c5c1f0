"""Serving runtime of the port: Multi-SPIN cell, verification backends,
the speculative engine, continuous batching, the plain decoding engine, the
page allocator, the scheduler and the SSE gateway.  The engines, the
continuous engine and the page allocator import torch and are resolved
lazily, so the cell, backends and scheduler stay torch-free; the gateway is
stdlib-only but lazy too, as in the JAX package."""

from .backends import (  # noqa: F401
    ContinuousBackend,
    EngineBackend,
    SyntheticBackend,
    VerificationBackend,
)
from .cell import CellConfig, MultiSpinCell, RoundRecord  # noqa: F401
from .scheduler import Request, RoundScheduler, SchedulerStats  # noqa: F401

_GATEWAY = ("MultiSpinGateway", "GatewayConfig", "GatewayClient",
            "MetricsHub", "RoundMetrics")
_CONTINUOUS = ("ContinuousEngine", "StreamFSM", "BatchAssembler",
               "IllegalTransition")
_LAZY = {"SpecEngine": "spec_engine", "StreamState": "spec_engine",
         "ServingEngine": "engine", "EngineState": "engine",
         "PagedKVCache": "kv_cache", "PagePoolExhausted": "kv_cache",
         **{n: "continuous" for n in _CONTINUOUS},
         **{n: "gateway" for n in _GATEWAY}}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
