"""Serving runtime of the port: Multi-SPIN cell, verification backends,
the paged speculative engine, the page allocator, the scheduler."""

from .backends import (  # noqa: F401
    EngineBackend,
    SyntheticBackend,
    VerificationBackend,
)
from .cell import CellConfig, MultiSpinCell, RoundRecord  # noqa: F401
from .kv_cache import PagedKVCache, PagePoolExhausted  # noqa: F401
from .scheduler import Request, RoundScheduler, SchedulerStats  # noqa: F401
from .spec_engine import SpecEngine, StreamState  # noqa: F401
