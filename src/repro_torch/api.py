"""The public names of the port: the serving path on either cache layout.

    from repro_torch.api import (CellConfig, EngineBackend, MultiSpinCell,
                                 Request, SpecEngine)

    engine = SpecEngine(tcfg, dcfg)       # contiguous, on the card
    engine.init_params(0)
    backend = EngineBackend(engine, engine.start(prompts))
    cell = MultiSpinCell(CellConfig(scheme="hete"), backend=backend)

``SpecEngine(..., cache_kind="paged")`` serves churn from a page pool;
``ContinuousBackend`` drives it with continuous batching; the SSE gateway
(``MultiSpinGateway``) serves a cell live.  The compiled round path comes
in a later slice (ROADMAP A9).  Like ``repro.api``, importing this module
loads no torch: the engines, the continuous engine, the page allocator and
``RoundDraws`` resolve on first use.
"""

from repro_torch.configs import get_config  # noqa: F401
from repro_torch.core.channel import ChannelConfig, ChannelState  # noqa: F401
from repro_torch.core.controller import (  # noqa: F401
    AcceptanceEstimator,
    MultiSpinController,
    VerificationLatencyModel,
)
from repro_torch.core.schemes import (  # noqa: F401
    CellObservation,
    RoundPlan,
    Scheme,
    SchemeCapabilities,
    SchemeCapabilityError,
    available_schemes,
    build_scheme,
    get_scheme,
    register_scheme,
    scheme_table_markdown,
)
from repro_torch.serving.backends import (  # noqa: F401
    ContinuousBackend,
    EngineBackend,
    SyntheticBackend,
    VerificationBackend,
)
from repro_torch.serving.cell import (  # noqa: F401
    SCHEDULES,
    CellConfig,
    MultiSpinCell,
    RoundRecord,
)
from repro_torch.serving.gateway import (  # noqa: F401
    GatewayClient,
    GatewayConfig,
    MetricsHub,
    MultiSpinGateway,
    RoundMetrics,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    Request,
    RoundScheduler,
    SchedulerStats,
)

__all__ = [
    "AcceptanceEstimator",
    "CellConfig",
    "CellObservation",
    "ChannelConfig",
    "ChannelState",
    "ContinuousBackend",
    "ContinuousEngine",
    "EngineBackend",
    "GatewayClient",
    "GatewayConfig",
    "MetricsHub",
    "MultiSpinCell",
    "MultiSpinGateway",
    "MultiSpinController",
    "PagedKVCache",
    "PagePoolExhausted",
    "Request",
    "RoundDraws",
    "RoundMetrics",
    "RoundPlan",
    "RoundRecord",
    "RoundScheduler",
    "SCHEDULES",
    "Scheme",
    "SchemeCapabilities",
    "SchemeCapabilityError",
    "SchedulerStats",
    "SpecEngine",
    "StreamState",
    "SyntheticBackend",
    "VerificationBackend",
    "VerificationLatencyModel",
    "available_schemes",
    "build_scheme",
    "get_config",
    "get_scheme",
    "register_scheme",
    "scheme_table_markdown",
]

_LAZY_TORCH = {"SpecEngine": "repro_torch.serving.spec_engine",
               "StreamState": "repro_torch.serving.spec_engine",
               "PagedKVCache": "repro_torch.serving.kv_cache",
               "PagePoolExhausted": "repro_torch.serving.kv_cache",
               "RoundDraws": "repro_torch.core.draws",
               "ContinuousEngine": "repro_torch.serving.continuous"}


def __getattr__(name):
    if name in _LAZY_TORCH:
        import importlib
        return getattr(importlib.import_module(_LAZY_TORCH[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
