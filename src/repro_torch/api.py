"""The public names of the port's first slice: the J=1 paged serving path.

    from repro_torch.api import (CellConfig, EngineBackend, MultiSpinCell,
                                 Request, SpecEngine)

    engine = SpecEngine(tcfg, dcfg, cache_kind="paged")      # on the card
    engine.init_params(0)
    backend = EngineBackend(engine, engine.start(prompts))
    cell = MultiSpinCell(CellConfig(scheme="hete"), backend=backend)

The gateway, continuous batching and the compiled round path come in later
slices (ROADMAP A8-A10).
"""

from repro_torch.configs import get_config  # noqa: F401
from repro_torch.core.channel import ChannelConfig, ChannelState  # noqa: F401
from repro_torch.core.controller import (  # noqa: F401
    AcceptanceEstimator,
    MultiSpinController,
    VerificationLatencyModel,
)
from repro_torch.core.draws import RoundDraws  # noqa: F401
from repro_torch.core.schemes import (  # noqa: F401
    CellObservation,
    RoundPlan,
    available_schemes,
    get_scheme,
)
from repro_torch.serving.backends import (  # noqa: F401
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
from repro_torch.serving.kv_cache import (  # noqa: F401
    PagedKVCache,
    PagePoolExhausted,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    Request,
    RoundScheduler,
    SchedulerStats,
)
from repro_torch.serving.spec_engine import SpecEngine, StreamState  # noqa: F401

__all__ = [
    "AcceptanceEstimator",
    "CellConfig",
    "CellObservation",
    "ChannelConfig",
    "ChannelState",
    "EngineBackend",
    "MultiSpinCell",
    "MultiSpinController",
    "PagedKVCache",
    "PagePoolExhausted",
    "Request",
    "RoundDraws",
    "RoundPlan",
    "RoundRecord",
    "RoundScheduler",
    "SCHEDULES",
    "SchedulerStats",
    "SpecEngine",
    "StreamState",
    "SyntheticBackend",
    "VerificationBackend",
    "VerificationLatencyModel",
    "available_schemes",
    "get_config",
    "get_scheme",
]
