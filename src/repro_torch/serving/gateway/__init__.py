"""Live serving gateway + telemetry for Multi-SPIN cells (stdlib-only).

``MultiSpinGateway`` serves a live ``MultiSpinCell`` over HTTP/1.1 with
SSE token streaming; ``MetricsHub`` turns round records into Prometheus
metrics and JSON stats; ``GatewayClient`` / ``run_loadgen`` drive it.
Everything in this package is importable without JAX.
"""

from repro_torch.serving.gateway.client import (
    GatewayClient,
    GatewayError,
    GenerateResult,
    SSEEvent,
)
from repro_torch.serving.gateway.dashboard import DASHBOARD_HTML
from repro_torch.serving.gateway.loadgen import (
    LoadGenConfig,
    RequestRecord,
    percentile,
    run_loadgen,
    summarize,
)
from repro_torch.serving.gateway.server import (
    GatewayConfig,
    MultiSpinGateway,
    serve,
)
from repro_torch.serving.gateway.telemetry import MetricsHub, RoundMetrics

__all__ = [
    "DASHBOARD_HTML",
    "GatewayClient",
    "GatewayError",
    "GenerateResult",
    "SSEEvent",
    "LoadGenConfig",
    "RequestRecord",
    "percentile",
    "run_loadgen",
    "summarize",
    "GatewayConfig",
    "MultiSpinGateway",
    "serve",
    "MetricsHub",
    "RoundMetrics",
]
