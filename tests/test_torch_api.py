"""The port's public surface, ``repro_torch.api``, against ``repro.api``.

Importing the api loads no torch (as ``repro.api`` loads no jax): the
engines, the continuous engine, the page allocator and ``RoundDraws``
resolve on first use.  Every
module that computes on the card turns TF32 off (``repro_torch.precision``).
The import checks run in a fresh interpreter, since by the time a test runs
here torch is long loaded.
"""

import os
import subprocess
import sys
from pathlib import Path

import repro.api as japi
import repro_torch.api as tapi

ROOT = Path(__file__).resolve().parents[1]

# names of repro.api that later slices of the port bring (none is left:
# continuous batching and the gateway came with ROADMAP A8 and A10)
PENDING: dict[str, str] = {}


def _fresh(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_api_import_leaves_torch_unloaded():
    got = _fresh("import sys\n"
                 "import repro_torch.api\n"
                 "print(sorted(m for m in ('torch', 'jax', 'repro')"
                 " if m in sys.modules))")
    assert got == "[]"


def test_engine_import_turns_tf32_off():
    got = _fresh("import torch\n"
                 "torch.backends.cuda.matmul.allow_tf32 = True\n"
                 "torch.backends.cudnn.allow_tf32 = True\n"
                 "import repro_torch.serving.spec_engine\n"
                 "print(torch.backends.cuda.matmul.allow_tf32,"
                 " torch.backends.cudnn.allow_tf32)")
    assert got == "False False"


def test_api_exports_the_reference_names_but_the_pending_ones():
    ref = set(japi.__all__)
    assert set(PENDING) <= ref
    missing = sorted(n for n in ref - set(PENDING) if not hasattr(tapi, n))
    assert missing == []
    assert not (set(PENDING) & set(tapi.__all__))
    assert ref - set(PENDING) <= set(tapi.__all__)
    assert all(hasattr(tapi, n) for n in tapi.__all__)


def test_engines_resolve_lazily():
    from repro_torch.core.draws import RoundDraws
    from repro_torch.serving import (
        EngineState,
        PagedKVCache,
        PagePoolExhausted,
        ServingEngine,
        SpecEngine,
        StreamState,
    )
    from repro_torch.serving.kv_cache import PagedKVCache as kv_cls
    from repro_torch.serving.spec_engine import SpecEngine as spec_cls

    assert tapi.SpecEngine is SpecEngine is spec_cls
    assert tapi.PagedKVCache is PagedKVCache is kv_cls
    assert tapi.StreamState is StreamState
    assert tapi.PagePoolExhausted is PagePoolExhausted
    assert tapi.RoundDraws is RoundDraws
    from repro_torch.serving import (
        BatchAssembler,
        ContinuousEngine,
        GatewayClient,
        IllegalTransition,
        MetricsHub,
        StreamFSM,
    )
    from repro_torch.serving.continuous import ContinuousEngine as cont_cls
    from repro_torch.serving.gateway import GatewayClient as client_cls

    assert tapi.ContinuousEngine is ContinuousEngine is cont_cls
    assert tapi.GatewayClient is GatewayClient is client_cls
    assert tapi.MetricsHub is MetricsHub
    assert {c.__name__ for c in (BatchAssembler, IllegalTransition,
                                 StreamFSM)} == {
        "BatchAssembler", "IllegalTransition", "StreamFSM"}
    assert ServingEngine.__name__ == "ServingEngine"
    assert EngineState.__name__ == "EngineState"
    scheme = tapi.build_scheme("hete")
    assert isinstance(scheme, tapi.Scheme)
    assert "hete" in tapi.scheme_table_markdown()
