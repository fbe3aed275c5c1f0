"""The port's verbatim copies stay verbatim, and the port stays free of jax.

The jax-free modules the cell needs are copied into ``repro_torch`` rather
than imported from ``repro``.  Each copy must equal its original line for
line once import lines are dropped (``repro.`` -> ``repro_torch.`` is the
only edit there).  Two exceptions: ``obs/trace.py``'s device-sync hunk,
where ``jax.block_until_ready`` becomes ``torch.cuda.synchronize``, skipped
while a CUDA graph is being captured (a capture may not synchronize); and
the body of ``solve_heterogeneous`` in ``core/draft_control.py``, which runs
the port's own inner steps (``core/hete_solve.py``) inside its planner
spans.  ``tests/test_torch_plan.py`` holds that body's outputs to the
reference's.
"""

import importlib
import inspect
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

COPIES = ([f"configs/{p.name}" for p in sorted((SRC / "configs").glob("*.py"))]
          + [f"core/{n}.py" for n in ("goodput", "channel", "bandwidth",
                                      "lambertw", "draft_control", "schemes",
                                      "controller", "beyond", "token_tree")]
          + ["serving/cell.py", "serving/scheduler.py", "obs/trace.py",
             "training/data.py", "roofline/analytic.py",
             "distributed/fault_tolerance.py"]
          + [f"serving/gateway/{n}.py" for n in ("__init__", "client",
                                                 "dashboard", "loadgen",
                                                 "server", "telemetry")])

_IMPORT = re.compile(r"^\s*(from|import) repro(_torch)?\.")

# obs/trace.py: the only lines allowed to differ (reference, port)
TRACE_HUNK = (
    ["                import jax",
     "                self._block = jax.block_until_ready"],
    ["                import torch",
     "",
     "                def _sync(value):",
     "                    if (getattr(value, \"is_cuda\", False)",
     "                            and not torch.cuda.is_current_stream_capturing()):",
     "                        torch.cuda.synchronize(value.device)",
     "                self._block = _sync"],
)


# copies whose only other edit is the body of one function
OWN_BODY = {"core/draft_control.py": "solve_heterogeneous"}


def _body(path: Path) -> list[str]:
    return [ln for ln in path.read_text().splitlines() if not _IMPORT.match(ln)]


def _drop_body(lines: list[str], fn: str) -> list[str]:
    """``lines`` without the body of the top-level function ``fn``: its
    ``def`` lines stay, the block after them goes."""
    i = next(k for k, ln in enumerate(lines) if ln.startswith(f"def {fn}("))
    while not lines[i].rstrip().endswith(":"):
        i += 1
    j = i + 1
    while j < len(lines) and (not lines[j].strip() or lines[j][0].isspace()):
        j += 1
    return lines[:i + 1] + lines[j:]


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    ref, port = _body(SRC / rel), _body(PORT / rel)
    if rel == "obs/trace.py":
        old, new = TRACE_HUNK
        i = next(k for k in range(len(port)) if port[k:k + len(new)] == new)
        port = port[:i] + old + port[i + len(new):]
    if rel in OWN_BODY:
        ref, port = (_drop_body(ref, OWN_BODY[rel]),
                     _drop_body(port, OWN_BODY[rel]))
    assert port == ref, f"{rel} drifted from src/repro/{rel}"


def test_synthetic_backend_is_verbatim():
    from repro.serving import backends as jb
    from repro_torch.serving import backends as tb

    for name in ("VerificationBackend", "SyntheticBackend"):
        assert inspect.getsource(getattr(tb, name)) \
            == inspect.getsource(getattr(jb, name))


def test_port_imports_no_jax_and_nothing_of_repro():
    """Import the port, its api and every module of it in a fresh
    interpreter: neither jax nor any ``repro`` module may be loaded."""
    mods = sorted("repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
                  for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"for m in ['repro_torch', 'repro_torch.api'] + {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('jaxlib') or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(mods) > 30


@pytest.mark.parametrize("entry", [
    "repro_torch.serving.spec_engine:SpecEngine",
    "repro_torch.serving.engine:ServingEngine",
    "repro_torch.serving.kv_cache:PagedKVCache",
    "repro_torch.models.model_zoo:build_model",
    "repro_torch.models.transformer:DecoderLM",
    "repro_torch.models.ssm:MambaLM",
    "repro_torch.models.hybrid:HybridLM",
    "repro_torch.bridge:params_from_jax",
    "repro_torch.core.draws:RoundDraws.sample",
    "repro_torch.core.draws:TreeDraws.sample",
    "repro_torch.core.draws:KeyedDraws",
])
def test_entry_points_default_to_the_card(entry):
    """Every public constructor that places tensors runs on the card unless
    the caller passes ``device="cpu"``."""
    mod, _, attr = entry.partition(":")
    obj = importlib.import_module(mod)
    for part in attr.split("."):
        obj = getattr(obj, part)
    assert inspect.signature(obj).parameters["device"].default == "cuda"


def test_config_registry_is_intact():
    jcfg = importlib.import_module("repro.configs")
    tcfg = importlib.import_module("repro_torch.configs")
    assert tcfg.list_architectures() == jcfg.list_architectures()
    for name in tcfg.list_architectures():
        assert (tcfg.get_config(name).__dict__
                == jcfg.get_config(name).__dict__), name
