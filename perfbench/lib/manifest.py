"""``BENCHMARK.json`` and the files it names, found by name.

A cell is a ``workloads`` entry: its configuration's file (``configs[].file``),
its traffic mix (``perfbench/traffic/<traffic>.json``), its limits
(``perfbench/limits/<cell>.json``), and the metrics it reports, each read
by ``perfbench/metrics/<metric>.py``.  Each model of a configuration is
served and judged through the module of its published ``architectures``
name, ``perfbench/arch/<name lowercased>.py`` (``lib/config.py`` says what
the module provides).  Adding a configuration, an architecture, a mix, a
cell or a metric adds files and entries; no code changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(manifest: dict, name: str, root: Path = ROOT) -> dict:
    """Everything one cell needs, by its name."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    limits = BENCH / "limits" / f"{name}.json"
    return {
        "name": name,
        "chips": int(w["chips"]),
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
        "limits": (json.loads(limits.read_text())["limits"]
                   if limits.exists() else None),
        "end_to_end": [m for m in manifest["end_to_end"]
                       if _applies(m, name)],
        "per_layer": [m for m in manifest["per_layer"] if _applies(m, name)],
    }


def load_module(path: Path, name: str):
    """The module in the file ``path``, imported under ``name`` (in
    ``sys.modules`` while it runs, as dataclasses need)."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(ctx)`` of ``perfbench/metrics/<metric>.py``."""
    return load_module(BENCH / "metrics" / f"{metric}.py",
                       "perfbench_metric_" + metric).read
