"""``BENCHMARK.json`` against the benchmark's contract and its own files:
keys, name and unit characters, bounds, each per-layer metric's ``moves``
reported by every cell it lists, every configuration used by a cell, and
every file a name points at present, an architecture's module included."""

import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = {w["name"]: w for w in M["workloads"]}
E2E = {m["name"]: m for m in M["end_to_end"]}


def _cells_of(metric):
    return set(metric.get("workloads", CELLS))


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "perfbench/run.py"]
    assert M["paths"] == ["perfbench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_and_units():
    names = ([c["name"] for c in M["configs"]] + list(CELLS)
             + list(E2E) + [m["name"] for m in M["per_layer"]]
             + [w["traffic"] for w in M["workloads"]]
             + [k for c in M["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    metric_names = list(E2E) + [m["name"] for m in M["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_bounds():
    assert E2E["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]


def test_every_cell_reports_setup_another_metric_and_a_layer_metric():
    for cell in CELLS:
        e2e = [n for n, m in E2E.items() if cell in _cells_of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(cell in _cells_of(m) for m in M["per_layer"]), cell


def test_moves_is_reported_by_each_listed_cell():
    for m in M["per_layer"]:
        assert m["moves"] in E2E, m["name"]
        assert _cells_of(m) <= _cells_of(E2E[m["moves"]]), m["name"]


def test_layers_are_named_alike():
    by = {}
    for m in M["per_layer"]:
        by.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by.values()), by


def test_every_configuration_keeps_a_cell_and_its_file():
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("perfbench/")
        cfg = json.loads(path.read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        for key in cfg["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size")) or \
                key == "vocab_size", key


@pytest.mark.parametrize("config", [c["file"] for c in M["configs"]])
def test_every_model_names_an_architecture_with_a_module(config):
    cfg = json.loads((ROOT / config).read_text())
    for section in (cfg, cfg["draft"]):
        names = section["architectures"]
        assert names and (BENCH / "arch"
                          / f"{names[0].lower()}.py").is_file(), names


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_files_exist(cell):
    w = CELLS[cell]
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert (BENCH / "limits" / f"{cell}.json").is_file()
    assert len({(x["config"], x["traffic"]) for x in M["workloads"]}) \
        == len(M["workloads"])


def test_every_metric_has_a_reader():
    for m in M["end_to_end"] + M["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_four_chip_share_and_budget():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, math.floor(0.25 * len(M["workloads"])))
    rs = M["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
