"""The CPU smoke cell the tests drive: a Qwen2-shaped pair at test width
(``data/``), the whole harness run on the CPU (the port's plain kernels,
its compiled modes without graphs), judged against ``data/smoke_limits``."""

import json
import sys
import time
from pathlib import Path

DATA = Path(__file__).resolve().parent / "data"
ROOT = DATA.parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def spec(limits: bool = True) -> dict:
    return {"name": "smoke", "chips": 1,
            "config": json.loads((DATA / "smoke_config.json").read_text()),
            "traffic": json.loads((DATA / "smoke_traffic.json").read_text()),
            "limits": (json.loads((DATA / "smoke_limits.json").read_text())
                       ["limits"] if limits else None),
            "end_to_end": [{"name": n, "unit": "x"} for n in
                           ("goodput_tok_s", "round_p95_ms", "setup_s")],
            "per_layer": [{"name": n, "unit": "x"} for n in
                          ("cell.plan_ms", "cell.draft_len",
                           "backend.host_syncs", "engine.draft_ms",
                           "engine.verify_ms", "engine.admit_ms",
                           "compiled.replays", "cell.ttft_p95_ms")]}


def run(seed: int = 1002, rounds: int = 60, trace: bool = False,
        control: bool = False) -> dict:
    from perfbench.lib import bench

    return bench.run_cell(spec(), seed, 600.0, trace, "cpu",
                          time.perf_counter(), None, control=control,
                          max_rounds=rounds)
