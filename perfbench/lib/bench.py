"""One run of one cell: set-up, the window (``trace=0``), or the window with
spans and a profiled stretch (``trace=1``), then the check.

``trace=0`` prints the cell's end-to-end metrics, taken on the host clock
with no tracer installed.  ``trace=1`` installs the program's tracer over
the window, with a device synchronise at the end of the engine's own
draft, verify and commit spans (and the benchmark's timed admission), then
runs ``profile_rounds`` more rounds under ``torch.profiler`` with a plain
tracer, and prints the per-layer metrics.  Both runs are judged the same
way (``lib/check.py``).
"""

from __future__ import annotations

import gc
import statistics
import subprocess
import time

import torch

from . import check, manifest, peaks, profile
from .serve import SYNCED_SPANS, CellRun


def _tracers():
    from repro_torch.obs import trace

    class EngineSyncTracer(trace.Tracer):
        """The program's tracer, synchronising the device only at the end
        of the engine's round spans (not at every kernel op's span)."""

        def _exit(self, sp):
            if sp.name not in SYNCED_SPANS:
                sp._sync = None
            super()._exit(sp)

    return trace, EngineSyncTracer


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_proc0: float, cache_dir: str | None, control: bool = False,
             max_rounds: int | None = None) -> dict:
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    run = CellRun(spec["config"], spec["traffic"], seed, device, cache_dir)
    run.setup()
    # what set-up made lives on: no later collection walks it again
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_proc0
    ctx = {"setup_s": setup_s, "models": (run.target, run.draft),
           "peaks": peaks}
    if not trace:
        ctx["window"] = run.window(seconds, max_rounds)
    else:
        tr, EngineSyncTracer = _tracers()
        tracer = tr.install(EngineSyncTracer(device_sync=True))
        run.wrap_admission()
        before = run.engine.step_counts()
        win = run.window(seconds, max_rounds)
        after = run.engine.step_counts()
        r0, r1 = win["rounds"]
        ctx.update(window=win, spans=tracer.snapshot(),
                   records=run.cell.history[r0:r1], admits=list(run.admits),
                   replays={s: after[s]["replays"] - before[s]["replays"]
                            for s in after})
        plain = tr.install(tr.Tracer())
        run.admit_sync = False
        ctx["profile"] = profile.stretch(
            run, int(spec["traffic"]["profile_rounds"]), plain)
        tr.uninstall()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx["peak_bytes"] = peak
    win = ctx["window"]
    mat = check.gather(run, spec["traffic"]["check"])
    target, draft, raw_t, raw_d = run.target, run.draft, run.raw_t, run.raw_d
    captures = win["captures"]
    del run
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    read = check.readings(mat, target, draft, raw_t, raw_d, device,
                          control=control)
    check_s = time.perf_counter() - t_check
    correct, table = check.judge(read, spec["limits"])
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(spec["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics, "device": dev}
    if trace:
        prof = ctx["profile"]
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        out["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in prof["device_ops"]],
            "idle_gaps": [[n, s] for n, s in prof["idle_gaps"]]}
    out["info"] = {
        "seed": int(seed), "card": _power_limit() if cuda else "cpu",
        "rounds": len(win["round_s"]), "window_s": win["seconds"],
        "round_ms_median": 1e3 * statistics.median(win["round_s"]),
        "captures_in_window": captures, "check_s": check_s,
        "judged": read["tokens_judged"]}
    if control:
        out["control"] = read["control"]
    out["check"] = table
    return out
