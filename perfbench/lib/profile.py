"""The traced run's profiled stretch: a few steady rounds under
``torch.profiler``, reduced to device intervals, kernel times, host launch
calls and the idle gaps named by the host span open at the time.

Host spans (the program's tracer and the benchmark's own) are on the
``perf_counter`` clock; the profiler's events on its own.  A
``record_function`` anchor taken at a known ``perf_counter`` instant maps
the one onto the other.
"""

from __future__ import annotations

import time

import numpy as np
import torch

LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel")


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged (start, end) intervals, sorted."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [iv[0].copy()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append(np.array([s, e]))
    return np.array(out)


def _innermost(spans, off: int) -> list[tuple[int, int, str]]:
    """The host timeline as disjoint (start, end, name) pieces, each named
    by the innermost span open over it ("(no span)" between spans), on the
    profiler's clock."""
    marks = []
    for i, sp in enumerate(spans):
        marks.append((sp.t0_ns + off, 1, i))
        marks.append((sp.t0_ns + sp.dur_ns + off, 0, i))
    marks.sort()
    out, stack, t_prev = [], [], None
    for t, kind, i in marks:
        if t_prev is not None and t > t_prev:
            out.append((t_prev, t, spans[stack[-1]].name if stack
                        else "(no span)"))
        if kind:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        t_prev = t
    return out


def _overlap(gaps: np.ndarray, pieces) -> list:
    """The parts of each gap under each named piece; parts outside every
    piece are "(no span)"."""
    out, j = [], 0
    for g0, g1 in gaps:
        t = g0
        while j < len(pieces) and pieces[j][1] <= t:
            j += 1
        k = j
        while t < g1:
            if k < len(pieces) and pieces[k][0] < g1:
                p0, p1, name = pieces[k]
                if p0 > t:
                    out.append(((t, min(p0, g1)), "(no span)"))
                    t = min(p0, g1)
                    continue
                e = min(p1, g1)
                out.append(((t, e), name))
                t = e
                k += 1
            else:
                out.append(((t, g1), "(no span)"))
                t = g1
    return out


def stretch(run, rounds: int, tracer) -> dict:
    """Run ``rounds`` rounds of ``run`` under the profiler; returns the
    reduced trace (times in ns on the profiler's clock, window seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = run.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    info = []
    if cuda:
        torch.cuda.synchronize(run.device)
    with profile(activities=acts) as prof:
        with record_function("perfbench.anchor"):
            anchor = time.perf_counter_ns()
        t_begin = time.perf_counter_ns()
        for _ in range(rounds):
            rec, _, _ = run.round()
            info.append(run.round_rows(rec))
        if cuda:
            torch.cuda.synchronize(run.device)
        t_end = time.perf_counter_ns()
    events = prof.profiler.kineto_results.events()
    off = next(e.start_ns() for e in events
               if e.name() == "perfbench.anchor") - anchor
    w0, w1 = t_begin + off, t_end + off
    dev, kern_names, launch_ns = [], [], 0
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            s, d = e.start_ns(), e.duration_ns()
            if s + d > w0 and s < w1:
                dev.append((max(s, w0), min(s + d, w1)))
                kern_names.append(e.name())
        elif e.name().startswith(LAUNCH_CALLS):
            s = e.start_ns()
            if w0 <= s < w1:
                launch_ns += e.duration_ns()
    dev = np.array(dev, dtype=np.int64).reshape(-1, 2)
    busy = _union(dev)
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0
    # device idle gaps inside the window, each cut by the innermost host
    # span open over each part of it
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    idle: dict[str, float] = {}
    for (s0, s1), name in _overlap(gaps, _innermost(tracer.snapshot(), off)):
        idle[name] = idle.get(name, 0.0) + (s1 - s0) * 1e-9
    ops: dict[str, float] = {}
    for (s, e), name in zip(dev, kern_names):
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e-9
    return {"window_s": (t_end - t_begin) * 1e-9, "busy_s": busy_ns * 1e-9,
            "launch_s": launch_ns * 1e-9, "rounds": info,
            "kernels": list(zip(kern_names, (dev[:, 1] - dev[:, 0]) * 1e-9)),
            "device_ops": sorted(ops.items(), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(idle.items(), key=lambda x: -x[1])[:10]}
