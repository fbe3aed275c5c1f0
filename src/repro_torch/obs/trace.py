"""Span tracer for the Multi-SPIN serving stack (stdlib only).

Design goals, in priority order:

1. **Free when off.**  Every instrumented call site goes through the
   module-level ``span(...)`` helper; with no tracer installed it returns
   the shared ``NULL_SPAN`` singleton — one function call, no allocation,
   no lock.  Call sites that would build an ``args`` dict guard on
   ``active()`` first so even the dict is never constructed.
2. **Thread-correct nesting.**  The gateway steps the cell on a worker
   thread while scrapes run on the event loop; each thread keeps its own
   span stack (``threading.local``), so parent/child links never cross
   threads and concurrent spans cannot corrupt each other.
3. **Bounded memory.**  Finished spans land in a ``deque(maxlen=capacity)``
   ring: a long-lived gateway with tracing left on degrades to "last N
   spans", never to OOM.
4. **Honest device timing, opt-in.**  JAX dispatch is asynchronous — the
   wall-clock around an ``ops.*`` call measures dispatch, not compute.
   A ``Tracer(device_sync=True)`` calls ``jax.block_until_ready`` on the
   value attached to each span (``sp.attach(out)``) before closing it, so
   span durations become device-true.  The import of jax is lazy and only
   happens when device sync is actually enabled, keeping this module (and
   the gateway importing it) jax-free.

Usage::

    from repro_torch.obs import trace

    tracer = trace.install(trace.Tracer())
    with trace.span("cell.step", cat="cell") as sp:
        ...
        sp.set(rounds=3)          # attach args at exit
    json_dict = tracer.export_chrome_trace()   # load in Perfetto
    trace.uninstall()

The exported dict follows the Chrome trace-event format: complete ("X")
events with microsecond ``ts``/``dur``, one ``tid`` per python thread, so
nesting renders as flame stacks in Perfetto / chrome://tracing.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque

__all__ = [
    "NULL_SPAN",
    "Span",
    "Tracer",
    "active",
    "incr",
    "install",
    "span",
    "tracing",
    "uninstall",
]


class _NullSpan:
    """Shared no-op span: the disabled-tracing fast path.  A single module
    lifetime instance is ever created (identity-tested by the no-op guard
    test), so instrumented code costs zero allocations when tracing is
    off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        pass

    def attach(self, value):
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One live span.  Use as a context manager; the tracer records it on
    exit.  ``set(**args)`` merges key/values into the exported ``args``;
    ``attach(value)`` hands the tracer a jax value to block on at exit when
    device sync is enabled (no-op otherwise)."""

    __slots__ = ("tracer", "name", "cat", "args", "sid", "parent_sid",
                 "tid", "t0_ns", "dur_ns", "_sync")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: dict | None):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.sid = -1
        self.parent_sid = -1
        self.tid = 0
        self.t0_ns = 0
        self.dur_ns = 0
        self._sync = None

    def set(self, **args):
        if self.args is None:
            self.args = {}
        self.args.update(args)

    def attach(self, value):
        self._sync = value

    def __enter__(self):
        self.tracer._enter(self)
        return self

    def __exit__(self, *exc):
        self.tracer._exit(self)
        return False


class Tracer:
    """Bounded, thread-safe span recorder with Chrome-trace export.

    ``capacity`` bounds the retained finished spans (a ring — oldest spans
    fall off first).  ``device_sync=True`` makes span exits call
    ``jax.block_until_ready`` on each span's attached value, turning
    dispatch timings into device timings (lazy jax import; only pay for it
    if you ask)."""

    def __init__(self, capacity: int = 65536, device_sync: bool = False):
        self.capacity = int(capacity)
        self.device_sync = bool(device_sync)
        self.spans: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        self._ids = itertools.count()
        self._tls = threading.local()
        self._lock = threading.Lock()
        self.t0_ns = time.perf_counter_ns()
        self._block = None
        # monotonically increasing named counters (host-transfer accounting:
        # the engine bumps ``engine.host_sync`` at every blocking device
        # fetch) — unbounded only in name count, which instrumentation fixes
        self._counters: dict[str, int] = {}

    # -- span lifecycle (called by Span.__enter__/__exit__) --------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _enter(self, sp: Span):
        st = self._stack()
        sp.sid = next(self._ids)
        sp.parent_sid = st[-1].sid if st else -1
        sp.tid = threading.get_ident()
        st.append(sp)
        sp.t0_ns = time.perf_counter_ns()

    def _exit(self, sp: Span):
        if self.device_sync and sp._sync is not None:
            if self._block is None:
                import torch

                def _sync(value):
                    if (getattr(value, "is_cuda", False)
                            and not torch.cuda.is_current_stream_capturing()):
                        torch.cuda.synchronize(value.device)
                self._block = _sync
            self._block(sp._sync)
            sp._sync = None
        sp.dur_ns = time.perf_counter_ns() - sp.t0_ns
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:          # tolerate out-of-order exits, never corrupt
            st.remove(sp)
        with self._lock:
            if len(self.spans) == self.capacity:
                self.dropped += 1
            self.spans.append(sp)

    # -- public API ------------------------------------------------------

    def span(self, name: str, cat: str = "repro",
             args: dict | None = None) -> Span:
        return Span(self, name, cat, args)

    def incr(self, name: str, n: int = 1) -> None:
        """Bump a named counter (thread-safe).  Counters ride the tracer so
        host-transfer accounting is free when tracing is off — the module
        level ``incr`` is a no-op without an installed tracer."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def counters(self) -> dict[str, int]:
        """Snapshot of the named counters."""
        with self._lock:
            return dict(self._counters)

    def clear(self):
        with self._lock:
            self.spans.clear()
            self.dropped = 0
            self.t0_ns = time.perf_counter_ns()
            self._counters.clear()

    def snapshot(self) -> list[Span]:
        """Finished spans, oldest first (thread-safe copy)."""
        with self._lock:
            return list(self.spans)

    def totals(self) -> dict[str, dict]:
        """Per-name aggregate: count and summed duration (seconds) over the
        retained ring."""
        out: dict[str, dict] = {}
        for sp in self.snapshot():
            t = out.setdefault(sp.name, {"count": 0, "seconds": 0.0})
            t["count"] += 1
            t["seconds"] += sp.dur_ns * 1e-9
        return out

    def export_chrome_trace(self, process_name: str = "multi-spin") -> dict:
        """The trace as a Chrome trace-event JSON object (Perfetto /
        chrome://tracing load it directly).  Spans become complete ("X")
        events with microsecond timestamps relative to tracer start; each
        python thread is a ``tid`` so nesting renders as flame stacks."""
        events = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": process_name},
        }]
        tids: dict[int, int] = {}
        for sp in self.snapshot():
            tid = tids.setdefault(sp.tid, len(tids) + 1)
            ev = {
                "name": sp.name,
                "cat": sp.cat,
                "ph": "X",
                "pid": 1,
                "tid": tid,
                "ts": (sp.t0_ns - self.t0_ns) / 1e3,
                "dur": sp.dur_ns / 1e3,
            }
            args = dict(sp.args) if sp.args else {}
            args["sid"] = sp.sid
            if sp.parent_sid >= 0:
                args["parent_sid"] = sp.parent_sid
            ev["args"] = args
            events.append(ev)
        for thread_ident, tid in tids.items():
            events.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                "args": {"name": f"thread-{thread_ident}"},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": self.dropped,
                          "counters": self.counters()},
        }

    def export_chrome_trace_json(self, **kw) -> str:
        return json.dumps(self.export_chrome_trace(**kw))


# ---------------------------------------------------------------------------
# module-level tracer (what instrumented call sites use)
# ---------------------------------------------------------------------------

_tracer: Tracer | None = None


def install(tracer: Tracer | None = None) -> Tracer:
    """Install ``tracer`` (or a fresh default one) as the process-wide
    tracer and return it.  Instrumented call sites pick it up on their next
    ``span()`` call — no re-wiring."""
    global _tracer
    _tracer = tracer if tracer is not None else Tracer()
    return _tracer


def uninstall() -> None:
    """Remove the process-wide tracer: every ``span()`` call reverts to the
    free ``NULL_SPAN`` path."""
    global _tracer
    _tracer = None


def active() -> Tracer | None:
    """The installed tracer, or None.  Hot paths that would build an args
    dict should guard on this so the dict is never constructed when
    tracing is off."""
    return _tracer


def span(name: str, cat: str = "repro", args: dict | None = None):
    """Open a span on the installed tracer; the shared no-op singleton when
    tracing is off (zero allocations)."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return t.span(name, cat=cat, args=args)


def incr(name: str, n: int = 1) -> None:
    """Bump a named counter on the installed tracer; free no-op when tracing
    is off (one global read, no allocation)."""
    t = _tracer
    if t is not None:
        t.incr(name, n)


class tracing:
    """Scoped install: ``with tracing() as tracer: ...`` installs a tracer
    for the block and restores the previous one after (tests and benches
    use this so they cannot leak a tracer into later code)."""

    def __init__(self, tracer: Tracer | None = None):
        self.tracer = tracer if tracer is not None else Tracer()
        self._prev: Tracer | None = None

    def __enter__(self) -> Tracer:
        global _tracer
        self._prev = _tracer
        _tracer = self.tracer
        return self.tracer

    def __exit__(self, *exc):
        global _tracer
        _tracer = self._prev
        return False
