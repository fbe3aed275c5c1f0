"""The port's own spans below the cell: admission and retirement
(``SpecEngine.add_streams`` / ``retire_stream``), the compiled steps' calls
(``StepGraphs``) and the planner's two phases (``solve_heterogeneous``),
and the benchmark's readers of them (``perfbench/metrics``).

On the CPU an admission's span carries its fetch count and no ``device_ms``
(no events); a compiled round's ``compiled.*`` spans sit inside the
engine's round spans, and eager rounds emit none.  ``StepGraphs.settle``
is held on stand-in events.  The one ``gpu`` test holds the events on the
card: every traced replay and admission gets its ``device_ms``, and an
untraced one builds no event.  This file imports no jax.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfgs
from repro_torch.core.draft_control import solve_heterogeneous
from repro_torch.core.draws import RoundDraws
from repro_torch.obs import trace
from repro_torch.serving import SpecEngine
from repro_torch.serving.compiled import COMPILE_MODES, StepGraphs

ROOT = Path(__file__).resolve().parents[1]
B, L, VHAT, MAX_LEN = 3, 4, 64, 96
ROUND_SPANS = {"compiled.draft": "engine.draft",
               "compiled.verify": "engine.verify_step",
               "compiled.commit": "engine.commit"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graph replays and timing events)")
    return torch.device("cuda")


def _engine(mode="jit+donate", device="cpu", warm=True):
    """A paged smoke engine of B streams, warmed at the (B, L) bucket
    unless ``warm`` is false."""
    tcfg = tcfgs.get_config("qwen2.5-3b").smoke()
    dcfg = tcfg.replace(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                        head_dim=16, d_ff=64, name="draft-smoke")
    eng = SpecEngine(tcfg, dcfg, max_len=MAX_LEN, cache_kind="paged",
                     num_pages=B * 2 * (MAX_LEN // 16), compile_mode=mode,
                     device=device)
    eng.init_params(0)
    prompts = np.random.default_rng(1).integers(0, 257, (B, 10))
    st = eng.start(torch.from_numpy(prompts.astype(np.int32)).to(device))
    if warm:
        st, _ = eng.warmup(st, [(B, L)], vhat=VHAT)
    return eng, st


def _prompt(M, device="cpu"):
    ids = np.random.default_rng(M).integers(0, 257, (1, M)).astype(np.int32)
    return torch.from_numpy(ids).to(device)


def _round(eng, st, device="cpu"):
    V = eng.target_cfg.vocab_size
    st, _, _ = eng.spin_round(st, np.array([L, 2, 3]),
                              RoundDraws.sample(0, B, L, VHAT, V, device),
                              vhat=VHAT)
    return st


def _named(tracer, prefix):
    return [sp for sp in tracer.snapshot() if sp.name.startswith(prefix)]


# ---------------------------------------------------------------------------
# admission and retirement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("traced", [True, False])
def test_admission_counts_its_four_fetches_apart_from_the_rounds(traced):
    """Every admission makes four blocking copies (the prompts and the
    state's three vectors), counted in ``admit_syncs`` and, traced, in the
    ``engine.admit_sync`` counter; the round's ``host_syncs`` stays put."""
    eng, st = _engine()
    eng.retire_stream(1)
    a0, h0 = eng.admit_syncs, eng.host_syncs
    with trace.tracing() as tracer:
        if not traced:
            trace.uninstall()
        st, rows = eng.add_streams(st, _prompt(12))
    assert rows == [1]
    assert eng.admit_syncs - a0 == 4 and eng.host_syncs == h0
    assert tracer.counters() == ({"engine.admit_sync": 4} if traced else {})
    assert (tracer.snapshot() != []) == traced


def test_admission_span_and_its_three_children():
    eng, st = _engine()
    with trace.tracing() as tracer:
        st, rows = eng.add_streams(st, _prompt(12))
    (admit,) = [sp for sp in tracer.snapshot() if sp.name == "engine.admit"]
    assert admit.args == {"n": 1, "M": 12, "bucket": 16, "rows": [B],
                          "syncs": 4}
    children = [sp for sp in tracer.snapshot()
                if sp.parent_sid == admit.sid and sp.name.startswith("engine.")]
    assert [sp.name for sp in sorted(children, key=lambda s: s.sid)] == [
        "engine.admit_pages", "engine.admit_prefill", "engine.admit_splice"]
    assert all(sp.t0_ns >= admit.t0_ns for sp in children)
    # the prefill's kernel ops sit under the prefill child
    prefill = next(sp for sp in children if sp.name == "engine.admit_prefill")
    ops = _named(tracer, "ops.")
    assert ops and all(sp.parent_sid != admit.sid for sp in ops)
    assert any(sp.parent_sid == prefill.sid for sp in ops)


def test_retirement_span_names_its_row():
    eng, _ = _engine()
    with trace.tracing() as tracer:
        eng.retire_stream(2)
        eng.retire_stream(2)          # already retired: nothing to do
    spans = _named(tracer, "engine.retire")
    assert [(sp.name, sp.args) for sp in spans] == [("engine.retire",
                                                     {"row": 2})]


# ---------------------------------------------------------------------------
# the compiled steps' calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", COMPILE_MODES)
def test_round_emits_one_span_per_compiled_step(mode):
    """A J=1 round of a compiled mode calls each step once, each call a
    ``compiled.<step>`` span inside its engine span with the bucket's n
    and L, and no ``device_ms`` on the CPU; eager has no steps to call."""
    eng, st = _engine(mode)
    with trace.tracing() as tracer:
        _round(eng, st)
    by_sid = {sp.sid: sp for sp in tracer.snapshot()}
    steps = _named(tracer, "compiled.")
    if mode == "eager":
        assert steps == []
        return
    assert sorted(sp.name for sp in steps) == sorted(ROUND_SPANS)
    for sp in steps:
        assert by_sid[sp.parent_sid].name == ROUND_SPANS[sp.name]
        assert sp.args == {"n": B, "L": L}
    assert eng._steps.graphs._timed == []


def test_capture_span_per_build():
    """Each build is a ``compiled.capture`` span (step, n, L); building
    alone (``run=False``) calls no step."""
    eng, st = _engine("jit", warm=False)
    with trace.tracing() as tracer:
        eng.warmup(st, [(B, 2), (B, 5)], vhat=VHAT)
    assert sorted((sp.name, sp.args["step"], sp.args["n"], sp.args["L"])
                  for sp in _named(tracer, "compiled.")) == sorted(
        ("compiled.capture", s, B, Lw) for s in ("draft", "verify", "commit")
        for Lw in (2, 5))


class _Event:
    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.t - self.t


def test_settle_times_finished_replays_and_keeps_the_rest():
    """``settle`` sets ``device_ms`` on the spans whose end event has run
    and keeps the others (a ticket still in flight) for a later call."""
    tracer = trace.Tracer()
    g = StepGraphs(None)
    spans = [tracer.span(f"compiled.{s}") for s in ("draft", "verify")]
    late = _Event(9.0, done=False)
    g._timed = [(spans[0], _Event(1.0), _Event(3.5)),
                (spans[1], _Event(4.0), late)]
    g.settle()
    assert spans[0].args == {"device_ms": 2.5} and spans[1].args is None
    late.done = True
    g.settle()
    assert spans[1].args == {"device_ms": 5.0} and g._timed == []
    g.settle()                        # nothing left: a no-op


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 6, 24])
def test_planner_phases_leave_the_plan_bit_for_bit(K):
    rng = np.random.default_rng(K)
    args = (rng.uniform(0.6, 0.9, K), rng.uniform(0.007, 0.011, K),
            rng.uniform(1.0, 3.0, K), 16 * 17.0, 1e6, 0.035)
    plain = solve_heterogeneous(*args, L_max=8)
    with trace.tracing() as tracer:
        traced = solve_heterogeneous(*args, L_max=8)
    lengths, equalize = tracer.snapshot()
    assert (lengths.name, equalize.name) == ("cell.plan_lengths",
                                             "cell.plan_equalize")
    assert lengths.args["iters"] >= 1
    assert 1 <= equalize.args["rows"] <= equalize.args["grid"] == 40 * 40
    assert np.array_equal(plain.lengths, traced.lengths)
    assert np.array_equal(plain.bandwidth, traced.bandwidth)
    assert (plain.goodput, plain.equalized_latency) == (
        traced.goodput, traced.equalized_latency)


# ---------------------------------------------------------------------------
# the benchmark's readers of these spans
# ---------------------------------------------------------------------------

def _reader(name):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "obs_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sp(name, dur_ms=0.0, **args):
    return SimpleNamespace(name=name, dur_ns=int(dur_ms * 1e6),
                           args=args or None)


SPANS = [
    _sp("engine.admit", 30.0, n=1, M=900, bucket=1024, syncs=4,
        device_ms=20.0),
    _sp("engine.admit", 50.0, n=2, M=1500, bucket=2048, syncs=4,
        device_ms=40.0),
    _sp("engine.admit", 5.0, n=1, M=8, bucket=8),   # raised: no exit args
    _sp("compiled.draft", 2.0, n=24, L=8, device_ms=30.0),
    _sp("compiled.draft", 3.0, n=24, L=7, device_ms=34.0),
    _sp("compiled.draft", 1.0, n=24, L=7),          # still in flight
    _sp("compiled.verify", 1.5, n=24, L=8, device_ms=12.0),
    _sp("compiled.verify", 0.5, n=24, L=7, device_ms=10.0),
    _sp("compiled.commit", 0.25, n=24, L=8, device_ms=0.5),
    _sp("compiled.commit", 0.25, n=24, L=7, device_ms=0.25),
    _sp("compiled.capture", 900.0, step="draft", n=24, L=6),
    _sp("engine.draft", 60.0, B=24, L=8),
    _sp("cell.plan_equalize", 3.0, grid=1600, rows=400),
    _sp("cell.plan_equalize", 2.0, grid=1600, rows=480),
    _sp("cell.plan_equalize", 9.0),                 # a planner without args
]


@pytest.mark.parametrize("name, want", [
    ("engine.admit_device_ms", 30.0),
    ("engine.admit_syncs", 4.0),
    ("compiled.draft_device_ms", 32.0),
    ("compiled.verify_device_ms", 11.0),
    ("compiled.commit_device_ms", 0.375),
    ("compiled.replay_ms", 4.25),
    ("cell.plan_rows", 27.5),
])
def test_reader_of_the_new_spans(name, want):
    """Per admission, the mean over the admissions that carry the arg; per
    round, the sum over the window's two rounds; per plan, the mean share
    of the plans that carry it."""
    ctx = {"spans": SPANS, "records": [object(), object()]}
    assert _reader(name)(ctx) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", [
    "engine.admit_device_ms", "engine.admit_syncs",
    "compiled.draft_device_ms", "compiled.verify_device_ms",
    "compiled.commit_device_ms", "compiled.replay_ms", "cell.plan_rows"])
@pytest.mark.parametrize("spans", ["none", "without_args"])
def test_reader_finds_nothing(name, spans):
    """A program without these spans (or, on the CPU, without events)
    reads None, and nothing raises."""
    have = [] if spans == "none" else [
        _sp("engine.admit", 1.0), _sp("engine.draft", 1.0),
        _sp("engine.verify_step", 1.0), _sp("cell.plan_equalize", 1.0)]
    ctx = {"spans": have, "records": [object()]}
    assert _reader(name)(ctx) is None


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_events_time_every_traced_replay_and_admission(cuda, monkeypatch):
    """On a paged jit+donate engine, an admission and a round under a
    tracer give ``engine.admit`` and every ``compiled.*`` span a positive
    ``device_ms``, each within its span's host time; with no tracer,
    another admission and round build no ``torch.cuda.Event``."""
    eng, st = _engine("jit+donate", cuda)
    eng.retire_stream(1)
    with trace.tracing() as tracer:
        st, rows = eng.add_streams(st, _prompt(12, cuda))
        st = _round(eng, st, cuda)
    assert rows == [1]
    spans = [sp for sp in tracer.snapshot()
             if sp.name == "engine.admit" or sp.name in ROUND_SPANS]
    assert sorted(sp.name for sp in spans) == sorted(
        ["engine.admit", *ROUND_SPANS])
    for sp in spans:
        assert sp.args["device_ms"] > 0, sp.name
    admit = spans[[sp.name for sp in spans].index("engine.admit")]
    assert admit.args["syncs"] == 4
    assert admit.args["device_ms"] < admit.dur_ns * 1e-6
    assert eng._steps.graphs._timed == []

    def refuse(*a, **k):
        raise AssertionError("a timing event was built with no tracer")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    eng.retire_stream(2)
    st, rows = eng.add_streams(st, _prompt(20, cuda))
    st = _round(eng, st, cuda)
    assert rows == [2] and eng.step_counts()["draft"]["replays"] == 2
