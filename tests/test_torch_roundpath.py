"""The port's compiled round path (``repro_torch.serving.compiled``) on the
CPU, the counterpart of ``tests/test_roundpath.py``.

Port eager already equals the reference round for round
(``tests/test_torch_engine.py``), so here ``jit`` and ``jit+donate`` are
held against port eager over the same draws: committed token ids must be
identical (exact equality, no tolerance).  On the CPU the step functions
run as they are (no CUDA graph), so these tests hold the contract the card
relies on: the steps' arguments and shapes, the build records
(``step_shapes``), one host sync a J=1 round, donated state adopted by the
caller, the refusals, the build cache.  ``tests/test_torch_cuda.py`` holds
the captured graphs against eager on the card.  No JAX engine is built.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfgs
from repro_torch.core.draws import RoundDraws, TreeDraws
from repro_torch.kernels import build
from repro_torch.serving import SpecEngine
from repro_torch.serving.compiled import COMPILE_MODES, setup_compilation_cache

B, L, VHAT, MAX_LEN = 3, 4, 64, 96
# per-round draft lengths (max L: every J=1 round is the (B, L) bucket)
LENGTHS = [[4, 2, 3], [1, 4, 4], [3, 4, 2], [4, 4, 1]]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs():
    tcfg = tcfgs.get_config("qwen2.5-3b").smoke()
    dcfg = tcfg.replace(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                        head_dim=16, d_ff=64, name="draft-smoke")
    return tcfg, dcfg


def _engine(mode, cache_kind="paged", n=B):
    tcfg, dcfg = _cfgs()
    kw = {"num_pages": n * 2 * (MAX_LEN // 16)} if cache_kind == "paged" else {}
    eng = SpecEngine(tcfg, dcfg, max_len=MAX_LEN, cache_kind=cache_kind,
                     compile_mode=mode, device="cpu", **kw)
    eng.init_params(0)
    prompts = np.random.default_rng(1).integers(0, 257, (n, 10))
    return eng, torch.from_numpy(prompts.astype(np.int32))


def _draws(r, J):
    V = _cfgs()[0].vocab_size
    if J == 1:
        return RoundDraws.sample(r, B, L, VHAT, V, device="cpu")
    return TreeDraws.sample(r, B, J, L, VHAT, V, device="cpu")


def _run(mode, cache_kind, widths=(1,)):
    """Four rounds (draft width cycling through ``widths``) after warming
    the (B, L) bucket.  Returns (engine, state, host syncs of each J=1
    round, shapes built after the warmup)."""
    eng, prompts = _engine(mode, cache_kind)
    st = eng.start(prompts)
    st, info = eng.warmup(st, [(B, L)], vhat=VHAT)
    assert bool(info) == (mode != "eager")
    built = []
    eng.on_step_trace = built.append
    syncs = []
    for r, lengths in enumerate(LENGTHS):
        J = widths[r % len(widths)]
        h0 = eng.host_syncs
        st, _, _ = eng.spin_round(st, np.asarray(lengths), _draws(r, J),
                                  vhat=VHAT, draft_width=J)
        if J == 1:
            syncs.append(eng.host_syncs - h0)
    if cache_kind == "paged":
        eng.t_pages.check_invariants()
        eng.d_pages.check_invariants()
    return eng, st, syncs, built


_COMMITTED = {}


def _committed(mode, cache_kind, widths=(1,)):
    key = (mode, cache_kind, widths)
    if key not in _COMMITTED:
        _, st, _, _ = _run(mode, cache_kind, widths)
        _COMMITTED[key] = [list(map(int, c)) for c in st.committed]
    return _COMMITTED[key]


@pytest.mark.parametrize("cache_kind", ["paged", "contiguous"])
@pytest.mark.parametrize("mode", ["jit", "jit+donate"])
def test_compiled_identical_to_eager(mode, cache_kind):
    assert _committed(mode, cache_kind) == _committed("eager", cache_kind)


@pytest.mark.parametrize("cache_kind", ["paged", "contiguous"])
def test_mixed_width_rounds_identical(cache_kind):
    """J=1 rounds run the compiled steps, J>1 rounds the eager tree path on
    the same caches and state: alternating them must still match eager."""
    widths = (1, 2, 1, 2)
    assert _committed("jit+donate", cache_kind, widths) \
        == _committed("eager", cache_kind, widths)


@pytest.mark.parametrize("mode", COMPILE_MODES)
def test_one_host_sync_per_linear_round(mode):
    _, _, syncs, _ = _run(mode, "paged")
    assert syncs == [1] * len(LENGTHS), syncs


@pytest.mark.parametrize("mode", ["jit", "jit+donate"])
def test_warmup_bounds_builds(mode):
    """``warmup([(B, L)])`` builds draft, verify and commit at the bucket;
    rounds at that bucket build nothing more."""
    eng, _, _, built = _run(mode, "paged")
    assert eng.step_shapes == {("draft", B, L), ("verify", B, L),
                               ("commit", B, L)}
    assert built == [], f"built after warmup: {built}"
    # on the CPU nothing is captured or replayed
    assert eng.step_counts()["verify"] == {"captures": 0, "replays": 0}


def test_donated_state_is_adopted():
    """jit+donate keeps the state in the commit's donated buffers: warmup
    hands back those buffers (same values) and every J=1 commit returns
    them, updated in place."""
    eng, prompts = _engine("jit+donate")
    st0 = eng.start(prompts)
    values = [t.clone() for t in (st0.pending, st0.target_pos, st0.draft_pos)]
    st, _ = eng.warmup(st0, [(B, L)], vhat=VHAT)
    bufs = (st.pending, st.target_pos, st.draft_pos)
    assert all(torch.equal(a, b) for a, b in zip(bufs, values))
    assert st.pending is not st0.pending
    st, _, _ = eng.spin_round(st, np.asarray(LENGTHS[0]), _draws(0, 1),
                              vhat=VHAT)
    assert all(a is b for a, b in zip(
        (st.pending, st.target_pos, st.draft_pos), bufs))
    assert all(torch.equal(t, torch.tensor([len(c) - 1 for c in st.committed],
                                           dtype=torch.int32))
               for t in (st.target_pos, st.draft_pos))


@pytest.mark.parametrize("mode", ["eager", "jit+donate"])
def test_roundrecord_reports_host_syncs(mode):
    """The cell's per-round telemetry carries the engine's host-transfer
    count: exactly one device->host fetch per committed round."""
    from repro_torch.api import CellConfig, EngineBackend, MultiSpinCell, Request

    eng, prompts = _engine(mode)
    st = eng.start(prompts)
    st, _ = eng.warmup(st, [(B, n) for n in range(1, L + 1)], vhat=VHAT)
    backend = EngineBackend(eng, st)
    cfg = CellConfig(scheme="hete", t_ver_fix=0.03, t_ver_lin=0.002,
                     L_max=L, max_batch=B, seed=0)
    cell = MultiSpinCell(cfg, backend=backend, rng=np.random.default_rng(0))
    for i in range(B):
        cell.submit(Request(rid=i, prompt_len=6, max_new_tokens=10 ** 9,
                            alpha=0.8, T_S=0.03))
    cell.admit()
    for _ in range(3):
        rec = cell.step()
        assert rec.n_host_syncs == 1, rec.n_host_syncs


def test_invalid_compile_mode_rejected():
    tcfg, _ = _cfgs()
    with pytest.raises(ValueError, match="compile_mode"):
        SpecEngine(tcfg, tcfg, max_len=32, compile_mode="aot", device="cpu")


def test_compile_mode_defaults_to_eager_or_repro_compile(monkeypatch):
    tcfg, dcfg = _cfgs()
    monkeypatch.delenv("REPRO_COMPILE", raising=False)
    assert SpecEngine(tcfg, dcfg, max_len=32,
                      device="cpu").compile_mode == "eager"
    monkeypatch.setenv("REPRO_COMPILE", "jit")
    assert SpecEngine(tcfg, dcfg, max_len=32, device="cpu").compile_mode == "jit"


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_ssm_and_hybrid_targets_refuse_compiled_modes(arch):
    _, dcfg = _cfgs()
    tcfg = tcfgs.get_config(arch).smoke()
    with pytest.raises(NotImplementedError, match="compiled round steps"):
        SpecEngine(tcfg, dcfg, max_len=32, compile_mode="jit+donate",
                   device="cpu")
    SpecEngine(tcfg, dcfg, max_len=32, compile_mode="eager", device="cpu")


def test_compile_modes_are_the_reference_names():
    from repro.serving.compiled import COMPILE_MODES as REFERENCE

    assert COMPILE_MODES == REFERENCE


def test_setup_compilation_cache(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    before = build.BUILD_DIR
    monkeypatch.delenv("REPRO_COMPILE_CACHE", raising=False)
    assert setup_compilation_cache() is None
    assert build.BUILD_DIR == before
    got = setup_compilation_cache(str(tmp_path / "a" / "kernels"))
    assert got == str((tmp_path / "a" / "kernels").resolve())
    assert (tmp_path / "a" / "kernels").is_dir()
    assert build.BUILD_DIR == tmp_path / "a" / "kernels"
    monkeypatch.setenv("REPRO_COMPILE_CACHE", str(tmp_path / "env"))
    assert setup_compilation_cache() == str(tmp_path / "env")
    assert build.BUILD_DIR == tmp_path / "env" and (tmp_path / "env").is_dir()
    # the engine installs it under a compiled mode only, as the reference
    tcfg, dcfg = _cfgs()
    SpecEngine(tcfg, dcfg, max_len=32, compile_mode="jit",
               compile_cache=str(tmp_path / "eng"), device="cpu")
    assert build.BUILD_DIR == tmp_path / "eng"
    SpecEngine(tcfg, dcfg, max_len=32, compile_cache=str(tmp_path / "no"),
               device="cpu")
    assert build.BUILD_DIR == tmp_path / "eng"


def paced_two_tickets(cont):
    """An externally paced continuous sequence on rows 0-3 with
    ``max_batch=2``: two draft groups of one (2, 4) bucket alive before
    either verifies, verified out of order, then batches merged across
    the two groups.  Returns (rows, accepted, committed) per commit."""
    out = []

    def land(batch):
        acc = cont.commit(batch)
        out.append((list(batch.ticket.rows), [int(a) for a in acc],
                    [[int(t) for t in c] for c in cont.state.committed]))

    for _ in range(2):
        f = {r: cont.ensure_stream(r) for r in range(4)}
        cont._dispatch_draft_group([f[0], f[1]], np.array([4, 3]))
        cont._dispatch_draft_group([f[2], f[3]], np.array([2, 4]))
        first = cont._dispatch_verify([f[0], f[1]])
        second = cont._dispatch_verify([f[2], f[3]])
        land(second)
        land(first)
        cont._dispatch_draft_group([f[0], f[1]], np.array([3, 4]))
        cont._dispatch_draft_group([f[2], f[3]], np.array([4, 1]))
        merged = cont._dispatch_verify([f[0], f[2]])
        rest = cont._dispatch_verify([f[1], f[3]])
        land(merged)
        land(rest)
    return out


def test_continuous_warmup_then_paced_run_equals_eager():
    """``ContinuousEngine.warmup`` builds the assembler's buckets and adopts
    the engine's state; a paced run with two draft tickets of one bucket
    alive at once then commits what the eager engine commits, building
    nothing more."""
    from repro_torch.serving.continuous import ContinuousEngine

    out = {}
    for mode in ("eager", "jit+donate"):
        eng, prompts = _engine(mode, n=4)
        st = eng.start(prompts)
        cont = ContinuousEngine(eng, st, 9, vhat=VHAT, max_inflight=2,
                                max_batch=2)
        info = cont.warmup([2], [4])
        assert bool(info) == (mode != "eager")
        built = []
        eng.on_step_trace = built.append
        out[mode] = paced_two_tickets(cont)
        assert built == []
        eng.t_pages.check_invariants()
        eng.d_pages.check_invariants()
    assert out["jit+donate"] == out["eager"]
    assert all(sum(acc) > 0 for _, acc, _ in out["eager"])


@pytest.mark.parametrize("mode", COMPILE_MODES)
def test_linear_round_spans_are_the_same_in_every_mode(mode):
    """A J=1 round emits the same engine spans in every mode, each over
    the same work: ``engine.verify_step`` is the target pass and the
    accept test together (one step body), so no mode emits the split
    ``engine.target_pass`` / ``engine.verify_tokens`` of a tree round."""
    from repro_torch.obs import trace

    eng, prompts = _engine(mode)
    st = eng.start(prompts)
    st, _ = eng.warmup(st, [(B, L)], vhat=VHAT)
    tracer = trace.install(trace.Tracer())
    try:
        eng.spin_round(st, np.asarray(LENGTHS[0]), _draws(0, 1), vhat=VHAT)
    finally:
        trace.uninstall()
    names = {sp.name for sp in tracer.spans if sp.name.startswith("engine.")}
    assert names == {"engine.page_alloc", "engine.draft", "engine.verify_step",
                     "engine.commit", "engine.page_free"}, names
