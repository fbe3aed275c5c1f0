"""Continuous batching in the port (``repro_torch.serving.continuous``) on
the CPU, with no JAX reference subprocess.

The host-side machinery (``StreamFSM``, ``BatchAssembler``) runs against
the reference's classes in-process: importing ``repro.serving.continuous``
compiles nothing.  The engine-driving tests hold the port against itself:
the forced barrier against ``spin_round`` with the same draws, the
overlapped mode on its invariants (budgets met, page pools consistent,
every page back after retire), retires from every phase, a mid-verify
disconnect, ``ContinuousBackend`` under a ``schedule="continuous"`` cell,
and the two repaired faults (F1: eager ``warmup`` is a no-op; F2:
``EngineBackend.verify`` falls back to the round's output lengths when the
engine kept no accepted counts).  Parity with the reference's engine under
replayed draws is in ``tests/test_torch_engine.py``.
"""

import types

import numpy as np
import pytest
import torch

from repro.serving import continuous as jc
from repro_torch.configs import get_config
from repro_torch.core.draws import KeyedDraws, RoundDraws
from repro_torch.serving import continuous as tc

B, MAX_LEN, VHAT, PS = 3, 96, 64, 16


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _engine(B=B, cache_kind="paged"):
    from repro_torch.serving import SpecEngine

    tcfg = get_config("qwen2.5-3b").smoke()
    dcfg = tcfg.replace(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                        head_dim=16, d_ff=64, name="draft-smoke")
    eng = SpecEngine(tcfg, dcfg, max_len=MAX_LEN, cache_kind=cache_kind,
                     num_pages=B * 2 * (MAX_LEN // PS), device="cpu")
    eng.init_params(0)
    return eng


def _prompts(B=B, M=10, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 257, (B, M)).astype(np.int32))


# ---------------------------------------------------------------------------
# state machine and assembler, against the reference's classes
# ---------------------------------------------------------------------------

def _walk(mod, start, phases):
    """Drive one FSM through ``phases``; the outcome of each step."""
    f = mod.StreamFSM(row=0, phase=start)
    out = []
    for p in phases:
        try:
            f.to(p)
            out.append(f.phase)
        except mod.IllegalTransition:
            out.append("illegal")
    return out, f.live


def test_fsm_legal_round_cycle_matches_reference():
    cycle = [tc.READY, tc.VERIFYING, tc.COMMITTING, tc.DRAFTING, tc.READY,
             tc.VERIFYING, tc.COMMITTING, tc.FINISHED, tc.RETIRED]
    got = _walk(tc, tc.DRAFTING, cycle)
    assert got == _walk(jc, jc.DRAFTING, cycle)
    assert got == (cycle, False)
    assert tc.PHASES == jc.PHASES and tc._LEGAL == jc._LEGAL


def test_fsm_every_transition_matches_reference():
    """All 36 (from, to) pairs: legal in the port iff in the reference, and
    ``retire`` legal from every live phase (and from FINISHED)."""
    for src in tc.PHASES:
        for dst in tc.PHASES:
            assert _walk(tc, src, [dst]) == _walk(jc, src, [dst]), (src, dst)
        retired = _walk(tc, src, [tc.RETIRED])[0]
        assert retired == (["illegal"] if src == tc.RETIRED else [tc.RETIRED])
    assert issubclass(tc.IllegalTransition, ValueError)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assembler_matches_reference_on_churny_ready_sets(seed):
    """The same seeded churn through both assemblers: the same groups, the
    same shapes, the trace hook firing once per new shape."""
    rng = np.random.default_rng(seed)
    port, ref = tc.BatchAssembler(max_batch=8), jc.BatchAssembler(max_batch=8)
    traced = {"port": [], "ref": []}
    port.on_assemble_trace = traced["port"].append
    ref.on_assemble_trace = traced["ref"].append
    for _ in range(40):
        ready = [(i, int(rng.integers(1, 9)))
                 for i in range(int(rng.integers(1, 13)))]
        assert port.assemble(ready) == ref.assemble(ready)
    assert port.shapes == ref.shapes
    assert traced["port"] == traced["ref"]
    assert len(traced["port"]) == len(port.shapes)


def test_assembler_bounds_twelve_ready_set_shapes_to_eight_buckets():
    port, ref = tc.BatchAssembler(max_batch=8), jc.BatchAssembler(max_batch=8)
    ready_sets = [(k, ln) for k in (1, 2, 3, 5) for ln in (3, 4, 6)]
    assert len(ready_sets) == 12
    for asm in (port, ref):
        for k, ln in ready_sets:
            asm.assemble([(object(), ln)] * k)
    assert port.shapes == ref.shapes
    assert len(port.shapes) <= 8 < len(ready_sets)
    assert all(s[0] in (1, 2, 4, 8) and s[1] in (4, 8) for s in port.shapes)


def test_assembler_exact_mode_and_max_batch_split():
    for mod in (tc, jc):
        asm = mod.BatchAssembler(max_batch=2, exact=True)
        assert [len(b) for b in asm.assemble([(i, 3) for i in range(5)])] \
            == [2, 2, 1]
        assert asm.shapes == {(2, 3), (1, 3)}


# ---------------------------------------------------------------------------
# the engine: barrier, overlap, retire, disconnect
# ---------------------------------------------------------------------------

def test_forced_barrier_bit_identical_to_spin_round():
    """With the barrier forced, dispatch ``r`` takes the draft half and the
    verify half of key ``(seed, fold r)``; ``spin_round`` fed the same
    halves commits the same tokens, and the pools end equal."""
    L, R, seed = 4, 4, 42
    draws = KeyedDraws("cpu")
    eng1 = _engine()
    st = eng1.start(_prompts())
    V = eng1.target_cfg.vocab_size
    for r in range(R):
        k = (seed, ("fold", r))
        gumbel = draws.draft(k + (("split", 0),), L, B, VHAT)
        st, _, _ = eng1.spin_round(st, np.full(B, L), RoundDraws(
            gumbel, *draws.verify(k + (("split", 1),), B, L, V)))
    eng2 = _engine()
    cont = tc.ContinuousEngine(eng2, eng2.start(_prompts()), seed,
                               max_inflight=1, exact_shapes=True, draws=draws)
    for b in range(B):
        cont.add_stream(b, length=L)
    for r in range(R):
        evs = cont.step()
        assert [ev.seq for ev in evs] == [r + 1]
    assert st.committed == cont.state.committed
    assert cont.assembler.shapes == {(B, L)}
    assert eng1.pool_stats() == eng2.pool_stats()
    np.testing.assert_array_equal(eng1.t_pages.page_table(range(B)),
                                  eng2.t_pages.page_table(range(B)))


def test_overlapped_mode_commits_and_respects_budgets():
    eng = _engine(B=4)
    cont = tc.ContinuousEngine(eng, eng.start(_prompts(B=4)), 7,
                               max_inflight=2)
    for b in range(4):
        cont.add_stream(b, length=3 + (b % 2), budget=8)
    cont.drain()
    for f in cont.fsm.values():
        assert f.phase == tc.FINISHED and f.generated >= 8
    assert cont.commits and all(0 < ev.occupancy <= 1 for ev in cont.commits)
    eng.t_pages.check_invariants()
    eng.d_pages.check_invariants()
    for b in range(4):
        cont.retire(b)
    assert eng.t_pages.num_allocated_pages == eng.d_pages.num_allocated_pages == 0


def test_retire_returns_pages_from_every_phase():
    eng = _engine()
    cont = tc.ContinuousEngine(eng, eng.start(_prompts()), 3, max_inflight=2)
    fsms = [cont.add_stream(b, length=3) for b in range(B)]
    assert fsms[0].phase == tc.DRAFTING
    used = eng.t_pages.num_allocated_pages
    cont.retire(0)
    assert eng.t_pages.num_allocated_pages < used
    cont._dispatch_draft_group([fsms[1], fsms[2]], np.array([3, 3]))
    assert fsms[1].phase == tc.READY
    used = eng.t_pages.num_allocated_pages
    cont.retire(1)
    assert fsms[1].phase == tc.RETIRED
    assert eng.t_pages.num_allocated_pages < used
    cont._dispatch_verify([fsms[2]])
    assert fsms[2].phase == tc.VERIFYING
    used = eng.t_pages.num_allocated_pages
    cont.retire(2)
    assert eng.t_pages.num_allocated_pages < used
    # the in-flight batch still lands, committing nothing for its member
    ev = cont._commit_batch(cont._inflight.popleft())
    np.testing.assert_array_equal(ev.accepted, [0])
    eng.t_pages.check_invariants()
    eng.d_pages.check_invariants()
    assert eng.t_pages.num_allocated_pages == eng.d_pages.num_allocated_pages == 0
    assert cont.done


def test_retire_from_committing_and_finished():
    eng = _engine()
    cont = tc.ContinuousEngine(eng, eng.start(_prompts()), 3)
    f = cont.add_stream(0, length=3)
    f.to(tc.READY).to(tc.VERIFYING).to(tc.COMMITTING)
    cont.retire(0)
    g = cont.add_stream(1, length=3)
    g.to(tc.READY).to(tc.VERIFYING).to(tc.COMMITTING).to(tc.FINISHED)
    cont.retire(1)
    assert f.phase == g.phase == tc.RETIRED
    assert (eng.t_pages.page_table([0, 1]) == -1).all()
    assert (eng.d_pages.page_table([0, 1]) == -1).all()
    eng.t_pages.check_invariants()


def test_mid_verify_disconnect_does_not_corrupt_batch():
    """A stream retired while its batch is in flight commits nothing and
    returns its pages at once; the other members commit as they would
    have without the disconnect."""
    results = {}
    for disconnect in (False, True):
        eng = _engine()
        cont = tc.ContinuousEngine(eng, eng.start(_prompts()), 5,
                                   max_inflight=2)
        handle = cont.dispatch_round([0, 1, 2], np.array([3, 3, 3]))
        assert handle.ticket.rows == [0, 1, 2, -1]        # bucket 4
        if disconnect:
            cont.retire(1)
            assert (eng.t_pages.page_table([1]) == -1).all()
        acc = cont.commit(handle)
        results[disconnect] = (acc, [list(c) for c in cont.state.committed])
        eng.t_pages.check_invariants()
        eng.d_pages.check_invariants()
        assert eng.last_accepted is None       # a row subset keeps none
    (acc0, com0), (acc1, com1) = results[False], results[True]
    assert acc1[1] == 0 and acc0[1] >= 1
    assert acc1[0] == acc0[0] >= 1 and acc1[2] == acc0[2] >= 1
    assert com1[0] == com0[0] and com1[2] == com0[2]
    assert len(com1[1]) == 10 < len(com0[1])


def test_row_subsets_need_a_paged_engine():
    eng = _engine(cache_kind="contiguous")
    st = eng.start(_prompts())
    gumbel = KeyedDraws("cpu").draft((0,), 4, 2, VHAT)
    with pytest.raises(RuntimeError, match="row subsets"):
        eng.draft_rows(st, [0, 1], [4, 4], gumbel)
    with pytest.raises(ValueError, match="paged"):
        tc.ContinuousEngine(eng, st)


def test_pad_to_and_padding_rows_shape_the_window():
    """``pad_to`` forces the window; a ``-1`` row is frozen, its pending
    token and positions are zero, and its pages stay unmapped."""
    eng = _engine()
    st = eng.start(_prompts())
    gumbel = KeyedDraws("cpu").draft((1,), 8, 3, VHAT)
    ticket = eng.draft_rows(st, [2, -1, 0], [2, 1, 3], gumbel, pad_to=8)
    assert ticket.L == 8 and tuple(ticket.draft.tokens.shape) == (3, 8)
    np.testing.assert_array_equal(ticket.freeze, [False, True, False])
    assert ticket.pending[1] == 0 and ticket.target_pos[1] == 0
    assert ticket.pending[0] == st.pending[2] and ticket.pending[2] == st.pending[0]
    assert eng.t_pages.length(2) == 9 + 8 + 1
    assert eng.t_pages.length(1) == 9
    eng.t_pages.check_invariants()


def test_eager_warmup_is_a_no_op():
    """F1: the reference returns ``(state, {})`` on an eager engine, and the
    continuous engine's warmup delegates to it."""
    eng = _engine()
    st = eng.start(_prompts())
    got, info = eng.warmup(st, [(B, 4), (4, 8)])
    assert got is st and info == {}
    cont = tc.ContinuousEngine(eng, st, 0)
    assert cont.warmup([1, 3], [2, 5]) == {} and cont.state is st


def test_engine_backend_falls_back_to_output_lengths():
    """F2: when the engine kept no accepted counts (a row-subset commit
    leaves ``last_accepted = None``), ``EngineBackend.verify`` returns the
    round's output lengths for its rows, as the reference does."""
    from repro_torch.api import EngineBackend, Request

    class _Engine:
        cache_kind, host_syncs, last_accepted = "contiguous", 0, None
        device = torch.device("cpu")
        target_cfg = types.SimpleNamespace(vocab_size=11)

        def spin_round(self, state, lengths, draws, **kw):
            res = types.SimpleNamespace(
                output_len=torch.tensor([3, 1, 2], dtype=torch.int32))
            return state, res, None

    state = types.SimpleNamespace(pending=torch.zeros(3), committed=[[]] * 3)
    backend = EngineBackend(_Engine(), state)
    reqs = [Request(rid=i, prompt_len=4, max_new_tokens=4) for i in range(3)]
    backend.bind(reqs)
    got = backend.verify(np.array([2, 2]), [reqs[2], reqs[0]],
                         np.random.default_rng(0))
    np.testing.assert_array_equal(got, [2, 3])


# ---------------------------------------------------------------------------
# the backend under the cell
# ---------------------------------------------------------------------------

def test_continuous_backend_serves_cell_with_churn():
    """``ContinuousBackend`` under ``schedule="continuous"`` with a
    mid-session leave and a fifth request joining late; the cell's numpy
    rng is never drawn from by the backend."""
    from repro_torch.api import (
        CellConfig,
        ContinuousBackend,
        MultiSpinCell,
        Request,
    )

    eng = _engine(B=4)
    be = ContinuousBackend(eng, eng.start(_prompts(B=4, M=8)), max_inflight=2)
    cfg = CellConfig(scheme="fixed", L_fixed=4, L_max=8, max_batch=4,
                     schedule="continuous", seed=0)
    cell = MultiSpinCell(cfg, backend=be)
    rng = np.random.default_rng(9)
    for i in range(5):
        cell.submit(Request(rid=i, prompt_len=8, max_new_tokens=8,
                            alpha=0.8, T_S=float(rng.choice([0.004, 0.03]))))
    cell.step()
    cell.step()
    cell.leave(cell.scheduler.active[0].rid)
    before = cell.rng.bit_generator.state
    be.collect(be.verify_async(np.array([4]), [cell.scheduler.active[0]],
                               cell.rng))
    assert cell.rng.bit_generator.state == before
    summary = cell.drain()
    assert cell.scheduler.stats.completed >= 4
    assert summary["tokens"] > 0
    for rec in cell.history:
        assert 0 < rec.batch_occupancy <= 1 and rec.ready_depth is not None
        assert rec.n_host_syncs == 1
    eng.t_pages.check_invariants()
    eng.d_pages.check_invariants()


def test_keyed_draws_depend_on_the_path_only():
    a, b = KeyedDraws("cpu"), KeyedDraws("cpu")
    p = (3, ("fold", 2), ("split", 1))
    assert torch.equal(a.draft(p, 4, 2, 8), b.draft(p, 4, 2, 8))
    for x, y in zip(a.verify(p, 2, 4, 11), b.verify(p, 2, 4, 11)):
        assert torch.equal(x, y)
    assert not torch.equal(a.draft(p, 4, 2, 8),
                           a.draft(p[:-1] + (("split", 0),), 4, 2, 8))
    u_accept, u_resid, bonus = a.verify(p, 2, 4, 11)
    assert (tuple(u_accept.shape), tuple(u_resid.shape),
            tuple(bonus.shape)) == ((2, 4), (2,), (2, 11))
