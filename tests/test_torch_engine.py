"""The port's J=1 paged serving path on the CPU against the JAX package's.

Randomness is replayed: ``jax_draws(seed, B, L, vhat, V)`` rebuilds, as
tensors, exactly the draws the reference takes from ``PRNGKey(seed)`` —
``spin_round`` splits the key into (draft, verify); drafting splits the
draft key into L step keys, one Gumbel (B, vhat) each; verification splits
the verify key into 3 for the accept uniforms, the residual uniforms and the
bonus Gumbel (B, V).  ``jax_draws(..., J=J)`` is the tree round's form
(``tests/test_torch_tree.py``).  ``JaxKeyedDraws`` is the continuous
engine's form: the same draws at a key path (the reference derives its keys
per dispatch, ``fold_in`` and ``split`` of one root key).  Both sides carry the same weights
(``bridge.params_from_jax``).  Sampled tokens, accept masks, counts,
committed lists, page tables and ``pool_stats`` must be identical; float
outputs agree within 2e-5 (``_tol(float32)`` of ``tests/test_kernels.py``).

The reference engines run in ONE subprocess (this file as a script):
compiling several JAX engines late in a long pytest process can segfault the
XLA CPU compiler (ROADMAP §C).  The port's side runs here on the CPU.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs as tcfgs
from repro_torch.bridge import params_from_jax
from repro_torch.core.draws import KeyedDraws, RoundDraws, TreeDraws

B, MAX_LEN, VHAT, PS = 3, 96, 64, 16
NUM_PAGES = B * 2 * (MAX_LEN // PS)
ROUND_LENGTHS = [[4, 2, 3], [1, 4, 4], [3, 3, 2], [4, 1, 4]]
ROUND_FREEZE = [None, [False, True, False], None, None]
TOL = dict(rtol=2e-5, atol=2e-5)
# rounds (commits) of the continuous and pipelined cell sessions: each
# reference round is ~3 s of eager JAX on this host, its layer scan traced
# anew at every forward
CELL_STEPS = {"continuous": 6, "pipelined": 4}


def _cfgs(cfg_mod):
    """The model sizes of ``tests/test_roundpath.py:24-26``, from either
    package's registry."""
    tcfg = cfg_mod.get_config("qwen2.5-3b").smoke()
    dcfg = tcfg.replace(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                        head_dim=16, d_ff=64, name="draft-smoke")
    return tcfg, dcfg


def _prompts():
    rng = np.random.default_rng(11)
    start = rng.integers(0, 257, (B, 10)).astype(np.int32)
    late = rng.integers(0, 257, (1, 7)).astype(np.int32)
    return start, late


def _requests(req_cls):
    start, late = _prompts()
    prompts = [tuple(int(t) for t in row) for row in start] \
        + [tuple(int(t) for t in late[0])]
    budgets = [2, 40, 40, 40]
    return [req_cls(rid=i, prompt_len=len(p), max_new_tokens=budgets[i],
                    alpha=0.8, T_S=0.02 + 0.005 * i, prompt=p)
            for i, p in enumerate(prompts)]


def _cell_config(cell_cls):
    return cell_cls(scheme="hete", t_ver_fix=0.03, t_ver_lin=0.002, L_max=4,
                    max_batch=B, seed=0)


def jax_draws(seed, B, L, vhat, V, J=None):
    """The reference's draws from ``PRNGKey(seed)``, with its key splits.

    ``J`` given: the tree form (``TreeDraws``) of a multi-draft round —
    run 0 drafts from the draft key, run j from ``fold_in(draft key, j)``,
    each split into L step keys; one accept uniform per tree node
    (W = J * L)."""
    k_draft, k_verify = jax.random.split(jax.random.PRNGKey(seed))
    runs = [k_draft if j == 0 else jax.random.fold_in(k_draft, j)
            for j in range(J or 1)]
    draft = np.stack([np.stack([np.asarray(jax.random.gumbel(k, (B, vhat)))
                                for k in jax.random.split(kj, L)])
                      for kj in runs])                      # (J, L, B, vhat)
    W = (J or 1) * L
    k_accept, k_resid, k_bonus = jax.random.split(k_verify, 3)
    out = dict(
        u_accept=torch.from_numpy(np.array(jax.random.uniform(k_accept, (B, W)))),
        u_resid=torch.from_numpy(np.array(jax.random.uniform(k_resid, (B,)))),
        bonus_gumbel=torch.from_numpy(np.array(jax.random.gumbel(k_bonus, (B, V)))))
    if J is None:
        return RoundDraws(draft_gumbel=torch.from_numpy(draft[0]), **out)
    return TreeDraws(draft_gumbel=torch.from_numpy(draft), **out)


class JaxKeyedDraws(KeyedDraws):
    """The reference's draws at a key path: the root is ``PRNGKey(root)``,
    ``("fold", i)`` is ``fold_in(key, i)``, ``("split", h)`` is
    ``split(key)[h]``; the draft half splits its key into L step keys, the
    verify half into 3, as ``generate_drafts`` / ``verify_drafts`` do."""

    def __init__(self):
        super().__init__("cpu")

    @staticmethod
    def _key(path):
        k = jax.random.PRNGKey(path[0])
        for op, v in path[1:]:
            k = jax.random.fold_in(k, v) if op == "fold" else jax.random.split(k)[v]
        return k

    def draft(self, path, L, n, vhat):
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.gumbel(k, (n, vhat)))
            for k in jax.random.split(self._key(path), L)]))

    def verify(self, path, n, L, V):
        k_accept, k_resid, k_bonus = jax.random.split(self._key(path), 3)
        return (torch.from_numpy(np.array(jax.random.uniform(k_accept, (n, L)))),
                torch.from_numpy(np.array(jax.random.uniform(k_resid, (n,)))),
                torch.from_numpy(np.array(jax.random.gumbel(k_bonus, (n, V)))))


def _committed(state):
    return [None if c is None else [int(t) for t in c] for c in state.committed]


def _engine_view(eng, rows=range(4)):
    """What a parity test holds equal after a commit: ``pool_stats`` and
    both page tables (the page invariants are checked on the way)."""
    eng.t_pages.check_invariants()
    eng.d_pages.check_invariants()
    return {"pool_stats": eng.pool_stats(),
            "t_table": eng.t_pages.page_table(rows),
            "d_table": eng.d_pages.page_table(rows)}


def _barrier_steps(cont, n_steps):
    """The forced-barrier continuous engine (``max_inflight=1``,
    ``exact_shapes=True``) over B streams of L = 4, ``n_steps`` ticks."""
    for b in range(B):
        cont.add_stream(b, length=4)
    out = []
    for _ in range(n_steps):
        evs = cont.step()
        out.append({"events": [(ev.rows, np.asarray(ev.accepted), ev.occupancy,
                                ev.seq) for ev in evs],
                    "committed": _committed(cont.state),
                    **_engine_view(cont.engine, range(B))})
    return out


def _paced_script(cont):
    """The externally paced sequence (rows 0-3, the start batch plus the
    late stream): 3 live rows in a ``-1``-padded bucket of 4, a commit out
    of dispatch order, a batch merged from two draft groups, a retire while
    that batch is in flight, and a last round on the survivors.  Returns
    one record per commit."""
    eng, out = cont.engine, []

    def land(batch):
        acc = cont.commit(batch)
        out.append({"rows": list(batch.ticket.rows),
                    "accepted": np.asarray(acc),
                    "committed": _committed(cont.state), **_engine_view(eng)})

    first = cont.dispatch_round([0, 1, 2], [3, 2, 4])    # bucket (4, 4)
    second = cont.dispatch_round([3], [4])
    land(second)                                         # out of order
    land(first)
    f = cont.fsm
    cont._dispatch_draft_group([f[0]], np.array([4]))
    cont._dispatch_draft_group([f[1], f[2]], np.array([2, 4]))
    merged = cont._dispatch_verify([f[0], f[1]])         # two draft groups
    rest = cont._dispatch_verify([f[2]])
    cont.retire(1)                                       # mid-verify
    land(rest)
    land(merged)
    land(cont.dispatch_round([0, 2, 3], [4, 4, 4]))
    return out


def _cell_steps(cell, reqs, n_steps=6, leave_after=2):
    """A cell session of ``n_steps`` rounds (commits, when continuous), the
    first request still active leaving after ``leave_after`` of them."""
    for req in reqs:
        cell.submit(req)
    recs = []
    for i in range(n_steps):
        if i == leave_after:
            cell.leave(cell.scheduler.active[0].rid)
        rec = cell.step()
        recs.append({k: getattr(rec, k) for k in (
            "rids", "lengths", "accepted", "active", "batch_occupancy",
            "ready_depth", "n_host_syncs", "pool_stats", "t_round")})
    return recs


def _cell_config_for(cell_cls, schedule):
    return cell_cls(scheme="hete", t_ver_fix=0.03, t_ver_lin=0.002, L_max=4,
                    max_batch=B, seed=0, schedule=schedule, max_inflight=2)


# ---------------------------------------------------------------------------
# the reference side (runs in a subprocess: this file as a script)
# ---------------------------------------------------------------------------

def _reference(out_path):
    from repro import configs as jcfgs
    from repro.api import CellConfig, EngineBackend, MultiSpinCell, Request
    from repro.serving import SpecEngine
    from repro.serving.backends import ContinuousBackend
    from repro.serving.continuous import ContinuousEngine

    tcfg, dcfg = _cfgs(jcfgs)
    start, late = _prompts()
    out = {}

    def engine():
        eng = SpecEngine(tcfg, dcfg, max_len=MAX_LEN, cache_kind="paged",
                         num_pages=NUM_PAGES, compile_mode="eager")
        eng.init_params(jax.random.PRNGKey(0))
        return eng

    # -- engine rounds with freeze, retirement and a recycled row --
    eng = engine()
    out["t_params"] = jax.tree.map(np.asarray, eng.t_params)
    out["d_params"] = jax.tree.map(np.asarray, eng.d_params)
    st = eng.start(jnp.asarray(start))
    rounds = []
    for r, lengths in enumerate(ROUND_LENGTHS):
        if r == 2:
            eng.retire_stream(1)
            st, rows = eng.add_streams(st, jnp.asarray(late))
            assert rows == [1]
        h0 = eng.host_syncs
        st, res, dres = eng.spin_round(st, np.asarray(lengths),
                                       jax.random.PRNGKey(1000 + r), vhat=VHAT,
                                       freeze=ROUND_FREEZE[r])
        rounds.append({
            "accept_counts": np.asarray(res.accept_counts),
            "output_tokens": np.asarray(res.output_tokens),
            "accept_mask": np.asarray(res.accept_mask),
            "draft_tokens": np.asarray(dres.tokens),
            "draft_probs": np.asarray(dres.probs),
            "q_idx": np.asarray(dres.q_idx),
            "last_accepted": eng.last_accepted.copy(),
            "host_syncs": eng.host_syncs - h0,
            "pool_stats": eng.pool_stats(),
            "t_table": eng.t_pages.page_table(range(B)),
            "d_table": eng.d_pages.page_table(range(B)),
            "committed": _committed(st),
        })
    out["engine_rounds"] = rounds

    # -- a 4-round cell session through the reference EngineBackend --
    eng = engine()
    reqs = _requests(Request)
    backend = EngineBackend(eng, eng.start(jnp.asarray(start)),
                            keep_finished_tokens=True)
    cell = MultiSpinCell(_cell_config(CellConfig), backend=backend,
                         rng=np.random.default_rng(0))
    for req in reqs:
        cell.submit(req)
    recs = []
    for _ in range(4):
        rec = cell.step()
        recs.append({k: getattr(rec, k) for k in (
            "lengths", "accepted", "active", "rids", "pool_stats",
            "n_host_syncs", "realized_goodput", "t_round")})
    out["cell_rounds"] = recs
    out["cell_summary"] = cell.summary()
    out["cell_tokens"] = {r.rid: backend.stream_tokens(r.rid) for r in reqs}

    # -- continuous batching: the forced barrier, the paced sequence; one
    # engine restarted by each start() (a new engine would compile anew) --
    eng = engine()
    cont = ContinuousEngine(eng, eng.start(jnp.asarray(start)),
                            jax.random.PRNGKey(42), max_inflight=1,
                            exact_shapes=True)
    out["barrier"] = _barrier_steps(cont, 3)
    out["barrier_shapes"] = sorted(cont.assembler.shapes)
    st, rows = eng.add_streams(eng.start(jnp.asarray(start)),
                               jnp.asarray(late))
    assert rows == [3]
    cont = ContinuousEngine(eng, st, jax.random.PRNGKey(5))
    out["paced"] = _paced_script(cont)
    out["paced_shapes"] = sorted(cont.assembler.shapes)

    # -- cell sessions: continuous over ContinuousBackend, pipelined over
    # EngineBackend --
    for schedule, backend_cls in (("continuous", ContinuousBackend),
                                  ("pipelined", EngineBackend)):
        reqs = _requests(Request)
        backend = backend_cls(eng, eng.start(jnp.asarray(start)),
                              keep_finished_tokens=True)
        cell = MultiSpinCell(_cell_config_for(CellConfig, schedule),
                             backend=backend, rng=np.random.default_rng(0))
        out[f"{schedule}_rounds"] = _cell_steps(cell, reqs,
                                                CELL_STEPS[schedule])
        out[f"{schedule}_summary"] = cell.summary()
        out[f"{schedule}_tokens"] = {r.rid: backend.stream_tokens(r.rid)
                                     for r in reqs}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "ref.pkl"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "reference", str(path)], env=env, cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, f"reference run failed:\n{res.stdout}\n{res.stderr}"
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port_engine(ref):
    from repro_torch.serving import SpecEngine

    tcfg, dcfg = _cfgs(tcfgs)
    eng = SpecEngine(tcfg, dcfg, max_len=MAX_LEN, cache_kind="paged",
                     num_pages=NUM_PAGES, device="cpu")
    eng.t_params = params_from_jax(tcfg, ref["t_params"], device="cpu")
    eng.d_params = params_from_jax(dcfg, ref["d_params"], device="cpu")
    return eng


# ---------------------------------------------------------------------------
# engine, cell
# ---------------------------------------------------------------------------

def test_engine_rounds_match_reference(ref):
    from repro_torch.kernels import ops

    eng = _port_engine(ref)
    start, late = _prompts()
    st = eng.start(torch.from_numpy(start))
    V = eng.target_cfg.vocab_size
    ops.reset_counts()
    for r, (lengths, want) in enumerate(zip(ROUND_LENGTHS, ref["engine_rounds"])):
        if r == 2:
            eng.retire_stream(1)
            st, rows = eng.add_streams(st, torch.from_numpy(late))
            assert rows == [1]
        h0 = eng.host_syncs
        draws = jax_draws(1000 + r, B, max(lengths), VHAT, V)
        st, res, dres = eng.spin_round(st, np.asarray(lengths), draws,
                                       vhat=VHAT, freeze=ROUND_FREEZE[r])
        np.testing.assert_array_equal(dres.tokens.numpy(), want["draft_tokens"])
        np.testing.assert_array_equal(dres.q_idx.numpy(), want["q_idx"])
        np.testing.assert_allclose(dres.probs.numpy(), want["draft_probs"], **TOL)
        np.testing.assert_array_equal(res.accept_counts.numpy(),
                                      want["accept_counts"])
        np.testing.assert_array_equal(res.output_tokens.numpy(),
                                      want["output_tokens"])
        np.testing.assert_array_equal(res.accept_mask.numpy(),
                                      want["accept_mask"])
        np.testing.assert_array_equal(eng.last_accepted, want["last_accepted"])
        assert eng.host_syncs - h0 == want["host_syncs"] == 1
        assert eng.pool_stats() == want["pool_stats"]
        np.testing.assert_array_equal(eng.t_pages.page_table(range(B)),
                                      want["t_table"])
        np.testing.assert_array_equal(eng.d_pages.page_table(range(B)),
                                      want["d_table"])
        assert _committed(st) == want["committed"]
        eng.t_pages.check_invariants()
        eng.d_pages.check_invariants()
    # the CPU path ran the plain versions only
    c = ops.counts()
    assert c["paged_attention"]["plain"] > 0 and c["fused_verify_sample"]["plain"] == 4
    assert c["paged_attention"]["kernel"] == c["fused_verify_sample"]["kernel"] == 0


def test_cell_session_matches_reference(ref):
    from repro_torch.api import CellConfig, EngineBackend, MultiSpinCell, Request

    eng = _port_engine(ref)
    start, _ = _prompts()
    reqs = _requests(Request)
    backend = EngineBackend(eng, eng.start(torch.from_numpy(start)),
                            keep_finished_tokens=True, draws_fn=jax_draws)
    cell = MultiSpinCell(_cell_config(CellConfig), backend=backend,
                         rng=np.random.default_rng(0))
    for req in reqs:
        cell.submit(req)
    for want in ref["cell_rounds"]:
        rec = cell.step()
        for k in ("lengths", "accepted", "active", "rids"):
            np.testing.assert_array_equal(getattr(rec, k), want[k])
        assert rec.pool_stats == want["pool_stats"]
        assert rec.n_host_syncs == want["n_host_syncs"] == 1
        assert rec.realized_goodput == want["realized_goodput"]
    assert cell.summary() == ref["cell_summary"]
    assert {r.rid: backend.stream_tokens(r.rid) for r in reqs} \
        == ref["cell_tokens"]
    assert 3 in {int(r) for want in ref["cell_rounds"] for r in want["rids"]}, \
        "the late request never joined: the session no longer covers churn"


# ---------------------------------------------------------------------------
# drafting, verification, commit, allocator (reference in-process: no engine)
# ---------------------------------------------------------------------------

def _draft_pair():
    """The target-smoke model as the SLM, through a paged view, both sides."""
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import build_model as jbuild
    from repro_torch.models import build_model as tbuild

    tcfg, _ = _cfgs(tcfgs)
    jm = jbuild(JModelConfig(**dataclasses.asdict(tcfg)))
    jp = jm.init(jax.random.PRNGKey(3))
    tm = tbuild(tcfg, device="cpu")
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return tcfg, jm, jp, tm, tp


def test_generate_drafts_matches_reference():
    from repro.core.drafting import generate_drafts as jgen
    from repro_torch.core.drafting import generate_drafts as tgen

    cfg, jm, jp, tm, tp = _draft_pair()
    Bd, L, vhat, n_slots = 2, 5, 16, 3
    rng = np.random.default_rng(5)
    pt = rng.permutation(Bd * n_slots).reshape(Bd, n_slots).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab_size, (Bd, 9)).astype(np.int32)
    jc = dict(jm.init_paged_cache(Bd * n_slots, PS, jnp.float32),
              pages=jnp.asarray(pt))
    tc = dict(tm.init_paged_cache(Bd * n_slots, PS, torch.float32),
              pages=torch.from_numpy(pt))
    _, jc, _ = jm.prefill(jp, jnp.asarray(prompt[:, :-1]), jc)
    _, tc, _ = tm.prefill(tp, torch.from_numpy(prompt[:, :-1]), tc)
    pos = np.full(Bd, 8, np.int32)
    key = jax.random.PRNGKey(9)
    want = jgen(jm, jp, jc, jnp.asarray(prompt[:, -1]), jnp.asarray(pos), L,
                key, vhat=vhat)
    # the reference drew step t's categorical from split(key, L)[t]
    gumbel = torch.from_numpy(np.stack([
        np.asarray(jax.random.gumbel(k, (Bd, vhat)))
        for k in jax.random.split(key, L)]))
    got = tgen(tm, tp, tc, torch.from_numpy(prompt[:, -1]),
               torch.from_numpy(pos), L, gumbel, vhat=vhat)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.q_idx.numpy(), np.asarray(want.q_idx))
    np.testing.assert_allclose(got.q_val.numpy(), np.asarray(want.q_val), **TOL)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs), **TOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(got.cache[leaf].numpy(),
                                   np.asarray(want.cache[leaf]), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_verify_drafts_matches_reference(seed):
    from repro.core.verification import verify_drafts as jverify
    from repro_torch.core.verification import verify_drafts as tverify

    rng = np.random.default_rng(seed)
    Bv, L, V, vhat = 4, 5, 300, 16
    logits = (rng.standard_normal((Bv, L + 1, V)) * 2).astype(np.float32)
    # drafts that agree with the target often enough to see full acceptance
    z = logits[:, :L] + rng.standard_normal((Bv, L, V)).astype(np.float32)
    q = np.exp(z - z.max(-1, keepdims=True))
    q /= q.sum(-1, keepdims=True)
    idx = np.argsort(-q, -1, kind="stable")[..., :vhat].astype(np.int32)
    val = np.take_along_axis(q, idx, -1)
    val = (val / val.sum(-1, keepdims=True)).astype(np.float32)
    toks = idx[..., 0].copy()
    probs = val[..., 0].copy()
    dlen = np.array([L, 3, 1, L], np.int32)
    key = jax.random.PRNGKey(100 + seed)
    want = jverify(key, jnp.asarray(toks), jnp.asarray(probs),
                   jnp.asarray(logits), q_idx=jnp.asarray(idx),
                   q_val=jnp.asarray(val), draft_len=jnp.asarray(dlen))
    k_accept, k_resid, k_bonus = jax.random.split(key, 3)
    got = tverify(torch.from_numpy(toks), torch.from_numpy(probs),
                  torch.from_numpy(logits), torch.from_numpy(idx),
                  torch.from_numpy(val),
                  torch.from_numpy(np.array(jax.random.uniform(k_accept, (Bv, L)))),
                  torch.from_numpy(np.array(jax.random.uniform(k_resid, (Bv,)))),
                  torch.from_numpy(np.array(jax.random.gumbel(k_bonus, (Bv, V)))),
                  draft_len=torch.from_numpy(dlen))
    for name in ("accept_counts", "output_tokens", "output_len", "accept_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


def test_commit_step_matches_reference():
    from repro.serving.compiled import commit_step as jcommit
    from repro_torch.serving.compiled import commit_step as tcommit

    rng = np.random.default_rng(4)
    pending = rng.integers(0, 50, 6).astype(np.int32)
    tpos = rng.integers(5, 20, 6).astype(np.int32)
    dpos = tpos.copy()
    rows = np.array([4, -1, 0, 2, -1], np.int32)
    skip = np.array([False, True, True, False, True])
    out = rng.integers(0, 50, (5, 4)).astype(np.int32)
    acc = np.array([2, 0, 1, 3, 0], np.int32)
    want = jcommit(*(jnp.asarray(a) for a in (pending, tpos, dpos, rows, skip,
                                             out, acc)))
    got = tcommit(*(torch.from_numpy(a) for a in (pending, tpos, dpos, rows,
                                                 skip, out, acc)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_paged_kv_cache_churn_matches_reference():
    """One random churn script through both allocators: identical tables,
    free counts and device tables, and the invariants hold throughout."""
    from repro.serving.kv_cache import PagedKVCache as JCache
    from repro.serving.kv_cache import PagePoolExhausted as JExhausted
    from repro_torch.serving.kv_cache import PagedKVCache as TCache
    from repro_torch.serving.kv_cache import PagePoolExhausted as TExhausted

    j, t = JCache(24, 4, 6, 128), TCache(24, 4, 6, 128, device="cpu")
    rng = np.random.default_rng(8)
    live: list[int] = []
    for step in range(300):
        op = rng.integers(4)
        s = int(rng.integers(0, 12)) if op == 0 or not live \
            else int(rng.choice(live))
        n = int(rng.integers(0, 25))
        outcome = []
        for mgr, exc in ((j, JExhausted), (t, TExhausted)):
            try:
                if op == 0 and s not in live:
                    mgr.alloc_stream(s, n)
                elif op == 1 and s in live:
                    mgr.extend(s, n)
                elif op == 2 and s in live:
                    mgr.truncate(s, n)
                elif op == 3 and s in live:
                    mgr.free_stream(s)
                outcome.append("ok")
            except exc:
                outcome.append("dry")
        assert outcome[0] == outcome[1], (step, op, outcome)
        if outcome[0] == "ok":
            if op == 0 and s not in live:
                live.append(s)
            elif op == 3 and s in live:
                live.remove(s)
        assert j.num_free_pages == t.num_free_pages
        assert j.free_bytes() == t.free_bytes() and j.used_bytes() == t.used_bytes()
        rows = sorted(live) + [-1, 17]
        np.testing.assert_array_equal(t.page_table(rows), j.page_table(rows))
        if step % 7 == 0:
            np.testing.assert_array_equal(t.device_table(rows).numpy(),
                                          np.asarray(j.device_table(rows)))
        t.check_invariants()


def test_unported_engine_paths_name_their_roadmap_item():
    from repro_torch.launch import gateway
    from repro_torch.serving import SpecEngine

    tcfg, dcfg = _cfgs(tcfgs)
    with pytest.raises(NotImplementedError, match="A9"):
        SpecEngine(tcfg, dcfg, compile_mode="jit", device="cpu")
    for flags in (["--compile", "jit"], ["--compile-cache", "cache"]):
        args = gateway.parser().parse_args(
            ["--backend", "engine", "--smoke-arch", "--device", "cpu"] + flags)
        with pytest.raises(NotImplementedError, match="A9"):
            gateway.build_cell(args)


# ---------------------------------------------------------------------------
# continuous batching and the cell's other schedules
# ---------------------------------------------------------------------------

def _assert_same_view(got, want):
    assert got["pool_stats"] == want["pool_stats"]
    np.testing.assert_array_equal(got["t_table"], want["t_table"])
    np.testing.assert_array_equal(got["d_table"], want["d_table"])


def test_forced_barrier_continuous_engine_matches_reference(ref):
    """(a) ``max_inflight=1, exact_shapes=True``: every tick commits the same
    rows, counts and tokens as the reference's, with the same pages."""
    from repro_torch.serving.continuous import ContinuousEngine

    eng = _port_engine(ref)
    cont = ContinuousEngine(eng, eng.start(torch.from_numpy(_prompts()[0])),
                            42, max_inflight=1, exact_shapes=True,
                            draws=JaxKeyedDraws())
    got = _barrier_steps(cont, len(ref["barrier"]))
    for g, w in zip(got, ref["barrier"]):
        assert len(g["events"]) == len(w["events"]) == 1
        for (rows, acc, occ, seq), (wrows, wacc, wocc, wseq) in zip(
                g["events"], w["events"]):
            assert (rows, occ, seq) == (wrows, wocc, wseq)
            np.testing.assert_array_equal(acc, wacc)
        assert g["committed"] == w["committed"]
        _assert_same_view(g, w)
    assert sorted(cont.assembler.shapes) == ref["barrier_shapes"] == [(B, 4)]


def test_externally_paced_continuous_engine_matches_reference(ref):
    """(b) a ``-1``-padded bucket, a commit out of dispatch order, a batch
    merged from two draft groups and a retire mid-verify.  A padding row
    sees no key: the reference's oracle gives page 0's mean there and the
    port 0 (ROADMAP §C), so its draft is not compared; every commit's
    counts, committed lists, ``pool_stats`` and page tables are exact."""
    from repro_torch.serving.continuous import ContinuousEngine

    eng = _port_engine(ref)
    start, late = _prompts()
    st, rows = eng.add_streams(eng.start(torch.from_numpy(start)),
                               torch.from_numpy(late))
    assert rows == [3]
    cont = ContinuousEngine(eng, st, 5, draws=JaxKeyedDraws())
    got = _paced_script(cont)
    assert len(got) == len(ref["paced"]) == 5
    for g, w in zip(got, ref["paced"]):
        assert g["rows"] == w["rows"]
        np.testing.assert_array_equal(g["accepted"], w["accepted"])
        assert g["committed"] == w["committed"]
        _assert_same_view(g, w)
    # the retired row committed nothing in the merged batch
    assert ref["paced"][3]["rows"] == [0, 1] and got[3]["accepted"][1] == 0
    assert sorted(cont.assembler.shapes) == ref["paced_shapes"] \
        == [(1, 4), (2, 4), (4, 4)]


@pytest.mark.parametrize("schedule", ["continuous", "pipelined"])
def test_scheduled_cell_session_matches_reference(ref, schedule):
    """(c) ``schedule="continuous"`` over ``ContinuousBackend`` and (d)
    ``schedule="pipelined"`` over ``EngineBackend``, a request leaving
    mid-session: every record's rids, lengths, counts, occupancy, ready
    depth, host syncs and pools, the summary and every stream's tokens."""
    from repro_torch.api import (
        CellConfig,
        ContinuousBackend,
        EngineBackend,
        MultiSpinCell,
        Request,
    )

    eng = _port_engine(ref)
    state = eng.start(torch.from_numpy(_prompts()[0]))
    if schedule == "continuous":
        backend = ContinuousBackend(eng, state, keep_finished_tokens=True,
                                    draws=JaxKeyedDraws())
    else:
        backend = EngineBackend(eng, state, keep_finished_tokens=True,
                                draws_fn=jax_draws)
    reqs = _requests(Request)
    cell = MultiSpinCell(_cell_config_for(CellConfig, schedule),
                         backend=backend, rng=np.random.default_rng(0))
    got = _cell_steps(cell, reqs, CELL_STEPS[schedule])
    want = ref[f"{schedule}_rounds"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("rids", "lengths", "accepted", "active"):
            np.testing.assert_array_equal(g[k], w[k], k)
        for k in ("batch_occupancy", "ready_depth", "n_host_syncs",
                  "pool_stats", "t_round"):
            assert g[k] == w[k], k
        assert g["n_host_syncs"] == 1
    assert cell.summary() == ref[f"{schedule}_summary"]
    assert {r.rid: backend.stream_tokens(r.rid) for r in reqs} \
        == ref[f"{schedule}_tokens"]
    eng.t_pages.check_invariants()
    eng.d_pages.check_invariants()


def test_serve_cli_runs_on_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen2.5-3b", "--smoke", "--devices", "3",
                "--rounds", "2", "--max-new-tokens", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round 0:" in out and "round 1:" in out and "completed=" in out

    # --dry-run calls run_cell with the reference launcher's arguments and
    # prints its status and the error of a failed cell
    from repro_torch.launch import dryrun

    calls = []

    def fake_run_cell(*args, **kw):
        calls.append((args, kw))
        return {"status": "error", "error": "KeyError: 'x'"}

    monkeypatch.setattr(dryrun, "run_cell", fake_run_cell)
    serve.main(["--arch", "qwen2.5-3b", "--dry-run", "--shape", "prefill_32k"])
    assert calls == [(("qwen2.5-3b", "prefill_32k", False), {"force": True})]
    assert capsys.readouterr().out == "error KeyError: 'x'\n"


if __name__ == "__main__":
    assert sys.argv[1] == "reference"
    _reference(sys.argv[2])
