"""The port's multi-draft token-tree rounds on the CPU against the JAX package's.

Randomness is replayed with ``tests/test_torch_engine.py::jax_draws`` in its
tree form: the reference drafts run 0 from the round's draft key and run j
from ``fold_in(draft key, j)``, and takes one accept uniform per tree node.
Both sides carry the same weights (``bridge.params_from_jax``).  Draft
tokens, per-node accept masks, winners, counts, committed lists, page
tables, ``pool_stats`` and host syncs per round must be identical; float
outputs agree within 2e-5 (``_tol(float32)`` of ``tests/test_kernels.py``).

The reference engines run in ONE subprocess (this file as a script), as in
``tests/test_torch_engine.py``: compiling several JAX engines late in a long
pytest process can segfault the XLA CPU compiler (ROADMAP §C).

A MoE target (``moonshot-v1-16b-a3b``'s smoke config: one leading dense
block with ``dense_k`` / ``dense_v`` cache leaves, then a MoE block with
shared experts) beside the dense smoke draft runs 3 J=1 rounds and 2 tree
rounds (J = 2, L <= 4) on each layout in the same subprocess, in the
reference's ``tree_commit="repair"``: the port commits the same tokens,
counts and ``pool_stats`` in both of its commit modes.  The reference's
scatter commit moves only the K/V leaves the draft also has, so it leaves
a MoE target's dense-block K/V at the tree slots (ROADMAP §C); the port's
scatter moves every leaf of the target's cache and must leave the K/V of
its own repair commit, leaf by leaf.
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

from test_torch_engine import (
    MAX_LEN,
    NUM_PAGES,
    TOL,
    VHAT,
    B,
    _cell_config,
    _cfgs,
    _committed,
    _draft_pair,
    _prompts,
    _requests,
    jax_draws,
)

from repro_torch import configs as tcfgs
from repro_torch.bridge import params_from_jax
from repro_torch.core.draws import RoundDraws, TreeDraws

# (J, tree, lengths, freeze) per round; the late stream replaces row 1
# before round RETIRE_ROUND
# (every round drafts up to L = 4, so the reference compiles few shapes)
TREE_ROUNDS = [
    (2, None, [4, 2, 3], None),
    (3, None, [1, 4, 4], [False, True, False]),
    (1, True, [4, 3, 2], None),          # J = 1 through the tree machinery
    (2, None, [2, 4, 3], None),
]
RETIRE_ROUND = 2
# the repair engine runs the J > 1 rounds before the retirement only (a
# J = 1 tree round runs no fix-up, so it is the same in both modes)
ROUNDS_OF = {"scatter": len(TREE_ROUNDS), "repair": RETIRE_ROUND}
CELL_ROUNDS = 3
COMMITS = ("scatter", "repair")
# the MoE target's rounds: (J, lengths, freeze)
MOE_ROUNDS = [
    (1, [4, 2, 3], None),
    (1, [1, 4, 4], [False, True, False]),
    (1, [3, 4, 2], None),
    (2, [4, 3, 4], None),
    (2, [2, 4, 3], None),
]
LAYOUTS = ("paged", "contiguous")


def _moe_cfgs(cfg_mod):
    """A MoE target beside the dense smoke draft (one vocabulary)."""
    return cfg_mod.get_config("moonshot-v1-16b-a3b").smoke(), _cfgs(cfg_mod)[1]


def _moe_draws(r, J, L, V):
    return jax_draws(5000 + r, B, L, VHAT, V, J=None if J == 1 else J)
MULTIDRAFT = {"J_min": 2, "J_max": 3}


def _round_draws(r, J, L, V):
    # a J = 1 tree round takes a sequential round's draws as they are
    return jax_draws(3000 + r, B, L, VHAT, V, J=None if J == 1 else J)


def _multidraft_config(cell_cls):
    return dataclasses.replace(_cell_config(cell_cls), scheme="multidraft",
                               scheme_params=dict(MULTIDRAFT))


# ---------------------------------------------------------------------------
# the reference side (runs in a subprocess: this file as a script)
# ---------------------------------------------------------------------------

def _reference(out_path):
    from repro import configs as jcfgs
    from repro.api import CellConfig, EngineBackend, MultiSpinCell, Request
    from repro.serving import SpecEngine

    tcfg, dcfg = _cfgs(jcfgs)
    start, late = _prompts()
    out = {}

    def engine(commit):
        eng = SpecEngine(tcfg, dcfg, max_len=MAX_LEN, cache_kind="paged",
                         num_pages=NUM_PAGES, tree_commit=commit,
                         compile_mode="eager")
        eng.init_params(jax.random.PRNGKey(0))
        return eng

    for commit in COMMITS:
        eng = engine(commit)
        out["t_params"] = jax.tree.map(np.asarray, eng.t_params)
        out["d_params"] = jax.tree.map(np.asarray, eng.d_params)
        st = eng.start(jnp.asarray(start))
        rounds = []
        for r, (J, tree, lengths, freeze) in enumerate(
                TREE_ROUNDS[:ROUNDS_OF[commit]]):
            if r == RETIRE_ROUND:
                eng.retire_stream(1)
                st, rows = eng.add_streams(st, jnp.asarray(late))
                assert rows == [1]
            h0 = eng.host_syncs
            st, res, forest = eng.spin_round(
                st, np.asarray(lengths), jax.random.PRNGKey(3000 + r),
                vhat=VHAT, freeze=freeze, draft_width=J, tree=tree)
            rounds.append({
                "forest_tokens": np.asarray(forest.tokens),
                "forest_probs": np.asarray(forest.probs),
                "accept_counts": np.asarray(res.accept_counts),
                "output_tokens": np.asarray(res.output_tokens),
                "accept_mask": np.asarray(res.accept_mask),
                "winner": np.asarray(res.winner),
                "last_accepted": eng.last_accepted.copy(),
                "host_syncs": eng.host_syncs - h0,
                "pool_stats": eng.pool_stats(),
                "t_table": eng.t_pages.page_table(range(B)),
                "d_table": eng.d_pages.page_table(range(B)),
                "committed": _committed(st),
            })
        out[commit] = rounds

    # -- a MoE target on both layouts, repair commits --
    mt, md = _moe_cfgs(jcfgs)
    moe = {}
    for layout in LAYOUTS:
        eng = SpecEngine(mt, md, max_len=MAX_LEN, cache_kind=layout,
                         num_pages=NUM_PAGES if layout == "paged" else None,
                         tree_commit="repair", compile_mode="eager")
        eng.init_params(jax.random.PRNGKey(4))
        moe["t_params"] = jax.tree.map(np.asarray, eng.t_params)
        moe["d_params"] = jax.tree.map(np.asarray, eng.d_params)
        st = eng.start(jnp.asarray(start))
        rounds = []
        for r, (J, lengths, freeze) in enumerate(MOE_ROUNDS):
            h0 = eng.host_syncs
            st, res, _ = eng.spin_round(st, np.asarray(lengths),
                                        jax.random.PRNGKey(5000 + r),
                                        vhat=VHAT, freeze=freeze,
                                        draft_width=J)
            rounds.append({
                "accept_counts": np.asarray(res.accept_counts),
                "output_tokens": np.asarray(res.output_tokens),
                "last_accepted": eng.last_accepted.copy(),
                "host_syncs": eng.host_syncs - h0,
                "pool_stats": eng.pool_stats(),
                "committed": _committed(st),
            })
        moe[layout] = rounds
    out["moe"] = moe

    # -- a multidraft cell session through the reference EngineBackend --
    eng = engine("scatter")
    reqs = _requests(Request)
    backend = EngineBackend(eng, eng.start(jnp.asarray(start)),
                            keep_finished_tokens=True)
    cell = MultiSpinCell(_multidraft_config(CellConfig), backend=backend,
                         rng=np.random.default_rng(0))
    for req in reqs:
        cell.submit(req)
    recs = []
    for _ in range(CELL_ROUNDS):
        rec = cell.step()
        recs.append({k: getattr(rec, k) for k in (
            "lengths", "accepted", "active", "rids", "pool_stats",
            "n_host_syncs", "realized_goodput", "draft_width")})
    out["cell_rounds"] = recs
    out["cell_summary"] = cell.summary()
    out["cell_tokens"] = {r.rid: backend.stream_tokens(r.rid) for r in reqs}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(autouse=True, scope="module")
def _reference_run(tmp_path_factory):
    """Start the reference subprocess as the module starts, so that it runs
    while the in-process tests at the top of this file do; ``ref`` waits
    for it.  The process is killed if the module ends first."""
    path = tmp_path_factory.mktemp("jax_tree_ref") / "ref.pkl"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    log = path.with_suffix(".log")
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                 "reference", str(path)], env=env, cwd=root,
                                stdout=out, stderr=subprocess.STDOUT)
    try:
        yield proc, path, log
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def ref(_reference_run):
    proc, path, log = _reference_run
    proc.wait(timeout=600)
    assert proc.returncode == 0, f"reference run failed:\n{log.read_text()}"
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port_engine(params, commit="scatter"):
    from repro_torch.serving import SpecEngine

    tcfg, dcfg = _cfgs(tcfgs)
    eng = SpecEngine(tcfg, dcfg, max_len=MAX_LEN, cache_kind="paged",
                     num_pages=NUM_PAGES, tree_commit=commit, device="cpu")
    eng.t_params = params_from_jax(tcfg, params["t_params"], device="cpu")
    eng.d_params = params_from_jax(dcfg, params["d_params"], device="cpu")
    return eng


def _pages_match_lengths(eng, state):
    """Every live row holds exactly the pages of its committed prefix: the
    dead branches' pages went back to the pool."""
    ps = eng.page_size
    for mgr in (eng.t_pages, eng.d_pages):
        table = mgr.page_table(range(len(state.committed)))
        for b, toks in enumerate(state.committed):
            if b in eng._retired:
                continue
            assert mgr.length(b) == len(toks) - 1
            assert int((table[b] >= 0).sum()) == -(-(len(toks) - 1) // ps)
        mgr.check_invariants()


# ---------------------------------------------------------------------------
# drafting and verification (reference in-process: no engine; these run
# first, while the reference subprocess of the engine tests runs)
# ---------------------------------------------------------------------------

def test_generate_draft_forest_matches_reference():
    """J runs from one committed prefix: identical tokens and sparse rows,
    p_S and the kept window K/V within ``_tol``, under replayed draws."""
    from repro.core.drafting import generate_draft_forest as jforest
    from repro_torch.core.drafting import generate_draft_forest as tforest

    cfg, jm, jp, tm, tp = _draft_pair()
    Bd, L, J, vhat, n_slots, ps = 2, 4, 3, 16, 3, 16
    rng = np.random.default_rng(12)
    pt = rng.permutation(Bd * n_slots).reshape(Bd, n_slots).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab_size, (Bd, 9)).astype(np.int32)
    jc = dict(jm.init_paged_cache(Bd * n_slots, ps, jnp.float32),
              pages=jnp.asarray(pt))
    tc = dict(tm.init_paged_cache(Bd * n_slots, ps, torch.float32),
              pages=torch.from_numpy(pt))
    _, jc, _ = jm.prefill(jp, jnp.asarray(prompt[:, :-1]), jc)
    _, tc, _ = tm.prefill(tp, torch.from_numpy(prompt[:, :-1]), tc)
    pos = np.full(Bd, 8, np.int32)
    key = jax.random.PRNGKey(21)
    want = jforest(jm, jp, jc, jnp.asarray(prompt[:, -1]), jnp.asarray(pos),
                   L, J, key, vhat=vhat, keep_windows=True)
    runs = [key if j == 0 else jax.random.fold_in(key, j) for j in range(J)]
    gumbel = torch.from_numpy(np.stack([np.stack([
        np.asarray(jax.random.gumbel(k, (Bd, vhat)))
        for k in jax.random.split(kj, L)]) for kj in runs]))
    got = tforest(tm, tp, tc, torch.from_numpy(prompt[:, -1]),
                  torch.from_numpy(pos), L, J, gumbel, vhat=vhat,
                  keep_windows=True)
    assert got.tokens.shape == (Bd, J, L)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.q_idx.numpy(), np.asarray(want.q_idx))
    np.testing.assert_allclose(got.q_val.numpy(), np.asarray(want.q_val), **TOL)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs), **TOL)
    assert set(got.windows) == set(want.windows) == {"k", "v"}
    for leaf in ("k", "v"):
        np.testing.assert_allclose(got.windows[leaf].numpy(),
                                   np.asarray(want.windows[leaf]), **TOL)
        np.testing.assert_allclose(got.cache[leaf].numpy(),
                                   np.asarray(want.cache[leaf]), **TOL)


def _tree_verify_inputs(seed, Bv, J, L, V, vhat):
    """A packed tree of J drafts per row whose tokens the target often
    agrees with (full acceptance occurs), with ragged draft lengths."""
    from repro_torch.core.token_tree import build_token_tree

    rng = np.random.default_rng(seed)
    W = J * L
    logits = (rng.standard_normal((Bv, W + 1, V)) * 2).astype(np.float32)
    z = rng.standard_normal((Bv, J, L, V)).astype(np.float32) * 2
    q = np.exp(z - z.max(-1, keepdims=True))
    q /= q.sum(-1, keepdims=True)
    idx = np.argsort(-q, -1, kind="stable")[..., :vhat].astype(np.int32)
    val = np.take_along_axis(q, idx, -1)
    val = (val / val.sum(-1, keepdims=True)).astype(np.float32)
    pick = rng.integers(0, 2, (Bv, J, L))           # shared prefixes occur
    toks = np.take_along_axis(idx, pick[..., None], -1)[..., 0]
    probs = np.take_along_axis(val, pick[..., None], -1)[..., 0]
    dlen = np.array([L, L - 1, 1, L][:Bv], np.int64)
    tree = build_token_tree(toks, probs, idx, val, dlen)
    return tree, logits, dlen


@pytest.mark.parametrize("seed,J", [(0, 2), (1, 3), (2, 2), (3, 1)])
def test_verify_tree_matches_reference(seed, J):
    from repro.core.verification import verify_tree as jverify
    from repro_torch.core.verification import verify_tree as tverify

    Bv, L, V, vhat = 4, 4, 300, 16
    tree, logits, dlen = _tree_verify_inputs(seed, Bv, J, L, V, vhat)
    fields = (tree.tokens, tree.parents, tree.depth, tree.probs, tree.paths)
    key = jax.random.PRNGKey(200 + seed)
    want = jverify(key, *(jnp.asarray(a) for a in fields), jnp.asarray(logits),
                   jnp.asarray(tree.q_idx), jnp.asarray(tree.q_val),
                   jnp.asarray(dlen.astype(np.int32)))
    k_accept, k_resid, k_bonus = jax.random.split(key, 3)
    got = tverify(*(torch.from_numpy(a) for a in fields),
                  torch.from_numpy(logits), torch.from_numpy(tree.q_idx),
                  torch.from_numpy(tree.q_val),
                  torch.from_numpy(dlen.astype(np.int32)),
                  torch.from_numpy(np.array(jax.random.uniform(k_accept, (Bv, J * L)))),
                  torch.from_numpy(np.array(jax.random.uniform(k_resid, (Bv,)))),
                  torch.from_numpy(np.array(jax.random.gumbel(k_bonus, (Bv, V)))))
    for name in ("accept_counts", "output_tokens", "output_len",
                 "accept_mask", "winner", "node_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_drafts_dense_matches_reference(seed):
    """The dense ``q_dense`` branch (``ops.gather_softmax_prob`` +
    ``ops.residual_sample``): identical accept masks, counts and outputs."""
    from repro.core.verification import verify_drafts as jverify
    from repro_torch.core.verification import sparse_to_dense
    from repro_torch.core.verification import verify_drafts as tverify

    rng = np.random.default_rng(40 + seed)
    Bv, L, V, vhat = 4, 5, 300, 16
    logits = (rng.standard_normal((Bv, L + 1, V)) * 2).astype(np.float32)
    z = logits[:, :L] + rng.standard_normal((Bv, L, V)).astype(np.float32)
    q = np.exp(z - z.max(-1, keepdims=True))
    q /= q.sum(-1, keepdims=True)
    idx = np.argsort(-q, -1, kind="stable")[..., :vhat].astype(np.int32)
    val = np.take_along_axis(q, idx, -1)
    val = (val / val.sum(-1, keepdims=True)).astype(np.float32)
    dense = sparse_to_dense(torch.from_numpy(idx), torch.from_numpy(val), V)
    toks, probs = idx[..., 0].copy(), val[..., 0].copy()
    dlen = np.array([L, 3, 1, L], np.int32)
    key = jax.random.PRNGKey(300 + seed)
    want = jverify(key, jnp.asarray(toks), jnp.asarray(probs),
                   jnp.asarray(logits), q_dense=jnp.asarray(dense.numpy()),
                   draft_len=jnp.asarray(dlen))
    k_accept, k_resid, k_bonus = jax.random.split(key, 3)
    got = tverify(torch.from_numpy(toks), torch.from_numpy(probs),
                  torch.from_numpy(logits), None, None,
                  torch.from_numpy(np.array(jax.random.uniform(k_accept, (Bv, L)))),
                  torch.from_numpy(np.array(jax.random.uniform(k_resid, (Bv,)))),
                  torch.from_numpy(np.array(jax.random.gumbel(k_bonus, (Bv, V)))),
                  draft_len=torch.from_numpy(dlen), q_dense=dense)
    for name in ("accept_counts", "output_tokens", "output_len", "accept_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


def test_sparse_to_dense_matches_reference():
    from repro.core.verification import sparse_to_dense as jdense
    from repro_torch.core.verification import sparse_to_dense as tdense

    rng = np.random.default_rng(8)
    idx = rng.integers(0, 30, (2, 3, 6)).astype(np.int32)   # duplicates add
    val = rng.random((2, 3, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tdense(torch.from_numpy(idx), torch.from_numpy(val), 30).numpy(),
        np.asarray(jdense(jnp.asarray(idx), jnp.asarray(val), 30)), **TOL)


# ---------------------------------------------------------------------------
# engine, cell, CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("commit", COMMITS)
def test_engine_tree_rounds_match_reference(ref, commit):
    from repro_torch.kernels import ops

    eng = _port_engine(ref, commit)
    start, late = _prompts()
    st = eng.start(torch.from_numpy(start))
    V = eng.target_cfg.vocab_size
    ops.reset_counts()
    n_tree = ROUNDS_OF[commit]
    assert len(ref[commit]) == n_tree
    for r, ((J, tree, lengths, freeze), want) in enumerate(
            zip(TREE_ROUNDS, ref[commit])):
        if r == RETIRE_ROUND:
            eng.retire_stream(1)
            st, rows = eng.add_streams(st, torch.from_numpy(late))
            assert rows == [1]
        draws = _round_draws(r, J, max(lengths), V)
        assert isinstance(draws, RoundDraws if J == 1 else TreeDraws)
        h0 = eng.host_syncs
        st, res, forest = eng.spin_round(st, np.asarray(lengths), draws,
                                         vhat=VHAT, freeze=freeze,
                                         draft_width=J, tree=tree)
        np.testing.assert_array_equal(forest.tokens.numpy(),
                                      want["forest_tokens"])
        np.testing.assert_allclose(forest.probs.numpy(), want["forest_probs"],
                                   **TOL)
        for name in ("accept_counts", "output_tokens", "accept_mask", "winner"):
            np.testing.assert_array_equal(getattr(res, name).numpy(),
                                          want[name], f"round {r} {name}")
        np.testing.assert_array_equal(eng.last_accepted, want["last_accepted"])
        expect_syncs = 3 if (commit == "repair" and J > 1) else 2
        assert eng.host_syncs - h0 == want["host_syncs"] == expect_syncs
        assert eng.pool_stats() == want["pool_stats"]
        np.testing.assert_array_equal(eng.t_pages.page_table(range(B)),
                                      want["t_table"])
        np.testing.assert_array_equal(eng.d_pages.page_table(range(B)),
                                      want["d_table"])
        assert _committed(st) == want["committed"]
        _pages_match_lengths(eng, st)
    assert any(int(w["winner"].max()) > 0 for w in ref[commit]), \
        "no round committed a draft other than the first: the case lost J"
    c = ops.counts()
    assert c["paged_tree_attention"]["plain"] > 0
    assert c["gather_softmax_prob"]["plain"] == c["residual_sample"]["plain"] \
        == n_tree
    assert c["fused_verify_sample"]["plain"] == 0
    assert all(v["kernel"] == 0 for v in c.values())


def test_scatter_commit_equals_repair_with_the_same_caches(ref):
    """Scatter and repair commit the same tokens, pages and pool accounting,
    and leave the same K/V at every committed position of every live row
    (within ``_tol``: repair recomputes them in a sequential window)."""
    from repro_torch.models.layers import gather_kv_window

    engines, states = {}, {}
    start, late = _prompts()
    V = 257
    for commit in COMMITS:
        eng = _port_engine(ref, commit)
        st = eng.start(torch.from_numpy(start))
        for r, (J, tree, lengths, freeze) in enumerate(TREE_ROUNDS[:2]):
            st, _, _ = eng.spin_round(st, np.asarray(lengths),
                                      TreeDraws.sample(r, B, J, max(lengths),
                                                       VHAT, V, device="cpu"),
                                      vhat=VHAT, freeze=freeze, draft_width=J)
        engines[commit], states[commit] = eng, st
    a, b = engines["scatter"], engines["repair"]
    assert _committed(states["scatter"]) == _committed(states["repair"])
    assert a.pool_stats() == b.pool_stats()
    np.testing.assert_array_equal(a.t_pages.page_table(range(B)),
                                  b.t_pages.page_table(range(B)))
    n = min(len(c) for c in states["scatter"].committed) - 1
    pos = torch.arange(n)[None].expand(B, n)
    for eng_attr, pages_attr in (("t_cache", "t_pages"), ("d_cache", "d_pages")):
        for leaf in ("k", "v"):
            got = [gather_kv_window(getattr(e, eng_attr)[leaf], pos,
                                    getattr(e, pages_attr).device_table(range(B)))
                   for e in (a, b)]
            np.testing.assert_allclose(got[0].numpy(), got[1].numpy(), **TOL)


def _moe_engine(ref, layout, commit):
    from repro_torch.serving import SpecEngine

    tcfg, dcfg = _moe_cfgs(tcfgs)
    eng = SpecEngine(tcfg, dcfg, max_len=MAX_LEN, cache_kind=layout,
                     num_pages=NUM_PAGES if layout == "paged" else None,
                     tree_commit=commit, device="cpu")
    eng.t_params = params_from_jax(tcfg, ref["moe"]["t_params"], device="cpu")
    eng.d_params = params_from_jax(dcfg, ref["moe"]["d_params"], device="cpu")
    return eng


def _moe_rounds(ref, layout, commit, check=True):
    """The MoE rounds on a port engine, each held against the reference's
    repair commit when ``check``; returns (engine, state)."""
    eng = _moe_engine(ref, layout, commit)
    start, _ = _prompts()
    st = eng.start(torch.from_numpy(start))
    V = eng.target_cfg.vocab_size
    for r, ((J, lengths, freeze), want) in enumerate(
            zip(MOE_ROUNDS, ref["moe"][layout])):
        h0 = eng.host_syncs
        st, res, _ = eng.spin_round(st, np.asarray(lengths),
                                    _moe_draws(r, J, max(lengths), V),
                                    vhat=VHAT, freeze=freeze, draft_width=J)
        if not check:
            continue
        for name in ("accept_counts", "output_tokens"):
            np.testing.assert_array_equal(getattr(res, name).numpy(),
                                          want[name], f"round {r} {name}")
        np.testing.assert_array_equal(eng.last_accepted, want["last_accepted"])
        syncs = 1 if J == 1 else (3 if commit == "repair" else 2)
        assert eng.host_syncs - h0 == syncs
        if commit == "repair":
            assert want["host_syncs"] == syncs
        assert eng.pool_stats() == want["pool_stats"]
        assert _committed(st) == want["committed"]
    return eng, st


@pytest.mark.parametrize("commit", COMMITS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_moe_engine_rounds_match_reference(ref, layout, commit):
    """3 J=1 and 2 tree rounds of the MoE target under the reference's
    draws: counts, tokens, committed lists and ``pool_stats`` (the paged
    pools hold the ``dense_k`` / ``dense_v`` leaves) exact against the
    reference's repair commit, in both of the port's commit modes."""
    eng, st = _moe_rounds(ref, layout, commit)
    assert sorted(k for k in eng.t_cache if k != "pages") == \
        ["dense_k", "dense_v", "k", "v"]
    if layout == "paged":
        eng.t_pages.check_invariants()
        eng.d_pages.check_invariants()
    assert any(int(w["accept_counts"].max()) > 0
               for w in ref["moe"][layout][3:]), "no tree round accepted a draft"


@pytest.mark.parametrize("layout", LAYOUTS)
def test_moe_scatter_commit_equals_repair_with_the_same_caches(ref, layout):
    """For a MoE target with a leading dense block the port's scatter
    commit leaves the K/V of its repair commit at every committed position
    of every row, in every leaf of the target's cache (``dense_k`` /
    ``dense_v`` too, which the reference's scatter leaves at the tree
    slots) and of the draft's, within ``_tol``."""
    from repro_torch.models.layers import gather_kv_window

    a, sa = _moe_rounds(ref, layout, "scatter", check=False)
    b, sb = _moe_rounds(ref, layout, "repair", check=False)
    assert _committed(sa) == _committed(sb)
    n = min(len(c) for c in sa.committed) - 1
    pos = torch.arange(n)[None].expand(B, n)
    for cache_attr, pages_attr in (("t_cache", "t_pages"),
                                   ("d_cache", "d_pages")):
        leaves = [k for k in getattr(a, cache_attr) if k != "pages"]
        assert ("dense_k" in leaves) == (cache_attr == "t_cache")
        for leaf in leaves:
            got = [gather_kv_window(
                getattr(e, cache_attr)[leaf], pos,
                None if layout == "contiguous"
                else getattr(e, pages_attr).device_table(range(B)))
                for e in (a, b)]
            np.testing.assert_allclose(got[0].numpy(), got[1].numpy(), **TOL)


def test_engine_tree_j1_commits_identical_tokens(ref):
    """``spin_round(tree=True)`` at J = 1, given a sequential round's draws,
    commits bit-identical tokens to the sequential round and leaves the
    same pages (the JAX guarantee of ``verify_tree`` at J = 1)."""
    start, _ = _prompts()
    runs = {}
    for tree in (False, True):
        eng = _port_engine(ref)
        st = eng.start(torch.from_numpy(start))
        syncs = []
        for r, lengths in enumerate(([4, 2, 3], [1, 4, 4], [3, 3, 2])):
            h0 = eng.host_syncs
            st, res, _ = eng.spin_round(
                st, np.asarray(lengths),
                RoundDraws.sample(r, B, max(lengths), VHAT, 257, device="cpu"),
                vhat=VHAT, tree=tree)
            syncs.append(eng.host_syncs - h0)
        runs[tree] = (_committed(st), eng.pool_stats(), syncs,
                      eng.t_pages.page_table(range(B)))
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] == runs[False][1]
    np.testing.assert_array_equal(runs[True][3], runs[False][3])
    assert runs[False][2] == [1, 1, 1] and runs[True][2] == [2, 2, 2]


def test_multidraft_cell_session_matches_reference(ref):
    from repro_torch.api import CellConfig, EngineBackend, MultiSpinCell, Request

    eng = _port_engine(ref)
    start, _ = _prompts()
    reqs = _requests(Request)
    backend = EngineBackend(eng, eng.start(torch.from_numpy(start)),
                            keep_finished_tokens=True, draws_fn=jax_draws)
    cell = MultiSpinCell(_multidraft_config(CellConfig), backend=backend,
                         rng=np.random.default_rng(0))
    for req in reqs:
        cell.submit(req)
    for want in ref["cell_rounds"]:
        rec = cell.step()
        for k in ("lengths", "accepted", "active", "rids"):
            np.testing.assert_array_equal(getattr(rec, k), want[k])
        assert rec.draft_width == want["draft_width"] >= 2
        assert rec.pool_stats == want["pool_stats"]
        assert rec.n_host_syncs == want["n_host_syncs"] == 2
        assert rec.realized_goodput == want["realized_goodput"]
    assert cell.summary() == ref["cell_summary"]
    assert {r.rid: backend.stream_tokens(r.rid) for r in reqs} \
        == ref["cell_tokens"]


def test_serve_cli_runs_multidraft_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen2.5-3b", "--smoke", "--devices", "3",
                "--rounds", "2", "--max-new-tokens", "6", "--device", "cpu",
                "--scheme", "multidraft", "--scheme-arg", "J_min=2",
                "--scheme-arg", "J_max=3"])
    out = capsys.readouterr().out
    rounds = [ln for ln in out.splitlines() if ln.startswith("round ")]
    assert len(rounds) == 2 and all(" J=2" in ln or " J=3" in ln
                                    for ln in rounds), out
    assert "completed=" in out


if __name__ == "__main__":
    assert sys.argv[1] == "reference"
    _reference(sys.argv[2])
