"""The port's contiguous cache layout on the CPU against the JAX package's.

The layout of ``SpecEngine(cache_kind="contiguous")`` (the default of both
engines): (B, max_len) caches fixed at ``start()``, J=1 rounds and
token-tree rounds (J=1 through the tree machinery, J=2, J=3; scatter and
repair commits), with ``ops.tree_attention`` (B6) on the tree windows.
Randomness is replayed with ``tests/test_torch_engine.py::jax_draws`` and
both sides carry the same weights (``bridge.params_from_jax``).  Tokens,
accept masks, counts, winners, committed lists, ``pool_stats`` and host
syncs per round must be identical; float outputs agree within 2e-5
(``_tol(float32)`` of ``tests/test_kernels.py``), bfloat16 attention within
2e-2 (``_tol(bfloat16)``).

The reference engines run in ONE subprocess (this file as a script), as in
``tests/test_torch_tree.py``: compiling several JAX engines late in a long
pytest process can segfault the XLA CPU compiler (ROADMAP §C).
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
    TOL,
    VHAT,
    B,
    _cell_config,
    _cfgs,
    _committed,
    _prompts,
    _requests,
    jax_draws,
)

from repro.kernels import ref as jref
from repro_torch import configs as tcfgs
from repro_torch.bridge import params_from_jax
from repro_torch.core.draws import RoundDraws, TreeDraws
from repro_torch.kernels import cases
from repro_torch.kernels import ops as tops

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# Every round drafts up to L = 4, so the reference compiles few shapes (its
# first round of each shape dominates the file's time).
SEQ_ROUNDS = [([4, 2, 3], None), ([1, 4, 4], [False, True, False]),
              ([3, 4, 2], None)]
# (J, tree, lengths, freeze) per round
TREE_ROUNDS = [
    (2, None, [4, 2, 3], None),
    (3, None, [1, 4, 4], [False, True, False]),
    (1, True, [4, 3, 2], None),          # J = 1 through the tree machinery
]
# the repair engine runs the first (J = 2) round: a J = 1 tree round runs no
# fix-up, so it is the same in both modes
ROUNDS_OF = {"scatter": len(TREE_ROUNDS), "repair": 1}
COMMITS = ("scatter", "repair")
CELL_ROUNDS = 3


def _multidraft_config(cell_cls):
    return dataclasses.replace(_cell_config(cell_cls), scheme="multidraft",
                               scheme_params={"J_min": 2, "J_max": 3})


# ---------------------------------------------------------------------------
# the reference side (runs in a subprocess: this file as a script)
# ---------------------------------------------------------------------------

def _reference(out_path):
    from repro import configs as jcfgs
    from repro.api import CellConfig, EngineBackend, MultiSpinCell, Request
    from repro.serving import SpecEngine

    tcfg, dcfg = _cfgs(jcfgs)
    start, _ = _prompts()
    out = {}

    params = []

    def engine(commit="scatter"):
        eng = SpecEngine(tcfg, dcfg, max_len=MAX_LEN, tree_commit=commit,
                         compile_mode="eager")
        if not params:                   # one draw of the weights for all
            params.extend(eng.init_params(jax.random.PRNGKey(0)))
        eng.t_params, eng.d_params = params
        return eng

    def record(eng, st, res, h0):
        return {"accept_counts": np.asarray(res.accept_counts),
                "output_tokens": np.asarray(res.output_tokens),
                "accept_mask": np.asarray(res.accept_mask),
                "last_accepted": eng.last_accepted.copy(),
                "host_syncs": eng.host_syncs - h0,
                "pool_stats": eng.pool_stats(),
                "committed": _committed(st)}

    eng = engine()
    out["t_params"] = jax.tree.map(np.asarray, eng.t_params)
    out["d_params"] = jax.tree.map(np.asarray, eng.d_params)
    st = eng.start(jnp.asarray(start))
    rounds = []
    for r, (lengths, freeze) in enumerate(SEQ_ROUNDS):
        h0 = eng.host_syncs
        st, res, dres = eng.spin_round(st, np.asarray(lengths),
                                       jax.random.PRNGKey(1000 + r), vhat=VHAT,
                                       freeze=freeze)
        rounds.append(dict(record(eng, st, res, h0),
                           draft_tokens=np.asarray(dres.tokens)))
    out["seq"] = rounds

    for commit in COMMITS:
        eng = engine(commit)
        st = eng.start(jnp.asarray(start))
        rounds = []
        for r, (J, tree, lengths, freeze) in enumerate(
                TREE_ROUNDS[:ROUNDS_OF[commit]]):
            h0 = eng.host_syncs
            st, res, forest = eng.spin_round(
                st, np.asarray(lengths), jax.random.PRNGKey(3000 + r),
                vhat=VHAT, freeze=freeze, draft_width=J, tree=tree)
            rounds.append(dict(record(eng, st, res, h0),
                               forest_tokens=np.asarray(forest.tokens),
                               winner=np.asarray(res.winner)))
        out[commit] = rounds

    for scheme, cfg_of in (("hete", _cell_config),
                           ("multidraft", _multidraft_config)):
        eng = engine()
        reqs = _requests(Request)
        backend = EngineBackend(eng, eng.start(jnp.asarray(start)),
                                keep_finished_tokens=True)
        cell = MultiSpinCell(cfg_of(CellConfig), backend=backend,
                             rng=np.random.default_rng(0))
        for req in reqs:
            cell.submit(req)
        recs = []
        for _ in range(CELL_ROUNDS):
            rec = cell.step()
            recs.append({k: getattr(rec, k) for k in (
                "lengths", "accepted", "active", "rids", "pool_stats",
                "n_host_syncs", "realized_goodput", "draft_width")})
        out[f"cell_{scheme}"] = {
            "rounds": recs, "summary": cell.summary(),
            "rejected": sorted(r.rid for r in cell.rejected),
            "tokens": {r.rid: backend.stream_tokens(r.rid) for r in reqs}}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(autouse=True, scope="module")
def _reference_run(tmp_path_factory):
    """Start the reference subprocess as the module starts, so that it runs
    while the in-process tests at the top of this file do; ``ref`` waits
    for it.  The process is killed if the module ends first."""
    path = tmp_path_factory.mktemp("jax_contiguous_ref") / "ref.pkl"
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
    eng = SpecEngine(tcfg, dcfg, max_len=MAX_LEN, tree_commit=commit,
                     device="cpu")
    assert eng.cache_kind == "contiguous"          # the reference's default
    eng.t_params = params_from_jax(tcfg, params["t_params"], device="cpu")
    eng.d_params = params_from_jax(dcfg, params["d_params"], device="cpu")
    return eng


# ---------------------------------------------------------------------------
# B6 and the contiguous cache primitives (reference in-process, no engine:
# these run while the reference subprocess runs)
# ---------------------------------------------------------------------------

CONTIGUOUS_TREE_SHAPES = [
    # B, J, L, H, KV, D, S, ctx
    (3, 2, 3, 4, 2, 16, 48, 30),      # GQA, J=2
    (2, 3, 2, 4, 1, 32, 40, 30),      # MQA, J=3
    (2, 2, 4, 4, 4, 64, 24, 14),      # MHA, short cache
]


@pytest.mark.parametrize("shape", CONTIGUOUS_TREE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_attention_plain_matches_jax_ref(shape, dtype):
    """The plain B6 against ``repro.kernels.ref.tree_attention_ref`` on the
    same inputs, one row's lengths at the end of the cache (S - T)."""
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, kc, vc, ln, mask = cases.contiguous_tree_case(*shape, dtype=tdt,
                                                     device="cpu",
                                                     seed=sum(shape))
    T = q.shape[1]
    ln[0] = kc.shape[1] - T
    arrs = [t.float().numpy() if t.is_floating_point() else t.numpy()
            for t in (q, kc, vc, ln, mask)]
    want = np.asarray(jref.tree_attention_ref(
        *(jnp.asarray(a, jdt) for a in arrs[:3]), jnp.asarray(arrs[3]),
        jnp.asarray(arrs[4])), np.float32)
    got = tops.tree_attention(q, kc, vc, ln, mask).float().numpy()
    np.testing.assert_allclose(got, want,
                               **(TOL if dtype == "float32" else BF16_TOL))


def test_tree_attention_plain_matches_pallas_interpret():
    from repro.kernels.tree_attention import tree_attention_pallas

    q, kc, vc, ln, mask = cases.contiguous_tree_case(2, 2, 2, 4, 2, 16, 32, 20,
                                                     torch.float32, "cpu",
                                                     seed=4)
    want = np.asarray(tree_attention_pallas(
        *(jnp.asarray(t.numpy()) for t in (q, kc, vc, ln, mask)), bs=16,
        interpret=True))
    got = tops.tree_attention(q, kc, vc, ln, mask).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_tree_attention_chain_mask_is_the_causal_window():
    """A lower-triangular mask over a contiguous cache is the sequential
    window: equal to ``gqa_attention`` under the causal window mask."""
    from repro_torch.models.layers import gqa_attention

    q, kc, vc, ln, mask = cases.contiguous_tree_case(3, 2, 3, 4, 2, 16, 40, 30,
                                                     torch.float32, "cpu",
                                                     chain=True)
    T, S = q.shape[1], kc.shape[1]
    kj = torch.arange(S)[None, None, :]
    causal = (kj <= (ln.long()[:, None] + torch.arange(T))[:, :, None])
    want = gqa_attention(q, kc, vc, causal[:, None, None])
    torch.testing.assert_close(tops.tree_attention(q, kc, vc, ln, mask), want,
                               rtol=2e-5, atol=2e-5)


def test_contiguous_cache_primitives_match_jax():
    """``update_kv_cache`` (scalar and per-row offsets, a row whose window
    would run past the end clamps to S - T as ``dynamic_update_slice``),
    ``gather_kv_window`` (positions clamp to [0, S-1]) and
    ``scatter_kv_window`` (invalid and out-of-range positions drop), each
    equal to the JAX function on the same arrays."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(5)
    Ln, Bc, S, KV, D, T = 2, 3, 12, 2, 4, 3
    base = rng.standard_normal((Ln, Bc, S, KV, D)).astype(np.float32)
    new = rng.standard_normal((Bc, T, KV, D)).astype(np.float32)

    def port_cache():
        c = tl.new_page_pool(Ln, Bc, S, KV, D, dtype=torch.float32,
                             device="cpu")
        c.copy_(torch.from_numpy(base))
        return c

    for offset in (4, np.array([0, 7, S - 1], np.int32)):
        want = np.asarray(jl.update_kv_cache(jnp.asarray(base[0]),
                                             jnp.asarray(new), offset))
        got = tl.update_kv_cache(port_cache()[0], torch.from_numpy(new),
                                 torch.as_tensor(offset))
        np.testing.assert_array_equal(got.numpy(), want)
    # the row at S - 1 landed at S - T, whole
    np.testing.assert_array_equal(want[2, S - T:], new[2])

    pos = np.array([[0, 5, 11, 12], [3, -2, 7, 30], [1, 2, 3, 4]], np.int32)
    want = np.asarray(jl.gather_kv_window(jnp.asarray(base), jnp.asarray(pos)))
    got = tl.gather_kv_window(port_cache(), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)

    vals = rng.standard_normal((Ln, Bc, 4, KV, D)).astype(np.float32)
    pos = np.array([[0, 5, 11, 12], [3, 4, 7, 30], [1, 2, 3, 4]], np.int32)
    valid = np.array([[1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 1, 0]], bool)
    want = np.asarray(jl.scatter_kv_window(jnp.asarray(base), jnp.asarray(vals),
                                           jnp.asarray(pos), jnp.asarray(valid)))
    got = tl.scatter_kv_window(port_cache(), torch.from_numpy(vals),
                               torch.from_numpy(pos), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jl.causal_mask(3, 5, 1)),
                                  tl.causal_mask(3, 5, 1, device="cpu").numpy())


def _dense_pair():
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import build_model as jbuild
    from repro_torch.models import build_model as tbuild

    tcfg, _ = _cfgs(tcfgs)
    jm = jbuild(JModelConfig(**dataclasses.asdict(tcfg)))
    jp = jm.init(jax.random.PRNGKey(3))
    tm = tbuild(tcfg, device="cpu")
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return tcfg, jm, jp, tm, tp


@pytest.mark.parametrize("J", ["seq", "chain", 2, 3])
def test_decoder_contiguous_matches_jax(J):
    """``DecoderLM`` on the contiguous layout: ``apply``, ``prefill`` and a
    window — sequential, a chain mask (which must equal the sequential
    window), and J=2 / J=3 tree windows from ``build_token_tree`` — give the
    JAX model's logits and caches within 2e-5; one row's window runs past
    the end of the cache and lands clamped on both sides."""
    from repro_torch.core.token_tree import build_token_tree

    cfg, jm, jp, tm, tp = _dense_pair()
    rng = np.random.default_rng(7)
    Bm, M, S, L = 3, 9, 24, 3
    toks = rng.integers(0, cfg.vocab_size, (Bm, M)).astype(np.int32)
    jl_, _ = jm.apply(jp, jnp.asarray(toks))
    tl_, _ = tm.apply(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL)
    jc = jm.init_cache(Bm, S, jnp.float32)
    tc = tm.init_cache(Bm, S, torch.float32)
    jl_, jc, _ = jm.prefill(jp, jnp.asarray(toks), jc)
    tl_, tc, _ = tm.prefill(tp, torch.from_numpy(toks), tc)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL)
    pos = np.array([M, M - 2, S - 2], np.int32)      # row 2 clamps
    if J == "seq":
        win = rng.integers(0, cfg.vocab_size, (Bm, L + 1)).astype(np.int32)
        jargs, targs = {}, {}
    else:
        Jn = 1 if J == "chain" else J
        drafts = rng.integers(0, 3, (Bm, Jn, L))
        zeros = np.zeros((Bm, Jn, L, 1))
        tree = build_token_tree(drafts, zeros[..., 0], zeros.astype(np.int32),
                                zeros, np.full(Bm, L))
        win = tree.window_tokens(toks[:, -1]).astype(np.int32)
        wm, depth = tree.window_mask(), tree.window_depth().astype(np.int32)
        jargs = dict(window_mask=jnp.asarray(wm), window_depth=jnp.asarray(depth))
        targs = dict(window_mask=torch.from_numpy(wm.copy()),
                     window_depth=torch.from_numpy(depth.copy()))
    jl_, jc = jm.forward_window(jp, jnp.asarray(win), jc, jnp.asarray(pos), **jargs)
    tops.reset_counts()
    tl_, tc = tm.forward_window(tp, torch.from_numpy(win), tc,
                                torch.from_numpy(pos), **targs)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tc[leaf].numpy(), np.asarray(jc[leaf]), **TOL)
    assert tops.counts()["tree_attention"]["plain"] == (
        0 if J == "seq" else cfg.num_layers)
    if J == "chain":
        tc2 = tm.init_cache(Bm, S, torch.float32)
        tm.prefill(tp, torch.from_numpy(toks), tc2)
        seq, _ = tm.forward_window(tp, torch.from_numpy(win), tc2,
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(tl_.numpy(), seq.numpy(), **TOL)


def test_concat_caches_keeps_the_drop_slot():
    """Per-row caches stacked into one batch equal the JAX concatenation
    and still take ``scatter_kv_window``'s dropped writes."""
    from repro_torch.models.layers import scatter_kv_window

    cfg, jm, jp, tm, tp = _dense_pair()
    rows = [tm.init_cache(1, 8, torch.float32) for _ in range(2)]
    for i, c in enumerate(rows):
        c["k"].fill_(i + 1.0)
    cat = tm.concat_caches(rows)
    want = jm.concat_caches([jax.tree.map(lambda t: jnp.asarray(t.numpy()), c)
                             for c in rows])
    np.testing.assert_array_equal(cat["k"].numpy(), np.asarray(want["k"]))
    vals = torch.zeros((cfg.num_layers, 2, 1) + tuple(cat["k"].shape[3:]))
    scatter_kv_window(cat["k"], vals, torch.tensor([[0], [9]]),
                      torch.tensor([[False], [True]]))
    np.testing.assert_array_equal(cat["k"].numpy(), np.asarray(want["k"]))


# ---------------------------------------------------------------------------
# engine, cells, refusals
# ---------------------------------------------------------------------------

def test_engine_sequential_rounds_match_reference(ref):
    eng = _port_engine(ref)
    start, _ = _prompts()
    st = eng.start(torch.from_numpy(start))
    V = eng.target_cfg.vocab_size
    tops.reset_counts()
    for r, ((lengths, freeze), want) in enumerate(zip(SEQ_ROUNDS, ref["seq"])):
        h0 = eng.host_syncs
        st, res, dres = eng.spin_round(
            st, np.asarray(lengths), jax_draws(1000 + r, B, max(lengths), VHAT, V),
            vhat=VHAT, freeze=freeze)
        np.testing.assert_array_equal(dres.tokens.numpy(), want["draft_tokens"])
        for name in ("accept_counts", "output_tokens", "accept_mask"):
            np.testing.assert_array_equal(getattr(res, name).numpy(),
                                          want[name], f"round {r} {name}")
        np.testing.assert_array_equal(eng.last_accepted, want["last_accepted"])
        assert eng.host_syncs - h0 == want["host_syncs"] == 1
        assert eng.pool_stats() == want["pool_stats"]
        assert set(want["pool_stats"]) == {"cache_bytes"}
        assert _committed(st) == want["committed"]
    c = tops.counts()
    assert c["fused_verify_sample"]["plain"] == len(SEQ_ROUNDS)
    assert c["paged_attention"]["plain"] == c["tree_attention"]["plain"] == 0
    # the draft steps of the contiguous layout run B7 (the prefill, B8, ran
    # in start() before the counters were reset)
    assert c["decode_attention"]["plain"] > 0
    assert c["flash_attention"]["plain"] == 0
    assert all(v["kernel"] == 0 for v in c.values())


@pytest.mark.parametrize("commit", COMMITS)
def test_engine_tree_rounds_match_reference(ref, commit):
    eng = _port_engine(ref, commit)
    start, _ = _prompts()
    st = eng.start(torch.from_numpy(start))
    V = eng.target_cfg.vocab_size
    tops.reset_counts()
    for r, ((J, tree, lengths, freeze), want) in enumerate(
            zip(TREE_ROUNDS, ref[commit])):
        draws = jax_draws(3000 + r, B, max(lengths), VHAT, V,
                          J=None if J == 1 else J)
        h0 = eng.host_syncs
        st, res, forest = eng.spin_round(st, np.asarray(lengths), draws,
                                         vhat=VHAT, freeze=freeze,
                                         draft_width=J, tree=tree)
        np.testing.assert_array_equal(forest.tokens.numpy(),
                                      want["forest_tokens"])
        for name in ("accept_counts", "output_tokens", "accept_mask", "winner"):
            np.testing.assert_array_equal(getattr(res, name).numpy(),
                                          want[name], f"round {r} {name}")
        np.testing.assert_array_equal(eng.last_accepted, want["last_accepted"])
        expect = 3 if (commit == "repair" and J > 1) else 2
        assert eng.host_syncs - h0 == want["host_syncs"] == expect
        assert eng.pool_stats() == want["pool_stats"]
        assert _committed(st) == want["committed"]
    assert len(ref[commit]) == ROUNDS_OF[commit]
    c = tops.counts()
    assert c["tree_attention"]["plain"] > 0 and c["decode_attention"]["plain"] > 0
    assert c["paged_tree_attention"]["plain"] == c["paged_attention"]["plain"] == 0


def test_tree_j1_equals_the_sequential_round(ref):
    """``spin_round(tree=True)`` at J = 1, given a sequential round's draws,
    commits the tokens of the sequential round and leaves the same target
    cache over every committed position (2 host syncs against 1)."""
    from repro_torch.models.layers import gather_kv_window

    start, _ = _prompts()
    runs = {}
    for tree in (False, True):
        eng = _port_engine(ref)
        st = eng.start(torch.from_numpy(start))
        syncs = []
        for r, lengths in enumerate(([4, 2, 3], [1, 4, 4], [3, 3, 2])):
            h0 = eng.host_syncs
            st, _, _ = eng.spin_round(
                st, np.asarray(lengths),
                RoundDraws.sample(r, B, max(lengths), VHAT, 257, device="cpu"),
                vhat=VHAT, tree=tree)
            syncs.append(eng.host_syncs - h0)
        n = min(len(c) for c in st.committed) - 1
        pos = torch.arange(n)[None].expand(B, n)
        runs[tree] = (_committed(st), syncs,
                      gather_kv_window(eng.t_cache["k"], pos))
    assert runs[True][0] == runs[False][0]
    assert runs[False][1] == [1, 1, 1] and runs[True][1] == [2, 2, 2]
    torch.testing.assert_close(runs[True][2], runs[False][2], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("scheme", ["hete", "multidraft"])
def test_cell_session_matches_reference(ref, scheme):
    """A cell session through ``EngineBackend`` on a contiguous engine: the
    late fourth request finds the batch full and is rejected as by the
    reference; rounds, tokens and summary are equal."""
    from repro_torch.api import CellConfig, EngineBackend, MultiSpinCell, Request

    want = ref[f"cell_{scheme}"]
    eng = _port_engine(ref)
    start, _ = _prompts()
    reqs = _requests(Request)
    backend = EngineBackend(eng, eng.start(torch.from_numpy(start)),
                            keep_finished_tokens=True, draws_fn=jax_draws)
    assert not backend.dynamic
    cfg = (_cell_config if scheme == "hete" else _multidraft_config)(CellConfig)
    cell = MultiSpinCell(cfg, backend=backend, rng=np.random.default_rng(0))
    for req in reqs:
        cell.submit(req)
    for w in want["rounds"]:
        rec = cell.step()
        for k in ("lengths", "accepted", "active", "rids"):
            np.testing.assert_array_equal(getattr(rec, k), w[k])
        assert rec.draft_width == w["draft_width"]
        assert rec.pool_stats == w["pool_stats"]
        assert rec.n_host_syncs == w["n_host_syncs"] == (
            1 if scheme == "hete" else 2)
        assert rec.realized_goodput == w["realized_goodput"]
    assert cell.summary() == want["summary"]
    assert sorted(r.rid for r in cell.rejected) == want["rejected"] == [3]
    assert {r.rid: backend.stream_tokens(r.rid) for r in reqs} == want["tokens"]


def test_contiguous_engine_refuses_churn(ref):
    """As the reference: no admission, no retirement, and a backend asked
    to map a request past the start batch raises "engine batch exhausted"."""
    from repro_torch.api import EngineBackend, Request

    eng = _port_engine(ref)
    start, late = _prompts()
    st = eng.start(torch.from_numpy(start))
    assert eng.can_admit(4) is False
    with pytest.raises(RuntimeError, match="fixed at start"):
        eng.add_streams(st, torch.from_numpy(late))
    with pytest.raises(RuntimeError, match="cannot retire"):
        eng.retire_stream(0)
    backend = EngineBackend(eng, st)
    reqs = _requests(Request)
    backend.bind(reqs[:B])
    assert not backend.can_admit(reqs[B]) and not backend.servable(reqs[B])
    with pytest.raises(ValueError, match="engine batch exhausted"):
        backend.bind(reqs[B:])


if __name__ == "__main__":
    assert sys.argv[1] == "reference"
    _reference(sys.argv[2])
