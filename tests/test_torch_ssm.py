"""The port's SSM (mamba2) and hybrid (zamba2) targets on the CPU against
the JAX package's.

The plain SSD scan (B10) and recurrence against ``repro.kernels.ref`` and
the Pallas kernel in interpret mode (float32 within 1e-4, the scan's band
in ``tests/test_kernels.py``; bfloat16 within its 3e-2), ``MambaLM`` /
``HybridLM`` logits and caches within 2e-5 (``_tol(float32)``), the
snapshot helpers exactly, and contiguous engine rounds with per-row state
rollback under replayed draws (``tests/test_torch_engine.py::jax_draws``):
identical tokens, accept masks, counts, committed lists, ``pool_stats`` and
host syncs.  The reference engines run in ONE subprocess (this file as a
script), as in ``tests/test_torch_tree.py``.
"""

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

from test_torch_engine import TOL, VHAT, B, _committed, _prompts, jax_draws

from repro.kernels import ref as jref
from repro_torch import configs as tcfgs
from repro_torch.bridge import params_from_jax
from repro_torch.core.draws import RoundDraws
from repro_torch.kernels import cases
from repro_torch.kernels import ops as tops

ARCHS = ("mamba2-130m", "zamba2-2.7b")
MAX_LEN = 64
ROUNDS = [[4, 2, 3], [1, 4, 4]]          # L = 4 in both: few reference shapes
CELL_ROUNDS = 2
SSD_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(cfg_mod, arch):
    """An SSM-family smoke target and the attention draft of
    ``tests/test_spec_engine.py::_engine`` (the JAX engine refuses SSM
    drafts), from either package's registry."""
    tcfg = cfg_mod.get_config(arch).smoke()
    dcfg = cfg_mod.get_config("qwen2.5-3b").smoke().replace(
        num_layers=1, d_model=32, num_heads=2, num_kv_heads=1, head_dim=16,
        d_ff=64, name="draft-smoke")
    return tcfg, dcfg


def _requests(req_cls):
    """Persistent requests, one per start row: an SSM target refuses frozen
    rows, so every request stays active in every round."""
    start, _ = _prompts()
    return [req_cls(rid=i, prompt_len=len(p), max_new_tokens=10 ** 6,
                    alpha=0.8, T_S=0.02 + 0.005 * i,
                    prompt=tuple(int(t) for t in p))
            for i, p in enumerate(start)]


def _cell_config(cell_cls):
    return cell_cls(scheme="hete", t_ver_fix=0.03, t_ver_lin=0.002, L_max=4,
                    max_batch=B, seed=0)


# ---------------------------------------------------------------------------
# the reference side (runs in a subprocess: this file as a script)
# ---------------------------------------------------------------------------

def _reference(out_path):
    from repro import configs as jcfgs
    from repro.api import CellConfig, EngineBackend, MultiSpinCell, Request
    from repro.serving import SpecEngine

    start, _ = _prompts()
    out = {}
    for arch in ARCHS:
        tcfg, dcfg = _cfgs(jcfgs, arch)
        eng = SpecEngine(tcfg, dcfg, max_len=MAX_LEN, compile_mode="eager")
        eng.init_params(jax.random.PRNGKey(0))
        params = (eng.t_params, eng.d_params)
        out[arch] = {"t_params": jax.tree.map(np.asarray, eng.t_params),
                     "d_params": jax.tree.map(np.asarray, eng.d_params)}
        st = eng.start(jnp.asarray(start))
        rounds = []
        for r, lengths in enumerate(ROUNDS):
            h0 = eng.host_syncs
            st, res, dres = eng.spin_round(st, np.asarray(lengths),
                                           jax.random.PRNGKey(500 + r),
                                           vhat=VHAT)
            rounds.append({
                "accept_counts": np.asarray(res.accept_counts),
                "output_tokens": np.asarray(res.output_tokens),
                "accept_mask": np.asarray(res.accept_mask),
                "draft_tokens": np.asarray(dres.tokens),
                "last_accepted": eng.last_accepted.copy(),
                "host_syncs": eng.host_syncs - h0,
                "pool_stats": eng.pool_stats(),
                "committed": _committed(st)})
        out[arch]["rounds"] = rounds
        out[arch]["t_cache"] = jax.tree.map(np.asarray, eng.t_cache)
        out[arch]["target_pos"] = np.asarray(st.target_pos)

    # a hete cell session with the hybrid target
    tcfg, dcfg = _cfgs(jcfgs, "zamba2-2.7b")
    eng = SpecEngine(tcfg, dcfg, max_len=MAX_LEN, compile_mode="eager")
    eng.t_params, eng.d_params = params
    reqs = _requests(Request)
    backend = EngineBackend(eng, eng.start(jnp.asarray(start)))
    cell = MultiSpinCell(_cell_config(CellConfig), backend=backend,
                         rng=np.random.default_rng(0))
    for req in reqs:
        cell.submit(req)
    recs = []
    for _ in range(CELL_ROUNDS):
        rec = cell.step()
        recs.append({k: getattr(rec, k) for k in (
            "lengths", "accepted", "active", "rids", "pool_stats",
            "n_host_syncs", "realized_goodput")})
    out["cell"] = {"rounds": recs, "summary": cell.summary(),
                   "tokens": {r.rid: backend.stream_tokens(r.rid) for r in reqs}}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(autouse=True, scope="module")
def _reference_run(tmp_path_factory):
    """Start the reference subprocess as the module starts, so that it runs
    while the in-process tests at the top of this file do; ``ref`` waits
    for it.  The process is killed if the module ends first."""
    path = tmp_path_factory.mktemp("jax_ssm_ref") / "ref.pkl"
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


def _port_engine(arch, params=None):
    from repro_torch.serving import SpecEngine

    tcfg, dcfg = _cfgs(tcfgs, arch)
    eng = SpecEngine(tcfg, dcfg, max_len=MAX_LEN, device="cpu")
    if params is None:
        eng.init_params(0)
    else:
        eng.t_params = params_from_jax(tcfg, params["t_params"], device="cpu")
        eng.d_params = params_from_jax(dcfg, params["d_params"], device="cpu")
    return eng


# ---------------------------------------------------------------------------
# B10, the recurrence and the snapshot helpers (reference in-process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 64, 4, 32, 1, 32, 16),
    (1, 48, 4, 16, 2, 16, 8),      # grouped B/C, smoke widths
])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_plain_matches_jax_ref(b, s, h, p, g, n, chunk, init):
    x, dt, A, B_, C, st = cases.ssd_case(b, s, h, p, g, n, torch.float32,
                                         "cpu", seed=s + h, init=init)
    want_y, want_s = jref.ssd_scan_ref(
        *(jnp.asarray(t.numpy()) for t in (x, dt, A, B_, C)), chunk=chunk,
        initial_state=None if st is None else jnp.asarray(st.numpy()))
    y, fs = tops.ssd_scan(x, dt, A, B_, C, chunk=chunk, initial_state=st)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
    np.testing.assert_allclose(fs.numpy(), np.asarray(want_s), **SSD_TOL)


def test_ssd_scan_plain_matches_jax_ref_in_bfloat16():
    x, dt, A, B_, C, _ = cases.ssd_case(1, 32, 2, 16, 1, 16, torch.bfloat16,
                                        "cpu", seed=3)
    want_y, want_s = jref.ssd_scan_ref(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype ==
                      torch.bfloat16 else jnp.float32)
          for t in (x, dt, A, B_, C)), chunk=8)
    y, fs = tops.ssd_scan(x, dt, A, B_, C, chunk=8)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want_y, np.float32),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(fs.numpy(), np.asarray(want_s),
                               rtol=1e-2, atol=1e-2)


def test_ssd_scan_plain_matches_pallas_interpret():
    from repro.kernels.ssd_scan import ssd_scan_pallas

    x, dt, A, B_, C, st = cases.ssd_case(1, 32, 2, 16, 1, 16, torch.float32,
                                         "cpu", seed=9, init=True)
    want_y, want_s = ssd_scan_pallas(
        *(jnp.asarray(t.numpy()) for t in (x, dt, A, B_, C)), chunk=8,
        initial_state=jnp.asarray(st.numpy()), interpret=True)
    y, fs = tops.ssd_scan(x, dt, A, B_, C, chunk=8, initial_state=st)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
    np.testing.assert_allclose(fs.numpy(), np.asarray(want_s), **SSD_TOL)


def test_ops_ssd_scan_pads_like_the_reference():
    """A 27-step sequence (not a chunk multiple) is padded with dt = 0 on
    both sides; y keeps its 27 steps and the final state is exact."""
    from repro.kernels import ops as jops

    x, dt, A, B_, C, st = cases.ssd_case(2, 27, 4, 16, 1, 16, torch.float32,
                                         "cpu", seed=27, init=True)
    want_y, want_s = jops.ssd_scan(
        *(jnp.asarray(t.numpy()) for t in (x, dt, A, B_, C)), chunk=8,
        initial_state=jnp.asarray(st.numpy()))
    tops.reset_counts()
    y, fs = tops.ssd_scan(x, dt, A, B_, C, chunk=8, initial_state=st)
    assert y.shape == (2, 27, 4, 16)
    assert tops.counts()["ssd_scan"] == {"kernel": 0, "plain": 1}
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
    np.testing.assert_allclose(fs.numpy(), np.asarray(want_s), **SSD_TOL)


def test_ssd_decode_matches_jax_and_counts_nothing():
    x, dt, A, B_, C, st = cases.ssd_case(3, 1, 4, 16, 2, 16, torch.float32,
                                         "cpu", seed=1, init=True)
    args = (x[:, 0], dt[:, 0], A, B_[:, 0], C[:, 0], st)
    want = jref.ssd_decode_ref(*(jnp.asarray(t.numpy()) for t in args))
    tops.reset_counts()
    got = tops.ssd_decode(*args)
    assert all(c == {"kernel": 0, "plain": 0} for c in tops.counts().values())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_snapshot_helpers_match_jax():
    """``select_snapshots`` (per-row step, clamped) and
    ``merge_snapshot_into_cache`` on the leaf layouts of both families."""
    from repro.serving import kv_cache as jkv
    from repro_torch.serving import kv_cache as tkv

    rng = np.random.default_rng(3)
    T, Bs = 4, 3
    snaps = {"ssm": rng.standard_normal((T, 2, 3, Bs, 2, 2, 2)).astype(np.float32),
             "conv": rng.standard_normal((T, 2, 3, Bs, 3, 5)).astype(np.float32)}
    axes = {"ssm": 2, "conv": 2, "k": 1, "v": 1}
    idx = np.array([0, 3, 7], np.int32)                  # 7 clamps to T - 1
    want = jkv.select_snapshots({k: jnp.asarray(v) for k, v in snaps.items()},
                                jnp.asarray(idx), axes)
    got = tkv.select_snapshots({k: torch.from_numpy(v) for k, v in snaps.items()},
                               torch.from_numpy(idx), axes)
    for k in snaps:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].is_contiguous()
    cache = {"ssm": torch.zeros(1), "conv": torch.zeros(1), "k": torch.ones(2)}
    merged = tkv.merge_snapshot_into_cache(cache, got)
    assert merged["k"] is cache["k"] and merged["ssm"] is got["ssm"]
    jmerged = jkv.merge_snapshot_into_cache(
        {k: jnp.asarray(v.numpy()) for k, v in cache.items()}, want)
    assert set(jmerged) == set(merged)


def _model_pair(arch):
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro_torch.models import build_model as tbuild

    tcfg = tcfgs.get_config(arch).smoke()
    jm = jbuild(jget(arch).smoke())
    jp = jm.init(jax.random.PRNGKey(4))
    tm = tbuild(tcfg, device="cpu")
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return tcfg, jm, jp, tm, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_models_match_jax(arch):
    """``apply``, ``prefill`` (the SSD scan over a ragged 11-step prompt)
    and a 4-step ``forward_window`` with per-step snapshots: logits, caches
    and snapshots within 2e-5 of the JAX model; the window leaves the cache
    it was given untouched (the state is functional)."""
    cfg, jm, jp, tm, tp = _model_pair(arch)
    rng = np.random.default_rng(8)
    Bm, M, S = 2, 12, 24
    toks = rng.integers(0, cfg.vocab_size, (Bm, M)).astype(np.int32)
    jl_, _ = jm.apply(jp, jnp.asarray(toks))
    tl_, _ = tm.apply(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL)
    jc = jm.init_cache(Bm, S, jnp.float32)
    tc = tm.init_cache(Bm, S, torch.float32)
    jl_, jc, _ = jm.prefill(jp, jnp.asarray(toks[:, :-1]), jc)
    tl_, tc, _ = tm.prefill(tp, torch.from_numpy(toks[:, :-1]), tc)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
    before = {k: v.clone() for k, v in tc.items() if k in ("ssm", "conv")}
    win = rng.integers(0, cfg.vocab_size, (Bm, 4)).astype(np.int32)
    pos = np.array([M - 1, M - 1], np.int32)
    jl_, jc2, jsnap = jm.forward_window(jp, jnp.asarray(win), jc,
                                        jnp.asarray(pos), return_snapshots=True)
    tl_, tc2, tsnap = tm.forward_window(tp, torch.from_numpy(win), tc,
                                        torch.from_numpy(pos),
                                        return_snapshots=True)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL)
    for k in jc2:
        np.testing.assert_allclose(tc2[k].numpy(), np.asarray(jc2[k]), **TOL)
    assert set(tsnap) == set(jsnap) == {"ssm", "conv"}
    for k in jsnap:
        np.testing.assert_allclose(tsnap[k].numpy(), np.asarray(jsnap[k]), **TOL)
        assert torch.equal(tc[k], before[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_unstacks_the_layer_axes(arch):
    cfg, jm, jp, tm, tp = _model_pair(arch)
    if arch.startswith("zamba"):
        groups = cfg.num_layers // cfg.hybrid_group
        assert len(tp["mamba"]) == groups
        assert all(len(g) == cfg.hybrid_group for g in tp["mamba"])
        np.testing.assert_array_equal(tp["mamba"][1][0]["in_proj"].numpy(),
                                      np.asarray(jp["mamba"]["in_proj"][1, 0]))
        np.testing.assert_array_equal(tp["shared"]["attn"]["wq"].numpy(),
                                      np.asarray(jp["shared"]["attn"]["wq"]))
    else:
        assert len(tp["blocks"]) == cfg.num_layers
        np.testing.assert_array_equal(tp["blocks"][1]["conv_w"].numpy(),
                                      np.asarray(jp["blocks"]["conv_w"][1]))
        assert "unembed" not in tp and cfg.tie_embeddings
    assert tm.num_params(tp) == jm.num_params(jp)


# ---------------------------------------------------------------------------
# engine, cell, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_rounds_match_reference(ref, arch):
    want = ref[arch]
    eng = _port_engine(arch, want)
    start, _ = _prompts()
    tops.reset_counts()
    st = eng.start(torch.from_numpy(start))
    tcfg = eng.target_cfg
    assert tops.counts()["ssd_scan"]["plain"] == tcfg.num_layers
    # B8 runs the draft's prefill layers and the hybrid's shared-block ones
    shared = tcfg.num_layers // tcfg.hybrid_group if tcfg.family == "hybrid" else 0
    assert tops.counts()["flash_attention"]["plain"] \
        == eng.draft_cfg.num_layers + shared
    V = eng.target_cfg.vocab_size
    for r, (lengths, w) in enumerate(zip(ROUNDS, want["rounds"])):
        h0 = eng.host_syncs
        st, res, dres = eng.spin_round(
            st, np.asarray(lengths), jax_draws(500 + r, B, max(lengths), VHAT, V),
            vhat=VHAT)
        np.testing.assert_array_equal(dres.tokens.numpy(), w["draft_tokens"])
        for name in ("accept_counts", "output_tokens", "accept_mask"):
            np.testing.assert_array_equal(getattr(res, name).numpy(), w[name],
                                          f"round {r} {name}")
        np.testing.assert_array_equal(eng.last_accepted, w["last_accepted"])
        assert eng.host_syncs - h0 == w["host_syncs"] == 1
        assert eng.pool_stats() == w["pool_stats"]
        assert _committed(st) == w["committed"]
    # every draft step and every hybrid target step ran B7
    assert tops.counts()["decode_attention"]["plain"] > 0
    # the rolled-back state of every row equals the reference's
    np.testing.assert_array_equal(st.target_pos.numpy(), want["target_pos"])
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(eng.t_cache[k].numpy(), want["t_cache"][k],
                                   **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_ssm_target_state_rollback(arch):
    """The port's ``tests/test_spec_engine.py::
    test_engine_ssm_target_state_rollback``: after rounds that reject, the
    engine's incremental next-token logits equal a fresh full forward over
    the committed sequence (within the reference test's 2e-3)."""
    eng = _port_engine(arch)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, 257, (2, 8)).astype(np.int32))
    st = eng.start(prompts)
    for r in range(2):
        st, res, _ = eng.spin_round(
            st, np.array([3, 4]), RoundDraws.sample(20 + r, 2, 4, VHAT, 257,
                                                    device="cpu"), vhat=VHAT)
    inc, _ = eng.target.forward_window(eng.t_params, st.pending[:, None],
                                       eng.t_cache, st.target_pos)
    for b in range(2):
        assert st.committed[b][-1] == int(st.pending[b])
        seq = torch.tensor([list(map(int, st.committed[b]))], dtype=torch.int32)
        full, _ = eng.target.apply(eng.t_params, seq)
        np.testing.assert_allclose(inc[b, 0].numpy(), full[0, -1].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_hybrid_cell_session_matches_reference(ref):
    """A hete cell over a zamba2 smoke target with persistent requests: all
    three stay active each round, as an SSM target needs (no frozen row)."""
    from repro_torch.api import CellConfig, EngineBackend, MultiSpinCell, Request

    eng = _port_engine("zamba2-2.7b", ref["zamba2-2.7b"])
    start, _ = _prompts()
    reqs = _requests(Request)
    backend = EngineBackend(eng, eng.start(torch.from_numpy(start)),
                            draws_fn=jax_draws)
    cell = MultiSpinCell(_cell_config(CellConfig), backend=backend,
                         rng=np.random.default_rng(0))
    for req in reqs:
        cell.submit(req)
    for w in ref["cell"]["rounds"]:
        rec = cell.step()
        for k in ("lengths", "accepted", "active", "rids"):
            np.testing.assert_array_equal(getattr(rec, k), w[k])
        assert len(rec.rids) == B
        assert rec.pool_stats == w["pool_stats"]
        assert rec.n_host_syncs == w["n_host_syncs"] == 1
        assert rec.realized_goodput == w["realized_goodput"]
    assert cell.summary() == ref["cell"]["summary"]
    assert {r.rid: backend.stream_tokens(r.rid) for r in reqs} \
        == ref["cell"]["tokens"]


def test_ssm_refusals_match_the_reference():
    """A frozen row with an SSM target, an SSM draft, an SSM model on pages
    and a tree round with an SSM target are refused, as in the JAX
    engine."""
    from repro_torch.serving import SpecEngine

    tcfg, dcfg = _cfgs(tcfgs, "zamba2-2.7b")
    with pytest.raises(NotImplementedError, match="paged caches"):
        SpecEngine(tcfg, dcfg, cache_kind="paged", device="cpu")
    eng = _port_engine("mamba2-130m")
    st = eng.start(torch.from_numpy(_prompts()[0]))
    draws = RoundDraws.sample(0, B, 2, VHAT, 257, device="cpu")
    with pytest.raises(NotImplementedError, match="pre-window"):
        eng.spin_round(st, np.array([2, 2, 2]), draws, vhat=VHAT,
                       freeze=[False, True, False])
    with pytest.raises(NotImplementedError, match="attention decoder"):
        eng.spin_round(st, np.array([2, 2, 2]), draws, vhat=VHAT, tree=True)
    ssm_draft = SpecEngine(dcfg, tcfgs.get_config("mamba2-130m").smoke(),
                           max_len=MAX_LEN, device="cpu")
    ssm_draft.init_params(0)
    st = ssm_draft.start(torch.from_numpy(_prompts()[0]))
    with pytest.raises(NotImplementedError, match="SSM draft"):
        ssm_draft.spin_round(st, np.array([2, 2, 2]), draws, vhat=VHAT)


if __name__ == "__main__":
    assert sys.argv[1] == "reference"
    _reference(sys.argv[2])
