"""The port's SmallThinker path on the CPU against the benchmark's plain
reference (``perfbench/arch/smallthinkerforcausallm.py``, float32, no
program import): one period of the layer pattern (a global NoPE layer and
three RoPE layers with a window of 8 keys), 8 ReGLU experts with top-2
and a router before attention, d = 64, pages of 4, float32.

* ``apply``, a paged ``prefill`` and J=1 ``SpecEngine`` rounds that run
  well past the window agree with the reference (logits within 2e-5; the
  greedy rounds' bonus tokens are the reference's argmax);
* the comparison catches each of four faults: the router reading the
  MLP's normed input, RoPE on the global layer, SwiGLU in place of ReGLU,
  and a window off by one either way;
* the window pool: pages below a row's window go back and are reused, a
  row holds at most ceil((window + L + 1) / ps) + 1 of them, and a window
  page never returned shows in ``pool_stats`` as the harness reads it;
* the dropless expert layer equals the capacity path at cf = E / K on the
  moonshot smoke stack, and the windowed plain B1 equals a masked plain
  attention;
* contiguous caches and token-tree rounds refuse a windowed target.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import config as pconfig  # noqa: E402
from perfbench.lib import weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.draws import RoundDraws  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.serving.spec_engine import SpecEngine  # noqa: E402

CFG = json.loads((ROOT / "perfbench" / "tests" / "data"
                  / "smallthinker_smoke_config.json").read_text())
TOL = 2e-5          # float32 against float32: a few ulps of the logits
W, PS = 8, 4


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    target, draft = pconfig.models(CFG)
    raw_t = weights.make(target, 0, "target", "cpu", dtype=torch.float32)
    raw_d = weights.make(draft, 0, "draft", "cpu", dtype=torch.float32)
    # wider weights than N(0, 0.02), so that every layer moves the logits
    for name, t in raw_t.items():
        if not name.endswith(("ln_attn", "ln_mlp", "ln_f")):
            t.mul_(5.0)
    return target, draft, raw_t, raw_d


def _seqs(n=2, S=30):
    g = np.random.default_rng(3)
    return [g.integers(0, 500, S).tolist() for _ in range(n)]


def _reference(target, raw, seqs):
    ref_model = target.arch.Reference(target.dims, raw, "cpu")
    return torch.stack(ref_model.logits_at(
        seqs, [list(range(len(s))) for s in seqs]))


def _port(target, raw, **change):
    cfg = target.arch.port_config(target.dims, "float32").replace(**change)
    return build_model(cfg, device="cpu"), target.arch.port_tree(
        target.dims, raw)


def _paged_prefill(model, params, tokens):
    """Prefill of (B, S) tokens through a window pool whose table frees
    nothing (every position written), then the logits."""
    B, S = tokens.shape
    slots = -(-S // PS)
    cache = model.init_paged_cache(B * slots, PS, torch.float32,
                                   window_pages=B * slots)
    pages = torch.arange(B * slots, dtype=torch.int32).reshape(B, slots)
    view = dict(cache, pages=pages, win_pages=pages.flip(1).contiguous())
    logits, _, _ = model.prefill(params, tokens, view)
    return logits


def test_apply_and_prefill_match_the_reference(pair):
    target, _, raw_t, _ = pair
    seqs = _seqs()
    want = _reference(target, raw_t, seqs)
    model, params = _port(target, raw_t)
    tokens = torch.tensor(seqs)
    got, _ = model.apply(params, tokens,
                         moe_capacity=model.no_drop_capacity)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    got = _paged_prefill(model, params, tokens)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.mark.parametrize("fault", ["router reads the MLP input",
                                   "RoPE on the global layer",
                                   "SwiGLU experts", "window + 1",
                                   "window - 1"])
def test_the_comparison_catches(pair, fault):
    target, _, raw_t, _ = pair
    change = {"router reads the MLP input": dict(router_input="mlp_norm"),
              "RoPE on the global layer": dict(rope_layers=(True,) * 4),
              "SwiGLU experts": dict(activation="swiglu"),
              "window + 1": dict(sliding_window=W + 1),
              "window - 1": dict(sliding_window=W - 1)}[fault]
    seqs = _seqs()
    want = _reference(target, raw_t, seqs)
    model, params = _port(target, raw_t, **change)
    got = _paged_prefill(model, params, torch.tensor(seqs))
    assert float((got - want).abs().max()) > 100 * TOL * float(
        want.abs().max())


def _engine(target, draft, raw_t, raw_d, prompts):
    eng = SpecEngine(target.arch.port_config(target.dims, "float32"),
                     draft.arch.port_config(draft.dims, "float32"),
                     max_len=64, cache_dtype=torch.float32,
                     cache_kind="paged", page_size=PS, compile_mode="eager",
                     device="cpu")
    eng.t_params = target.arch.port_tree(target.dims, raw_t)
    eng.d_params = draft.arch.port_tree(draft.dims, raw_d)
    return eng, eng.start(torch.tensor(prompts, dtype=torch.int32))


def _greedy(B, L, V, seed):
    d = RoundDraws.sample(seed, B, L, 16, V, device="cpu")
    return RoundDraws(draft_gumbel=torch.zeros_like(d.draft_gumbel),
                      u_accept=torch.zeros_like(d.u_accept),
                      u_resid=d.u_resid,
                      bonus_gumbel=torch.zeros_like(d.bonus_gumbel))


def test_engine_rounds_past_the_window_match_the_reference(pair):
    target, draft, raw_t, raw_d = pair
    prompts = [s[:10] for s in _seqs(3, 10)]
    eng, state = _engine(target, draft, raw_t, raw_d, prompts)
    V = target.dims.vocab
    bonus = []                      # (row, position that scores it)
    lengths = np.array([3, 1, 4])
    held_max = 0
    for r in range(9):
        before = [len(c) for c in state.committed]
        state, res, _ = eng.spin_round(state, lengths,
                                       _greedy(3, 4, V, r), vhat=16)
        for b in range(3):
            assert len(state.committed[b]) - before[b] == lengths[b] + 1
            bonus.append((b, len(state.committed[b]) - 2))
            held_max = max(held_max, eng.w_pages.held(b))
        eng.w_pages.check_invariants()
    assert min(len(c) for c in state.committed) > 3 * W
    # each live row holds only its window's pages
    assert held_max <= math.ceil((W + 4 + 1) / PS) + 1
    want = target.arch.Reference(target.dims, raw_t, "cpu").logits_at(
        [list(map(int, c[:-1])) for c in state.committed],
        [[p for b2, p in bonus if b2 == b] for b in range(3)])
    for b in range(3):
        poss = [p for b2, p in bonus if b2 == b]
        toks = torch.tensor([int(state.committed[b][p + 1]) for p in poss])
        lg = want[b]
        gap = lg.max(dim=-1).values - lg.gather(1, toks[:, None])[:, 0]
        assert float(gap.max()) <= TOL * float(lg.abs().max())


def test_window_pool_frees_reuses_and_shows_a_leak(pair):
    target, draft, raw_t, raw_d = pair
    prompts = [s[:20] for s in _seqs(2, 20)]
    eng, state = _engine(target, draft, raw_t, raw_d, prompts)
    # pool: 2 x pages_per_stream rows' windows and one admission's pages
    rows = eng.num_pages // eng.pages_per_stream
    assert eng.window_pages == rows * (math.ceil((W + PS) / PS) + 1) \
        + eng.pages_per_stream
    # after the admission's prefill, pages wholly below 19 - 8 + 1 are back
    for b in range(2):
        table = eng.w_pages.page_table([b])[0]
        assert (table[:(19 - W + 1) // PS] == -1).all()
        assert (table[(19 - W + 1) // PS:5] >= 0).all()
    free0 = eng.w_pages.num_free_pages
    for r in range(4):
        state, _, _ = eng.spin_round(state, np.array([4, 4]),
                                     _greedy(2, 4, target.dims.vocab, r),
                                     vhat=16)
    assert eng.w_pages.num_free_pages == free0    # freed as fast as grown
    for row in (0, 1):
        eng.retire_stream(row)
    ps = eng.pool_stats()
    assert ps["free_pages"] == eng.num_pages and ps["used_bytes"] == 0
    # the freed pages serve a new stream; a page never returned is a leak
    state, (row,) = eng.add_streams(state, torch.tensor([prompts[0]]))
    eng.retire_stream(row)
    eng.w_pages._free.pop()
    ps = eng.pool_stats()
    leaked = max(eng.num_pages - ps["free_pages"],
                 0 if ps["used_bytes"] == 0 else 1)
    assert leaked == 1


def test_dropless_experts_equal_the_capacity_path():
    cfg = get_config("moonshot-v1-16b-a3b").smoke()
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    x = torch.randn(3, 7, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    p = params["blocks"][0]["moe"]
    a, aux_a = tl.moe_apply(p, x, model.moe_cfg, dropless=True)
    b, aux_b = tl.moe_apply(p, x, model.moe_cfg,
                            capacity_factor=model.no_drop_capacity)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert torch.equal(aux_a, aux_b)
    # the counts of a window's needed tokens
    counts = torch.zeros(cfg.num_experts, dtype=torch.int32)
    needed = torch.zeros(3, 7, dtype=torch.bool)
    needed[:, :2] = True
    tl.moe_apply(p, x, model.moe_cfg, dropless=True, count=(counts, needed))
    assert int(counts.sum()) == 3 * 2 * cfg.top_k


def test_windowed_plain_b1_equals_masked_attention():
    g = torch.Generator().manual_seed(5)
    B, T, H, KV, D, ps, n_slots = 3, 5, 4, 2, 16, 4, 12
    q = torch.randn(B, T, H, D, generator=g)
    kp = torch.randn(B * n_slots, ps, KV, D, generator=g)
    vp = torch.randn(B * n_slots, ps, KV, D, generator=g)
    pt = torch.arange(B * n_slots, dtype=torch.int32).reshape(B, n_slots)
    lengths = torch.tensor([1, 20, 40], dtype=torch.int32)
    window = 7
    # slots wholly below every query's window go unmapped
    freed = pt.clone()
    for b in range(B):
        freed[b, :max(0, int(lengths[b]) - window) // ps] = -1
    got = ref.paged_attention_ref(q, kp, vp, freed, lengths, window=window)
    k = tl.paged_gather_kv(kp, pt)
    v = tl.paged_gather_kv(vp, pt)
    kpos = torch.arange(n_slots * ps)
    hor = lengths.long()[:, None] + torch.arange(T)[None]
    mask = (kpos[None, None] < hor[..., None]) & (
        kpos[None, None] >= hor[..., None] - window)
    want = tl.gqa_attention(q, k, v, mask[:, None, None])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_contiguous_caches_and_tree_rounds_refuse_a_windowed_target(pair):
    target, draft, raw_t, raw_d = pair
    tcfg = target.arch.port_config(target.dims, "float32")
    with pytest.raises(NotImplementedError, match="paged caches only"):
        build_model(tcfg, device="cpu").init_cache(1, 16, torch.float32)
    with pytest.raises(NotImplementedError, match="paged caches only"):
        SpecEngine(tcfg, draft.arch.port_config(draft.dims, "float32"),
                   max_len=64, cache_kind="contiguous", device="cpu")
    eng, state = _engine(target, draft, raw_t, raw_d, [_seqs(1, 9)[0]])
    with pytest.raises(NotImplementedError, match="token-tree rounds"):
        eng.spin_round(state, np.array([2]), None, draft_width=2)
