"""SmallThinker (``perfbench/arch/smallthinkerforcausallm.py``) at its
published dims: the operations of a row's window and the B1 totals
composed by hand (13 global layers with every earlier key, 39 with the
last 4096, in the published order), the expert costs, and both new
readers (``moe_experts_roofline``, ``engine.window_pages``) on a fixed
profile; then the whole harness on the CPU at smoke size
(``data/smallthinker_smoke_config.json``): a sound run is correct and
reads the window pages it holds."""

import json
import math
import time
from types import SimpleNamespace

import pytest

import smoke
from perfbench.costs import model as cost
from perfbench.costs import moe
from perfbench.costs import paged_attention as pa
from perfbench.lib import config, manifest, peaks

CFG = json.loads((smoke.ROOT / "perfbench" / "configs"
                  / "smallthinker-21ba3b_qwen2.5-0.5b.json").read_text())
H, KV, D, d, V, W = 28, 4, 128, 2560, 151936, 4096
E, K, F = 64, 6, 768


@pytest.fixture(scope="module")
def pair():
    return config.models(CFG)


def test_layers_and_forward_flops_by_hand(pair):
    target, draft = pair
    layers = target.arch.attention_layers(target.dims)
    assert layers == [(H, KV, D, None if i % 4 == 0 else W)
                      for i in range(52)]
    assert sum(w is None for *_, w in layers) == 13
    # a verify window of 9 tokens at 12000: every layer's projections,
    # router and six experts a token; a global layer's queries see
    # 12001 .. 12009 keys, a window layer's 4096 each; the head on 9
    matmul = 2 * 9 * (d * H * D + 2 * d * KV * D + H * D * d + d * E
                      + K * 3 * d * F)
    pairs_global = 9 * 12000 + 45
    want = (52 * matmul + 13 * 4 * H * D * pairs_global
            + 39 * 4 * H * D * 9 * W + 2 * 9 * d * V)
    assert target.arch.forward_flops(target.dims, 12000, 9, 9) == want
    assert cost.verify_needed(target, 12000, 8) == want
    # short of the window, window layers are global ones
    assert target.arch.forward_flops(target.dims, 10, 5, 0) == \
        52 * (2 * 5 * (d * H * D + 2 * d * KV * D + H * D * d + d * E
                       + K * 3 * d * F) + 4 * H * D * (5 * 10 + 15))


def test_b1_totals_by_hand(pair):
    target, draft = pair
    # one verify window (T = 9) of a row at 12000: a global layer reads
    # 12009 keys on 751 pages, a window layer 4104 keys from 7905, pages
    # 494 .. 750
    g_flops = 4 * H * D * (9 * 12000 + 45)
    g_bytes = 2 * 12009 * KV * D * 2 + 2 * 9 * H * D * 2 + 4 * 751 + 4
    w_flops = 4 * H * D * 9 * W
    w_bytes = 2 * 4104 * KV * D * 2 + 2 * 9 * H * D * 2 + 4 * (751 - 494) + 4
    assert pa.call_cost((H, KV, D, None), [(12000, 9)]) == (g_flops, g_bytes)
    assert pa.call_cost((H, KV, D, W), [(12000, 9)]) == (w_flops, w_bytes)
    calls = list(pa.round_calls(target, draft, [12000], 8))
    tgt = calls[-52:]
    assert sum(pa.call_cost(layer, rows)[1] for layer, rows in tgt) == \
        13 * g_bytes + 39 * w_bytes
    # the draft: 9 one-token steps in each of its 24 full layers first
    assert len(calls) == 9 * 24 + 52


def test_expert_costs(pair):
    target, _ = pair
    assert moe.routed_rows(target, 13) == 52 * 6 * 13
    fl, nb = moe.expert_cost(target, 100, 70)
    assert fl == 2 * 3 * d * F * 100
    assert nb == (3 * d * F * 70 + 2 * d * 100) * 2
    assert moe.prefill_hit(target, 3) == 52 * 18
    assert moe.prefill_hit(target, 1000) == 52 * 64


def _span(name, **args):
    return SimpleNamespace(name=name, args=args)


GROUPED = ("void cutlass::device_kernel<at::cuda::detail::enable_3x_kernel"
           "_for_sm9x<cutlass::gemm::kernel::GemmUniversal<cutlass::gemm::"
           "GroupProblemShape<cute::tuple<int, int, int> >, ...> > >")
PROFILE = {
    "busy_s": 0.5, "window_s": 0.75,
    "kernels": [(GROUPED, 0.04), ("at::cuda::detail::prepare_grouped_gemm"
                                   "_data(...)", 0.005),
                ("void paged_attention_kernel<1>", 0.25), ("other", 1.0)],
    "rounds": [{"pos": [9000, 12000], "lengths": [3, 8], "L": 8,
                "buckets": [], "prompts": []},
               {"pos": [9004, 12009], "lengths": [5, 2], "L": 5,
                "buckets": [], "prompts": []}]}
SPANS = [_span("compiled.verify", device_ms=20.0, moe_rows=4056,
               moe_hit=3000),
         _span("compiled.verify", device_ms=20.0, moe_rows=3000,
               moe_hit=3200),
         _span("engine.window_free", freed=3, held=516, rows=2),
         _span("engine.window_free", freed=0, held=514, rows=2),
         _span("engine.commit")]


def test_readers_on_a_fixed_profile(pair):
    target, _ = pair
    ctx = {"profile": PROFILE, "models": pair, "peaks": peaks,
           "spans": SPANS}
    least = 0.0
    for tokens in (4 + 9, 6 + 3):
        rows = 52 * 6 * tokens
        flops = 2 * 3 * d * F * rows
        nbytes = (3 * d * F * 3100 + 2 * d * rows) * 2
        least += max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)
    got = manifest.reader("moe_experts_roofline")(ctx)
    assert got == pytest.approx(100 * least / 0.045, rel=1e-12)
    assert 0 < got < 100
    assert manifest.reader("engine.window_pages")(ctx) == (258 + 257) / 2
    # a dense target's run: no grouped kernel, no moe_hit, no window span
    dense = {"profile": dict(PROFILE, kernels=[("other", 1.0)]),
             "models": pair, "peaks": peaks, "spans": [SPANS[-1]]}
    assert manifest.reader("moe_experts_roofline")(dense) is None
    assert manifest.reader("engine.window_pages")(dense) is None


def test_smoke_cell_is_correct_and_holds_its_window():
    from perfbench.lib import bench

    spec = smoke.spec()
    spec["config"] = json.loads(
        (smoke.DATA / "smallthinker_smoke_config.json").read_text())
    spec["per_layer"] = [{"name": "engine.window_pages", "unit": "x"}]
    out = bench.run_cell(spec, 2147483901, 600.0, True, "cpu",
                         time.perf_counter(), None, max_rounds=12)
    assert out["correct"], out["check"]
    assert out["check"]["pages_leaked"]["value"] == 0
    held = out["metrics"]["engine.window_pages"]["value"]
    # window 8, pages of 4, L_max 4: at most ceil((8 + 4 + 1) / 4) + 1
    assert 0 < held <= math.ceil((8 + 4 + 1) / 4) + 1


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    """One short run of ``st21b.longctx.k24``'s command prints the
    contract's last line, correct, on the card."""
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "st21b.longctx.k24",
         "--seed", "2718281828459", "--seconds", "5", "--trace", "0"],
        cwd=smoke.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert line["device"]["platform"] == "gpu"
