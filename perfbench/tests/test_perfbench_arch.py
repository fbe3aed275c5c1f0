"""An architecture plugs in as one file: a test-only module with a
windowed layer (``data/arch/tinywindowforcausallm.py``), found by its
``architectures`` name once the lookup points at ``data/arch``.  B1's
costs clip that layer's keys to its window, and the generic FLOP sums are
its ``forward_flops`` composed by hand; a name with no module is an error
that names the modules present."""

import pytest
import torch

import smoke
from perfbench.costs import model as cost
from perfbench.costs import paged_attention as pa
from perfbench.lib import config, manifest, peaks, weights

SECTION = {"architectures": ["TinyWindowForCausalLM"], "hidden_size": 64,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 16, "intermediate_size": 128, "vocab_size": 512,
           "sliding_window": 8}
CFG = {**SECTION, "target_name": "tiny-target", "assumed": {},
       "draft": {**SECTION, "name": "tiny-draft", "head_dim": 8}}
PROFILE = {
    "busy_s": 0.5, "window_s": 0.75,
    "kernels": [("void paged_attention_kernel<1>", 2e-6)],
    "rounds": [{"pos": [100, 3], "lengths": [3, 1], "L": 3,
                "buckets": [16], "prompts": [12]}]}


@pytest.fixture
def pair(monkeypatch):
    monkeypatch.setattr(config, "ARCH", smoke.DATA / "arch")
    return config.models(CFG)


def test_windowed_layer_clips_b1_keys(pair):
    target, draft = pair
    full, windowed, _ = target.arch.attention_layers(target.dims)
    assert windowed == (4, 2, 16, 8) and full[3] is None
    # a window of 4 at 100: queries see keys 93-100 .. 96-103, 11 in all,
    # on pages 5 and 6
    flops, nbytes = pa.call_cost(windowed, [(100, 4)])
    assert flops == 4 * 4 * 16 * (4 * 8)
    assert nbytes == 2 * 11 * 2 * 16 * 2 + 2 * 4 * 4 * 16 * 2 + 4 * 2 + 4
    # short of the window, the same as full attention
    assert pa.call_cost(windowed, [(2, 3)]) == pa.call_cost(full, [(2, 3)])
    calls = list(pa.round_calls(target, draft, [100], 3))
    assert [layer[3] for layer, _ in calls] == [None, 8, None] * 5
    least = 0.0                  # in the reader's order, uncompensated
    for layer, rows in (list(pa.round_calls(target, draft, [100, 3], 3))
                        + list(pa.prefill_calls(target, draft, 16))):
        least += peaks.least_seconds(*pa.call_cost(layer, rows))
    ctx = {"profile": PROFILE, "models": pair, "peaks": peaks}
    assert manifest.reader("paged_attention_roofline")(ctx) == \
        100.0 * least / 2e-6


def test_generic_flop_sums_are_forward_flops_composed(pair):
    target, draft = pair
    fwd_t = lambda pos, T, lm: target.arch.forward_flops(  # noqa: E731
        target.dims, pos, T, lm)
    fwd_d = lambda pos, T, lm: draft.arch.forward_flops(  # noqa: E731
        draft.dims, pos, T, lm)
    want = 0.0
    for pos, L in ((100, 3), (3, 1)):
        want += (sum(fwd_d(pos + t, 1, 1) for t in range(L))
                 + fwd_d(pos + L, 1, 0))
        want += fwd_t(pos, L + 1, L + 1)
    want += fwd_t(0, 11, 0) + fwd_d(0, 11, 0)
    ctx = {"profile": PROFILE, "models": pair, "peaks": peaks}
    assert manifest.reader("models.mfu")(ctx) == \
        100.0 * want / (0.75 * peaks.BF16_FLOPS)
    # verifying 3 drafts at 100: 4 tokens through three layers, whose
    # queries see 410 keys in the full layers and 4 x 8 in the windowed one
    matmul = 2 * 4 * (2 * 64 * 64 + 2 * 64 * 32 + 3 * 64 * 128)
    assert cost.verify_needed(target, 100, 3) == (
        3 * matmul + 4 * 4 * 16 * (410 + 32 + 410) + 2 * 4 * 64 * 512)
    raw = weights.make(target, 0, "target", "cpu", dtype=torch.float32)
    assert raw["layers.2.w_down"].shape == (128, 64)


def test_missing_module_names_the_key_and_the_modules(pair):
    with pytest.raises(LookupError, match="NoSuchForCausalLM.*"
                       "tinywindowforcausallm.py"):
        config.arch({"architectures": ["NoSuchForCausalLM"]})
