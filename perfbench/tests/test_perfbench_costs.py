"""The operation and byte counts against hand counts at test width
(d 64, 4 heads of 16, 2 kv heads, d_ff 128, vocab 512, 2 layers), through
the Qwen2 module (``perfbench/arch/qwen2forcausallm.py``) and the generic
compositions (``costs/model.py``, ``costs/paged_attention.py``)."""

from perfbench.costs import model as cost
from perfbench.costs import paged_attention as pa
from perfbench.lib.config import Model, arch

Q = arch({"architectures": ["Qwen2ForCausalLM"]})
M = Q.Model(layers=2, d=64, heads=4, kv_heads=2, head_dim=16, d_ff=128,
            vocab=512)
D = Q.Model(layers=1, d=32, heads=2, kv_heads=1, head_dim=16, d_ff=64,
            vocab=512)
TM, DM = Model(Q, M), Model(Q, D)


def test_layer_and_head():
    # q 64x64, k and v 64x32 each, o 64x64, gate/up/down 3 x 64x128
    assert Q.layer_matmul_flops(M, 1) == 2 * (4096 + 4096 + 4096 + 24576)
    assert Q.lm_head_flops(M, 3) == 2 * 3 * 64 * 512


def test_window_pairs_and_attention():
    # queries at 10, 11, 12 see 11, 12 and 13 keys
    assert cost.window_pairs(10, 3) == 36
    assert Q.attention_flops(M, 36) == 4 * 4 * 16 * 36
    # with a window of 12 keys: 11, 12 and 12
    assert cost.window_pairs(10, 3, 12) == 35
    assert cost.window_pairs(0, 5, 2) == 1 + 2 + 2 + 2 + 2
    assert cost.window_pairs(10, 3, 1000) == 36


def test_round_work():
    one = Q.layer_matmul_flops(M, 1)
    assert cost.verify_needed(TM, 10, 2) == (
        2 * (3 * one + Q.attention_flops(M, 36)) + 2 * 3 * 64 * 512)
    assert cost.prefill_needed(TM, 5) == 2 * (
        4 * one + Q.attention_flops(M, 10))
    step = lambda pos, lm: (Q.layer_matmul_flops(D, 1)  # noqa: E731
                            + Q.attention_flops(D, pos + 1)
                            + lm * 2 * 32 * 512)
    assert cost.draft_needed(DM, 7, 2) == step(7, 1) + step(8, 1) + step(9, 0)


def test_paged_attention_call():
    layer = Q.attention_layers(M)[0]
    assert layer == (4, 2, 16, None)
    flops, nbytes = pa.call_cost(layer, [(10, 3)])
    assert flops == 4 * 4 * 16 * 36
    # K and V of 13 keys, q and out of 3 rows, one page entry and a length
    assert nbytes == 2 * 13 * 2 * 16 * 2 + 2 * 3 * 4 * 16 * 2 + 4 + 4
    calls = list(pa.round_calls(TM, DM, [10, 20], 3))
    assert len(calls) == 4 * D.layers + M.layers
    assert calls[0] == ((2, 1, 16, None), [(10, 1), (20, 1)])
    assert calls[-1] == (layer, [(10, 4), (20, 4)])
    assert len(list(pa.prefill_calls(TM, DM, 64))) == M.layers + D.layers
