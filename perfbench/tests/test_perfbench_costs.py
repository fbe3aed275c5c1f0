"""The operation and byte counts against hand counts at test width
(d 64, 4 heads of 16, 2 kv heads, d_ff 128, vocab 512, 2 layers)."""

from perfbench.costs import dense
from perfbench.costs import paged_attention as pa

M = dense.Dims(layers=2, d=64, heads=4, kv_heads=2, head_dim=16, d_ff=128,
               vocab=512)
D = dense.Dims(layers=1, d=32, heads=2, kv_heads=1, head_dim=16, d_ff=64,
               vocab=512)


def test_layer_and_head():
    # q 64x64, k and v 64x32 each, o 64x64, gate/up/down 3 x 64x128
    assert dense.layer_matmul_flops(M, 1) == 2 * (4096 + 4096 + 4096 + 24576)
    assert dense.lm_head_flops(M, 3) == 2 * 3 * 64 * 512


def test_window_pairs_and_attention():
    # queries at 10, 11, 12 see 11, 12 and 13 keys
    assert dense.window_pairs(10, 3) == 36
    assert dense.attention_flops(M, 36) == 4 * 4 * 16 * 36


def test_round_work():
    one = dense.layer_matmul_flops(M, 1)
    assert dense.verify_needed(M, 10, 2) == (
        2 * (3 * one + dense.attention_flops(M, 36)) + 2 * 3 * 64 * 512)
    assert dense.prefill_needed(M, 5) == 2 * (
        4 * one + dense.attention_flops(M, 10))
    step = lambda pos, lm: (dense.layer_matmul_flops(D, 1)  # noqa: E731
                            + dense.attention_flops(D, pos + 1)
                            + lm * 2 * 32 * 512)
    assert dense.draft_needed(D, 7, 2) == step(7, 1) + step(8, 1) + step(9, 0)


def test_paged_attention_call():
    flops, nbytes = pa.call_cost(M, [(10, 3)])
    assert flops == 4 * 4 * 16 * 36
    # K and V of 13 keys, q and out of 3 rows, one page entry and a length
    assert nbytes == 2 * 13 * 2 * 16 * 2 + 2 * 3 * 4 * 16 * 2 + 4 + 4
    calls = list(pa.round_calls(M, D, [10, 20], 3))
    assert len(calls) == 4 * D.layers + M.layers
    assert calls[0] == (D, [(10, 1), (20, 1)])
    assert calls[-1] == (M, [(10, 4), (20, 4)])
    assert len(list(pa.prefill_calls(M, D, 64))) == M.layers + D.layers
