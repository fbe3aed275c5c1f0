"""A test-only architecture, ``TinyWindowForCausalLM``: three dense
layers, the middle one attending to its last ``sliding_window`` keys.  It
has the contract's dims, weights and counts, and no ``port_config``,
``port_tree`` or ``Reference``: the port has no windowed layer, and the
test drives only the harness's sums."""

from __future__ import annotations

import dataclasses

from perfbench.costs.model import window_pairs


@dataclasses.dataclass(frozen=True)
class Model:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    window: int


def model(hf: dict, name: str, assumed: dict) -> Model:
    return Model(layers=3, d=int(hf["hidden_size"]),
                 heads=int(hf["num_attention_heads"]),
                 kv_heads=int(hf["num_key_value_heads"]),
                 head_dim=int(hf["head_dim"]),
                 d_ff=int(hf["intermediate_size"]),
                 vocab=int(hf["vocab_size"]),
                 window=int(hf["sliding_window"]))


def attention_layers(m: Model):
    full = (m.heads, m.kv_heads, m.head_dim, None)
    return [full, (m.heads, m.kv_heads, m.head_dim, m.window), full]


def forward_flops(m: Model, pos: int, T: int, lm_tokens: int) -> float:
    q, kv = m.heads * m.head_dim, m.kv_heads * m.head_dim
    matmul = 2.0 * T * (2 * m.d * q + 2 * m.d * kv + 3 * m.d * m.d_ff)
    total = 0.0
    for heads, _, head_dim, window in attention_layers(m):
        total += matmul + 4.0 * heads * head_dim * window_pairs(pos, T,
                                                                window)
    return total + 2.0 * lm_tokens * m.d * m.vocab


def leaf_shapes(m: Model):
    q, kv = m.heads * m.head_dim, m.kv_heads * m.head_dim
    out = [("embed", (m.vocab, m.d))]
    for i in range(m.layers):
        p = f"layers.{i}."
        out += [(p + "wq", (m.d, q)), (p + "wk", (m.d, kv)),
                (p + "wv", (m.d, kv)), (p + "wo", (q, m.d)),
                (p + "w_gate", (m.d, m.d_ff)), (p + "w_up", (m.d, m.d_ff)),
                (p + "w_down", (m.d_ff, m.d))]
    return out


def norm_shapes(m: Model):
    return [("ln_f", (m.d,))] + [(f"layers.{i}.{n}", (m.d,))
                                 for i in range(m.layers)
                                 for n in ("ln_attn", "ln_mlp")]
