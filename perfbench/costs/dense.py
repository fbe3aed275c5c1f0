"""Operations of the dense Qwen2 models, counted from their shapes.

Counts are multiply-adds x 2 of the matrix products
(projections, the MLP, the LM head) and of attention's two products (Q K^T
and P V); norms, RoPE, softmax, bias adds and the embedding lookup are
left out (they are not tensor-core work and are < 1% of the total).

``*_needed`` count the work the round's inputs need: a row's own draft
length, not the padded window, and no frozen rows.  ``prefill_needed``
counts the prompt's own tokens through the layers and no LM head: the
engine throws the prefill's logits away.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Dims:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int


def layer_matmul_flops(m: Dims, tokens: int) -> float:
    """Projections and the SwiGLU MLP of one layer over ``tokens``."""
    q = m.heads * m.head_dim
    kv = m.kv_heads * m.head_dim
    per_token = m.d * q + 2 * m.d * kv + q * m.d + 3 * m.d * m.d_ff
    return 2.0 * tokens * per_token


def window_pairs(pos: int, T: int) -> int:
    """(query, key) pairs of a causal window of T tokens written at
    ``pos``: query t sees keys 0 .. pos + t."""
    return T * pos + T * (T + 1) // 2


def attention_flops(m: Dims, pairs: int) -> float:
    """Q K^T and P V of one layer over ``pairs`` (query, key) pairs."""
    return 4.0 * m.heads * m.head_dim * pairs


def lm_head_flops(m: Dims, tokens: int) -> float:
    return 2.0 * tokens * m.d * m.vocab


def forward_flops(m: Dims, pos: int, T: int, lm_tokens: int) -> float:
    """One row's window of T tokens at ``pos`` through every layer, and the
    LM head on ``lm_tokens`` of them."""
    per_layer = layer_matmul_flops(m, T) + attention_flops(
        m, window_pairs(pos, T))
    return m.layers * per_layer + lm_head_flops(m, lm_tokens)


def prefill_needed(m: Dims, prompt_len: int) -> float:
    """Admission: the prompt less its last token (the pending one) through
    the layers."""
    return forward_flops(m, 0, prompt_len - 1, 0)


def draft_needed(m: Dims, pos: int, L_k: int) -> float:
    """A row's drafting of L_k tokens: L_k steps that each score the next
    token, and the step that writes d_L into the cache (its logits
    unused)."""
    steps = sum(forward_flops(m, pos + t, 1, 1) for t in range(L_k))
    return steps + forward_flops(m, pos + L_k, 1, 0)


def verify_needed(m: Dims, pos: int, L_k: int) -> float:
    """A row's verification window [pending, d_1 .. d_Lk]: L_k + 1 tokens,
    all of whose logits the accept test and the bonus token read."""
    return forward_flops(m, pos, L_k + 1, L_k + 1)
