"""Operations a round's inputs need, composed from each architecture's
``forward_flops`` (``perfbench/arch/<name>.py``).

An architecture counts multiply-adds x 2 of its matrix products
(projections, the MLP or experts, the LM head) and of attention's two
products (Q K^T and P V); norms, RoPE, softmax, bias adds and the
embedding lookup are left out (they are not tensor-core work and are < 1%
of the total).

``*_needed`` count the work the round's inputs need: a row's own draft
length, not the padded window, and no frozen rows.  ``prefill_needed``
counts the prompt's own tokens through the layers and no LM head: the
engine throws the prefill's logits away.  Each takes a ``Model`` of
``lib/config.py``: an architecture's module and its dims.
"""

from __future__ import annotations


def window_pairs(pos: int, T: int, window: int | None = None) -> int:
    """(query, key) pairs of a causal window of T tokens written at
    ``pos``: query t sees keys 0 .. pos + t, or the last ``window`` of
    them."""
    if window is None:
        return T * pos + T * (T + 1) // 2
    a, b = pos + 1, pos + T              # keys of the first and last query
    inside = max(0, min(b, window) - a + 1)
    return (a + a + inside - 1) * inside // 2 + (T - inside) * window


def prefill_needed(model, prompt_len: int) -> float:
    """Admission: the prompt less its last token (the pending one) through
    the layers."""
    arch, m = model
    return arch.forward_flops(m, 0, prompt_len - 1, 0)


def draft_needed(model, pos: int, L_k: int) -> float:
    """A row's drafting of L_k tokens: L_k steps that each score the next
    token, and the step that writes d_L into the cache (its logits
    unused)."""
    arch, m = model
    steps = sum(arch.forward_flops(m, pos + t, 1, 1) for t in range(L_k))
    return steps + arch.forward_flops(m, pos + L_k, 1, 0)


def verify_needed(model, pos: int, L_k: int) -> float:
    """A row's verification window [pending, d_1 .. d_Lk]: L_k + 1 tokens,
    all of whose logits the accept test and the bonus token read."""
    arch, m = model
    return arch.forward_flops(m, pos, L_k + 1, L_k + 1)
