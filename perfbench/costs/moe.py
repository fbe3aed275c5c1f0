"""Operations and bytes of the routed experts of a mixture-of-experts
target (the port's dropless expert layer: three grouped products over the
rows sorted by expert), counted from what the round needs.

A routed row is one (token, expert) pair: each token the round needs
(``L_k + 1`` a verify window, a prompt's tokens at admission) goes to
``top_k`` experts in each layer.  Its operations are the three products
of one expert, 2 x 3 x d x F.  The bytes are each expert's three (d, F)
bf16 matrices once for every (layer, expert) the rows hit, and each routed
row's input and output of width d, once each; the hidden units between
the products and the router are left out (the least the products must
move).  Each takes a ``Model`` of ``lib/config.py`` whose dims carry
``layers``, ``d``, ``experts``, ``top_k`` and ``expert_ff``.
"""

from __future__ import annotations


def routed_rows(model, tokens: int) -> int:
    """Routed rows of ``tokens`` tokens through every layer."""
    _, m = model
    return m.layers * m.top_k * int(tokens)


def expert_cost(model, rows: int, hit: int,
                elem_bytes: int = 2) -> tuple[float, float]:
    """``(flops, bytes)`` of the expert products over ``rows`` routed rows
    that hit ``hit`` (layer, expert) pairs."""
    _, m = model
    flops = 2.0 * 3 * m.d * m.expert_ff * rows
    nbytes = (3.0 * m.d * m.expert_ff * hit + 2.0 * m.d * rows) * elem_bytes
    return flops, nbytes


def prefill_hit(model, tokens: int) -> int:
    """(layer, expert) pairs a prompt of ``tokens`` tokens hits at most."""
    _, m = model
    return m.layers * min(m.experts, m.top_k * int(tokens))
