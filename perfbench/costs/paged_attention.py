"""Operations and bytes of one ``paged_attention`` call (B1), counted from
what the call is given: per row its write offset ``pos`` and window length
T, and the layer's heads and window.  Each input byte is counted once (the
K and V of every key a row sees, its queries, the page-table entries of
those keys and its length) and each output byte once; the operations are
the two products over the (query, key) pairs the causal window lets a row
see.  A windowed layer's query sees the last ``window`` keys at most.

A call runs over every row of the batch; rows whose page table is all -1
(retired) read nothing, so a caller passes the live rows only.
"""

from __future__ import annotations

from .model import window_pairs


def call_cost(layer, rows, page_size: int = 16,
              elem_bytes: int = 2) -> tuple[float, float]:
    """``(flops, bytes)`` of one layer's call over ``rows`` = [(pos, T)];
    ``layer`` is one ``(heads, kv_heads, head_dim, window)`` of an
    architecture's ``attention_layers``."""
    heads, kv_heads, head_dim, window = layer
    flops = 0.0
    nbytes = 0.0
    for pos, T in rows:
        end = pos + T                    # one past the last key
        first = 0 if window is None else max(0, pos + 1 - window)
        keys = end - first
        flops += 4.0 * heads * head_dim * window_pairs(pos, T, window)
        kv = 2 * keys * kv_heads * head_dim * elem_bytes
        qo = 2 * T * heads * head_dim * elem_bytes
        table = 4 * (-(-end // page_size) - first // page_size) + 4
        nbytes += kv + qo + table
    return flops, nbytes


def _layers(model):
    arch, m = model
    return arch.attention_layers(m)


def round_calls(target, draft, pos, L: int):
    """Every B1 call of one J=1 round over live rows at offsets ``pos``
    with window L: the draft's L + 1 one-token steps in each of its layers,
    then the target's (L + 1)-token window in each of its layers.  Yields
    ``(layer, rows)`` per call; ``target`` and ``draft`` are ``Model``s of
    ``lib/config.py``."""
    d_layers = _layers(draft)
    for t in range(L + 1):
        rows = [(p + t, 1) for p in pos]
        for layer in d_layers:
            yield layer, rows
    rows = [(p, L + 1) for p in pos]
    for layer in _layers(target):
        yield layer, rows


def prefill_calls(target, draft, bucket: int):
    """The B1 calls of one admission's prefill at the engine's bucket
    (``bucket - 1`` tokens from offset 0), target then draft."""
    rows = [(0, bucket - 1)]
    for model in (target, draft):
        for layer in _layers(model):
            yield layer, rows
