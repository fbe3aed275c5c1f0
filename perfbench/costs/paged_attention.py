"""Operations and bytes of one ``paged_attention`` call (B1), counted from
what the call is given: per row its write offset ``pos`` and window length
T, and the model's heads.  Each input byte is counted once (the K and V of
every key a row sees, its queries, its page-table entries and length) and
each output byte once; the operations are the two products over the
(query, key) pairs the causal window lets a row see.

A call runs over every row of the batch; rows whose page table is all -1
(retired) read nothing, so a caller passes the live rows only.
"""

from __future__ import annotations

from .dense import Dims, window_pairs


def call_cost(m: Dims, rows, page_size: int = 16,
              elem_bytes: int = 2) -> tuple[float, float]:
    """``(flops, bytes)`` of one layer's call over ``rows`` = [(pos, T)]."""
    flops = 0.0
    nbytes = 0.0
    for pos, T in rows:
        keys = pos + T
        flops += 4.0 * m.heads * m.head_dim * window_pairs(pos, T)
        kv = 2 * keys * m.kv_heads * m.head_dim * elem_bytes
        qo = 2 * T * m.heads * m.head_dim * elem_bytes
        table = 4 * (-(-keys // page_size)) + 4
        nbytes += kv + qo + table
    return flops, nbytes


def round_calls(target: Dims, draft: Dims, pos, L: int):
    """Every B1 call of one J=1 round over live rows at offsets ``pos``
    with window L: the draft's L + 1 one-token steps in each of its layers,
    then the target's (L + 1)-token window in each of its layers.  Yields
    ``(dims, rows)`` per call."""
    for t in range(L + 1):
        rows = [(p + t, 1) for p in pos]
        for _ in range(draft.layers):
            yield draft, rows
    rows = [(p, L + 1) for p in pos]
    for _ in range(target.layers):
        yield target, rows


def prefill_calls(target: Dims, draft: Dims, bucket: int):
    """The B1 calls of one admission's prefill at the engine's bucket
    (``bucket - 1`` tokens from offset 0), target then draft."""
    rows = [(0, bucket - 1)]
    for m in (target, draft):
        for _ in range(m.layers):
            yield m, rows
