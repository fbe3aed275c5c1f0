"""The round's commit step, on device (eager).

``commit_step`` is the port of ``repro.serving.compiled.commit_step``: it
updates only the committed rows of the stream-state tensors and packs the
round's one device->host transfer.  The port runs eagerly; the compiled
modes of the JAX package (``jit``, ``jit+donate``) and their counterparts
here (``torch.compile``, CUDA graphs) are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import torch

COMPILE_MODES = ("eager",)


def commit_step(pending: torch.Tensor, target_pos: torch.Tensor,
                draft_pos: torch.Tensor, rows: torch.Tensor,
                skip: torch.Tensor, output_tokens: torch.Tensor,
                accept_counts: torch.Tensor):
    """Row-subset commit, entirely on device.

    rows: (n,) int32 state-row index per ticket slot, ``-1`` = padding.
    skip: (n,) bool — padding / frozen / retired slots commit nothing.
    output_tokens: (n, L+1); accept_counts: (n,).

    Padding maps to row 0 with a zero delta (integer adds of zero are exact,
    so duplicated padding rows are harmless).  Returns new state tensors
    plus a packed ``(n, L+2)`` int32 emission — ``[advance, output_tokens...]``
    per slot — the ONE device->host fetch of a round.
    """
    safe = torch.where(rows < 0, torch.zeros_like(rows), rows).long()
    k = accept_counts.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int32, device=rows.device)
    adv = torch.where(skip, zero, (k + 1).to(torch.int32))
    new_tok = output_tokens.gather(1, k[:, None])[:, 0]
    old = pending.index_select(0, safe)
    delta = torch.where(skip, torch.zeros_like(old),
                        new_tok.to(pending.dtype) - old)
    pending = pending.index_add(0, safe, delta)
    target_pos = target_pos.index_add(0, safe, adv.to(target_pos.dtype))
    draft_pos = draft_pos.index_add(0, safe, adv.to(draft_pos.dtype))
    emission = torch.cat([adv[:, None], output_tokens.to(torch.int32)], dim=1)
    return pending, target_pos, draft_pos, emission
