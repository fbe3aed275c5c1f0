"""Weights from the seed, made on the device in the type they are served in.

One model's weights are two buffers: every matrix, bias and embedding that
its architecture's ``leaf_shapes`` names, in that order, from one
``normal_(0, 0.02)`` over a flat bf16 buffer (the ``initializer_range`` of
the models served), and the norm scales its ``norm_shapes`` names from one
more, as 1 + 0.1 N(0, 1) (so a norm that ignored its scale would show).
The leaves are views of those buffers.  ``raw`` maps plain names to the
tensors; the architecture's ``port_tree`` holds the very same tensors for
the port, and its ``Reference`` reads ``raw``: nothing is copied, and
nothing the port derives reaches the reference.
"""

from __future__ import annotations

import torch

from .seeds import derive


def _views(flat: torch.Tensor, shapes) -> dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, shape in shapes:
        n = 1
        for s in shape:
            n *= s
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def _numel(shapes) -> int:
    return sum(int(torch.Size(s).numel()) for _, s in shapes)


def make(model, seed: int, role: str, device, dtype=torch.bfloat16) -> dict:
    """The ``raw`` weights of one model (a ``Model`` of ``lib/config.py``;
    ``role`` names its stream)."""
    arch, m = model
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights",
                                                           role))
    shapes = arch.leaf_shapes(m)
    flat = torch.empty(_numel(shapes), dtype=dtype, device=device)
    flat.normal_(0.0, 0.02, generator=gen)
    raw = _views(flat, shapes)
    shapes = arch.norm_shapes(m)
    norms = torch.empty(_numel(shapes), dtype=dtype, device=device)
    norms.normal_(1.0, 0.1, generator=gen)
    raw.update(_views(norms, shapes))
    return raw
