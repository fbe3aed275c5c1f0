"""Weights from the seed, made on the device in the type they are served in.

One model's weights are two buffers: every matrix, bias and the embedding
from one ``normal_(0, 0.02)`` over a flat bf16 buffer (Qwen2's
``initializer_range``), and the norm scales from one more, as
1 + 0.1 N(0, 1) (so a norm that ignored its scale would show).  The leaves
are views of those buffers.  ``raw`` maps plain names to the tensors; the
port's parameter tree (``port_tree``) holds the very same tensors, and the
reference reads ``raw``: nothing is copied, and nothing the port derives
reaches the reference.
"""

from __future__ import annotations

import torch

from .seeds import derive


def leaf_shapes(m) -> list[tuple[str, tuple[int, ...]]]:
    """Name and shape of every matrix, bias and embedding, in the (in, out)
    layout the port uses; one model, ``m`` a ``costs.dense.Dims`` plus
    ``tied`` and ``qkv_bias``."""
    q, kv = m.heads * m.head_dim, m.kv_heads * m.head_dim
    out = [("embed", (m.vocab, m.d))]
    if not m.tied:
        out.append(("unembed", (m.d, m.vocab)))
    for i in range(m.layers):
        p = f"layers.{i}."
        out += [(p + "wq", (m.d, q)), (p + "wk", (m.d, kv)),
                (p + "wv", (m.d, kv)), (p + "wo", (q, m.d))]
        if m.qkv_bias:
            out += [(p + "bq", (q,)), (p + "bk", (kv,)), (p + "bv", (kv,))]
        out += [(p + "w_gate", (m.d, m.d_ff)), (p + "w_up", (m.d, m.d_ff)),
                (p + "w_down", (m.d_ff, m.d))]
    return out


def norm_names(m) -> list[str]:
    names = ["ln_f"]
    for i in range(m.layers):
        names += [f"layers.{i}.ln_attn", f"layers.{i}.ln_mlp"]
    return names


def _views(flat: torch.Tensor, shapes) -> dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, shape in shapes:
        n = 1
        for s in shape:
            n *= s
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def make(m, seed: int, role: str, device, dtype=torch.bfloat16) -> dict:
    """The ``raw`` weights of one model (``role`` names its stream)."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights",
                                                           role))
    shapes = leaf_shapes(m)
    total = sum(int(torch.Size(s).numel()) for _, s in shapes)
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(0.0, 0.02, generator=gen)
    raw = _views(flat, shapes)
    names = norm_names(m)
    norms = torch.empty(len(names) * m.d, dtype=dtype, device=device)
    norms.normal_(1.0, 0.1, generator=gen)
    raw.update(_views(norms, [(n, (m.d,)) for n in names]))
    return raw


def port_tree(m, raw: dict) -> dict:
    """The port's ``DecoderLM`` parameter tree over the same tensors."""
    tree = {"embed": raw["embed"], "ln_f": {"scale": raw["ln_f"]}}
    if not m.tied:
        tree["unembed"] = raw["unembed"]
    blocks = []
    for i in range(m.layers):
        p = f"layers.{i}."
        attn = {k: raw[p + k] for k in ("wq", "wk", "wv", "wo")}
        if m.qkv_bias:
            attn.update({k: raw[p + k] for k in ("bq", "bk", "bv")})
        blocks.append({
            "ln_attn": {"scale": raw[p + "ln_attn"]},
            "attn": attn,
            "ln_mlp": {"scale": raw[p + "ln_mlp"]},
            "mlp": {k: raw[p + k] for k in ("w_gate", "w_up", "w_down")},
        })
    tree["blocks"] = blocks
    return tree
