"""Carry JAX-package parameters across into the port.

``params_from_jax(cfg, tree)`` turns a ``repro`` model's ``init`` pytree,
given as numpy arrays, into the port's parameters: the same names, with
every stacked layer axis unrolled into python lists of per-layer dicts —
``blocks`` (dense, MoE and VLM ``DecoderLM`` and ``MambaLM``: one leading
layer axis), ``dense_blocks`` (the leading dense blocks of a MoE stack),
``enc_blocks`` / ``dec_blocks`` (``EncDecLM``) and ``mamba``
(``HybridLM``: leading (groups, group_size) axes); the other entries
(``embed``, ``ln_f``, ``unembed`` when embeddings are not tied, the
encoder-decoder's position tables and ``ln_enc``, the hybrid's ``shared``
block) carry over as they are.  A MoE block's nested ``moe`` dict (router,
stacked expert weights, ``shared`` / ``dense`` MLPs) is indexed by layer
leaf by leaf.  Projections keep their (in, out) layout: the port computes
``x @ W`` exactly as the JAX package does, so no weight is transposed.
``params_to_jax(cfg, params)`` is the inverse: the port's tree (parameters,
or the optimizer's ``m`` / ``v`` of the same structure) re-stacked into the
reference's layout, so that a training state the port checkpoints restores
in the reference and the other way round.
This module imports neither jax nor ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16 has no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)      # a writable copy


def _convert(tree, device, index=()):
    if isinstance(tree, dict):
        return {k: _convert(v, device, index) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):       # a reference-layout torch tree
        return (tree[index] if index else tree).to(device, copy=True)
    a = np.asarray(tree)
    return _tensor(a[index] if index else a, device)


# entries whose leaves carry a leading layer axis
LAYER_STACKS = ("blocks", "dense_blocks", "enc_blocks", "dec_blocks")


def _n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(tree.shape[0])


def params_from_jax(cfg: ModelConfig, tree, device="cuda"):
    """A ``DecoderLM`` (dense, MoE, VLM), ``MambaLM``, ``HybridLM`` or
    ``EncDecLM`` init pytree (numpy leaves, or torch tensors in the same
    layout) -> port parameters."""
    params = {k: _convert(v, device) for k, v in tree.items()
              if k not in LAYER_STACKS + ("mamba",)}
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.hybrid_group
        params["mamba"] = [[_convert(tree["mamba"], device, (g, i))
                            for i in range(cfg.hybrid_group)]
                           for g in range(groups)]
    for stack in LAYER_STACKS:
        if stack in tree:
            params[stack] = [_convert(tree[stack], device, (i,))
                             for i in range(_n_layers(tree[stack]))]
    return params


def _stack(layers: list):
    """Per-layer dicts (or nested lists of them) -> one dict whose leaves
    carry the list's axes in front."""
    if isinstance(layers[0], list):
        layers = [_stack(group) for group in layers]
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return torch.stack([t.detach().cpu() for t in layers])


def params_to_jax(cfg: ModelConfig, params):
    """Port parameters (or an optimizer moment of the same structure) -> the
    reference's layout as CPU torch tensors: ``blocks``, ``dense_blocks``,
    ``enc_blocks`` and ``dec_blocks`` stacked on a leading layer axis, the
    hybrid's ``mamba`` on (groups, group_size); every other entry copied.
    Every leaf is a fresh host tensor."""
    out = {}
    for k, v in params.items():
        if k in LAYER_STACKS or (k == "mamba" and cfg.family == "hybrid"):
            out[k] = _stack(v)
        else:
            out[k] = _convert(v, "cpu")
    return out
