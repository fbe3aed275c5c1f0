"""Carry JAX-package parameters across into the port.

``params_from_jax(cfg, tree)`` turns a ``repro`` ``DecoderLM.init`` pytree,
given as numpy arrays (``embed``, ``ln_f``, ``unembed`` and ``blocks``
stacked on a leading layer axis), into the port's parameters: the same
names, one dict per layer in a list.  Projections keep their (in, out)
layout: the port computes ``x @ W`` exactly as the JAX package does, so no
weight is transposed.  This module imports neither jax nor ``repro``.
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


def _convert(tree, device, layer=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, layer) for k, v in tree.items()}
    return _tensor(tree if layer is None else np.asarray(tree)[layer], device)


def params_from_jax(cfg: ModelConfig, tree, device="cuda"):
    """A dense ``DecoderLM.init`` pytree (numpy leaves) -> port parameters."""
    if cfg.num_experts or "dense_blocks" in tree:
        raise NotImplementedError("MoE stacks are not ported yet (ROADMAP A12)")
    params = {k: _convert(v, device) for k, v in tree.items() if k != "blocks"}
    params["blocks"] = [_convert(tree["blocks"], device, layer=i)
                        for i in range(cfg.num_layers)]
    return params
