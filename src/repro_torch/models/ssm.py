"""Mamba-2 (SSD) attention-free language model on torch tensors.

The port of ``repro.models.ssm``.  Block layout follows the Mamba-2 paper:
in_proj -> (z | xBC | dt), short causal depthwise conv over xBC, SSD scan,
gated RMSNorm, out_proj.  Full-sequence forwards (``apply``, ``prefill``)
run the chunked SSD scan through ``ops.ssd_scan`` (the CUDA kernel on the
card, its plain version on the CPU); decode runs the O(1) recurrence
``ops.ssd_decode`` with the (ssm state, conv state) carried in the cache.

Caches are functional, as in the JAX package: a forward returns new state
tensors and leaves the ones it was given untouched, so a snapshot of the
state after a step costs no copy of its own.  Parameters keep the JAX
package's names and layouts; the blocks are a python list of per-layer
dicts (``bridge.params_from_jax`` converts the stacked JAX pytree).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.kernels import ops as kops

from .layers import (
    dense_init,
    embed_init,
    embed_lookup,
    init_rmsnorm,
    remat,
    rmsnorm,
)
from .transformer import _dtype

Params = Any


def ssm_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    g = cfg.ssm_ngroups
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * g * n
    return d_inner, nheads, g, n, conv_dim


def init_mamba2_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """One block's random weights with the JAX package's distributions,
    drawn from ``gen`` on its device."""
    dtype = _dtype(cfg.param_dtype)
    dev = gen.device
    d_inner, nheads, g, n, conv_dim = ssm_dims(cfg)
    d_in_proj = 2 * d_inner + 2 * g * n + nheads
    W = cfg.ssm_conv_width
    conv_w = torch.randn((W, conv_dim), generator=gen, device=dev) / math.sqrt(W)
    return {
        "ln": init_rmsnorm(cfg.d_model, dtype, dev),
        "in_proj": dense_init(gen, cfg.d_model, d_in_proj, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads,
                                          device=dev)).to(dtype),
        "D": torch.ones((nheads,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((nheads,), dtype=dtype, device=dev),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, d_inner, cfg.d_model, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal 1-D conv.  x: (B, S, C); w: (W, C).

    Returns (y (B, S, C), new_state (B, W-1, C)) where the state carries the
    last W-1 inputs for streaming decode.
    """
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xw = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xw[:, i:i + x.shape[1]] * w[i] for i in range(W))
    new_state = xw[:, -(W - 1):] if W > 1 else state
    return y + b, new_state


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    y = y * F.silu(z.float()).to(y.dtype)
    var = y.float().square().mean(dim=-1, keepdim=True)
    return (y.float() * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def mamba2_block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                       ssm_state: torch.Tensor | None = None,
                       conv_state: torch.Tensor | None = None,
                       decode: bool = False):
    """x: (B, S, d_model).  Returns (out, new_ssm_state, new_conv_state)."""
    d_inner, nheads, g, n, conv_dim = ssm_dims(cfg)
    B_, S, _ = x.shape
    h = rmsnorm(p["ln"], x)
    # whole over model before the split into z, xBC, dt (a no-op without
    # an active mesh): the split points need not fall on shard edges
    zxbcdt = logical_constraint(h @ p["in_proj"], "batch")
    z, xBC, dt = torch.split(zxbcdt, [d_inner, conv_dim, nheads], dim=-1)
    xBC, new_conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                       conv_state)
    xBC = F.silu(xBC)
    xs, Bs, Cs = torch.split(xBC, [d_inner, g * n, g * n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(B_, S, nheads, cfg.ssm_head_dim)
    Bh = Bs.reshape(B_, S, g, n)
    Ch = Cs.reshape(B_, S, g, n)

    if decode:
        if S != 1:
            raise ValueError(f"decode takes one token, got {S}")
        state = ssm_state if ssm_state is not None else torch.zeros(
            (B_, nheads, cfg.ssm_head_dim, n), dtype=torch.float32,
            device=x.device)
        y, new_state = kops.ssd_decode(xh[:, 0], dt[:, 0], A, Bh[:, 0],
                                       Ch[:, 0], state)
        y = y[:, None]
    else:
        y, new_state = kops.ssd_scan(xh, dt, A, Bh, Ch, chunk=cfg.ssm_chunk,
                                     initial_state=ssm_state)
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    # whole heads over model before merging (h, p): a state sharded on its
    # head dim p (the cache rule's fallback) cannot merge
    y = logical_constraint(y, "batch").reshape(B_, S, d_inner)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    return (x + logical_constraint(y @ p["out_proj"], "batch"), new_state,
            new_conv_state)


def keep_snapshot(snaps: dict | None, cache: dict, keys, t: int, T: int):
    """Copy ``cache[key]`` for ``keys`` into step ``t`` of the (T, ...)
    snapshot buffers ``snaps`` (allocated at the first step), and point the
    cache at that copy, so each step's state lives once.  Returns
    ``snaps``."""
    if snaps is None:
        snaps = {k: cache[k].new_empty((T,) + tuple(cache[k].shape))
                 for k in keys}
    for k in keys:
        snaps[k][t].copy_(cache[k])
        cache[k] = snaps[k][t]
    return snaps


class MambaLM:
    """Attention-free Mamba-2 LM (mamba2-130m family).  ``device`` is where
    ``init`` draws the weights and ``init_cache`` allocates the state."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def init(self, gen: torch.Generator | int) -> Params:
        if isinstance(gen, int):
            gen = torch.Generator(device=self.device).manual_seed(gen)
        cfg = self.cfg
        dtype = _dtype(cfg.param_dtype)
        params = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
            "ln_f": init_rmsnorm(cfg.d_model, dtype, self.device),
            "blocks": [init_mamba2_block(gen, cfg)
                       for _ in range(cfg.num_layers)],
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                           dtype)
        return params

    def init_cache(self, batch: int, max_len: int = 0,
                   dtype=torch.bfloat16) -> Params:
        """SSM cache is O(1) in sequence length (max_len unused, kept for
        API parity with attention models)."""
        cfg = self.cfg
        d_inner, nheads, g, n, conv_dim = ssm_dims(cfg)
        L = cfg.num_layers
        return {
            "ssm": torch.zeros((L, batch, nheads, cfg.ssm_head_dim, n),
                               dtype=torch.float32, device=self.device),
            "conv": torch.zeros((L, batch, cfg.ssm_conv_width - 1, conv_dim),
                                dtype=dtype, device=self.device),
        }

    CACHE_BATCH_AXES = {"ssm": 1, "conv": 1}

    def concat_caches(self, caches: list) -> Params:
        return {key: torch.cat([c[key] for c in caches],
                               dim=self.CACHE_BATCH_AXES[key])
                for key in caches[0]}

    def _stack_forward(self, params, x, cache=None, decode=False):
        new_ssm, new_conv = [], []
        block = remat(mamba2_block_apply, self.cfg.remat)
        for i, p in enumerate(params["blocks"]):
            ssm_s = cache["ssm"][i] if cache is not None else None
            conv_s = cache["conv"][i] if cache is not None else None
            x, s_new, c_new = block(p, x, self.cfg, ssm_s, conv_s, decode)
            new_ssm.append(s_new)
            new_conv.append(c_new)
        if cache is None:
            return x, None
        return x, {"ssm": torch.stack(new_ssm), "conv": torch.stack(new_conv)}

    def _embed(self, params, tokens):
        return logical_constraint(embed_lookup(params["embed"], tokens),
                                  "batch").to(_dtype(self.cfg.compute_dtype))

    def _logits(self, params, x):
        x = rmsnorm(params["ln_f"], x)
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return logical_constraint((x @ w.to(x.dtype)).float(),
                                  "batch", None, "vocab")

    def apply(self, params, tokens, prefix_embeds=None):
        x, _ = self._stack_forward(params, self._embed(params, tokens))
        return (self._logits(params, x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def prefill(self, params, tokens, cache, prefix_embeds=None):
        x, cache = self._stack_forward(params, self._embed(params, tokens),
                                       cache=cache)
        return (self._logits(params, x), cache,
                torch.zeros((), dtype=torch.float32, device=x.device))

    def forward_window(self, params, tokens, cache, pos,
                       return_snapshots=False):
        """SSM decode is strictly sequential: unroll T steps of the
        recurrence (T is the small draft window, not the context).

        With return_snapshots=True also returns the cache after EVERY step
        (leading axis T): speculative verification rolls the state back to
        the accepted position by selecting a snapshot per row.  Each step's
        state is kept once, in the (T, ...) snapshot buffers; the returned
        cache views the last step's.
        """
        T = tokens.shape[1]
        logits_steps, snaps = [], None
        for t in range(T):
            x = self._embed(params, tokens[:, t:t + 1])
            x, cache = self._stack_forward(params, x, cache=cache, decode=True)
            logits_steps.append(self._logits(params, x))
            if return_snapshots:
                snaps = keep_snapshot(snaps, cache, ("ssm", "conv"), t, T)
        logits = torch.cat(logits_steps, dim=1)
        if return_snapshots:
            return logits, cache, snaps
        return logits, cache

    def num_params(self, params) -> int:
        return _count(params)


def _count(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return sum(_count(v) for v in tree)
