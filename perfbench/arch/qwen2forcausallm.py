"""Qwen2 (``Qwen2ForCausalLM``) as published: pre-norm blocks, RMSNorm,
grouped-query attention with a bias on q, k and v, rotary embeddings with
the half-split rotation, SwiGLU MLP, tied or untied LM head; every layer
attends to every earlier key.

A model section of a configuration file keeps the published
``config.json`` keys.  The bias on q, k and v is the architecture's, not a
config key: the file states it under ``assumed`` (``qkv_bias``), and
``head_dim`` is ``hidden_size / num_attention_heads`` where the section
gives none.

``Reference`` is the plain forward in float32 with TF32 off, or in the
control's fp8.  It reads the benchmark's raw weights (``lib/weights.py``:
a dict of plain names to tensors in the (in, out) layout) and runs whole
sequences from position 0, layer by layer over a list of sequences, so
that only one layer's weights are upcast at a time.  It imports nothing of
the program.  ``fp8=True`` is the control (``reference/plain.py``): every
matrix product in W8A8; attention's own products, norms and softmax stay
in float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from perfbench.costs.model import window_pairs
from perfbench.reference.plain import no_tf32, q8


@dataclasses.dataclass(frozen=True)
class Model:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    tied: bool = False
    qkv_bias: bool = True
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    name: str = ""


def model(hf: dict, name: str, assumed: dict) -> Model:
    """The dims of one model section (``hf``: its published keys)."""
    heads = int(hf["num_attention_heads"])
    return Model(layers=int(hf["num_hidden_layers"]),
                 d=int(hf["hidden_size"]), heads=heads,
                 kv_heads=int(hf["num_key_value_heads"]),
                 head_dim=int(hf.get("head_dim",
                                     int(hf["hidden_size"]) // heads)),
                 d_ff=int(hf["intermediate_size"]),
                 vocab=int(hf["vocab_size"]),
                 tied=bool(hf["tie_word_embeddings"]),
                 qkv_bias=bool(assumed["qkv_bias"]),
                 rope_theta=float(hf["rope_theta"]),
                 rms_eps=float(hf["rms_norm_eps"]), name=name)


def port_config(m: Model, dtype: str = "bfloat16"):
    """The port's ``ModelConfig`` for a model (the port's own class: the
    engine is built from it)."""
    from repro_torch.configs.base import ModelConfig

    if m.rms_eps != 1e-6:
        raise ValueError("the port's RMSNorm uses eps 1e-6")
    return ModelConfig(name=m.name, family="dense", num_layers=m.layers,
                       d_model=m.d, num_heads=m.heads,
                       num_kv_heads=m.kv_heads, head_dim=m.head_dim,
                       d_ff=m.d_ff, vocab_size=m.vocab, activation="swiglu",
                       qkv_bias=m.qkv_bias, rope_theta=m.rope_theta,
                       tie_embeddings=m.tied, param_dtype=dtype,
                       compute_dtype=dtype)


# -- weights ------------------------------------------------------------------

def leaf_shapes(m: Model) -> list[tuple[str, tuple[int, ...]]]:
    """Name and shape of every matrix, bias and embedding, in the (in, out)
    layout the port uses."""
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


def norm_shapes(m: Model) -> list[tuple[str, tuple[int, ...]]]:
    names = ["ln_f"]
    for i in range(m.layers):
        names += [f"layers.{i}.ln_attn", f"layers.{i}.ln_mlp"]
    return [(n, (m.d,)) for n in names]


def port_tree(m: Model, raw: dict) -> dict:
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


# -- the plain reference --------------------------------------------------------

class Reference:
    """``logits_at(seqs, positions)``: for each token sequence, the float32
    logits at the given positions, each scoring the token that follows."""

    def __init__(self, m, raw: dict, device, fp8: bool = False,
                 attn_block_bytes: int = 1 << 30):
        self.m = m
        self.raw = raw
        self.device = torch.device(device)
        self.fp8 = fp8
        self.attn_block_bytes = attn_block_bytes

    # -- helpers ------------------------------------------------------------

    def _w(self, name: str) -> torch.Tensor:
        w = self.raw[name].to(self.device, torch.float32)
        return q8(w, 0) if self.fp8 and w.dim() == 2 else w

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = q8(x, -1)
        return x @ w

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.m.rms_eps) * scale

    def _rope(self, x: torch.Tensor, cos, sin) -> torch.Tensor:
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _angles(self, S: int):
        D = self.m.head_dim
        inv = 1.0 / (self.m.rope_theta ** (
            torch.arange(0, D, 2, dtype=torch.float64, device=self.device) / D))
        ang = torch.arange(S, dtype=torch.float64, device=self.device)[:, None] * inv
        return (torch.cos(ang).to(torch.float32)[:, None, :],
                torch.sin(ang).to(torch.float32)[:, None, :])

    def _attention(self, q, k, v) -> torch.Tensor:
        """Causal attention: q (S, H, D), k / v (S, KV, D) -> (S, H * D),
        in query blocks that keep the scores near ``attn_block_bytes``."""
        S, H, D = q.shape
        group = H // k.shape[1]
        k = k.repeat_interleave(group, dim=1).transpose(0, 1)   # (H, S, D)
        v = v.repeat_interleave(group, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        rows = max(1, self.attn_block_bytes // (4 * H * S))
        out = torch.empty((H, S, D), dtype=torch.float32, device=q.device)
        for a in range(0, S, rows):
            b = min(S, a + rows)
            s = (q[:, a:b] @ k[:, :b].transpose(1, 2)) / math.sqrt(D)
            i = torch.arange(a, b, device=q.device)[:, None]
            j = torch.arange(b, device=q.device)[None, :]
            s = s.masked_fill(j > i, float("-inf"))
            out[:, a:b] = torch.softmax(s, dim=-1) @ v[:, :b]
        return out.transpose(0, 1).reshape(S, H * D)

    def _layer(self, i: int) -> dict:
        p = f"layers.{i}."
        names = ["ln_attn", "wq", "wk", "wv", "wo", "ln_mlp", "w_gate",
                 "w_up", "w_down"]
        if self.m.qkv_bias:
            names += ["bq", "bk", "bv"]
        return {n: self._w(p + n) for n in names}

    def _block(self, w: dict, x: torch.Tensor, cos, sin) -> torch.Tensor:
        m = self.m
        S = x.shape[0]
        h = self._norm(x, w["ln_attn"])
        q = self._mm(h, w["wq"])
        k = self._mm(h, w["wk"])
        v = self._mm(h, w["wv"])
        if m.qkv_bias:
            q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
        q = self._rope(q.view(S, m.heads, m.head_dim), cos[:S], sin[:S])
        k = self._rope(k.view(S, m.kv_heads, m.head_dim), cos[:S], sin[:S])
        v = v.view(S, m.kv_heads, m.head_dim)
        x = x + self._mm(self._attention(q, k, v), w["wo"])
        h = self._norm(x, w["ln_mlp"])
        gate = torch.nn.functional.silu(self._mm(h, w["w_gate"]))
        return x + self._mm(gate * self._mm(h, w["w_up"]), w["w_down"])

    # -- entry point ----------------------------------------------------------

    @torch.no_grad()
    def logits_at(self, seqs, positions) -> list[torch.Tensor]:
        """``seqs``: token id lists; ``positions``: for each, the positions
        whose logits are wanted.  Returns one (n, V) float32 tensor each."""
        with no_tf32():
            embed = self.raw["embed"]
            xs = [embed[torch.as_tensor(s, device=embed.device).long()]
                  .to(self.device, torch.float32) for s in seqs]
            cos, sin = self._angles(max(len(s) for s in seqs))
            for i in range(self.m.layers):
                w = self._layer(i)
                xs = [self._block(w, x, cos, sin) for x in xs]
                del w
            ln_f = self._w("ln_f")
            if self.m.tied:
                # the head is the embedding, one output row per token id
                e = self.raw["embed"].to(self.device, torch.float32)
                head = (q8(e, 1) if self.fp8 else e).T
            else:
                head = self._w("unembed")
            out = []
            for x, pos in zip(xs, positions):
                idx = torch.as_tensor(pos, device=self.device).long()
                out.append(self._mm(self._norm(x[idx], ln_f), head))
            return out


# -- operations (conventions in ``costs/model.py``) ---------------------------

def attention_layers(m: Model) -> list[tuple[int, int, int, None]]:
    """``(heads, kv_heads, head_dim, window)`` of each layer: full
    attention everywhere."""
    return [(m.heads, m.kv_heads, m.head_dim, None)] * m.layers


def layer_matmul_flops(m: Model, tokens: int) -> float:
    """Projections and the SwiGLU MLP of one layer over ``tokens``."""
    q = m.heads * m.head_dim
    kv = m.kv_heads * m.head_dim
    per_token = m.d * q + 2 * m.d * kv + q * m.d + 3 * m.d * m.d_ff
    return 2.0 * tokens * per_token


def attention_flops(m: Model, pairs: int) -> float:
    """Q K^T and P V of one layer over ``pairs`` (query, key) pairs."""
    return 4.0 * m.heads * m.head_dim * pairs


def lm_head_flops(m: Model, tokens: int) -> float:
    return 2.0 * tokens * m.d * m.vocab


def forward_flops(m: Model, pos: int, T: int, lm_tokens: int) -> float:
    """One row's window of T tokens at ``pos`` through every layer, and the
    LM head on ``lm_tokens`` of them."""
    per_layer = layer_matmul_flops(m, T) + attention_flops(
        m, window_pairs(pos, T))
    return m.layers * per_layer + lm_head_flops(m, lm_tokens)
