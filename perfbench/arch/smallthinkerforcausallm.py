"""SmallThinker (``SmallThinkerForCausalLM``) as published: pre-norm blocks,
RMSNorm, grouped-query attention with no bias, and in every layer a
mixture of experts whose router sits before attention; layers alternate
by ``sliding_window_layout`` and ``rope_layout``, [0, 1, 1, 1] repeated:
a global layer with no rotary embedding (NoPE) over every earlier key,
then three layers with RoPE over the last ``sliding_window_size`` keys.

Layer equations (``x`` the layer's input):

    h = RMSNorm_attn(x)
    a = x + Attn(h)              # window layers: RoPE, a query at p sees
                                 # keys max(0, p - window + 1) .. p;
                                 # global layers: no RoPE, every key <= p
    w, e = top6(softmax(h W_router))  renormalised over the six
    y = a + sum_i w_i W_down,e_i(relu(m W_gate,e_i) * m W_up,e_i),
        m = RMSNorm_mlp(a)

The router reads ``h``, the attention's normed input (the family's "router
placed before attention"); the experts are ReGLU ("sparse ReGLU"); the
config's ``moe_primary_router_apply_softmax`` and ``norm_topk_prob`` make
the weights a softmax over the six largest logits.  No shared experts, no
leading dense layers, an untied head.  What the config leaves unsaid (no
q, k, v bias; the tokenizer) the configuration file states under
``assumed``.

``Reference`` is the plain forward in float32 with TF32 off, or in the
control's fp8 (W8A8 of every matrix product, the router's and each
expert's included).  It reads the benchmark's raw weights
(``lib/weights.py``), runs whole sequences from position 0, layer by
layer, and computes the experts by a loop over the experts a layer's
tokens hit, one expert's weights upcast at a time.  It imports nothing of
the program.
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
    experts: int
    top_k: int
    expert_ff: int
    vocab: int
    window: int
    window_layers: tuple
    rope_layers: tuple
    tied: bool = False
    rope_theta: float = 1.5e6
    rms_eps: float = 1e-6
    name: str = ""

    def layer_window(self, i: int) -> int | None:
        return self.window if self.window_layers[i] else None


def model(hf: dict, name: str, assumed: dict) -> Model:
    """The dims of one model section (``hf``: its published keys)."""
    if not (hf["moe_primary_router_apply_softmax"] and hf["norm_topk_prob"]):
        raise ValueError("SmallThinker's router: softmax, top-k renormalised")
    if assumed.get("qkv_bias"):
        raise ValueError("SmallThinker's attention has no q, k, v bias")
    layers = int(hf["num_hidden_layers"])
    win = tuple(bool(v) for v in hf["sliding_window_layout"])
    rope = tuple(bool(v) for v in hf["rope_layout"])
    if len(win) != layers or len(rope) != layers:
        raise ValueError("a layout entry per layer")
    return Model(layers=layers, d=int(hf["hidden_size"]),
                 heads=int(hf["num_attention_heads"]),
                 kv_heads=int(hf["num_key_value_heads"]),
                 head_dim=int(hf["head_dim"]),
                 experts=int(hf["moe_num_primary_experts"]),
                 top_k=int(hf["moe_num_active_primary_experts"]),
                 expert_ff=int(hf["moe_ffn_hidden_size"]),
                 vocab=int(hf["vocab_size"]),
                 window=int(hf["sliding_window_size"]), window_layers=win,
                 rope_layers=rope, tied=bool(hf["tie_word_embeddings"]),
                 rope_theta=float(hf["rope_theta"]),
                 rms_eps=float(hf["rms_norm_eps"]), name=name)


def port_config(m: Model, dtype: str = "bfloat16"):
    """The port's ``LayerPatternConfig`` for a model (the port's own class:
    the engine is built from it)."""
    from repro_torch.models.layer_pattern import LayerPatternConfig

    if m.rms_eps != 1e-6:
        raise ValueError("the port's RMSNorm uses eps 1e-6")
    return LayerPatternConfig(
        name=m.name, family="moe", num_layers=m.layers, d_model=m.d,
        num_heads=m.heads, num_kv_heads=m.kv_heads, head_dim=m.head_dim,
        d_ff=m.expert_ff, vocab_size=m.vocab, activation="reglu",
        qkv_bias=False, rope_theta=m.rope_theta, tie_embeddings=m.tied,
        num_experts=m.experts, top_k=m.top_k, moe_d_ff=m.expert_ff,
        sliding_window=m.window, window_layers=m.window_layers,
        rope_layers=m.rope_layers, router_input="attn_norm",
        param_dtype=dtype, compute_dtype=dtype)


# -- weights ------------------------------------------------------------------

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def leaf_shapes(m: Model) -> list[tuple[str, tuple[int, ...]]]:
    """Name and shape of every matrix and embedding, in the (in, out)
    layout the port uses; each layer's experts stacked (E, in, out)."""
    q, kv = m.heads * m.head_dim, m.kv_heads * m.head_dim
    E, F = m.experts, m.expert_ff
    out = [("embed", (m.vocab, m.d))]
    if not m.tied:
        out.append(("unembed", (m.d, m.vocab)))
    for i in range(m.layers):
        p = f"layers.{i}."
        out += [(p + "wq", (m.d, q)), (p + "wk", (m.d, kv)),
                (p + "wv", (m.d, kv)), (p + "wo", (q, m.d)),
                (p + "router", (m.d, E)),
                (p + "w_gate", (E, m.d, F)), (p + "w_up", (E, m.d, F)),
                (p + "w_down", (E, F, m.d))]
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
        blocks.append({
            "ln_attn": {"scale": raw[p + "ln_attn"]},
            "attn": {k: raw[p + k] for k in ("wq", "wk", "wv", "wo")},
            "ln_mlp": {"scale": raw[p + "ln_mlp"]},
            "moe": {k: raw[p + k] for k in ("router",) + EXPERT_LEAVES},
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

    def _w(self, name: str, e: int | None = None) -> torch.Tensor:
        w = self.raw[name] if e is None else self.raw[name][e]
        w = w.to(self.device, torch.float32)
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

    def _attention(self, q, k, v, window: int | None) -> torch.Tensor:
        """Causal attention: q (S, H, D), k / v (S, KV, D) -> (S, H * D),
        in query blocks that keep the scores near ``attn_block_bytes``;
        with ``window`` a query at i sees keys i - window < j <= i only, and
        each block reads just the keys its queries can see."""
        S, H, D = q.shape
        group = H // k.shape[1]
        k = k.repeat_interleave(group, dim=1).transpose(0, 1)   # (H, S, D)
        v = v.repeat_interleave(group, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        span = S if window is None else min(S, window)
        rows = max(1, self.attn_block_bytes // (4 * H * (span + 1)))
        rows = min(rows, S)
        out = torch.empty((H, S, D), dtype=torch.float32, device=q.device)
        for a in range(0, S, rows):
            b = min(S, a + rows)
            lo = 0 if window is None else max(0, a - window + 1)
            s = (q[:, a:b] @ k[:, lo:b].transpose(1, 2)) / math.sqrt(D)
            i = torch.arange(a, b, device=q.device)[:, None]
            j = torch.arange(lo, b, device=q.device)[None, :]
            hide = j > i
            if window is not None:
                hide = hide | (j <= i - window)
            s = s.masked_fill(hide, float("-inf"))
            out[:, a:b] = torch.softmax(s, dim=-1) @ v[:, lo:b]
        return out.transpose(0, 1).reshape(S, H * D)

    def _experts(self, i: int, h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """The layer's routed experts: the router scores ``h`` (the
        attention's normed input), each token's six experts run on ``m``
        (the MLP's normed input), a loop over the experts hit."""
        p = f"layers.{i}."
        md = self.m
        logits = self._mm(h, self._w(p + "router"))              # (S, E)
        top, idx = torch.topk(logits, md.top_k, dim=-1)
        gate = torch.softmax(top, dim=-1)                        # (S, K)
        y = torch.zeros_like(m)
        for e in torch.unique(idx).tolist():
            tok, slot = (idx == e).nonzero(as_tuple=True)
            xe = m[tok]
            act = torch.relu(self._mm(xe, self._w(p + "w_gate", e)))
            ye = self._mm(act * self._mm(xe, self._w(p + "w_up", e)),
                          self._w(p + "w_down", e))
            y.index_add_(0, tok, gate[tok, slot][:, None] * ye)
        return y

    def _layer(self, i: int) -> dict:
        p = f"layers.{i}."
        return {n: self._w(p + n) for n in ("ln_attn", "wq", "wk", "wv",
                                            "wo", "ln_mlp")}

    def _block(self, i: int, w: dict, x: torch.Tensor, cos, sin) -> torch.Tensor:
        m = self.m
        S = x.shape[0]
        h = self._norm(x, w["ln_attn"])
        q = self._mm(h, w["wq"]).view(S, m.heads, m.head_dim)
        k = self._mm(h, w["wk"]).view(S, m.kv_heads, m.head_dim)
        v = self._mm(h, w["wv"]).view(S, m.kv_heads, m.head_dim)
        if m.rope_layers[i]:
            q = self._rope(q, cos[:S], sin[:S])
            k = self._rope(k, cos[:S], sin[:S])
        a = x + self._mm(self._attention(q, k, v, m.layer_window(i)), w["wo"])
        return a + self._experts(i, h, self._norm(a, w["ln_mlp"]))

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
                xs = [self._block(i, w, x, cos, sin) for x in xs]
                del w
            ln_f = self._w("ln_f")
            if self.m.tied:
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

def attention_layers(m: Model) -> list[tuple[int, int, int, int | None]]:
    """``(heads, kv_heads, head_dim, window)`` of each layer, in order:
    None for a global layer, the sliding window for the others."""
    return [(m.heads, m.kv_heads, m.head_dim, m.layer_window(i))
            for i in range(m.layers)]


def layer_matmul_flops(m: Model, tokens: int) -> float:
    """Projections, the router and each token's top-k experts of one layer
    over ``tokens``."""
    q = m.heads * m.head_dim
    kv = m.kv_heads * m.head_dim
    per_token = (m.d * q + 2 * m.d * kv + q * m.d + m.d * m.experts
                 + m.top_k * 3 * m.d * m.expert_ff)
    return 2.0 * tokens * per_token


def attention_flops(m: Model, pairs: int) -> float:
    """Q K^T and P V of one layer over ``pairs`` (query, key) pairs."""
    return 4.0 * m.heads * m.head_dim * pairs


def lm_head_flops(m: Model, tokens: int) -> float:
    return 2.0 * tokens * m.d * m.vocab


def forward_flops(m: Model, pos: int, T: int, lm_tokens: int) -> float:
    """One row's window of T tokens at ``pos`` through every layer (a
    window layer's queries see at most its window of keys), and the LM
    head on ``lm_tokens`` of them."""
    total = m.layers * layer_matmul_flops(m, T)
    for i in range(m.layers):
        total += attention_flops(m, window_pairs(pos, T, m.layer_window(i)))
    return total + lm_head_flops(m, lm_tokens)
