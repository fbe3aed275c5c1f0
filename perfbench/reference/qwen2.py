"""Plain Qwen2 forward (Qwen2 as published: pre-norm blocks, RMSNorm,
grouped-query attention with a bias on q, k and v, rotary embeddings with
the half-split rotation, SwiGLU MLP, tied or untied LM head), in float32
with TF32 off, or in the control's fp8.

It reads the benchmark's raw weights (``lib/weights.py``: a dict of plain
names to tensors in the (in, out) layout) and runs whole sequences from
position 0, layer by layer over a list of sequences, so that only one
layer's weights are upcast at a time.  It imports nothing of the program.

``fp8=True`` is the control: every matrix product takes its weight
quantized per output column and its input quantized per token to
float8_e4m3fn (scales by absolute maximum, products in float32), the
W8A8 step below the configuration's bfloat16.  Attention's own products,
norms and softmax stay in float32.
"""

from __future__ import annotations

import math

import torch

E4M3_MAX = 448.0


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` through float8_e4m3fn with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Qwen2:
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
        return _q8(w, 0) if self.fp8 and w.dim() == 2 else w

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = _q8(x, -1)
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
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
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
                head = (_q8(e, 1) if self.fp8 else e).T
            else:
                head = self._w("unembed")
            out = []
            for x, pos in zip(xs, positions):
                idx = torch.as_tensor(pos, device=self.device).long()
                out.append(self._mm(self._norm(x[idx], ln_f), head))
            return out
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
