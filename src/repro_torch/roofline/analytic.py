"""Closed-form roofline terms per (arch x shape x mesh).

Why analytic: on the CPU dry-run backend, XLA's cost_analysis over SPMD
modules is unstable (recorded evidence: a 2-layer unrolled probe reports
FEWER flops than the 1-layer probe — propagation chooses different
replication), and while-loop bodies are counted once.  The dry-run therefore
proves compilability + memory fit, while FLOPs/bytes/collective-bytes come
from exact closed forms below, derived from the same configs and the same
sharding rules the dry-run lowers with.  The HLO collective inventory is
still parsed and stored as a structural cross-check.

Conventions:
  * all quantities are PER CHIP per step unless suffixed _global
  * bf16 activations/params (2 bytes); fp32 logits, scores softmax (4)
  * training counts fwd + 2x bwd (+1x fwd remat) = 4x forward matmul FLOPs
  * XLA-baseline attention MATERIALIZES (B, H, Sq, Skv) scores in HBM; the
    Pallas flash-attention path sets ``flash=True`` and removes those bytes
    (that delta is a §Perf lever, measured analytically)
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import InputShape, ModelConfig

from .analysis import HBM_BW, ICI_LINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class MeshInfo:
    chips: int
    dp: int          # data-parallel ways (pod * data)
    mp: int          # model-parallel ways


@dataclasses.dataclass
class TermBreakdown:
    flops: float = 0.0            # per chip
    hbm_bytes: float = 0.0        # per chip
    coll_bytes: float = 0.0       # per chip (sent over own links)
    detail: dict = dataclasses.field(default_factory=dict)

    def add(self, key, flops=0.0, hbm=0.0, coll=0.0):
        self.flops += flops
        self.hbm_bytes += hbm
        self.coll_bytes += coll
        self.detail[key] = {"flops": flops, "hbm": hbm, "coll": coll}


def _ring(bytes_, ways):
    """Per-chip wire bytes of a ring all-gather / reduce-scatter of a
    ``bytes_``-sized global tensor over ``ways`` participants."""
    if ways <= 1:
        return 0.0
    return bytes_ * (ways - 1) / ways


def attention_flops(T, Skv, cfg, causal_half=False):
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    proj = 2 * T * d * (H * Dh) * 2 + 2 * T * d * (KV * Dh) * 2   # q,o + k,v
    factor = 0.5 if causal_half else 1.0
    scores = 2 * T * Skv * H * Dh * factor * 2                     # qk^T + av
    return proj + scores


def mlp_flops(T, cfg):
    if cfg.d_ff == 0:
        return 0.0
    n_mat = 3 if cfg.activation in ("swiglu", "geglu") else 2
    return 2 * T * cfg.d_model * cfg.d_ff * n_mat


def moe_flops(T, cfg):
    n_mat = 3 if cfg.activation in ("swiglu", "geglu") else 2
    f = 2 * T * cfg.top_k * cfg.d_model * cfg.moe_d_ff * n_mat
    if cfg.num_shared_experts:
        f += 2 * T * cfg.d_model * (cfg.shared_d_ff or cfg.moe_d_ff) * n_mat
    if cfg.dense_residual:
        f += 2 * T * cfg.d_model * cfg.d_ff * n_mat
    # router
    f += 2 * T * cfg.d_model * cfg.num_experts
    return f


def mamba_flops(T, cfg, decode=False):
    from repro_torch.models.ssm import ssm_dims
    d_inner, nheads, g, n, conv_dim = ssm_dims(cfg)
    d_in_proj = 2 * d_inner + 2 * g * n + nheads
    f = 2 * T * cfg.d_model * d_in_proj + 2 * T * d_inner * cfg.d_model
    f += 2 * T * conv_dim * cfg.ssm_conv_width
    if decode:
        # recurrence: state update + output: ~4 * H * P * N per token
        f += T * 4 * nheads * cfg.ssm_head_dim * n
    else:
        l = cfg.ssm_chunk
        P = cfg.ssm_head_dim
        # intra-chunk: (l x N)x(N x l) + (l x l)x(l x P); inter: 2 state GEMMs
        per_head_per_chunk = 2 * l * l * n + 2 * l * l * P + 4 * l * P * n
        f += T / l * per_head_per_chunk * nheads
    return f


def layer_flops(T, Skv, cfg, decode=False):
    """Forward FLOPs of ONE repeating layer/unit at T tokens (global)."""
    if cfg.family == "ssm":
        return mamba_flops(T, cfg, decode)
    if cfg.family == "hybrid":
        # one unit = hybrid_group mamba layers + 1 shared attn block
        f = mamba_flops(T, cfg, decode) * cfg.hybrid_group
        f += attention_flops(T, Skv, cfg) + mlp_flops(T, cfg)
        return f
    if cfg.family == "audio":
        # one unit = 1 encoder layer (handled separately) + 1 decoder layer
        return attention_flops(T, Skv, cfg) + mlp_flops(T, cfg)
    att = attention_flops(T, Skv, cfg)
    if cfg.num_experts:
        return att + moe_flops(T, cfg)
    return att + mlp_flops(T, cfg)


def n_units(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_group
    return cfg.num_layers


def params_per_unit(cfg) -> float:
    """Approximate parameter count of one repeating unit (for FSDP traffic)."""
    from .analysis import count_params
    total, _ = count_params(cfg)
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return max((total - embed) / n_units(cfg), 1.0)


def roofline_terms(cfg: ModelConfig, shape: InputShape, mesh: MeshInfo,
                   flash: bool = False, microbatches: int = 4,
                   fsdp: bool = True, seq_shard: bool = False,
                   draft_window: int = 0, kv_bytes: int = 2) -> TermBreakdown:
    """Per-chip roofline terms for one cell under the repo's sharding rules.

    draft_window > 0 models the paper's speculative verification: decode
    steps process (1 + draft_window) tokens per row against the same cache.
    kv_bytes = 1 models an int8-quantized KV cache (per-head scales).
    """
    tb = TermBreakdown()
    B, S = shape.global_batch, shape.seq_len
    training = shape.kind == "train"
    decode = shape.kind == "decode"
    d, V = cfg.d_model, cfg.vocab_size
    L = n_units(cfg)
    dp, mp, chips = mesh.dp, mesh.mp, mesh.chips

    if decode:
        T_global = B * (1 + draft_window)  # window tokens per row
        Skv = S
    else:
        T_global = B * S
        Skv = S
    T_chip = T_global / chips             # activations sharded over all chips
    T_dp = T_global / dp                  # batch rows per data shard

    fwd_mult = 4.0 if (training and cfg.remat) else (3.0 if training else 1.0)

    # ---- per-layer compute ----
    f_layer_fwd_global = layer_flops(T_global, Skv, cfg, decode)
    tb.add("layers_compute",
           flops=f_layer_fwd_global * L * fwd_mult / chips)

    # ---- embed + logits ----
    f_logits = 2 * T_global * d * V
    tb.add("logits_compute", flops=f_logits * (3.0 if training else 1.0) / chips)

    # ---- encoder (audio) ----
    if cfg.family == "audio":
        T_enc = B * cfg.encoder_seq_len
        f_enc = (attention_flops(T_enc, cfg.encoder_seq_len, cfg)
                 + mlp_flops(T_enc, cfg)) * cfg.num_encoder_layers
        if decode:
            f_enc = 0.0                   # encoder ran at prefill
        else:
            tb.add("encoder_compute", flops=f_enc * fwd_mult / chips)
        # cross-attention KV + scores per decoder layer
        f_cross = 2 * T_global * cfg.encoder_seq_len * cfg.num_heads * cfg.head_dim * 2
        tb.add("cross_attn_compute",
               flops=f_cross * L * (fwd_mult if training else 1.0) / chips)

    # ---- HBM bytes ----
    from .analysis import count_params
    P_total, _ = count_params(cfg)
    p_bytes_chip = P_total * 2 / chips    # bf16, fully sharded (fsdp x tp)
    if training:
        # fwd+bwd weight reads (per microbatch pass) + optimizer update r/w
        opt_bytes = 4 if cfg.name != "arctic-480b" else 2
        tb.add("weights_hbm",
               hbm=p_bytes_chip * 2 * microbatches
               + P_total / chips * (2 * opt_bytes + 2 + 2 * opt_bytes))
    else:
        tb.add("weights_hbm", hbm=p_bytes_chip)

    # activations: residual stream in/out per unit (+ revisits for bwd/remat)
    act_visits = 6.0 if training else 2.0
    act_bytes = L * T_chip * d * 2 * act_visits
    tb.add("activations_hbm", hbm=act_bytes)

    # attention score materialization (XLA baseline, not flash)
    if cfg.family in ("dense", "moe", "vlm", "audio") or cfg.family == "hybrid":
        n_att_layers = L if cfg.family != "hybrid" else L  # 1 shared blk / unit
        if not flash and not decode:
            sc = B * cfg.num_heads * S * Skv * 4 / chips
            tb.add("scores_hbm", hbm=sc * n_att_layers
                   * (3.0 if training else 1.0) * 2)
        if decode:
            kvb = (B * Skv * cfg.num_kv_heads * cfg.head_dim * 2 * kv_bytes
                   * n_att_layers / chips)
            tb.add("kv_cache_hbm", hbm=kvb)
            if not flash and draft_window > 0:
                # XLA decode materializes (B, H, T, Skv) f32 scores
                sc = (B * cfg.num_heads * (1 + draft_window) * Skv * 4 * 2
                      * n_att_layers / chips)
                tb.add("decode_scores_hbm", hbm=sc)

    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models.ssm import ssm_dims
        d_inner, nheads, g, n, conv_dim = ssm_dims(cfg)
        n_ssm = cfg.num_layers
        if decode:
            state_bytes = B * nheads * cfg.ssm_head_dim * n * 4 * 2 * n_ssm / chips
            tb.add("ssm_state_hbm", hbm=state_bytes)
        else:
            # chunked states written/read once per chunk
            st = (T_global / cfg.ssm_chunk) * nheads * cfg.ssm_head_dim * n * 4
            tb.add("ssm_state_hbm", hbm=st * 2 * n_ssm / chips
                   * (2.0 if training else 1.0))

    # logits + one-hot loss traffic
    logit_bytes = T_global * V * 4 / chips * (2 if training else 1)
    if decode:
        logit_bytes = B * V * 4 / chips
    tb.add("logits_hbm", hbm=logit_bytes)

    # ---- collectives ----
    # TP all-reduce of activations: 2 per layer fwd (+2 bwd)
    n_ar = 2 * (2 if training else 1)
    ar_bytes = _ring(T_dp * d * 2, mp) * n_ar * L
    tb.add("tp_allreduce", coll=ar_bytes * (microbatches if training else 1)
           / (microbatches if training else 1))
    if fsdp and training:
        # per-layer param all-gather (fwd + bwd) over dp + grad reduce-scatter
        unit_p_bytes = params_per_unit(cfg) * 2 / mp
        ag = _ring(unit_p_bytes, dp) * 2 * L * microbatches
        rs = _ring(unit_p_bytes, dp) * L
        tb.add("fsdp_gather_scatter", coll=ag + rs)
    if cfg.num_experts:
        # token dispatch+combine all-to-all over mp (EP): T*d each way
        a2a = 2 * T_dp * d * 2 * cfg.top_k / mp * L
        tb.add("moe_all2all", coll=a2a * (2 if training else 1))
    if training:
        # cross-pod gradient all-reduce happens inside reduce-scatter ring
        # over the combined (pod, data) axis — covered by fsdp term.
        pass
    if decode and cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
        pass  # decode TP all-reduce covered by tp_allreduce above

    return tb


def summarize(tb: TermBreakdown, model_flops_global: float, chips: int) -> dict:
    compute_s = tb.flops / PEAK_FLOPS_BF16
    memory_s = tb.hbm_bytes / HBM_BW
    collective_s = tb.coll_bytes / ICI_LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = (model_flops_global / chips) / PEAK_FLOPS_BF16
    bound = max(max(terms.values()), 1e-30)
    return {
        "flops": tb.flops,
        "hbm_bytes": tb.hbm_bytes,
        "collective_bytes": tb.coll_bytes,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": bottleneck,
        "model_flops": model_flops_global,
        "flops_ratio": (model_flops_global / chips) / max(tb.flops, 1e-30),
        "peak_fraction": useful / bound,
        "detail": tb.detail,
    }
