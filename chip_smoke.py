#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (``/usr/local/cuda``); exits non-zero, with no
result line, without them.  Imports nothing of jax and nothing of the JAX
package.  Phases (none catches a failure):

  1. the card: nvidia-smi's name and power limit, torch's device name
  2. build the ten kernels from ``src/repro_torch/csrc`` (nine sources, one
     nvcc each, in parallel; B7 and B9 share ``decode_attention.cu``); print
     build seconds and ptxas register/smem/spill lines
  3. each kernel against its plain version on the card at the shapes the
     serving paths give it: max error, exact-match counts, kernel / plain /
     library ms (CUDA events, L2 flushed between launches, the host's
     enqueue of every timed call inside the spin before it, else the spin
     is lengthened: ``cases.time_ms``), and the bound from this run's
     inputs.  Attention (paged and tree, float32 and bfloat16) is held
     against the plain version in float32 on the same inputs, tolerances
     ``cases.PAGED_TOL``, the error against the bfloat16 plain version
     printed beside it; paged attention also at the edges of its split
     slot axis (``cases.PAGED_EDGE_CASES``), with the split printed; a
     chain-masked tree window must also match paged attention at lengths + 1
     within ``cases.PAGED_TOL``.  The samplers (B4, B5) are printed with
     their split of the vocabulary (chunks a row) at the path shapes and
     at unaligned V (4097, 300, 1), each called again after a split B1
     launch (the same tickets: the same bits); B4 is held on relative
     error (``cases.GATHER_TOL``) and timed beside ``cross_entropy`` (-log
     of the same value, not the same function); B5's tokens must agree
     except where ``u * Z`` lies within rounding of a CDF step (float64
     check), its Z = 0 row give argmax(p), the first of two maxima tied
     across chunks, and its no-crossing row V - 1;
     the verification kernel (B2) is printed with its split of the
     vocabulary (chunks a row), called twice (the same bits), and also run
     with a row whose residual is all zero (the token must be argmax(p))
     and one where nothing crosses (V - 1), ``cases.verify_edge_rows``.
     Contiguous tree attention (B6) is held like paged tree attention, and
     its chain mask must equal paged tree attention over the same keys laid
     out in pages, bit for bit; both tree kernels in bfloat16 also on grids
     small enough to split their key axis (``cases.TREE_SPLIT_CASES``: a
     length-0 row, an all-(-1) table row, a ragged S of 96, page sizes 8 and
     16), each bf16 case printed with its split and called twice (the same
     bits); the SSD scan (B10, bfloat16 and float32, with and without an
     initial state, and at b = 1, where bf16 cuts the head dim across
     blocks) within ``cases.SSD_TOL`` and ``cases.SSD_STATE_TOL``, each bf16
     case printed with its head-dim slices and called twice (the same
     bits).  Decode attention (B7: the TinyLlama draft step, Zamba2's
     shared-attention step at head dim 80, Llama-2-7B's plain decode step,
     lengths 1, S and past S, and a split grid with a row of length 0, which
     must give 0) and flash attention (B8: the Llama-2-7B, TinyLlama and
     Zamba2 prefills, Sq < Skv, non-causal) are held like paged attention;
     each bf16 B7 case is printed with its split, called twice (the same
     bits) and, at B6's head dims, must equal B6 with a one-row window and
     mask [[1]] at lengths - 1 bit for bit on every row with 1 <= lengths
     <= S.  Int8
     decode attention (B9) over caches made by ``quantize_kv`` from the
     same normal K/V (Llama-2-7B, TinyLlama and Zamba2 steps, the JAX kernel
     bench's shape, lengths 1, S, past S and 0) is held like B7 on its live
     rows, its dead row must be 0, and its error against B7 on the
     unquantized caches must stay under the JAX package's budget of 0.05;
     each bf16 B9 case is printed with its split, called twice (the same
     bits) and, at unit scales, must equal bf16 B7 on the codes as bf16
     caches bit for bit.  B1, B3, B6, B7, B8 and B9 also run at head dim
     256 (gemma-7b: B=8, H=KV=16; paligemma-3b: H=8, KV=1) and B8 at
     whisper-large-v3's encoder and cross-attention (non-causal, 1500
     frames), with times and bounds; and every kernel at the shapes the
     full-width phases 14 and 17 give it: B1 at the MoE pair's verify
     window, draft step and prefill (H = KV = 16, D = 128), B3 at its tree
     window (J=2, L=4), B2, B4 and B5 at V = 163840, B7 and B8 at whisper's
     decoder step and prefill (H = KV = 20, D = 64).
  4. a small-input reference check: the smoke-size engine on the card
     (kernels) against the same engine on the CPU (plain versions), same
     weights and draws, three sequential rounds then three tree rounds
     (J=1 through the tree machinery, J=2, J=3) on the paged layout; the
     paged engine under ``ContinuousEngine``: a forced-barrier session of
     three steps and an externally paced sequence (a ``-1``-padded bucket,
     a commit out of dispatch order, a batch merged from two draft groups,
     a retire mid-verify), identical committed tokens and counts; the
     same six rounds on the contiguous layout, and three J=1 rounds each
     with mamba2 and zamba2 smoke targets (contiguous; each of these
     launches B7 and B8): identical committed tokens; and the plain
     ``ServingEngine`` on the deepseek-7b smoke config, greedy and sampled
     with the same noise: identical tokens; the MoE ``SpecEngine``
     (moonshot smoke target, dense smoke draft) on both layouts, 3 J=1 and
     2 tree rounds in each commit mode: identical tokens across devices and
     commit modes; the paligemma and whisper smoke models: prefill and 3
     one-token windows, the same next tokens, float32 logits within
     ``SMOKE_LOGIT_TOL``
  5. the J=1 path at full width: Llama-2-7B verifying TinyLlama-1.1B drafts
     in bfloat16, paged (page_size 16, max_len 1024), under a
     ``MultiSpinCell`` (scheme hete) with 8 requests of 128-token prompts
     asking 64 new tokens each; rounds until drain or 20; per round: every
     unmasked stream commits >= 1 token, the path's kernels' launch
     counters grow (paged_attention, fused_verify_sample), every plain
     counter stays 0, both page pools pass their invariants, exactly one
     host sync; then 3 more rounds under torch.profiler: device busy share
     and the kernels that take the time
  6. the tree path at full width: the same pair and requests under a
     ``MultiSpinCell(scheme="multidraft", J_min=2, J_max=3)`` on a fresh
     engine (the J=1 engine is freed first); per round as in 5 with
     ``draft_width >= 2``, the kernels paged_attention, paged_tree_attention,
     gather_softmax_prob and residual_sample, and exactly two host syncs;
     then 3 profiled rounds
  7. the contiguous tree path at full width: the same pair, requests and
     ``multidraft`` cell on a contiguous engine (max_len 1024, the JAX
     engine's default layout); flash_attention once per layer of both
     models (54) in ``start()``; per round ``draft_width >= 2``, the kernels
     tree_attention, gather_softmax_prob, residual_sample and
     decode_attention (the draft steps), no plain call, exactly two host
     syncs; then 3 profiled rounds
  8. the hybrid path at full width: Zamba2-2.7B verifying TinyLlama-1.1B
     drafts in bfloat16, contiguous, scheme hete, 8 persistent requests of
     128-token prompts (an SSM target refuses frozen rows); ssd_scan
     launches once per Mamba-2 layer (54) and flash_attention once per
     shared-block invocation and draft layer (9 + 22) in ``start()``'s
     prefill, which runs under torch.profiler to print the device ms of
     the 54 ssd_scan launches per admission; per round fused_verify_sample
     and decode_attention, no plain call, exactly one host sync; then 3
     profiled rounds
  9. the plain decode path at full width: ``ServingEngine`` with Llama-2-7B
     in bfloat16 (max_len 1024), 8 prompts of 128 tokens, 64 sampled decode
     steps; flash_attention 32 launches in ``start()``, decode_attention 32
     a step, one host fetch a step, every plain counter 0; ms per step,
     tokens/s and peak memory; then 3 profiled steps
 10. the int8 path, on phase 9's engine while it is alive: for each of
     Llama-2-7B's 32 layers, its (8, 1024, 32, 128) bf16 K/V view of the
     cache through ``ops.quantize_kv`` and one ``ops.decode_attention_q8``
     at lengths ``state.pos`` with a seeded bf16 query; decode_attention_q8
     exactly 32 launches and nothing else launched or called plain; then
     each layer held against its plain version within ``cases.PAGED_TOL``
     and against B7 on the bf16 slab, and the bytes of both slabs
 11. the continuous path at full width: the J=1 pair and requests (``T_S``
     alternating 0.004 / 0.03) under ``MultiSpinCell(scheme="hete",
     schedule="continuous", max_batch=8, max_inflight=2, L_max=8)`` over
     ``ContinuousBackend`` on a fresh paged engine; one request leaves
     while its batch is in flight (its pages back at once); per committed
     batch every live member commits >= 1 token, B2 launches once per
     verification batch dispatched and B1 grows, no plain call, both pools
     pass their invariants, one host sync per collect, occupancy in
     (0, 1]; 24 checked batches, then 3 profiled, then the drain under the
     same checks, after which every page is back; ms per batch and tokens/s
     beside phase 5's; then a forced barrier of 3 steps restarted from the
     same prompts must commit the tokens of 3 ``spin_round``s with the same
     draws
 12. the gateway path: the port launcher's ``build_cell`` (``--backend
     engine --arch llama2-7b --max-len 1024 --max-batch 8 --L-max 8``: the
     float32 target and the launcher's one-layer draft) behind
     ``MultiSpinGateway`` on 127.0.0.1, ``run_loadgen`` of 16 requests at
     32/s: no error, every request's streamed token ids equal the engine's
     committed tokens of its stream, ``/metrics`` parses, B1 and B2
     launch, no plain call, the pools pass their invariants; TTFT p50/p95
     and tokens/s; then 3 rounds of the same cell stepped directly (8 more
     requests) under torch.profiler
 14. the MoE path at full width (``moe_path``): moonshot-v1-16b-a3b and a
     2-layer dense draft at its widths, bf16, paged, 8 x 128-token prompts,
     10 J=1 rounds of a ``MultiSpinCell(scheme="hete", L_max=4)`` (one
     host sync each), a request leaving (``cell.leave``) before round 5
     (its pages back at once), then 4 tree rounds (J=2, L=4) through
     ``spin_round`` on the cell's engine state, one MoE
     layer's ``moe_apply`` under ``set_sync_debug_mode("error")``, 3
     profiled rounds, the drain (every page back)
 15. gemma-7b (head dim 256) through phase 9's ``plain_decode_path``, 32
     steps: B8 28 in ``start()``, B7 28 a step
 16. paligemma-3b (``vlm_path``): 8 x (256 patch embeds + 128 tokens),
     prefill and 32 greedy one-token windows, contiguous and paged, the
     two layouts' logits compared
 17. whisper-large-v3 (``encdec_path``): 8 x 1500 frames, 8 x 64 decoder
     tokens, 32 greedy steps (B7 and B8 32 each a step)
 18. the training path (``training_reference_check``, ``training_path``):
     four smoke families (tinyllama, moonshot MoE, paligemma with prefix
     embeds, whisper with frames) train 3 steps on the card as on the CPU
     from the same port init (losses and the first step's gradients
     within ``SMOKE_TRAIN_TOL``, no kernel launched); a Mamba-2 smoke step
     on the card must raise at ``ops.ssd_scan`` (no kernel has a
     backward); then TinyLlama-1.1B in float32 at full width and depth,
     the train launcher's defaults (seq 128, batch 8, microbatches 2), 20
     steps: ms a step, tokens/s, peak memory, the bound, every counter 0;
     3 profiled steps; one step repeated from the same state (the same
     bits or the differing leaves named); a restart at 1 layer of the
     same widths, begun before phase 14 so that its checkpoint write
     overlaps phases 14-17: 20 steps with ``CheckpointManager.save_async``
     at step 10 (zlib where zstandard is missing), and here a fresh
     template restored and run to step 20 against the uninterrupted run,
     bit for bit or within 2 lr a resumed step; checkpoint bytes,
     snapshot, write and read seconds
 19. the mesh path (``mesh_path``, ``dryrun_begin`` / ``dryrun_end``):
     a one-rank NCCL group (``HashStore``) and ``make_smoke_mesh()``, the
     (1, 1) mesh with the production axis names; qwen2.5-3b at full width
     and depth in bf16 (random weights, seed 0) on contiguous caches, 8 x
     128-token prompts, max_len 1024: a prefill (B8) and 32 greedy
     ``forward_window`` steps (B7), once plain and once with params,
     caches and inputs placed by the sharding rules under ``use_mesh``:
     logits and tokens equal bit for bit, the same B7/B8 launches, the
     ``record_collectives`` counts printed, host-timed ms a step both
     ways; ``compressed_psum_int8`` over the group on a (151936, 2048)
     float32 leaf = ``dequantize_int8`` of its requantized codes, bit for
     bit, timed; then the dry run's qwen2.5-3b ``decode_32k`` and
     ``train_4k`` cells (pod16x16), traced in subprocesses begun before
     phase 14, each ``ok``: per-device argument bytes and traced peak
     beside the card's 80 GB, and the roofline line; the group destroyed
 20. summary lines: each profiled path's device busy, wall and idle share
     per round, step or batch; per path, the launches of B3, B6, B1, B7,
     B2, B4 and B5 per round, step or batch (counters) beside their
     profiled calls and device ms; the gateway's TTFT and tokens/s; then
     one ``{"kernels": [...]}`` JSON line (each kernel with
     the design it, or its bf16 route, moved to), the card line, and as the
     last line
     ``{"ok": true, "device": {...}}``

Each path's counters are set to 0 just before its engine's ``start()`` and
read after its last checked round or step; ``launches`` in the kernels line
sums them over the paths, prefills included (``launches_per_round`` counts
per step on the plain decode path and per 32-layer pass on the int8 path).
Paths with two kinds of round keep a run each, so that each
``launches_per_round`` is one kind's own: the MoE path's J=1 and tree
rounds, paligemma's contiguous and paged layouts.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN_ROUNDS = 20
PROFILE_ROUNDS = 3
PAGED_CASES = [
    # name, (B, T, H, KV, D, ps, ctx): the shapes of the main path
    ("llama2-7b verify window", (8, 9, 32, 32, 128, 16, 512)),
    ("tinyllama-1.1b draft step", (8, 1, 32, 4, 64, 16, 512)),
    ("llama2-7b prefill", (8, 127, 32, 32, 128, 16, 1)),
    ("tinyllama-1.1b prefill", (8, 127, 32, 4, 64, 16, 1)),
    # head dim 256: gemma-7b (H = KV = 16) and paligemma-3b (H = 8, KV = 1)
    ("gemma-7b verify window", (8, 9, 16, 16, 256, 16, 512)),
    ("gemma-7b prefill", (8, 127, 16, 16, 256, 16, 1)),
    ("paligemma-3b step", (8, 1, 8, 1, 256, 16, 400)),
    ("paligemma-3b prefill", (8, 384, 8, 1, 256, 16, 1)),
    # the MoE path: moonshot-v1-16b-a3b and its 2-layer draft (H = KV = 16)
    ("moonshot verify window L=4", (8, 5, 16, 16, 128, 16, 140)),
    ("moonshot draft step", (8, 1, 16, 16, 128, 16, 140)),
    ("moonshot prefill", (8, 127, 16, 16, 128, 16, 1)),
]
PAGED_HEADLINE = ("tinyllama-1.1b draft step", "bfloat16")
VERIFY_CASES = [
    # name, (B, L, V, Vhat), rows 0 and 1 at Z = 0 and nothing crossing
    ("llama pair, V=32000", (8, 8, 32000, 64), False),
    ("qwen3.5 pair, V=151936", (8, 8, 151936, 64), False),
    ("moonshot pair L=4, V=163840", (8, 4, 163840, 64), False),
    ("llama pair, Z = 0 and no crossing", (8, 8, 32000, 64), True),
]
VERIFY_HEADLINE = "llama pair, V=32000"
TREE_ROUNDS = 20
TREE_CASES = [
    # name, (B, J, L, H, KV, D, ps, ctx), chain: T = J*L + 1
    ("llama2-7b tree window J=2 L=6", (8, 2, 6, 32, 32, 128, 16, 512), False),
    ("llama2-7b ceiling J=6 L=8", (8, 6, 8, 32, 32, 128, 16, 512), False),
    ("llama2-7b chain T=13", (8, 2, 6, 32, 32, 128, 16, 512), True),
    ("gemma-7b tree window J=2 L=6", (8, 2, 6, 16, 16, 256, 16, 512), False),
    ("paligemma-3b tree window J=2 L=6", (8, 2, 6, 8, 1, 256, 16, 512), False),
    ("moonshot tree window J=2 L=4", (8, 2, 4, 16, 16, 128, 16, 150), False),
]
TREE_HEADLINE = ("llama2-7b tree window J=2 L=6", "bfloat16")
SOFTMAX_CASES = [
    # name, (N, V): the path's shapes, then the edges of the vocab split
    ("tree nodes J=2 L=6", (96, 32000)),
    ("ceiling J=6 L=8", (384, 32000)),
    ("qwen3.5 vocab", (96, 151936)),
    ("moonshot tree nodes J=2 L=4", (64, 163840)),
    ("unaligned rows V=4097", (5, 4097)),
    ("V=300, one chunk", (5, 300)),
    ("V=1", (3, 1)),
]
SOFTMAX_HEADLINE = "tree nodes J=2 L=6"
RESIDUAL_CASES = [
    # name, (N, V): rows 0-2 at Z = 0, a tie of p's maxima, no crossing
    ("llama vocab", (8, 32000)),
    ("qwen3.5 vocab", (8, 151936)),
    ("moonshot vocab", (8, 163840)),
    ("unaligned rows V=4097", (5, 4097)),
    ("V=300, one chunk", (5, 300)),
    ("V=1", (3, 1)),
    ("rows past the SMs", (136, 32000)),
]
RESIDUAL_HEADLINE = "llama vocab"
CONTIGUOUS_ROUNDS = 16
HYBRID_ROUNDS = 16
CONTIGUOUS_TREE_CASES = [
    # name, (B, J, L, H, KV, D, S, ctx), chain: T = J*L + 1
    ("llama2-7b tree window J=2 L=6", (8, 2, 6, 32, 32, 128, 1024, 512), False),
    ("llama2-7b ceiling J=6 L=8", (8, 6, 8, 32, 32, 128, 1024, 512), False),
    ("llama2-7b chain T=13", (8, 2, 6, 32, 32, 128, 1024, 512), True),
    ("gemma-7b tree window J=2 L=6", (8, 2, 6, 16, 16, 256, 1024, 512), False),
    ("paligemma-3b tree window J=2 L=6", (8, 2, 6, 8, 1, 256, 1024, 512),
     False),
]
CONTIGUOUS_TREE_HEADLINE = ("llama2-7b tree window J=2 L=6", "bfloat16")
SSD_CASES = [
    # name, (b, s, h, p, g, n, chunk), initial state
    ("zamba2-2.7b prefill", (8, 128, 80, 64, 1, 64, 64), False),
    ("zamba2-2.7b prefill, initial state", (8, 128, 80, 64, 1, 64, 64), True),
    ("mamba2-130m heads", (8, 128, 24, 64, 1, 128, 64), False),
    ("zamba2-2.7b prefill, one row (p cut)", (1, 128, 80, 64, 1, 64, 64),
     False),
]
SSD_HEADLINE = ("zamba2-2.7b prefill", "bfloat16")
DECODE_CASES = [
    # name, (B, H, KV, D, S, lengths): a (lo, hi) range or the rows' list
    ("tinyllama-1.1b draft step", (8, 32, 4, 64, 1024, (128, 520))),
    ("zamba2-2.7b shared-attention step", (8, 32, 32, 80, 1024, (128, 160))),
    ("llama2-7b plain decode", (8, 32, 32, 128, 1024, (127, 190))),
    ("lengths 1, S, past S", (4, 32, 4, 64, 1024, [1, 1024, 1100, 700])),
    ("split, a length-0 row", (2, 32, 4, 128, 1024, [0, 900])),
    ("gemma-7b decode step", (8, 16, 16, 256, 1024, (128, 160))),
    ("paligemma-3b decode step", (8, 8, 1, 256, 512, (384, 416))),
    ("whisper-large-v3 decoder step", (8, 20, 20, 64, 128, (64, 96))),
    ("qwen2.5-3b decode step", (8, 16, 2, 128, 1024, (128, 160))),
]
DECODE_HEADLINE = ("tinyllama-1.1b draft step", "bfloat16")
FLASH_CASES = [
    # name, (B, Sq, Skv, H, KV, D, causal)
    ("llama2-7b prefill", (8, 127, 127, 32, 32, 128, True)),
    ("tinyllama-1.1b prefill", (8, 127, 127, 32, 4, 64, True)),
    ("zamba2-2.7b shared-attention prefill", (8, 127, 127, 32, 32, 80, True)),
    ("Sq < Skv", (2, 70, 200, 8, 2, 64, True)),
    ("non-causal", (2, 100, 100, 8, 2, 80, False)),
    ("gemma-7b prefill", (8, 128, 128, 16, 16, 256, True)),
    ("paligemma-3b prefill", (8, 384, 384, 8, 1, 256, True)),
    ("whisper-large-v3 encoder", (8, 1500, 1500, 20, 20, 64, False)),
    ("whisper-large-v3 decoder prefill", (8, 64, 64, 20, 20, 64, True)),
    ("whisper-large-v3 cross-attention prefill",
     (8, 64, 1500, 20, 20, 64, False)),
    ("whisper-large-v3 cross-attention step", (8, 1, 1500, 20, 20, 64, False)),
    ("qwen2.5-3b prefill", (8, 128, 128, 16, 2, 128, True)),
]
FLASH_HEADLINE = ("llama2-7b prefill", "bfloat16")
Q8_CASES = [
    # name, (B, H, KV, D, S, lengths): a (lo, hi) range or the rows' list
    ("llama2-7b plain decode", (8, 32, 32, 128, 1024, (127, 190))),
    ("tinyllama-1.1b draft step", (8, 32, 4, 64, 1024, (128, 520))),
    ("zamba2-2.7b shared-attention step", (8, 32, 32, 80, 1024, (128, 160))),
    ("jax kernel bench", (4, 8, 4, 64, 512, [256] * 4)),
    ("lengths 1, S, past S, 0", (4, 32, 4, 64, 1024, [1, 1024, 1100, 0])),
    ("gemma-7b decode step", (8, 16, 16, 256, 1024, (128, 160))),
    ("paligemma-3b decode step", (8, 8, 1, 256, 1024, (384, 416))),
]
Q8_HEADLINE = ("llama2-7b plain decode", "bfloat16")
Q8_BUDGET = 0.05    # int8 against exact K/V, tests/test_kernels.py:475
DECODE_STEPS = 64
CONTINUOUS_CHECKED = 24     # checked batches before the profile
PROFILES = {}   # label -> device busy, wall and idle share per round or step
START_PROFILES = {}   # (label, op) -> device ms and calls in a profiled start()
GATEWAY = {}   # the gateway session's loadgen numbers
TRAINING = {}   # the full-width training run's numbers
SMOKE_TRAIN_TOL = dict(loss_rtol=1e-5, grad_rtol=1e-4, grad_atol_scale=1e-5)
TRAIN_STEPS = 20            # the full-width run: launcher defaults
RESTART_AT = 10


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def check_kernels(torch, cases, pa, fvs):
    """Phase 3: each kernel against its plain version; returns records."""
    paged = []
    all_cases = ([(name, shape, {}) for name, shape in PAGED_CASES]
                 + cases.PAGED_EDGE_CASES)
    for name, shape, extra in all_cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = cases.paged_case(*shape, dtype=dtype, device="cuda", **extra)
            B, T, H, D = args[0].shape
            P, ps, KV, _ = args[1].shape
            plan = (pa.split_plan(B, KV, T * (H // KV), args[3].shape[1], ps,
                                  pa.sm_count(args[0].device))
                    if dtype == torch.bfloat16 else None)
            got = pa.paged_attention_cuda(*args).float()
            want = cases.paged_attention_held(*args)
            plain = pa.paged_attention_plain(*args).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            err_plain = float((got - plain).abs().max())
            rtol, atol = cases.PAGED_TOL[dtype]
            close = torch.allclose(got, want, rtol=rtol, atol=atol)
            n_bytes, n_ops = cases.paged_work(*args)
            bound_ms, bound_by = cases.bound(n_bytes, n_ops, dtype)
            sq, sk, sv, smask = cases.paged_sdpa_inputs(*args)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            rec = {
                "case": name, "dtype": str(dtype).replace("torch.", ""),
                "shape": dict(zip("B T H KV D ps ctx".split(), shape),
                              n_slots=args[3].shape[1],
                              lengths=args[4].tolist()),
                "split_plan": (dict(zip(("row_tile", "row_tiles", "n_split",
                                         "split_slots"), plan))
                               if plan else None),
                "max_abs_err": err, "rtol": rtol, "atol": atol,
                "max_abs_err_vs_plain_same_dtype": err_plain,
                "ms": cases.time_ms(lambda: pa.paged_attention_cuda(*args)),
                "plain_ms": cases.time_ms(lambda: pa.paged_attention_plain(*args),
                                          iters=10),
                "library_ms": cases.time_ms(lambda: sdpa(sq, sk, sv,
                                                         attn_mask=smask)),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": n_bytes, "ops": n_ops,
            }
            log(f"paged_attention  {name:33s} {rec['dtype']:8s} "
                + (f"(row tile {plan[0]} x {plan[1]}, {plan[2]} splits of "
                   f"{plan[3]} slots) " if plan else "")
                + f"max|err| {err:.3e} vs f32 plain (rtol {rtol}, atol {atol}), "
                f"{err_plain:.3e} vs {rec['dtype']} plain  kernel {rec['ms']:.4f} ms  "
                f"plain {rec['plain_ms']:.4f} ms  sdpa {rec['library_ms']:.4f} ms  "
                f"bound {bound_ms:.4f} ms ({bound_by})")
            if not close:
                raise AssertionError(f"paged_attention {name} {dtype}: kernel "
                                     f"disagrees with plain, max|err| {err}")
            paged.append(rec)
    verify = []
    for name, (B, L, V, vhat), edge in VERIFY_CASES:
        args = cases.verify_case(B, L, V, vhat, "cuda")
        if edge:
            args = cases.verify_edge_rows(args)
        n_chunks, chunk = fvs.split_plan(args[0], args[3])
        got = fvs.fused_verify_sample_cuda(*args)
        want = fvs.fused_verify_sample_plain(*args)
        again = fvs.fused_verify_sample_cuda(*args)
        torch.cuda.synchronize()
        rep = cases.compare_verify(got, want, args)
        second_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        edge_tokens = None
        if edge:
            sel = min(rep["n_acc"][0], L - 1)
            edge_tokens = (int(got[2][0]) == int(args[1][0, sel])
                           and int(got[2][1]) == V - 1)
        n_bytes, n_ops = cases.verify_work(*args)
        bound_ms, bound_by = cases.bound(n_bytes, n_ops, torch.float32)
        n_acc, dlen = rep["n_acc"], rep["draft_len"]
        rec = {
            "case": name, "shape": {"B": B, "L": L, "V": V, "vhat": vhat},
            "vocab_split": {"chunks": n_chunks, "chunk": chunk},
            "second_call_equal": second_equal,
            "edge_rows_exact": edge_tokens,
            **{k: rep[k] for k in ("accept_equal", "n_acc_equal",
                                   "calibrated_equal_rows",
                                   "calibrated_diff_rows",
                                   "diff_rows_at_cdf_step")},
            "max_abs_err": rep["max_abs_err"],
            "rows_reject": sum(n == 0 for n in n_acc),
            "rows_full_accept": sum(n >= d for n, d in zip(n_acc, dlen)),
            "ms": cases.time_ms(lambda: fvs.fused_verify_sample_cuda(*args)),
            "plain_ms": cases.time_ms(lambda: fvs.fused_verify_sample_plain(*args),
                                      iters=10),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "ops": n_ops,
        }
        log(f"fused_verify_sample {name:34s} ({n_chunks} chunks of {chunk} "
            f"a row, {B * n_chunks} blocks) accept equal {rep['accept_equal']}  "
            f"n_acc equal {rep['n_acc_equal']}  calibrated equal "
            f"{rep['calibrated_equal_rows']}/{B} (differing rows "
            f"{rep['calibrated_diff_rows']} at a CDF step: "
            f"{rep['diff_rows_at_cdf_step']})  reject rows {rec['rows_reject']} "
            f"full-accept rows {rec['rows_full_accept']}  second call equal "
            f"{second_equal}"
            + ("" if edge_tokens is None else
               f"  Z = 0 row -> argmax(p), no-crossing row -> V - 1: "
               f"{edge_tokens}")
            + f"  kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms  "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        if not (rep["accept_equal"] and rep["n_acc_equal"]
                and rep["diff_rows_at_cdf_step"]):
            raise AssertionError(f"fused_verify_sample {name}: {rep}")
        if not second_equal or edge_tokens is False:
            raise AssertionError(f"fused_verify_sample {name}: a second call "
                                 f"gave other bits ({not second_equal}) or an "
                                 f"edge row another token ({edge_tokens})")
        if not (rec["rows_reject"] and rec["rows_full_accept"]):
            raise AssertionError(f"{name}: the case lost its reject or "
                                 f"full-accept rows: {rep}")
        verify.append(rec)
    return paged, verify


def check_tree_kernels(torch, cases, pa, pta):
    """Phase 3, paged tree attention (B3) against its plain version; returns
    records."""
    tree = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    runs = [(name, dict(zip("B J L H KV D ps ctx".split(), shape)), chain,
             dtype, {})
            for name, shape, chain in TREE_CASES
            for dtype in (torch.float32, torch.bfloat16)]
    runs += [(f"split: {name}, ps {ps}", dict(zip("B J L H KV D".split(),
                                              shape), ps=ps, ctx=0),
              False, torch.bfloat16,
              dict(lengths=lengths, width=keys // ps))
             for name, shape, lengths, keys in cases.TREE_SPLIT_CASES
             for ps in (8, 16)]
    for name, shape, chain, dtype, extra in runs:
        args = cases.tree_case(*shape.values(), dtype=dtype, device="cuda",
                               chain=chain, **extra)
        plan = (pta.split_plan(args[0], args[1], args[3],
                               pa.sm_count(args[0].device))
                if dtype == torch.bfloat16 else None)
        got = pta.paged_tree_attention_cuda(*args).float()
        want = cases.tree_attention_held(*args)
        plain = pta.paged_tree_attention_plain(*args).float()
        again = pta.paged_tree_attention_cuda(*args).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        err_plain = float((got - plain).abs().max())
        rtol, atol = cases.PAGED_TOL[dtype]
        close = torch.allclose(got, want, rtol=rtol, atol=atol)
        err_b1 = None
        if chain:       # the sequential window: B1 at lengths + 1, held
            # within PAGED_TOL (B1 splits its keys by slots, B3 by chunks)
            q, kp, vp, pt, ln, _ = args
            b1 = pa.paged_attention_cuda(q, kp, vp, pt, ln + 1).float()
            err_b1 = float((got - b1).abs().max())
        n_bytes, n_ops = cases.tree_work(*args)
        bound_ms, bound_by = cases.bound(n_bytes, n_ops, dtype)
        sq, sk, sv, smask = cases.tree_sdpa_inputs(*args)
        rec = {
            "case": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": dict(shape, T=shape["J"] * shape["L"] + 1, chain=chain,
                          n_slots=args[3].shape[1], lengths=args[4].tolist()),
            "split_plan": (dict(zip(("row_tile", "row_tiles", "n_split",
                                     "split_keys"), plan)) if plan else None),
            "max_abs_err": err, "rtol": rtol, "atol": atol,
            "max_abs_err_vs_plain_same_dtype": err_plain,
            "max_abs_err_vs_paged_attention": err_b1,
            "second_call_equal": bool(torch.equal(got, again)),
            "ms": cases.time_ms(lambda: pta.paged_tree_attention_cuda(*args)),
            "plain_ms": cases.time_ms(
                lambda: pta.paged_tree_attention_plain(*args), iters=10),
            "library_ms": cases.time_ms(lambda: sdpa(sq, sk, sv,
                                                     attn_mask=smask)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "ops": n_ops,
        }
        log(f"paged_tree_attention {name:30s} {rec['dtype']:8s} "
            + _split_note(plan)
            + f"max|err| {err:.3e} vs f32 plain (rtol {rtol}, atol {atol}), "
            f"{err_plain:.3e} vs {rec['dtype']} plain"
            + (f", {err_b1:.3e} vs paged_attention" if chain else "")
            + f"  kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms  "
            f"sdpa {rec['library_ms']:.4f} ms  bound {bound_ms:.4f} ms "
            f"({bound_by})")
        if not close:
            raise AssertionError(f"paged_tree_attention {name} {dtype}: "
                                 f"kernel disagrees with plain, max|err| {err}")
        if not rec["second_call_equal"]:
            raise AssertionError(f"paged_tree_attention {name} {dtype}: a "
                                 f"second call gave other bits")
        if chain and not torch.allclose(got, b1, rtol=rtol, atol=atol):
            raise AssertionError(f"paged_tree_attention {name} {dtype}: a "
                                 f"chain mask differs from paged_attention "
                                 f"by {err_b1}")
        tree.append(rec)
    try:                        # the kernel's limit is refused, not mis-run
        over = cases.tree_case(1, 8, 8, 4, 2, 16, 16, 40, torch.float32, "cuda")
        pta.paged_tree_attention_cuda(*over)
        raise AssertionError("paged_tree_attention accepted a 65-token window")
    except ValueError as e:
        log(f"paged_tree_attention T=65 refused: {e}")
    return tree


def check_samplers(torch, cases, pa, fvs, gsp, rs):
    """Phase 3, the samplers (B4, B5) against their plain versions at the
    path shapes and the edges of their vocabulary split: each case printed
    with its chunks a row, called again after a split B1 launch (the same
    tickets; the same bits); B4 beside ``cross_entropy`` (-log of the same
    value: not the same function); B5's Z = 0 row must give the first argmax
    of p (a tie across two chunks when split) and its no-crossing row
    V - 1.  Returns (softmax, residual) records."""
    b1_split = cases.paged_case(8, 1, 32, 4, 64, 16, 512, torch.bfloat16,
                                "cuda", width=64)
    cross_entropy = torch.nn.functional.cross_entropy
    softmax = []
    rtol, atol = cases.GATHER_TOL
    for name, (N, V) in SOFTMAX_CASES:
        logits, ids = cases.softmax_case(N, V, "cuda")
        n_chunks, chunk = fvs.row_split_plan(N, V, pa.sm_count(logits.device))
        got = gsp.gather_softmax_prob_cuda(logits, ids)
        want = gsp.gather_softmax_prob_plain(logits, ids)
        pa.paged_attention_cuda(*b1_split)
        again = gsp.gather_softmax_prob_cuda(logits, ids)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        n_bytes, n_ops = cases.softmax_work(logits, ids)
        bound_ms, bound_by = cases.bound(n_bytes, n_ops, torch.float32)
        ids_long = ids.long()
        rec = {
            "case": name, "shape": {"N": N, "V": V},
            "vocab_split": {"chunks": n_chunks, "chunk": chunk},
            "second_call_equal": bool(torch.equal(got, again)),
            "max_abs_err": err, "max_rel_err": rel, "rtol": rtol, "atol": atol,
            "ms": cases.time_ms(lambda: gsp.gather_softmax_prob_cuda(logits, ids)),
            "plain_ms": cases.time_ms(
                lambda: gsp.gather_softmax_prob_plain(logits, ids), iters=10),
            "library_ms": None,
            "cross_entropy_ms_not_same_function": cases.time_ms(
                lambda: cross_entropy(logits, ids_long, reduction="none")),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "ops": n_ops,
        }
        log(f"gather_softmax_prob {name:22s} N={N} V={V} ({n_chunks} chunks of "
            f"{chunk} a row, {N * n_chunks} blocks)  max|err| {err:.3e} "
            f"(rel {rel:.3e}; rtol {rtol}, atol {atol})  second call equal "
            f"{rec['second_call_equal']}  kernel {rec['ms']:.4f} ms  "
            f"plain {rec['plain_ms']:.4f} ms  library none; cross_entropy "
            f"(-log of the same value, not the same function) "
            f"{rec['cross_entropy_ms_not_same_function']:.4f} ms  "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"gather_softmax_prob {name}: max|err| {err}, "
                                 f"max relative err {rel}")
        if not rec["second_call_equal"]:
            raise AssertionError(f"gather_softmax_prob {name}: a second call "
                                 f"gave other bits")
        softmax.append(rec)

    residual = []
    for name, (N, V) in RESIDUAL_CASES:
        p, q, u = cases.residual_case(N, V, "cuda")
        n_chunks, chunk = fvs.row_split_plan(N, V, pa.sm_count(p.device))
        got = rs.residual_sample_cuda(p, q, u)
        want = rs.residual_sample_plain(p, q, u)
        pa.paged_attention_cuda(*b1_split)
        again = rs.residual_sample_cuda(p, q, u)
        torch.cuda.synchronize()
        rep = cases.compare_residual(got, want, p, q, u)
        z = (p - q).clamp(min=0).sum(-1).cpu()
        tied = (p[1] == p[1].max()).nonzero().flatten().cpu().tolist()
        n_bytes, n_ops = cases.residual_work(p, q, u, want)
        bound_ms, bound_by = cases.bound(n_bytes, n_ops, torch.float32)
        rec = {
            "case": name, "shape": {"N": N, "V": V},
            "vocab_split": {"chunks": n_chunks, "chunk": chunk},
            "second_call_equal": bool(torch.equal(got, again)),
            "max_abs_err": rep["max_abs_err"], "equal_rows": rep["equal_rows"],
            "diff_rows": rep["diff_rows"],
            "diff_rows_at_cdf_step": rep["diff_rows_at_cdf_step"],
            "rows_zero_residual": int((z <= 0).sum()),
            "rows_no_crossing": int((u.cpu() >= 1).sum()),
            "tie_across_chunks": (len(tied) == 2
                                  and tied[0] // chunk != tied[1] // chunk),
            "ms": cases.time_ms(lambda: rs.residual_sample_cuda(p, q, u)),
            "plain_ms": cases.time_ms(lambda: rs.residual_sample_plain(p, q, u),
                                      iters=10),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "ops": n_ops,
        }
        log(f"residual_sample {name:22s} N={N} V={V} ({n_chunks} chunks of "
            f"{chunk} a row, {N * n_chunks} blocks)  equal "
            f"{rep['equal_rows']}/{N} (differing rows {rep['diff_rows']} at a "
            f"CDF step: {rep['diff_rows_at_cdf_step']})  Z=0 rows "
            f"{rec['rows_zero_residual']} (tie across chunks "
            f"{rec['tie_across_chunks']})  no-crossing rows "
            f"{rec['rows_no_crossing']}  second call equal "
            f"{rec['second_call_equal']}  kernel {rec['ms']:.4f} ms  "
            f"plain {rec['plain_ms']:.4f} ms  library none  "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        tok = got.cpu()
        if not rep["diff_rows_at_cdf_step"] or not rec["second_call_equal"]:
            raise AssertionError(f"residual_sample {name}: {rep}, second call "
                                 f"equal {rec['second_call_equal']}")
        if not (int(tok[0]) == int(p[0].argmax()) and int(tok[2]) == V - 1
                and int(tok[1]) == int(p[1].argmax()) == tied[0]):
            raise AssertionError(f"residual_sample {name}: the Z = 0 rows must "
                                 f"give the first argmax of p and the row "
                                 f"where nothing crosses V - 1: {tok.tolist()}")
        residual.append(rec)
    return softmax, residual


def check_contiguous_kernels(torch, cases, pa, pta, ta, ssd):
    """Phase 3, the contiguous layout's kernels against their plain
    versions; returns (tree attention, ssd scan) records."""
    tree = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    runs = [(name, dict(zip("B J L H KV D S ctx".split(), shape)), chain,
             dtype, {})
            for name, shape, chain in CONTIGUOUS_TREE_CASES
            for dtype in (torch.float32, torch.bfloat16)]
    runs += [(f"split: {name}" + (", chain" if chain else ""),
              dict(zip("B J L H KV D".split(), shape), S=keys, ctx=0), chain,
              torch.bfloat16,
              dict(lengths=lengths))
             for name, shape, lengths, keys in cases.TREE_SPLIT_CASES
             for chain in (False, True)]
    for name, shape, chain, dtype, extra in runs:
        args = cases.contiguous_tree_case(*shape.values(), dtype=dtype,
                                          device="cuda", chain=chain, **extra)
        plan = (ta.split_plan(args[0], args[1], pa.sm_count(args[0].device))
                if dtype == torch.bfloat16 else None)
        got = ta.tree_attention_cuda(*args).float()
        want = cases.contiguous_tree_held(*args)
        plain = ta.tree_attention_plain(*args).float()
        again = ta.tree_attention_cuda(*args).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        err_plain = float((got - plain).abs().max())
        rtol, atol = cases.PAGED_TOL[dtype]
        close = torch.allclose(got, want, rtol=rtol, atol=atol)
        err_b3 = None
        if chain:       # the same keys in 16-key pages through B3
            q, kc, vc, ln, mask = args
            kp, vp, table = cases.as_pages(kc, vc)
            b3 = pta.paged_tree_attention_cuda(q, kp, vp, table, ln,
                                               mask).float()
            err_b3 = float((got - b3).abs().max())
        n_bytes, n_ops = cases.contiguous_tree_work(*args)
        bound_ms, bound_by = cases.bound(n_bytes, n_ops, dtype)
        sq, sk, sv, smask = cases.contiguous_tree_sdpa_inputs(*args)
        rec = {
            "case": name, "dtype": str(dtype).replace("torch.", ""),
            "shape": dict(shape, T=shape["J"] * shape["L"] + 1, chain=chain,
                          lengths=args[3].tolist()),
            "split_plan": (dict(zip(("row_tile", "row_tiles", "n_split",
                                     "split_keys"), plan)) if plan else None),
            "max_abs_err": err, "rtol": rtol, "atol": atol,
            "max_abs_err_vs_plain_same_dtype": err_plain,
            "max_abs_err_vs_paged_tree_attention": err_b3,
            "second_call_equal": bool(torch.equal(got, again)),
            "ms": cases.time_ms(lambda: ta.tree_attention_cuda(*args)),
            "plain_ms": cases.time_ms(lambda: ta.tree_attention_plain(*args),
                                      iters=10),
            "library_ms": cases.time_ms(lambda: sdpa(sq, sk, sv,
                                                     attn_mask=smask)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "ops": n_ops,
        }
        log(f"tree_attention {name:30s} {rec['dtype']:8s} "
            + _split_note(plan)
            + f"max|err| {err:.3e} vs f32 plain (rtol {rtol}, atol {atol}), "
            f"{err_plain:.3e} vs {rec['dtype']} plain"
            + (f", {err_b3:.3e} vs paged_tree_attention" if chain else "")
            + f"  kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms  "
            f"sdpa {rec['library_ms']:.4f} ms  bound {bound_ms:.4f} ms "
            f"({bound_by})")
        if not close:
            raise AssertionError(f"tree_attention {name} {dtype}: kernel "
                                 f"disagrees with plain, max|err| {err}")
        if not rec["second_call_equal"]:
            raise AssertionError(f"tree_attention {name} {dtype}: a second "
                                 f"call gave other bits")
        if chain and err_b3 != 0.0:
            raise AssertionError(f"tree_attention {name} {dtype}: a chain "
                                 f"mask differs from paged_tree_attention "
                                 f"over the same keys by {err_b3}")
        tree.append(rec)
    try:                        # the kernel's limit is refused, not mis-run
        over = cases.contiguous_tree_case(1, 8, 8, 4, 2, 16, 128, 40,
                                          torch.float32, "cuda")
        ta.tree_attention_cuda(*over)
        raise AssertionError("tree_attention accepted a 65-token window")
    except ValueError as e:
        log(f"tree_attention T=65 refused: {e}")

    scan = []
    for name, (b, s, h, p, g, n, chunk), init in SSD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x, dt, A, B, C, st = cases.ssd_case(b, s, h, p, g, n, dtype, "cuda",
                                                init=init)
            plan = (ssd.split_plan(b, h, p, pa.sm_count(x.device))
                    if dtype == torch.bfloat16 else None)
            y, fs = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk,
                                      initial_state=st)
            y_want, fs_want = cases.ssd_scan_held(x, dt, A, B, C, chunk, st)
            y_plain, _ = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                            initial_state=st)
            again = (ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk,
                                       initial_state=st)
                     if dtype == torch.bfloat16 else (y, fs))
            torch.cuda.synchronize()
            err = float((y.float() - y_want).abs().max())
            err_state = float((fs - fs_want).abs().max())
            err_plain = float((y.float() - y_plain.float()).abs().max())
            rtol, atol = cases.SSD_TOL[dtype]
            srtol, satol = cases.SSD_STATE_TOL
            close = (torch.allclose(y.float(), y_want, rtol=rtol, atol=atol)
                     and torch.allclose(fs, fs_want, rtol=srtol, atol=satol))
            n_bytes, n_ops = cases.ssd_work(x, dt, A, B, C, chunk, st)
            bound_ms, bound_by = cases.bound(n_bytes, n_ops, dtype)
            rec = {
                "case": name, "dtype": str(dtype).replace("torch.", ""),
                "shape": dict(zip("b s h p g n chunk".split(),
                                  (b, s, h, p, g, n, chunk)),
                              initial_state=init),
                "max_abs_err": err, "rtol": rtol, "atol": atol,
                "max_abs_err_state": err_state, "state_rtol": srtol,
                "state_atol": satol,
                "max_abs_err_vs_plain_same_dtype": err_plain,
                "p_split": (dict(p_block=plan[0], n_slices=plan[1])
                            if plan else None),
                "second_call_equal": bool(torch.equal(y, again[0])
                                          and torch.equal(fs, again[1])),
                "ms": cases.time_ms(lambda: ssd.ssd_scan_cuda(
                    x, dt, A, B, C, chunk=chunk, initial_state=st)),
                "plain_ms": cases.time_ms(lambda: ssd.ssd_scan_plain(
                    x, dt, A, B, C, chunk=chunk, initial_state=st), iters=10),
                "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": n_bytes, "ops": n_ops,
            }
            log(f"ssd_scan {name:36s} {rec['dtype']:8s} "
                + (f"(p in {plan[1]} slice{'s' if plan[1] > 1 else ''} of "
                   f"{plan[0]}) " if plan else "")
                + f"max|err| y {err:.3e} "
                f"(rtol {rtol}, atol {atol}) state {err_state:.3e} vs f32 plain, "
                f"y {err_plain:.3e} vs {rec['dtype']} plain  kernel "
                f"{rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms  library "
                f"none  bound {bound_ms:.4f} ms ({bound_by})")
            if not close:
                raise AssertionError(f"ssd_scan {name} {dtype}: kernel disagrees "
                                     f"with plain, y {err}, state {err_state}")
            if not rec["second_call_equal"]:
                raise AssertionError(f"ssd_scan {name} {dtype}: a second call "
                                     f"gave other bits")
            scan.append(rec)
    return tree, scan


def check_decode_kernels(torch, cases, pa, ta, da, fa):
    """Phase 3, decode attention (B7) and flash attention (B8) against
    their plain versions at the path shapes and the edge cases; bf16 B7
    also called twice (the same bits) and, at B6's head dims, against B6
    with a one-row window at lengths - 1 (the same bits on every row with
    1 <= lengths <= S); returns (decode, flash) records."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    decode, flash = [], []
    for name, shape in DECODE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = cases.decode_case(*shape, dtype=dtype, device="cuda")
            q, kc, vc, ln = args
            bf16 = dtype == torch.bfloat16
            plan = (da.split_plan(q, kc, pa.sm_count(q.device)) if bf16
                    else None)
            out = da.decode_attention_cuda(*args)
            got = out.float()
            want = cases.decode_attention_held(*args)
            plain = da.decode_attention_plain(*args).float()
            again = da.decode_attention_cuda(*args) if bf16 else out
            b6_rows = (ln >= 1) & (ln <= kc.shape[1])
            b6_equal = None
            if bf16 and q.shape[-1] in ta.HEAD_DIMS:
                b6 = ta.tree_attention_cuda(
                    q[:, None].contiguous(), kc, vc, ln - 1,
                    torch.ones((q.shape[0], 1, 1), dtype=torch.bool,
                               device=q.device))[:, 0]
                b6_equal = bool(torch.equal(out[b6_rows], b6[b6_rows]))
            torch.cuda.synchronize()
            live = ln > 0
            if got[~live].any():
                raise AssertionError(f"decode_attention {name} {dtype}: a row "
                                     f"of length 0 is not 0")
            n_bytes, n_ops = cases.decode_work(*args)
            sq, sk, sv, kw = cases.decode_sdpa_inputs(*args)
            rec = _attention_record(
                torch, cases, name, dtype, dict(zip("B H KV D S".split(),
                                                    shape[:5]),
                                                lengths=ln.tolist()),
                got[live], want[live], plain[live], n_bytes, n_ops,
                lambda: da.decode_attention_cuda(*args),
                lambda: da.decode_attention_plain(*args),
                lambda: sdpa(sq, sk, sv, **kw))
            rec.update(
                split_plan=(dict(zip(("row_tile", "row_tiles", "n_split",
                                      "split_keys"), plan)) if plan else None),
                dead_rows=int((~live).sum()),
                second_call_equal=bool(torch.equal(out, again)),
                equal_to_tree_attention_one_row=b6_equal)
            log(f"decode_attention {name:34s} {rec['dtype']:8s} "
                + _split_note(plan) + _attention_line(rec)
                + ("" if b6_equal is None else
                   f"; = B6 at one row, lengths - 1, bit for bit on "
                   f"{int(b6_rows.sum())} rows: {b6_equal}"))
            if not rec["second_call_equal"]:
                raise AssertionError(f"decode_attention {name} {dtype}: a "
                                     f"second call gave other bits")
            if b6_equal is False:
                raise AssertionError(f"decode_attention {name} {dtype}: "
                                     f"differs from B6 at one row")
            decode.append(rec)
    for name, (B, Sq, Skv, H, KV, D, causal) in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = cases.flash_case(B, Sq, Skv, H, KV, D, dtype, "cuda")
            got = fa.flash_attention_cuda(q, k, v, causal=causal).float()
            want = cases.flash_attention_held(q, k, v, causal=causal)
            plain = fa.flash_attention_plain(q, k, v, causal=causal).float()
            torch.cuda.synchronize()
            n_bytes, n_ops = cases.flash_work(q, k, v, causal=causal)
            sq, sk, sv, kw = cases.flash_sdpa_inputs(q, k, v, causal=causal)
            rec = _attention_record(
                torch, cases, name, dtype,
                dict(B=B, Sq=Sq, Skv=Skv, H=H, KV=KV, D=D, causal=causal),
                got, want, plain, n_bytes, n_ops,
                lambda: fa.flash_attention_cuda(q, k, v, causal=causal),
                lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                lambda: sdpa(sq, sk, sv, **kw))
            log(f"flash_attention  {name:34s} {rec['dtype']:8s} "
                + _attention_line(rec))
            flash.append(rec)
    return decode, flash


def check_q8_kernel(torch, cases, pa, da, daq):
    """Phase 3, int8 decode attention (B9) against its plain version at the
    path shapes and the edge rows, and against B7 on the unquantized caches;
    bf16 B9 also called twice (the same bits) and, at unit scales, against
    bf16 B7 on ``codes.to(bfloat16)`` (the same bits on every row); returns
    records."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q8 = []
    for name, shape in Q8_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = cases.q8_case(*shape, dtype=dtype, device="cuda")
            q, kq, vq, ks, vs, ln = args
            exact = cases.decode_case(*shape, dtype=dtype, device="cuda")
            live = args[-1] > 0
            bf16 = dtype == torch.bfloat16
            plan = (da.split_plan(q, kq, pa.sm_count(q.device)) if bf16
                    else None)
            out = daq.decode_attention_q8_cuda(*args)
            got = out
            want = cases.q8_held(*args)
            plain = daq.decode_attention_q8_plain(*args).float()
            b7 = da.decode_attention_cuda(*exact).float()
            again = daq.decode_attention_q8_cuda(*args) if bf16 else out
            codes_equal = None
            if bf16:
                ones = torch.ones_like(ks)
                codes_equal = bool(torch.equal(
                    daq.decode_attention_q8_cuda(q, kq, vq, ones, ones, ln),
                    da.decode_attention_cuda(q, kq.to(dtype), vq.to(dtype),
                                             ln)))
            torch.cuda.synchronize()
            if got.dtype != dtype or got[~live].any():
                raise AssertionError(f"decode_attention_q8 {name} {dtype}: "
                                     f"output {got.dtype}, a dead row not 0")
            got = got.float()
            err_b7 = float((got - b7)[live].abs().max())
            if not err_b7 < Q8_BUDGET:
                raise AssertionError(f"decode_attention_q8 {name} {dtype}: "
                                     f"{err_b7} from B7 on the exact caches")
            n_bytes, n_ops = cases.q8_work(*args)
            sq, sk, sv, kw = cases.q8_sdpa_inputs(*args)
            rec = _attention_record(
                torch, cases, name, dtype,
                dict(zip("B H KV D S".split(), shape[:5]),
                     lengths=args[-1].tolist()),
                got[live], want[live], plain[live], n_bytes, n_ops,
                lambda: daq.decode_attention_q8_cuda(*args),
                lambda: daq.decode_attention_q8_plain(*args), None)
            rec.update(
                split_plan=(dict(zip(("row_tile", "row_tiles", "n_split",
                                      "split_keys"), plan)) if plan else None),
                second_call_equal=bool(torch.equal(out, again)),
                unit_scales_equal_to_decode_attention_on_codes=codes_equal,
                dead_rows=int((~live).sum()),
                max_abs_err_vs_decode_attention_exact=err_b7,
                decode_attention_exact_ms=cases.time_ms(
                    lambda: da.decode_attention_cuda(*exact)),
                sdpa_dequantized_ms=cases.time_ms(lambda: sdpa(sq, sk, sv,
                                                               **kw)))
            log(f"decode_attention_q8 {name:33s} {rec['dtype']:8s} "
                + _split_note(plan) + _attention_line(rec)
                + f"; {err_b7:.3e} vs B7 on the exact caches (budget "
                f"{Q8_BUDGET}), B7 {rec['decode_attention_exact_ms']:.4f} ms, "
                f"sdpa over dequantized caches (not the same function) "
                f"{rec['sdpa_dequantized_ms']:.4f} ms"
                + ("" if codes_equal is None else
                   f"; unit scales = B7 on the codes bit for bit: "
                   f"{codes_equal}; second call equal "
                   f"{rec['second_call_equal']}"))
            if not rec["second_call_equal"] or codes_equal is False:
                raise AssertionError(f"decode_attention_q8 {name} {dtype}: a "
                                     f"second call gave other bits or unit "
                                     f"scales differ from B7 on the codes")
            q8.append(rec)
    return q8


def _split_note(plan):
    """How a bf16 window kernel cuts its work: row tile x tiles, splits."""
    if not plan:
        return ""
    return (f"(row tile {plan[0]} x {plan[1]}, {plan[2]} split"
            f"{'s' if plan[2] > 1 else ''} of {plan[3]} keys) ")


def _attention_record(torch, cases, name, dtype, shape, got, want, plain,
                      n_bytes, n_ops, kernel_fn, plain_fn, library_fn):
    """One case of an attention kernel held against its float32 plain
    version within ``cases.PAGED_TOL``, with its times and bound; raises
    when they disagree.  ``library_fn`` None: no single library call
    computes the function."""
    err = float((got - want).abs().max())
    rtol, atol = cases.PAGED_TOL[dtype]
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name} {dtype}: kernel disagrees with plain, "
                             f"max|err| {err}")
    bound_ms, bound_by = cases.bound(n_bytes, n_ops, dtype)
    return {
        "case": name, "dtype": str(dtype).replace("torch.", ""),
        "shape": shape, "max_abs_err": err, "rtol": rtol, "atol": atol,
        "max_abs_err_vs_plain_same_dtype": float((got - plain).abs().max()),
        "ms": cases.time_ms(kernel_fn),
        "plain_ms": cases.time_ms(plain_fn, iters=10),
        "library_ms": None if library_fn is None else cases.time_ms(library_fn),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": n_bytes, "ops": n_ops,
    }


def _attention_line(rec):
    lib = ("library none" if rec["library_ms"] is None
           else f"sdpa {rec['library_ms']:.4f} ms")
    return (f"max|err| {rec['max_abs_err']:.3e} vs f32 plain (rtol "
            f"{rec['rtol']}, atol {rec['atol']}), "
            f"{rec['max_abs_err_vs_plain_same_dtype']:.3e} vs {rec['dtype']} "
            f"plain  kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms"
            f"  {lib}  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def reference_check(torch, np):
    """Phase 4: the smoke-size engine on the card against the same engine on
    the CPU (plain versions), same weights and draws."""
    from repro_torch.configs import get_config
    from repro_torch.core.draws import RoundDraws, TreeDraws
    from repro_torch.serving import SpecEngine

    tcfg = get_config("qwen2.5-3b").smoke()
    dcfg = tcfg.replace(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                        head_dim=16, d_ff=64, name="draft-smoke")
    prompts = torch.from_numpy(
        np.random.default_rng(1).integers(0, 257, (3, 10)).astype(np.int32))
    committed = {}
    for dev in ("cpu", "cuda"):
        eng = SpecEngine(tcfg, dcfg, max_len=96, cache_kind="paged",
                         device=dev)
        eng.init_params(0)
        if dev == "cuda":            # the CPU engine's weights, moved over
            eng.t_params, eng.d_params = (
                _to(torch, p, "cuda") for p in ref_params)
        else:
            ref_params = (eng.t_params, eng.d_params)
        st = eng.start(prompts)
        for r, lengths in enumerate(([4, 2, 3], [1, 4, 4], [3, 3, 2])):
            draws = RoundDraws.sample(100 + r, 3, max(lengths), 64, 257,
                                      device="cpu").to(dev)
            st, _, _ = eng.spin_round(st, np.asarray(lengths), draws)
        # tree rounds: J=1 through the tree machinery, then J=2 and J=3
        for r, (J, lengths) in enumerate(((1, [4, 2, 3]), (2, [3, 4, 2]),
                                          (3, [2, 3, 4]))):
            L = max(lengths)
            draws = (RoundDraws.sample(200 + r, 3, L, 64, 257, device="cpu")
                     if J == 1 else
                     TreeDraws.sample(200 + r, 3, J, L, 64, 257, device="cpu"))
            st, _, _ = eng.spin_round(st, np.asarray(lengths), draws.to(dev),
                                      draft_width=J, tree=True)
            eng.t_pages.check_invariants()
            eng.d_pages.check_invariants()
        committed[dev] = [[int(t) for t in c] for c in st.committed]
    same = committed["cpu"] == committed["cuda"]
    log(f"reference check (smoke engine, 3 sequential + 3 tree rounds): card "
        f"== CPU committed tokens: {same}; lengths "
        f"{[len(c) for c in committed['cuda']]}")
    if not same:
        raise AssertionError(f"card {committed['cuda']} != CPU {committed['cpu']}")
    continuous_reference_check(torch, np, tcfg, dcfg, prompts)
    contiguous_reference_check(torch, np, dcfg, prompts)


def _paced_script(np, cont):
    """Phase 4's externally paced continuous sequence (rows 0-3: the start
    batch plus a late stream): 3 live rows in a ``-1``-padded bucket of 4,
    a commit out of dispatch order, a batch merged from two draft groups,
    a retire while that batch is in flight, and a last round on the
    survivors.  Returns (rows, accepted, committed) per commit."""
    out = []

    def land(batch):
        acc = cont.commit(batch)
        out.append((list(batch.ticket.rows), [int(a) for a in acc],
                    [[int(t) for t in c] for c in cont.state.committed]))
        cont.engine.t_pages.check_invariants()
        cont.engine.d_pages.check_invariants()

    first = cont.dispatch_round([0, 1, 2], [3, 2, 4])    # bucket (4, 4)
    second = cont.dispatch_round([3], [4])
    land(second)                                         # out of order
    land(first)
    f = cont.fsm
    cont._dispatch_draft_group([f[0]], np.array([4]))
    cont._dispatch_draft_group([f[1], f[2]], np.array([2, 4]))
    merged = cont._dispatch_verify([f[0], f[1]])         # two draft groups
    rest = cont._dispatch_verify([f[2]])
    cont.retire(1)                                       # mid-verify
    land(rest)
    land(merged)
    land(cont.dispatch_round([0, 2, 3], [4, 4, 4]))
    assert out[3][0] == [0, 1] and out[3][1][1] == 0, out[3]
    return out


def continuous_reference_check(torch, np, tcfg, dcfg, prompts):
    """Phase 4, continuous batching: the smoke-size paged engine under
    ``ContinuousEngine`` on the card against the same on the CPU, the same
    weights and the same draws (``KeyedDraws`` on the CPU, moved over): a
    forced-barrier session of three steps, then the externally paced
    sequence.  Committed tokens and accepted counts must be identical."""
    from repro_torch.core.draws import KeyedDraws
    from repro_torch.kernels import ops
    from repro_torch.serving import SpecEngine
    from repro_torch.serving.continuous import ContinuousEngine

    late = torch.from_numpy(
        np.random.default_rng(3).integers(0, 257, (1, 7)).astype(np.int32))
    out = {}
    for dev in ("cpu", "cuda"):
        eng = SpecEngine(tcfg, dcfg, max_len=96, cache_kind="paged",
                         num_pages=36, device=dev)
        eng.init_params(0)
        if dev == "cuda":
            eng.t_params, eng.d_params = (_to(torch, p, "cuda")
                                          for p in ref_params)
        else:
            ref_params = (eng.t_params, eng.d_params)
        ops.reset_counts()
        cont = ContinuousEngine(eng, eng.start(prompts.to(dev)), 42,
                                max_inflight=1, exact_shapes=True,
                                draws=KeyedDraws("cpu"))
        for b in range(3):
            cont.add_stream(b, length=4)
        barrier = []
        for _ in range(3):
            evs = cont.step()
            assert len(evs) == 1, evs
            barrier.append(([int(a) for a in evs[0].accepted],
                            [[int(t) for t in c] for c in cont.state.committed]))
        st, rows = eng.add_streams(eng.start(prompts.to(dev)), late.to(dev))
        assert rows == [3]
        paced = _paced_script(np, ContinuousEngine(eng, st, 5,
                                                   draws=KeyedDraws("cpu")))
        out[dev] = (barrier, paced, {k: v for k, v in ops.counts().items()
                                     if v["kernel"] or v["plain"]})
    same = out["cpu"][:2] == out["cuda"][:2]
    log(f"reference check (continuous, smoke engine: forced barrier 3 steps, "
        f"paced sequence of 5 commits with a -1-padded bucket, a merged batch, "
        f"an out-of-order commit and a retire mid-verify): card == CPU "
        f"committed tokens and counts: {same}; accepted per commit "
        f"{[acc for _, acc, _ in out['cuda'][1]]}; card counts {out['cuda'][2]}")
    if not same:
        raise AssertionError(f"card {out['cuda'][:2]} != CPU {out['cpu'][:2]}")
    for op in ("paged_attention", "fused_verify_sample"):
        c = out["cuda"][2][op]
        assert c["kernel"] > 0 and c["plain"] == 0, out["cuda"][2]


CONTIGUOUS_CHECK_ROUNDS = {
    # target arch: [(J, tree, lengths), ...], contiguous layout
    "qwen2.5-3b": [(1, False, [4, 2, 3]), (1, False, [1, 4, 4]),
                   (1, False, [3, 3, 2]), (1, True, [4, 2, 3]),
                   (2, True, [3, 4, 2]), (3, True, [2, 3, 4])],
    "mamba2-130m": [(1, False, [4, 2, 3]), (1, False, [1, 4, 4]),
                    (1, False, [3, 3, 2])],
    "zamba2-2.7b": [(1, False, [4, 2, 3]), (1, False, [1, 4, 4]),
                    (1, False, [3, 3, 2])],
}


def contiguous_reference_check(torch, np, dcfg, prompts):
    """Phase 4, contiguous: the dense smoke engine's J=1 and tree rounds and
    the mamba2 / zamba2 smoke targets' J=1 rounds, card against CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core.draws import RoundDraws, TreeDraws
    from repro_torch.kernels import ops
    from repro_torch.serving import SpecEngine

    for arch, rounds in CONTIGUOUS_CHECK_ROUNDS.items():
        tcfg = get_config(arch).smoke()
        committed, launched = {}, {}
        for dev in ("cpu", "cuda"):
            eng = SpecEngine(tcfg, dcfg, max_len=96, device=dev)
            eng.init_params(0)
            if dev == "cuda":
                eng.t_params, eng.d_params = (_to(torch, p, "cuda")
                                              for p in ref_params)
            else:
                ref_params = (eng.t_params, eng.d_params)
            ops.reset_counts()
            st = eng.start(prompts.to(dev))
            for r, (J, tree, lengths) in enumerate(rounds):
                L = max(lengths)
                draws = (RoundDraws.sample(300 + r, 3, L, 64, 257, device="cpu")
                         if J == 1 else
                         TreeDraws.sample(300 + r, 3, J, L, 64, 257,
                                          device="cpu"))
                h0 = eng.host_syncs
                st, _, _ = eng.spin_round(st, np.asarray(lengths),
                                          draws.to(dev), draft_width=J,
                                          tree=tree)
                assert eng.host_syncs - h0 == (2 if tree else 1)
            committed[dev] = [[int(t) for t in c] for c in st.committed]
            launched[dev] = {k: v["kernel"] for k, v in ops.counts().items()
                             if v["kernel"]}
            if dev == "cuda":
                assert all(v["plain"] == 0 for v in ops.counts().values()), \
                    ops.counts()
        for op in ("decode_attention", "flash_attention"):
            assert launched["cuda"].get(op, 0) > 0, (arch, op, launched)
        same = committed["cpu"] == committed["cuda"]
        log(f"reference check (contiguous, {arch} smoke target, "
            f"{len(rounds)} rounds): card == CPU committed tokens: {same}; "
            f"lengths {[len(c) for c in committed['cuda']]}; card launches "
            f"{launched['cuda']}")
        if not same:
            raise AssertionError(f"{arch}: card {committed['cuda']} != CPU "
                                 f"{committed['cpu']}")


def serving_engine_reference_check(torch, np):
    """Phase 4, the plain engine: the smoke-size ``ServingEngine`` on the
    card (B8 in start, B7 every step) against the same engine on the CPU,
    same weights, greedy and sampled with the same Gumbel noise."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving import ServingEngine

    cfg = get_config("deepseek-7b").smoke()
    prompts = torch.from_numpy(
        np.random.default_rng(2).integers(0, 257, (3, 9)).astype(np.int32))
    noise = -torch.empty((6, 3, cfg.vocab_size)).exponential_(
        generator=torch.Generator().manual_seed(4)).log()
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, max_len=48, device=dev)
        eng.init_params(0)
        if dev == "cuda":
            eng.params = _to(torch, ref_params, "cuda")
        else:
            ref_params = eng.params
        ops.reset_counts()
        greedy = eng.generate(prompts.to(dev), 6, temperature=0)
        sampled = eng.generate(prompts.to(dev), 6, noise.to(dev),
                               temperature=0.8)
        out[dev] = ([[int(t) for t in c] for c in greedy],
                    [[int(t) for t in c] for c in sampled],
                    {k: v for k, v in ops.counts().items()
                     if v["kernel"] or v["plain"]})
    same = out["cpu"][:2] == out["cuda"][:2]
    log(f"reference check (plain ServingEngine, deepseek-7b smoke, greedy "
        f"and sampled, 6 steps each): card == CPU committed tokens: {same}; "
        f"card counts {out['cuda'][2]}")
    if not same:
        raise AssertionError(f"card {out['cuda'][:2]} != CPU {out['cpu'][:2]}")
    for op in ("decode_attention", "flash_attention"):
        c = out["cuda"][2].get(op, {"kernel": 0, "plain": 0})
        assert c["kernel"] > 0 and c["plain"] == 0, out["cuda"][2]


def _to(torch, tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    return [_to(torch, v, device) for v in tree]


def main_path(torch, np, ops, tcfg, dcfg, cache_dtype, *, label, scheme,
              scheme_params, path_ops, syncs, min_width, n_rounds,
              cache_kind="paged", start_ops=None, device="cuda", K=8, M=128,
              NEW=64, max_len=1024, profile_start=()):
    """Phases 5-8: one serving path at full width, through the cell.
    Counters are set to 0 just before ``start()``; ``start_ops`` maps the
    kernels the prefill must launch to their launch count, ``path_ops`` are
    the kernels every round must launch; every plain counter must stay 0.
    With ``profile_start`` (op names), ``start()`` runs under torch.profiler
    and the device ms of each named op's kernels in it is printed.
    Returns (launch counts, per-round records, launch counts of start)."""
    from repro_torch.api import (
        CellConfig,
        ChannelConfig,
        EngineBackend,
        MultiSpinCell,
        Request,
        SpecEngine,
    )

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = SpecEngine(tcfg, dcfg, max_len=max_len, cache_dtype=cache_dtype,
                        cache_kind=cache_kind, page_size=16, device=device)
    engine.init_params(0)
    paged = cache_kind == "paged"
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, tcfg.vocab_size, (K, M), generator=gen,
                            device=device, dtype=torch.int32)
    torch.cuda.synchronize()
    ops.reset_counts()
    t1 = time.perf_counter()
    if profile_start:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state = engine.start(prompts)
            torch.cuda.synchronize()
    else:
        state = engine.start(prompts)
    torch.cuda.synchronize()
    at_start = ops.counts()
    started = {k: v["kernel"] for k, v in at_start.items() if v["kernel"]}
    for op in profile_start:
        hit = [e for e in prof.key_averages() if op in e.key
               and str(getattr(e, "device_type", "")).endswith("CUDA")]
        ms = sum(_dev_us(e) for e in hit) / 1e3
        calls = sum(e.count for e in hit)
        START_PROFILES[(label, op)] = {"device_ms": ms, "calls": calls,
                                       "launches": at_start[op]["kernel"]}
        log(f"{label}: {op} in start(): {at_start[op]['kernel']} launches, "
            f"profiled {calls} kernel calls taking {ms:.3f} device ms per "
            f"admission (profiler on)")
    for op, n in (start_ops or {}).items():
        assert at_start[op]["kernel"] == n, (op, n, at_start)
    assert all(c["plain"] == 0 for c in at_start.values()), at_start
    log(f"{label}: weights in {t1 - t0:.2f} s, {cache_kind} prefill of "
        f"{K}x{M} in {time.perf_counter() - t1:.2f} s"
        + (f"; pool {engine.num_pages} pages" if paged else "")
        + f"; params target {engine.target.num_params(engine.t_params)} "
        f"draft {engine.draft.num_params(engine.d_params)}; cache bytes "
        f"{engine.pool_stats()['cache_bytes']}; device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; launches in "
        f"start() {started}")
    backend = EngineBackend(engine, state)
    rng = np.random.default_rng(0)
    cfg = CellConfig(scheme=scheme, scheme_params=dict(scheme_params),
                     channel=ChannelConfig(vocab_size=tcfg.vocab_size),
                     t_ver_fix=0.035, t_ver_lin=0.0177, L_max=8, max_batch=K)
    cell = MultiSpinCell(cfg, backend=backend, rng=rng)
    host_prompts = prompts.cpu().numpy()
    for i in range(K):
        cell.submit(Request(rid=i, prompt_len=M, max_new_tokens=NEW,
                            alpha=float(rng.choice([0.71, 0.74, 0.86])),
                            T_S=0.009 * float(rng.uniform(0.85, 1.15)),
                            prompt=tuple(int(t) for t in host_prompts[i])))

    torch.cuda.synchronize()
    rounds, total_tokens, total_s = [], 0, 0.0
    for i in range(n_rounds):
        before = ops.counts()
        h0 = engine.host_syncs
        lens0 = [len(c) if c is not None else 0 for c in backend.state.committed]
        t = time.perf_counter()
        rec = cell.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if rec is None:
            break
        after = ops.counts()
        active = np.asarray(rec.active, dtype=bool)
        acc = np.asarray(rec.accepted)
        grew = [len(c) - l0 for c, l0 in zip(backend.state.committed, lens0)]
        assert (acc[active] >= 1).all(), f"round {i}: a stream committed nothing"
        assert rec.draft_width >= min_width, (i, rec.draft_width)
        for op in path_ops:
            assert after[op]["kernel"] > before[op]["kernel"], (i, op, after)
        for op in ops.OPS:
            assert after[op]["plain"] == 0, (i, op, after)
        if paged:
            engine.t_pages.check_invariants()
            engine.d_pages.check_invariants()
        assert engine.host_syncs - h0 == syncs, \
            f"round {i}: {engine.host_syncs - h0} syncs"
        assert sum(grew) == int(acc.sum()), (grew, acc)
        total_tokens += int(acc.sum())
        total_s += dt
        rounds.append({"round": i, "ms": 1e3 * dt, "J": int(rec.draft_width),
                       "lengths": rec.lengths.tolist(),
                       "accepted": acc.tolist(), "committed": int(acc.sum())})
        log(f"{label} round {i:2d}: {1e3 * dt:9.2f} ms  J={rec.draft_width}  "
            f"L={rec.lengths.tolist()}  accepted={acc.tolist()}  committed "
            f"{int(acc.sum())}  active {len(cell.scheduler.active)}")
    counts = ops.counts()
    for op in path_ops:
        assert counts[op]["kernel"] > 0, counts
    assert all(c["plain"] == 0 for c in counts.values()), counts
    assert len(rounds) == n_rounds, f"{label}: drained after {len(rounds)} rounds"
    profile_rounds(torch, cell.step, PROFILE_ROUNDS, label)
    vocab = tcfg.vocab_size
    for c in backend.state.committed:
        assert c is None or all(0 <= int(t) < vocab for t in c)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: {len(rounds)} rounds, {total_tokens} tokens in "
        f"{total_s:.3f} s wall = {total_tokens / total_s:.2f} tokens/s; "
        f"mean round {1e3 * total_s / len(rounds):.2f} ms; "
        f"peak memory {peak / 2**30:.2f} GiB; launches {counts}; "
        f"summary {cell.summary()}")
    return counts, rounds, at_start


def continuous_path(torch, np, ops, tcfg, dcfg, cache_dtype, j1, *, K=8,
                    M=128, NEW=64, max_len=1024, checked=CONTINUOUS_CHECKED):
    """Phase 11: continuous batching at full width.  ``ContinuousBackend``
    over a paged engine under ``MultiSpinCell(schedule="continuous",
    max_inflight=2)``, K requests of M-token prompts asking NEW tokens,
    ``T_S`` alternating 0.004 / 0.03 so that ready sets churn; one request
    leaves while its batch is in flight.  Per committed batch: every live
    member commits >= 1 token, each verification batch dispatched launches
    B2 exactly once and B1, every plain counter stays 0, both pools pass
    their invariants, one host sync per collect, occupancy in (0, 1].
    Counters are set to 0 just before ``start()`` and read after
    ``checked`` batches; 3 batches are profiled; the session then drains
    under the same checks and every page must be back.  Last, a forced
    barrier (``max_inflight=1, exact_shapes=True``) of 3 steps restarted
    from the same prompts must commit the tokens of 3 ``spin_round``s fed
    the same draws.  Returns (launch counts, per-batch records, launch
    counts of start)."""
    from repro_torch.api import (
        CellConfig,
        ChannelConfig,
        ContinuousBackend,
        MultiSpinCell,
        Request,
        SpecEngine,
    )
    from repro_torch.core.draws import KeyedDraws, RoundDraws
    from repro_torch.serving.continuous import ContinuousEngine

    label = "continuous path"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = SpecEngine(tcfg, dcfg, max_len=max_len, cache_dtype=cache_dtype,
                        cache_kind="paged", page_size=16, device="cuda")
    engine.init_params(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, tcfg.vocab_size, (K, M), generator=gen,
                            device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    ops.reset_counts()
    t1 = time.perf_counter()
    state = engine.start(prompts)
    torch.cuda.synchronize()
    at_start = ops.counts()
    assert all(c["plain"] == 0 for c in at_start.values()), at_start
    log(f"{label}: weights in {t1 - t0:.2f} s, paged prefill of {K}x{M} in "
        f"{time.perf_counter() - t1:.2f} s; pool {engine.num_pages} pages")
    backend = ContinuousBackend(engine, state, max_inflight=2, max_batch=K)
    cont = backend.cont
    rng = np.random.default_rng(0)
    cfg = CellConfig(scheme="hete", schedule="continuous", max_batch=K,
                     max_inflight=2, channel=ChannelConfig(
                         vocab_size=tcfg.vocab_size),
                     t_ver_fix=0.035, t_ver_lin=0.0177, L_max=8)
    cell = MultiSpinCell(cfg, backend=backend, rng=rng)
    host_prompts = prompts.cpu().numpy()
    for i in range(K):
        cell.submit(Request(rid=i, prompt_len=M, max_new_tokens=NEW,
                            alpha=float(rng.choice([0.71, 0.74, 0.86])),
                            T_S=0.004 if i % 2 else 0.03,
                            prompt=tuple(int(t) for t in host_prompts[i])))

    def batches():
        return len(cont.commits) + len(cont._inflight)

    left = None
    records, total_tokens, total_s = [], 0, 0.0

    def checked_step(i):
        nonlocal left, total_tokens, total_s
        before, n_before = ops.counts(), batches()
        lens0 = [len(c) if c is not None else 0 for c in backend.state.committed]
        t = time.perf_counter()
        rec = cell.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if rec is None:
            return None
        after, dispatched = ops.counts(), batches() - n_before
        acc, active = np.asarray(rec.accepted), np.asarray(rec.active, bool)
        assert (acc[active] >= 1).all(), f"batch {i}: a member committed nothing"
        assert after["fused_verify_sample"]["kernel"] \
            - before["fused_verify_sample"]["kernel"] == dispatched, (i, after)
        if dispatched:
            assert after["paged_attention"]["kernel"] \
                > before["paged_attention"]["kernel"], (i, after)
        for op in ops.OPS:
            assert after[op]["plain"] == 0, (i, op, after)
        engine.t_pages.check_invariants()
        engine.d_pages.check_invariants()
        assert rec.n_host_syncs == 1, (i, rec.n_host_syncs)
        assert 0 < rec.batch_occupancy <= 1, rec.batch_occupancy
        grew = [len(c) - l0 if c is not None else 0
                for c, l0 in zip(backend.state.committed, lens0)]
        assert sum(grew) == int(acc.sum()), (grew, acc)
        if left is None and i >= 2 and cell._cont_inflight:
            # a request leaves while its batch is on the card: its pages
            # come back at once, the batch skips it at commit
            rid = cell._cont_inflight[0]["rids"][0]
            row = backend._row_of[rid]
            cell.leave(rid)
            assert (engine.t_pages.page_table([row]) == -1).all()
            assert (engine.d_pages.page_table([row]) == -1).all()
            left = (i, rid)
        total_tokens += int(acc.sum())
        total_s += dt
        return {"batch": i, "ms": 1e3 * dt, "rids": rec.rids.tolist(),
                "lengths": rec.lengths.tolist(), "accepted": acc.tolist(),
                "committed": int(acc.sum()), "dispatched": dispatched,
                "occupancy": float(rec.batch_occupancy),
                "ready_depth": int(rec.ready_depth)}

    torch.cuda.synchronize()
    for i in range(checked):
        r = checked_step(i)
        assert r is not None, f"{label}: drained after {i} batches"
        records.append(r)
        log(f"{label} batch {i:2d}: {r['ms']:9.2f} ms  rids {r['rids']}  "
            f"L={r['lengths']}  accepted={r['accepted']}  dispatched "
            f"{r['dispatched']}  occupancy {r['occupancy']:.3f}  ready "
            f"{r['ready_depth']}")
    assert left is not None, "no request left while its batch was in flight"
    counts = ops.counts()
    for op in ("paged_attention", "fused_verify_sample"):
        assert counts[op]["kernel"] > at_start[op]["kernel"], counts
    profile_rounds(torch, cell.step, PROFILE_ROUNDS, label, unit="batch")
    mean_ms = total_s * 1e3 / len(records)
    j1_ms = sum(r["ms"] for r in j1[1]) / len(j1[1])
    j1_tok = sum(r["committed"] for r in j1[1]) / (j1_ms / 1e3 * len(j1[1]))
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: {len(records)} checked batches, {total_tokens} tokens in "
        f"{total_s:.3f} s = {total_tokens / total_s:.2f} tokens/s, mean batch "
        f"{mean_ms:.2f} ms (J=1 lockstep path: mean round {j1_ms:.2f} ms, "
        f"{j1_tok:.2f} tokens/s); request {left[1]} left at batch {left[0]}; "
        f"peak memory {peak / 2**30:.2f} GiB; launches {counts}")
    n = len(records)
    while True:
        n_before = len(cell.history)
        r = checked_step(n)
        if r is None:
            break
        n += 1
        assert len(cell.history) == n_before + 1
    assert not cell.scheduler.active and not cell.scheduler.queue
    engine.t_pages.check_invariants()
    engine.d_pages.check_invariants()
    assert engine.t_pages.num_free_pages == engine.d_pages.num_free_pages \
        == engine.num_pages, engine.pool_stats()
    log(f"{label}: drained after {n} batches (summary {cell.summary()}); "
        f"every page back: {engine.pool_stats()}")

    # the forced barrier against lockstep, same prompts and draws
    draws, L = KeyedDraws("cuda"), 4
    cont = ContinuousEngine(engine, engine.start(prompts), 42, max_inflight=1,
                            exact_shapes=True, draws=draws)
    for b in range(K):
        cont.add_stream(b, length=L)
    for _ in range(3):
        cont.step()
    barrier = [[int(t) for t in c] for c in cont.state.committed]
    st = engine.start(prompts)
    for r in range(3):
        k = (42, ("fold", r))
        st, _, _ = engine.spin_round(st, np.full(K, L), RoundDraws(
            draws.draft(k + (("split", 0),), L, K, 64),
            *draws.verify(k + (("split", 1),), K, L, tcfg.vocab_size)))
    lockstep = [[int(t) for t in c] for c in st.committed]
    same = barrier == lockstep
    log(f"{label}: forced barrier (3 steps, max_inflight=1, exact shapes) == "
        f"3 spin_rounds with the same draws: {same}; committed lengths "
        f"{[len(c) for c in barrier]}")
    if not same:
        raise AssertionError(f"barrier {barrier} != lockstep {lockstep}")
    return counts, records, at_start


def gateway_path(torch, ops, *, n_requests=16):
    """Phase 12: the port launcher's cell (``build_cell`` with ``--backend
    engine --arch llama2-7b --max-len 1024 --max-batch 8 --L-max 8``, on the
    card) behind ``MultiSpinGateway`` on 127.0.0.1, ``run_loadgen`` of
    ``n_requests`` at 32/s, prompts of 8 tokens (the launcher's start
    prompts: a start row streams from the request's ``prompt_len`` on,
    ROADMAP §C).  No request may fail; each one's streamed token
    ids must equal the engine's committed tokens of its stream up to its
    cap; ``/metrics`` must parse; B1 and B2 launch and no plain version
    runs; the pools pass their invariants.  Counters are set to 0 just
    before ``build_cell`` (which runs ``start()``) and read after the
    burst.  Returns (launch counts, [the session's record], launch counts
    of start)."""
    import asyncio
    import re

    from repro_torch.api import Request
    from repro_torch.launch import gateway as launcher
    from repro_torch.serving.gateway import (
        GatewayClient,
        GatewayConfig,
        LoadGenConfig,
        MultiSpinGateway,
        run_loadgen,
    )
    from repro_torch.serving.gateway import client as gclient

    label = "gateway path"
    args = launcher.parser().parse_args(
        ["--backend", "engine", "--arch", "llama2-7b", "--max-len", "1024",
         "--max-batch", "8", "--L-max", "8"])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    cell = launcher.build_cell(args)
    torch.cuda.synchronize()
    at_start = ops.counts()
    backend, engine = cell.backend, cell.backend.engine
    log(f"{label}: build_cell(--backend engine --arch llama2-7b --max-len "
        f"1024 --max-batch 8 --L-max 8) in "
        f"{time.perf_counter() - t0:.2f} s: target {engine.target_cfg.name} "
        f"{engine.target_cfg.param_dtype}, draft {engine.draft_cfg.name}, "
        f"device {engine.device}, pool {engine.num_pages} pages")
    final, streamed = {}, {}
    drop = backend.drop_finished

    def keep_then_drop(rid):
        final[rid] = backend.stream_tokens(rid)
        drop(rid)

    backend.drop_finished = keep_then_drop
    generate = gclient.GatewayClient.generate

    async def recording_generate(self, **kw):
        res = await generate(self, **kw)
        streamed[res.rid] = list(res.tokens)
        return res

    async def session():
        gw = MultiSpinGateway(cell, GatewayConfig(port=0, idle_wait_s=0.02))
        await gw.start()
        try:
            gclient.GatewayClient.generate = recording_generate
            report = await run_loadgen(
                "127.0.0.1", gw.port,
                LoadGenConfig(rate_per_s=32.0, n_requests=n_requests,
                              prompt_len_choices=(8,),
                              max_new_tokens_choices=(4, 8), seed=0))
        finally:
            gclient.GatewayClient.generate = generate
            text = await GatewayClient(port=gw.port).metrics()
            await gw.stop()
        return report, text

    t = time.perf_counter()
    report, text = asyncio.run(session())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.counts()
    assert report["n_error"] == 0, report["errors"]
    assert report["n_ok"] == n_requests, report
    for rec in report["records"]:
        toks = streamed[rec["rid"]]
        assert len(toks) == rec["tokens"] > 0, rec
        assert toks == final[rec["rid"]][:len(toks)], (rec, toks)
    line_re = re.compile(r"^(#.*|[a-z_]+(\{[^}]*\})? [0-9.eE+-]+)$")
    bad = [ln for ln in text.strip().splitlines() if not line_re.match(ln)]
    assert not bad and "multispin_rounds_total" in text, bad
    for op in ("paged_attention", "fused_verify_sample"):
        assert counts[op]["kernel"] > at_start[op]["kernel"], counts
    assert all(c["plain"] == 0 for c in counts.values()), counts
    engine.t_pages.check_invariants()
    engine.d_pages.check_invariants()
    rounds = [{"round": i, "committed": int(r.accepted.sum())}
              for i, r in enumerate(cell.history)]
    peak = torch.cuda.max_memory_allocated()
    rec = {"requests": n_requests, "rounds": len(rounds), "wall_s": wall,
           "tokens": report["tokens"], "tokens_per_s": report["tokens_per_s"],
           "ttft_p50_s": report["ttft_s"]["p50"],
           "ttft_p95_s": report["ttft_s"]["p95"],
           "latency_p95_s": report["latency_s"]["p95"]}
    log(f"{label}: {n_requests} requests at 32/s, {report['n_ok']} ok, "
        f"{report['n_error']} errors, {len(rounds)} rounds, {report['tokens']} "
        f"tokens in {wall:.2f} s; TTFT p50 {rec['ttft_p50_s']:.4f} s, p95 "
        f"{rec['ttft_p95_s']:.4f} s; {report['tokens_per_s']:.2f} tokens/s; "
        f"latency p95 {rec['latency_p95_s']:.4f} s; /metrics "
        f"{len(text.splitlines())} lines parsed; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {counts}")
    GATEWAY.update(rec)
    # the launcher's cell, stepped here as the gateway's worker thread steps
    # it, for the profile: 8 more requests, 3 rounds
    for i in range(8):
        cell.submit(Request(rid=10_000 + i, prompt_len=8, max_new_tokens=64,
                            alpha=0.8, T_S=0.009))
    profile_rounds(torch, cell.step, PROFILE_ROUNDS, label)
    return counts, rounds, at_start


def _dev_us(e):
    """Device microseconds of a profiler average (its own time)."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profile_rounds(torch, step, n, label, unit="round"):
    """Phase 5b: ``n`` more rounds (or steps) of the same session under
    torch.profiler (after the checked ones, so their counts are not mixed
    in): device busy time against host wall time, the kernels that take it,
    and the host<->device copies and syncs each makes.  ``step()`` returns
    None once the session has drained."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        done = 0
        for _ in range(n):
            if step() is None:
                break
            done += 1
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    if not done:
        log(f"{label} profile: the session had drained; nothing profiled")
        return
    avgs = prof.key_averages()
    dev_us = _dev_us
    kernels = [e for e in avgs if dev_us(e) > 0
               and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(dev_us(e) for e in kernels)
    by_op = {}
    for e in kernels:
        op = window_op(e.key)
        if op:
            ms, calls = by_op.get(op, (0.0, 0.0))
            by_op[op] = (ms + dev_us(e) / 1e3 / done, calls + e.count / done)
    PROFILES[label] = {"unit": unit, "device_busy_ms": busy / 1e3 / done,
                       "wall_ms": wall_us / 1e3 / done,
                       "idle_share": 1 - busy / wall_us, "window_ops": by_op}
    u = unit
    log(f"{label} profile: {done} {u}s, wall {wall_us / 1e3 / done:.2f} ms/{u} "
        f"(profiler on), device busy {busy / 1e3 / done:.2f} ms/{u}, "
        f"idle share {1 - busy / wall_us:.3f}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3 / done:9.3f} ms/{u}  {e.count / done:7.1f} "
            f"calls/{u}  {e.key[:90]}")
    for name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize",
                 "cudaDeviceSynchronize", "cudaHostAlloc"):
        hit = [e for e in avgs if e.key == name]
        if hit:
            log(f"  host: {name} {hit[0].count / done:.1f} calls/{u}, "
                f"{hit[0].cpu_time_total / 1e3 / done:.3f} ms/{u}")


def window_op(kernel_name):
    """The op of the port's window attention kernels (B1, B3, B6, B7, B9),
    of the verification kernel (B2) or of the samplers (B4, B5) that a
    profiler key names, else
    None: the bf16 body of ``csrc/window_attention_bf16.cuh`` is told apart
    by its key locator and mask policy, the float32 kernels by their
    names."""
    for op in ("fused_verify_sample", "gather_softmax_prob", "residual_sample"):
        if f"{op}_kernel" in kernel_name:
            return op
    if ("ContiguousCodes" in kernel_name
            or "::decode_attention_kernel<float, signed char" in kernel_name):
        return "decode_attention_q8"
    if "CausalRows" in kernel_name:
        return ("decode_attention" if "ContiguousKeys" in kernel_name
                else "paged_attention")
    if "::decode_attention_kernel<" in kernel_name:
        return "decode_attention"
    if "::paged_attention_kernel<" in kernel_name:
        return "paged_attention"
    if ("PagedKeys<false>" in kernel_name
            or "::paged_tree_attention_kernel<" in kernel_name):
        return "paged_tree_attention"
    if "ContiguousKeys" in kernel_name or "::tree_attention_kernel<" in kernel_name:
        return "tree_attention"
    return None


def plain_decode_path(torch, ops, cfg, *, K=8, M=128, steps=DECODE_STEPS,
                      max_len=1024, label="plain decode path"):
    """Phase 9: the plain (non-speculative) engine at full width: ``K``
    prompts of ``M`` tokens, ``steps`` sampled decode steps.  Counters are
    set to 0 just before ``start()``, which must launch B8 once per layer;
    every step launches B7 once per layer and makes one host fetch; every
    plain counter stays 0.  Returns ((launch counts, per-step records,
    launch counts of start), the engine, its last state).  Phase 15 runs
    it on ``gemma-7b`` (head dim 256) under its own ``label``."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import gumbel_noise

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, max_len=max_len, cache_dtype=torch.bfloat16)
    eng.init_params(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (K, M), generator=gen,
                            device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    ops.reset_counts()
    t1 = time.perf_counter()
    state = eng.start(prompts)
    torch.cuda.synchronize()
    at_start = ops.counts()
    assert at_start["flash_attention"]["kernel"] == cfg.num_layers, at_start
    assert all(c["plain"] == 0 for c in at_start.values()), at_start
    log(f"{label}: weights in {t1 - t0:.2f} s, contiguous prefill of {K}x{M} "
        f"in {time.perf_counter() - t1:.2f} s; params "
        f"{eng.model.num_params(eng.params)}; device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; launches in start() "
        f"{ {k: v['kernel'] for k, v in at_start.items() if v['kernel']} }")
    records, total_s = [], 0.0
    for i in range(steps):
        before = ops.counts()["decode_attention"]["kernel"]
        h0 = eng.host_syncs
        t = time.perf_counter()
        state, nxt = eng.decode_step(state, gumbel_noise(gen, (K, cfg.vocab_size)))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        assert ops.counts()["decode_attention"]["kernel"] - before \
            == cfg.num_layers
        assert eng.host_syncs - h0 == 1
        total_s += dt
        records.append({"step": i, "ms": 1e3 * dt})
    counts = ops.counts()
    assert all(c["plain"] == 0 for c in counts.values()), counts
    assert all(len(c) == M + steps for c in state.committed)
    assert all(0 <= int(t) < cfg.vocab_size for c in state.committed for t in c)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: {steps} steps of {K} streams, mean step "
        f"{1e3 * total_s / steps:.2f} ms, {K * steps / total_s:.2f} tokens/s; "
        f"peak memory {peak / 2**30:.2f} GiB; launches {counts}")
    holder = [state]

    def step():
        holder[0], _ = eng.decode_step(
            holder[0], gumbel_noise(gen, (K, cfg.vocab_size)))
        return True

    profile_rounds(torch, step, PROFILE_ROUNDS, label, unit="step")
    return (counts, records, at_start), eng, holder[0]


def int8_path(torch, ops, cases, da, daq, eng, state):
    """Phase 10: ``ops.quantize_kv`` then ``ops.decode_attention_q8`` over
    each layer's bf16 K/V view of the plain-decode engine's cache, at
    lengths ``state.pos``, one seeded bf16 query per layer.  Counters are set
    to 0 just before the 32-layer pass and read just after it: B9 once per
    layer, nothing else.  Then each layer is held against its plain version
    and compared with B7 on the bf16 slab.  Returns (launch counts, [the
    pass's record], launch counts at its start)."""
    label = "int8 path"
    cfg = eng.cfg
    lengths = state.pos
    S = eng.cache["k"].shape[2]
    assert 0 < int(lengths.min()) and int(lengths.max()) <= S, lengths
    gen = torch.Generator(device=eng.device).manual_seed(3)
    qs = [torch.randn((lengths.shape[0], cfg.num_heads, cfg.head_dim),
                      generator=gen, device=eng.device, dtype=torch.bfloat16)
          for _ in range(cfg.num_layers)]
    torch.cuda.synchronize()
    ops.reset_counts()
    at_start = ops.counts()
    t = time.perf_counter()
    layers = []
    for i, q in enumerate(qs):
        kq, ks, vq, vs = ops.quantize_kv(eng.cache["k"][i], eng.cache["v"][i])
        layers.append((q, kq, vq, ks, vs,
                       ops.decode_attention_q8(q, kq, vq, ks, vs, lengths)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    counts = ops.counts()
    assert counts["decode_attention_q8"]["kernel"] == cfg.num_layers, counts
    assert all(c["plain"] == 0 and (c["kernel"] == 0 or op == "decode_attention_q8")
               for op, c in counts.items()), counts
    rtol, atol = cases.PAGED_TOL[torch.bfloat16]
    errs, errs_b7 = [], []
    for i, (q, kq, vq, ks, vs, out) in enumerate(layers):
        want = cases.q8_held(q, kq, vq, ks, vs, lengths)
        b7 = da.decode_attention_cuda(q, eng.cache["k"][i], eng.cache["v"][i],
                                      lengths)
        errs.append(float((out.float() - want).abs().max()))
        errs_b7.append(float((out.float() - b7.float()).abs().max()))
        if out.dtype != torch.bfloat16 or not torch.allclose(
                out.float(), want, rtol=rtol, atol=atol):
            raise AssertionError(f"{label} layer {i}: kernel disagrees with "
                                 f"plain, max|err| {errs[-1]}")
    q, kq, vq, ks, vs, _ = layers[0]
    layer_ms = cases.time_ms(lambda: daq.decode_attention_q8_cuda(
        q, kq, vq, ks, vs, lengths))
    layer_plain_ms = cases.time_ms(lambda: daq.decode_attention_q8_plain(
        q, kq, vq, ks, vs, lengths), iters=10)
    layer_bound_ms, layer_bound_by = cases.bound(
        *cases.q8_work(q, kq, vq, ks, vs, lengths), torch.bfloat16)
    int8_bytes = sum(t.numel() * t.element_size()
                     for layer in layers for t in layer[1:5])
    bf16_bytes = sum(eng.cache[leaf].numel() * eng.cache[leaf].element_size()
                     for leaf in ("k", "v"))
    rec = {"layers": cfg.num_layers, "lengths": lengths.tolist(),
           "wall_ms": 1e3 * dt, "layer0_kernel_ms": layer_ms,
           "layer0_plain_ms": layer_plain_ms,
           "layer0_bound_ms": layer_bound_ms, "layer0_bound_by": layer_bound_by,
           "max_abs_err": max(errs), "rtol": rtol, "atol": atol,
           "max_abs_err_vs_decode_attention_bf16": max(errs_b7),
           "int8_slab_bytes": int8_bytes, "bf16_slab_bytes": bf16_bytes}
    log(f"{label}: {cfg.num_layers} layers of {tuple(eng.cache['k'].shape[1:])} "
        f"bf16 K/V through quantize_kv + decode_attention_q8 at lengths "
        f"{lengths.tolist()} in {1e3 * dt:.2f} ms wall; launches "
        f"{ {k: v for k, v in counts.items() if v['kernel'] or v['plain']} }; "
        f"max|err| vs f32 plain {max(errs):.3e} (rtol {rtol}, atol {atol}), "
        f"per layer {[f'{e:.1e}' for e in errs]}; vs B7 on the bf16 slab "
        f"{max(errs_b7):.3e}, per layer {[f'{e:.1e}' for e in errs_b7]}; "
        f"layer 0 kernel {layer_ms:.4f} ms, plain {layer_plain_ms:.4f} ms, "
        f"bound {layer_bound_ms:.4f} ms ({layer_bound_by}); slab bytes int8 "
        f"{int8_bytes} "
        f"(scales included) against bf16 {bf16_bytes}")
    return counts, [rec], at_start


SMOKE_LOGIT_TOL = 1e-4   # float32 logits, card against CPU (see below)


def moe_vlm_encdec_reference_check(torch, np):
    """Phase 4, the slice-12 models at smoke size, card against CPU with the
    same weights and draws: the MoE ``SpecEngine`` (``moonshot-v1-16b-a3b``
    smoke target, a leading dense block and shared experts, beside the
    dense smoke draft) on both layouts, 3 J=1 and 2 tree rounds (J = 2) in
    each commit mode: committed tokens equal across devices and across the
    commit modes; ``paligemma-3b`` (prefix embeds, both layouts) and
    ``whisper-large-v3`` (frames) smoke models: prefill and 3 one-token
    windows, the next tokens (argmax) equal and the float32 logits within
    ``SMOKE_LOGIT_TOL`` (the kernels' float32 band is 2e-5 per attention
    call; two layers of float32 products summed in other orders on the two
    devices move logits of magnitude ~1 by up to ~1e-5)."""
    from repro_torch.configs import get_config
    from repro_torch.core.draws import RoundDraws, TreeDraws
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import SpecEngine

    tcfg = get_config("moonshot-v1-16b-a3b").smoke()
    dcfg = get_config("qwen2.5-3b").smoke().replace(
        num_layers=1, d_model=32, num_heads=2, num_kv_heads=1, head_dim=16,
        d_ff=64, name="draft-smoke")
    prompts = torch.from_numpy(
        np.random.default_rng(3).integers(0, 257, (3, 10)).astype(np.int32))
    rounds = [(1, [4, 2, 3]), (1, [1, 4, 4]), (1, [3, 4, 2]), (2, [4, 3, 4]),
              (2, [2, 4, 3])]
    committed, ref_params = {}, None
    for layout in ("paged", "contiguous"):
        for commit in ("scatter", "repair"):
            for dev in ("cpu", "cuda"):
                eng = SpecEngine(tcfg, dcfg, max_len=96, cache_kind=layout,
                                 tree_commit=commit, device=dev)
                if ref_params is None:
                    eng.init_params(0)
                    ref_params = (eng.t_params, eng.d_params)
                else:
                    eng.t_params, eng.d_params = (_to(torch, p, dev)
                                                  for p in ref_params)
                ops.reset_counts()
                st = eng.start(prompts.to(dev))
                for r, (J, lengths) in enumerate(rounds):
                    L = max(lengths)
                    draws = (RoundDraws.sample(300 + r, 3, L, 64, 257,
                                               device="cpu") if J == 1 else
                             TreeDraws.sample(300 + r, 3, J, L, 64, 257,
                                              device="cpu"))
                    st, _, _ = eng.spin_round(st, np.asarray(lengths),
                                              draws.to(dev), draft_width=J)
                if dev == "cuda":
                    c = ops.counts()
                    assert all(v["plain"] == 0 for v in c.values()), c
                committed[(layout, commit, dev)] = [[int(t) for t in row]
                                                    for row in st.committed]
        same = all(committed[(layout, c, "cpu")] == committed[(layout, c, "cuda")]
                   for c in ("scatter", "repair"))
        modes = committed[(layout, "scatter", "cuda")] \
            == committed[(layout, "repair", "cuda")]
        log(f"reference check (MoE SpecEngine, moonshot smoke target, "
            f"{layout}, 3 J=1 + 2 tree rounds): card == CPU committed tokens "
            f"in both commit modes: {same}; scatter == repair: {modes}; "
            f"lengths {[len(c) for c in committed[(layout, 'scatter', 'cuda')]]}")
        if not (same and modes):
            raise AssertionError(f"MoE engine {layout}: {committed}")

    rng = np.random.default_rng(4)
    for arch in ("paligemma-3b", "whisper-large-v3"):
        cfg = get_config(arch).smoke()
        B, S = 3, 7
        P = cfg.num_patches if cfg.family == "vlm" else cfg.encoder_seq_len
        prefix = torch.from_numpy(
            rng.standard_normal((B, P, cfg.d_model)).astype(np.float32))
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
        layouts = ("contiguous", "paged") if cfg.family == "vlm" else (
            "contiguous",)
        for layout in layouts:
            logits, nxt = {}, None
            for dev in ("cpu", "cuda"):
                model = build_model(cfg, device=dev)
                if dev == "cpu":
                    params = model.init(0)
                    cpu_params = params
                else:
                    params = _to(torch, cpu_params, dev)
                if layout == "paged":
                    n_slots = 8
                    cache = dict(model.init_paged_cache(B * n_slots, 16,
                                                        torch.float32),
                                 pages=torch.arange(B * n_slots, dtype=torch.int32,
                                                    device=dev).reshape(B, n_slots))
                else:
                    cache = model.init_cache(B, 128, torch.float32)
                ops.reset_counts()
                out, cache, _ = model.prefill(params, tokens.to(dev), cache,
                                              prefix_embeds=prefix.to(dev))
                seq = [out[:, -1].float().cpu()]
                pos = torch.full((B,), out.shape[1], dtype=torch.int32,
                                 device=dev)
                for i in range(3):
                    step = (seq[-1].argmax(-1) if dev == "cpu"
                            else nxt[i]).to(dev, torch.int32)[:, None]
                    if dev == "cpu":
                        nxt = (nxt or []) + [step[:, 0].cpu()]
                    out, cache = model.forward_window(params, step, cache, pos)
                    seq.append(out[:, -1].float().cpu())
                    pos = pos + 1
                if dev == "cuda":
                    c = ops.counts()
                    assert all(v["plain"] == 0 for v in c.values()), c
                    launched = {k: v["kernel"] for k, v in c.items()
                                if v["kernel"]}
                logits[dev] = torch.stack(seq)
            err = float((logits["cpu"] - logits["cuda"]).abs().max())
            same = torch.equal(logits["cpu"].argmax(-1),
                               logits["cuda"].argmax(-1))
            log(f"reference check ({arch} smoke model, {layout}, prefill with "
                f"{P} prefix rows + 3 one-token windows): card == CPU next "
                f"tokens {same}; max|logits err| {err:.3e} (band "
                f"{SMOKE_LOGIT_TOL}); card launches {launched}")
            if not same or err > SMOKE_LOGIT_TOL:
                raise AssertionError(f"{arch} {layout}: tokens equal {same}, "
                                     f"logits err {err}")


MOE_J1_ROUNDS = 10
MOE_TREE_ROUNDS = 4
MOE_LEAVE_ROUND = 5
MOE_L = 4


def moe_path(torch, np, ops, *, K=8, M=128, NEW=64, max_len=512):
    """Phase 14: the MoE target at full width, bfloat16, paged:
    ``moonshot-v1-16b-a3b`` (48 layers, 64 experts top-6, two shared
    experts, one leading dense block, V = 163840) verifying a 2-layer dense
    draft at its widths and vocabulary (the target's config with
    ``family="dense"``, ``num_layers=2`` and the expert fields zeroed, not
    registered), both initialised on the card in bfloat16.  ``K`` requests
    of ``M``-token prompts under ``MultiSpinCell(scheme="hete")`` with
    ``L_max = MOE_L`` (each device's own length): ``MOE_J1_ROUNDS`` J=1
    rounds through ``cell.step``, request 3 leaving (``cell.leave``) before
    round ``MOE_LEAVE_ROUND`` with its pages back at once.  Then
    ``MOE_TREE_ROUNDS`` tree rounds (J = 2, L = ``MOE_L``, scatter commit)
    through ``spin_round`` on the cell's engine state with the departed row
    frozen: the cell's schemes plan one width a round and ``multidraft``,
    the cell's tree scheme, plans J and L for a dense pair's costs, so the
    width is fixed here.  Every J=1 round makes exactly one host sync, a
    tree round two; every live row commits >= 1 token; no plain call.  Then
    one MoE layer's ``moe_apply`` at the verify window's shape under
    ``torch.cuda.set_sync_debug_mode("error")`` (the dispatch makes no
    synchronizing call), 3 profiled J=1 cell rounds, and the drain (every
    request leaves): every page of both pools back.  Returns {"J=1": run,
    "tree": run}, each run (launch counts, per-round records, launch counts
    of start) of its own rounds only (the tree run's start is empty)."""
    from repro_torch.api import (
        CellConfig,
        ChannelConfig,
        EngineBackend,
        MultiSpinCell,
        Request,
    )
    from repro_torch.configs import get_config
    from repro_torch.core.draws import TreeDraws
    from repro_torch.models.layers import moe_apply
    from repro_torch.serving import SpecEngine

    label = "MoE path"
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    tcfg = get_config("moonshot-v1-16b-a3b").replace(**bf16)
    dcfg = tcfg.replace(name="moonshot-draft-2l", family="dense",
                        num_layers=2, num_experts=0, top_k=0, moe_d_ff=0,
                        num_shared_experts=0, shared_d_ff=0, first_k_dense=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = SpecEngine(tcfg, dcfg, max_len=max_len, cache_dtype=torch.bfloat16,
                     cache_kind="paged", page_size=16)
    eng.init_params(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, tcfg.vocab_size, (K, M), generator=gen,
                            device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    ops.reset_counts()
    t1 = time.perf_counter()
    st = eng.start(prompts)
    torch.cuda.synchronize()
    at_start = ops.counts()
    assert at_start["paged_attention"]["kernel"] == tcfg.num_layers \
        + dcfg.num_layers, at_start
    assert all(c["plain"] == 0 for c in at_start.values()), at_start
    log(f"{label}: weights in {t1 - t0:.2f} s, paged prefill of {K}x{M} in "
        f"{time.perf_counter() - t1:.2f} s; pool {eng.num_pages} pages; params "
        f"target {eng.target.num_params(eng.t_params)} draft "
        f"{eng.draft.num_params(eng.d_params)}; cache leaves "
        f"{sorted(eng.t_cache)}; cache bytes {eng.pool_stats()['cache_bytes']}; "
        f"device memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB; launches in start() "
        f"{ {k: v['kernel'] for k, v in at_start.items() if v['kernel']} }")
    V = tcfg.vocab_size
    backend = EngineBackend(eng, st)
    rng = np.random.default_rng(0)
    cell = MultiSpinCell(
        CellConfig(scheme="hete", channel=ChannelConfig(vocab_size=V),
                   t_ver_fix=0.035, t_ver_lin=0.0177, L_max=MOE_L,
                   max_batch=K),
        backend=backend, rng=rng)
    host_prompts = prompts.cpu().numpy()
    for i in range(K):
        cell.submit(Request(rid=i, prompt_len=M, max_new_tokens=NEW,
                            alpha=float(rng.choice([0.71, 0.74, 0.86])),
                            T_S=0.009 * float(rng.uniform(0.85, 1.15)),
                            prompt=tuple(int(t) for t in host_prompts[i])))
    left = 3
    path_ops = {1: ("paged_attention", "fused_verify_sample"),
                2: ("paged_attention", "paged_tree_attention",
                    "gather_softmax_prob", "residual_sample")}
    rounds = {1: [], 2: []}

    def lens():
        return [0 if c is None else len(c) for c in backend.state.committed]

    def one_round(i, J, run):
        before = ops.counts()
        h0 = eng.host_syncs
        lens0 = lens()
        t = time.perf_counter()
        acc, L = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = ops.counts()
        live = np.array([b != left or i < MOE_LEAVE_ROUND for b in range(K)])
        assert (acc[live] >= 1).all() and not acc[~live].any(), (i, acc)
        assert [n - n0 for n, n0 in zip(lens(), lens0)] == acc.tolist()
        assert eng.host_syncs - h0 == (1 if J == 1 else 2), \
            f"round {i}: {eng.host_syncs - h0} syncs"
        for op in path_ops[J]:
            assert after[op]["kernel"] > before[op]["kernel"], (i, op)
        assert all(c["plain"] == 0 for c in after.values()), after
        eng.t_pages.check_invariants()
        eng.d_pages.check_invariants()
        per = {op: after[op]["kernel"] - before[op]["kernel"]
               for op in ("paged_attention", "fused_verify_sample",
                          "paged_tree_attention", "gather_softmax_prob",
                          "residual_sample")}
        rounds[J].append({"round": i, "ms": 1e3 * dt, "J": J, "lengths": L,
                          "accepted": acc.tolist(),
                          "committed": int(acc.sum()), "launches": per})
        log(f"{label} round {i:2d}: {1e3 * dt:9.2f} ms  J={J}  L={L}  "
            f"accepted={acc.tolist()}  launches {per}")

    def cell_round():
        rec = cell.step()
        assert rec is not None and rec.draft_width == 1 and rec.active.all()
        acc = np.asarray(eng.last_accepted)   # per engine row, 0 if frozen
        assert int(acc.sum()) == int(np.sum(rec.accepted)), (acc, rec)
        return acc, rec.lengths.tolist()

    for i in range(MOE_J1_ROUNDS):
        if i == MOE_LEAVE_ROUND:
            held = (int((eng.t_pages.page_table([left]) >= 0).sum()),
                    int((eng.d_pages.page_table([left]) >= 0).sum()))
            free0 = (eng.t_pages.num_free_pages, eng.d_pages.num_free_pages)
            cell.leave(left)
            back = (eng.t_pages.num_free_pages - free0[0],
                    eng.d_pages.num_free_pages - free0[1])
            log(f"{label}: request {left} leaves before round {i}: pages "
                f"back at once (target, draft) {back} of {held} it held")
            assert back == held and held[0] > 0, (back, held)
        one_round(i, 1, cell_round)
    j1_counts = ops.counts()

    freeze = np.zeros(K, dtype=bool)
    freeze[left] = True

    def tree_round(i):
        def run():
            draws = TreeDraws.sample(700 + i, K, 2, MOE_L, 64, V,
                                     device="cuda")
            backend.state, _, _ = eng.spin_round(
                backend.state, np.full(K, MOE_L), draws, freeze=freeze,
                draft_width=2)
            return np.asarray(eng.last_accepted), [MOE_L] * K
        return run

    for i in range(MOE_J1_ROUNDS, MOE_J1_ROUNDS + MOE_TREE_ROUNDS):
        one_round(i, 2, tree_round(i))
    counts = ops.counts()
    peak = torch.cuda.max_memory_allocated()
    parts = []
    for J, kind in ((1, "J=1 rounds (hete)"), (2, "tree rounds (J=2)")):
        rs = rounds[J]
        ms = sum(r["ms"] for r in rs)
        parts.append(f"{len(rs)} {kind}, mean {ms / len(rs):.2f} ms, "
                     f"{sum(r['committed'] for r in rs) / ms * 1e3:.2f} "
                     f"tokens/s")
    log(f"{label}: " + "; ".join(parts) + f"; peak memory "
        f"{peak / 2**30:.2f} GiB")

    # the MoE dispatch at the verify window's shape makes no sync
    blk = eng.t_params["blocks"][0]
    x = torch.randn((K, MOE_L + 1, tcfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe_apply(blk["moe"], x, eng.target.moe_cfg,
                           capacity_factor=eng.target.no_drop_capacity)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.isfinite(aux)
    log(f"{label}: moe_apply at the verify window ({K}, {MOE_L + 1}, "
        f"{tcfg.d_model}) under set_sync_debug_mode('error'): no "
        f"synchronizing call")

    profile_rounds(torch, cell.step, PROFILE_ROUNDS, label)
    for r in list(cell.scheduler.active):
        cell.leave(r.rid)
    assert eng.t_pages.num_free_pages == eng.num_pages
    assert eng.d_pages.num_free_pages == eng.num_pages
    log(f"{label}: drained: every page of both pools back "
        f"({eng.num_pages} each)")
    tree_counts = {op: {"kernel": counts[op]["kernel"]
                        - j1_counts[op]["kernel"], "plain": 0}
                   for op in counts}
    none = {op: {"kernel": 0, "plain": 0} for op in counts}
    return {"J=1": (j1_counts, rounds[1], at_start),
            "tree": (tree_counts, rounds[2], none)}


def vlm_path(torch, ops, *, K=8, P=256, M=128, steps=32, max_len=512):
    """Phase 16: ``paligemma-3b`` at full width in bfloat16 (head dim 256,
    MQA): ``K`` rows of ``P`` patch embeddings and ``M`` text tokens,
    prefill then ``steps`` one-token windows (greedy), on the contiguous
    layout (B8 once per layer in the prefill, B7 once per layer a step) and
    through a paged view of the same tokens (B1 throughout).  Checks:
    shapes, finite logits, the launches, and that the two layouts agree
    (the same function through other kernels, in bfloat16: the largest
    logit difference is printed and must stay under 1, where a wrong head
    dim would move logits of magnitude ~1 by their own size).  Returns
    {layout: (launch counts, per-step records, launch counts of the
    prefill)}, each of that layout's run alone."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, has_prefix_embeds

    label = "paligemma path"
    cfg = get_config("paligemma-3b").replace(param_dtype="bfloat16",
                                             compute_dtype="bfloat16")
    assert has_prefix_embeds(cfg) and cfg.num_patches == P
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    prefix = torch.randn((K, P, cfg.d_model), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (K, M), generator=gen,
                           device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    log(f"{label}: weights in {time.perf_counter() - t0:.2f} s, params "
        f"{model.num_params(params)}")
    n_slots = max_len // 16
    out, runs = {}, {}
    for layout in ("contiguous", "paged"):
        if layout == "paged":
            cache = dict(model.init_paged_cache(K * n_slots, 16, torch.bfloat16),
                         pages=torch.arange(K * n_slots, dtype=torch.int32,
                                            device="cuda").reshape(K, n_slots))
        else:
            cache = model.init_cache(K, max_len, torch.bfloat16)
        ops.reset_counts()
        t = time.perf_counter()
        logits, cache, _ = model.prefill(params, tokens, cache,
                                         prefix_embeds=prefix)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t
        start = ops.counts()
        prefill_op = "flash_attention" if layout == "contiguous" else \
            "paged_attention"
        assert logits.shape == (K, P + M, cfg.vocab_size)
        assert start[prefill_op]["kernel"] == cfg.num_layers, start
        seq = [logits[:, -1].float()]
        pos = torch.full((K,), P + M, dtype=torch.int32, device="cuda")
        step_op = "decode_attention" if layout == "contiguous" else \
            "paged_attention"
        step_s, records = 0.0, []
        for i in range(steps):
            # the paged view is fed the contiguous run's greedy tokens
            nxt = (out["contiguous"][i] if layout == "paged"
                   else seq[-1]).argmax(-1).to(torch.int32)[:, None]
            before = ops.counts()[step_op]["kernel"]
            t = time.perf_counter()
            logits, cache = model.forward_window(params, nxt, cache, pos)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            step_s += dt
            assert ops.counts()[step_op]["kernel"] - before == cfg.num_layers
            seq.append(logits[:, -1].float())
            pos = pos + 1
            records.append({"layout": layout, "step": i, "ms": 1e3 * dt})
        counts = ops.counts()
        assert all(c["plain"] == 0 for c in counts.values()), counts
        out[layout] = torch.stack(seq)
        assert torch.isfinite(out[layout]).all()
        runs[layout] = (counts, records, start)
        log(f"{label} ({layout}): prefill of {K} x ({P} patches + {M} tokens) "
            f"in {1e3 * t_pre:.2f} ms ({start[prefill_op]['kernel']} "
            f"{prefill_op} launches), {steps} one-token windows, mean "
            f"{1e3 * step_s / steps:.2f} ms ({K * steps / step_s:.2f} tokens/s); "
            f"launches {({k: v['kernel'] for k, v in counts.items() if v['kernel']})}")
    diff = float((out["contiguous"] - out["paged"]).abs().max())
    top1 = float((out["contiguous"].argmax(-1) == out["paged"].argmax(-1))
                 .float().mean())
    log(f"{label}: contiguous vs paged logits max|diff| {diff:.4f}, top-1 "
        f"agreement {top1:.3f} over {steps + 1} positions x {K} rows "
        f"(logit std {float(out['contiguous'].std()):.3f})")
    assert diff < 1.0, diff
    return runs


def encdec_path(torch, ops, *, K=8, M=64, steps=32, max_len=128):
    """Phase 17: ``whisper-large-v3`` at full width in bfloat16: encode
    ``K`` x 1500 frames (B8 non-causal, 32 layers), prefill ``K`` x ``M``
    decoder tokens (B8 causal for the self-attention and non-causal for the
    cross-attention, each layer), then ``steps`` greedy decode steps (B7
    for the self-attention, B8 non-causal over the 1500 frames for the
    cross-attention, each layer).  Returns (launch counts, per-step
    records, launch counts of the prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    label = "whisper path"
    cfg = get_config("whisper-large-v3").replace(param_dtype="bfloat16",
                                                 compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    frames = torch.randn((K, cfg.encoder_seq_len, cfg.d_model), generator=gen,
                         device="cuda", dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (K, M), generator=gen,
                           device="cuda", dtype=torch.int32)
    cache = model.init_cache(K, max_len, torch.bfloat16)
    torch.cuda.synchronize()
    ops.reset_counts()
    t1 = time.perf_counter()
    logits, cache, _ = model.prefill(params, tokens, cache,
                                     prefix_embeds=frames)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t1
    at_start = ops.counts()
    n = cfg.num_layers
    assert at_start["flash_attention"]["kernel"] == \
        cfg.num_encoder_layers + 2 * n, at_start
    assert logits.shape == (K, M, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    log(f"{label}: weights in {t1 - t0:.2f} s, params "
        f"{model.num_params(params)}; encode {K} x {cfg.encoder_seq_len} "
        f"frames + prefill {K} x {M} tokens in {1e3 * t_pre:.2f} ms; launches "
        f"{ {k: v['kernel'] for k, v in at_start.items() if v['kernel']} }")
    pos = torch.full((K,), M, dtype=torch.int32, device="cuda")
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    records, total_s = [], 0.0
    for i in range(steps):
        before = ops.counts()
        t = time.perf_counter()
        logits, cache = model.forward_window(params, nxt, cache, pos)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = ops.counts()
        assert after["decode_attention"]["kernel"] \
            - before["decode_attention"]["kernel"] == n
        assert after["flash_attention"]["kernel"] \
            - before["flash_attention"]["kernel"] == n
        assert torch.isfinite(logits).all()
        total_s += dt
        records.append({"step": i, "ms": 1e3 * dt})
        pos = pos + 1
    counts = ops.counts()
    assert all(c["plain"] == 0 for c in counts.values()), counts
    log(f"{label}: {steps} decode steps of {K} streams, mean "
        f"{1e3 * total_s / steps:.2f} ms, {K * steps / total_s:.2f} tokens/s; "
        f"launches {({k: v['kernel'] for k, v in counts.items() if v['kernel']})}")
    return counts, records, at_start


def _leaf_items(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_items(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _differing_leaves(torch, a, b):
    """(key, max |a - b|) of every leaf that is not bit for bit equal."""
    out = []
    for (k, x), (_, y) in zip(_leaf_items(a), _leaf_items(b)):
        if not torch.equal(x, y):
            out.append((k, float((x.float() - y.float()).abs().max())))
    return out


def training_reference_check(torch, np, ops):
    """Phase 18a: the smoke models of four families train on the card as on
    the CPU: the same port init (drawn on the CPU, copied over), three
    steps of ``make_train_step`` at the launcher's microbatches (2) on the
    same batches; the first step's gradients within ``SMOKE_TRAIN_TOL``
    (grad_rtol, and an atol of grad_atol_scale x the leaf's largest entry:
    float32 products summed in other orders), every step's loss within
    loss_rtol; no kernel launches (``apply`` runs plain attention).  Then a
    Mamba-2 smoke step on the card must raise at ``ops.ssd_scan``: the
    kernel has no backward, and its op refuses an input that requires
    grad."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, has_prefix_embeds
    from repro_torch.models.model_zoo import prefix_len
    from repro_torch.training import (OptimizerConfig, init_optimizer,
                                      make_train_step)
    from repro_torch.training.train_loop import value_and_grad

    tol = SMOKE_TRAIN_TOL
    opt_cfg = OptimizerConfig(learning_rate=3e-3, warmup_steps=1,
                              decay_steps=20)
    rng = np.random.default_rng(5)
    for arch in ("tinyllama-1.1b", "moonshot-v1-16b-a3b", "paligemma-3b",
                 "whisper-large-v3"):
        cfg = get_config(arch).smoke()
        batches = []
        for _ in range(3):
            b = {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (8, 16)).astype(np.int32))}
            if has_prefix_embeds(cfg):
                b["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
                    (8, prefix_len(cfg), cfg.d_model)).astype(np.float32))
            batches.append(b)
        init = build_model(cfg, device="cpu").init(0)
        runs = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, device=dev)
            params = _to(torch, init, dev)
            on = [{k: v.to(dev) for k, v in b.items()} for b in batches]
            ops.reset_counts()
            _, _, grads = value_and_grad(model, params, on[0]["tokens"],
                                         on[0].get("prefix_embeds"))
            step = make_train_step(model, opt_cfg, microbatches=2,
                                   has_prefix=has_prefix_embeds(cfg))
            state, losses = init_optimizer(opt_cfg, params), []
            for b in on:
                params, state, met = step(params, state, b)
                losses.append(float(met["loss"]))
            counts = ops.counts()
            assert all(v == {"kernel": 0, "plain": 0}
                       for v in counts.values()), counts
            runs[dev] = (losses, _to(torch, grads, "cpu"))
        (lc, gc_), (lg, gg) = runs["cpu"], runs["cuda"]
        worst = 0.0
        for (k, a), (_, b) in zip(_leaf_items(gc_), _leaf_items(gg)):
            scale = float(a.abs().max())
            excess = float(((b - a).abs() - tol["grad_rtol"] * a.abs()).max())
            worst = max(worst, excess / max(scale, 1e-30))
            assert excess <= tol["grad_atol_scale"] * scale, (arch, k, excess)
        rel = max(abs(x - y) / abs(x) for x, y in zip(lc, lg))
        log(f"training reference check ({cfg.name}, 3 steps, microbatches 2, "
            f"batch 8 x 16): losses card {[f'{x:.6f}' for x in lg]}, CPU "
            f"{[f'{x:.6f}' for x in lc]}, max rel {rel:.3e} (band "
            f"{tol['loss_rtol']}); step-0 grads: worst excess over rtol "
            f"{tol['grad_rtol']} {worst:.3e} of the leaf's max (band "
            f"{tol['grad_atol_scale']}); no kernel launched")
        assert rel <= tol["loss_rtol"], (arch, lc, lg)
    cfg = get_config("mamba2-130m").smoke()
    model = build_model(cfg, device="cuda")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16))
                              .astype(np.int32)).cuda()
    ops.reset_counts()
    try:
        value_and_grad(model, model.init(0), tokens)
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError("a Mamba-2 train step on the card went through "
                             "ops.ssd_scan without refusing")
    assert "ops.ssd_scan" in refused and "no backward" in refused, refused
    assert ops.counts()["ssd_scan"]["kernel"] == 0
    log(f"training reference check (mamba2-130m smoke, on the card): the "
        f"step raises at the SSD scan, none launched: {refused[:90]}...")


def _train_setup(torch, cfg, seq, batch, microbatches, n_batches):
    """The launcher's optimizer, data and step for ``cfg`` on the card."""
    from repro_torch.models import build_model
    from repro_torch.training import (DataConfig, OptimizerConfig,
                                      SyntheticLMDataset, init_optimizer,
                                      make_train_step)

    opt_cfg = OptimizerConfig(warmup_steps=10, decay_steps=TRAIN_STEPS)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=seq, global_batch=batch))
    batches = [torch.from_numpy(data.batch(s)["tokens"]).cuda()
               for s in range(n_batches)]
    model = build_model(cfg)
    params = model.init(0)
    step_fn = make_train_step(model, opt_cfg, microbatches=microbatches)
    return (model, params, init_optimizer(opt_cfg, params), step_fn, batches,
            opt_cfg)


def training_path(torch, np, ops, *, arch="tinyllama-1.1b", seq=128, batch=8,
                  microbatches=2):
    """Phase 18b: ``arch`` at full width and depth in float32 (its config),
    the launcher's defaults (seq 128, batch 8, microbatches 2, 10 warmup
    steps decaying over 20): 20 train steps, timed per step (host clock,
    each step ending in a read of its loss), peak memory, counters (all 0:
    no kernel on this path, as in the JAX package), then 3 profiled steps;
    a step repeated from the same state must give the same bits, or the
    differing leaves are named."""
    from repro_torch.configs import get_config

    label = "training path"
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model, params, state, step_fn, batches, _ = _train_setup(
        torch, cfg, seq, batch, microbatches, TRAIN_STEPS + 4)
    n_params = model.num_params(params)
    torch.cuda.synchronize()
    log(f"{label}: {cfg.name} float32, {cfg.num_layers} layers, "
        f"{n_params} params in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    losses, ms = [], []
    for s in range(TRAIN_STEPS):
        t = time.perf_counter()
        params, state, met = step_fn(params, state, {"tokens": batches[s]})
        losses.append(float(met["loss"]))
        ms.append(1e3 * (time.perf_counter() - t))
    counts = ops.counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(v == {"kernel": 0, "plain": 0} for v in counts.values()), counts
    assert np.isfinite(losses).all(), losses
    steady = sum(ms[1:]) / (len(ms) - 1)
    tokens = batch * seq
    # bound: the products (6 flops a matmul weight a token, attention's
    # causal half 6 B H S^2 D a layer) at 67 TFLOP/s f32, then AdamW's
    # bytes (p, g, m, v read, p, m, v written) at 3.35 TB/s: the optimizer
    # needs every gradient, so the two do not overlap
    matmul_w = n_params - cfg.vocab_size * cfg.d_model     # the lookup
    flops = (6 * matmul_w * tokens + 6 * cfg.num_layers * batch
             * cfg.num_heads * seq * seq * cfg.head_dim)
    bound_ms = 1e3 * (flops / 67e12 + 7 * 4 * n_params / 3.35e12)
    log(f"{label}: {TRAIN_STEPS} steps (seq {seq}, batch {batch}, "
        f"microbatches {microbatches}): step 0 {ms[0]:.2f} ms, steps 1-"
        f"{TRAIN_STEPS - 1} mean {steady:.2f} ms/step, "
        f"{tokens / steady * 1e3:.2f} tokens/s; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; peak memory {peak:.2f} GiB; bound {bound_ms:.2f} "
        f"ms/step ({flops / 1e12:.3f} TFLOP at 67 TFLOP/s + AdamW "
        f"{7 * 4 * n_params / 1e9:.2f} GB at 3.35 TB/s), the step at "
        f"{bound_ms / steady:.3f} of it; counters all 0: "
        f"{ {k: v['kernel'] for k, v in counts.items()} }")
    TRAINING.update(step_ms=steady, first_step_ms=ms[0], peak_gib=peak,
                    tokens_per_s=tokens / steady * 1e3, bound_ms=bound_ms,
                    losses=losses)
    it = iter(range(TRAIN_STEPS, TRAIN_STEPS + 3))
    current = [params, state]

    def one_step():
        current[0], current[1], met = step_fn(current[0], current[1],
                                              {"tokens": batches[next(it)]})
        return met

    profile_rounds(torch, one_step, 3, label, unit="step")
    params, state = current
    a = step_fn(params, state, {"tokens": batches[-1]})
    b = step_fn(params, state, {"tokens": batches[-1]})
    diff = _differing_leaves(torch, (a[0], a[1]), (b[0], b[1]))
    log(f"{label}: one step repeated from the same state at full depth: the "
        f"same bits: {not diff}" + (f"; differing leaves {diff[:6]}"
                                    if diff else ""))
    TRAINING["repeat_bit_exact"] = not diff


def training_restart_begin(torch, np, ops, *, arch="tinyllama-1.1b",
                           layers=1, seq=128, batch=8, microbatches=2):
    """Phase 18c, begun before phase 14: ``arch``'s widths at ``layers``
    layers (the 22-layer float32 state is 13.2 GB, which zlib, the codec
    where zstandard is missing, writes at ~20 MB/s on one core), the
    launcher's defaults, 20 steps with a ``CheckpointManager.save_async``
    at step 10, as the launcher saves.  The writer compresses in the
    background while phases 14-17 run (its zlib and hashing release the
    interpreter lock; it touches no CUDA tensor); ``training_restart_end``
    restores the file.  No kernel launches in the 20 steps."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config

    class TimedManager(CheckpointManager):
        """Records how long its last ``save`` took (the background
        writer's wall time, for ``save_async``)."""
        seconds = None

        def save(self, step, tree, metadata=None):
            t = time.perf_counter()
            super().save(step, tree, metadata)
            self.seconds = time.perf_counter() - t

    cfg = get_config(arch).replace(num_layers=layers)
    model, params, state, step_fn, batches, opt_cfg = _train_setup(
        torch, cfg, seq, batch, microbatches, TRAIN_STEPS)
    tmp = tempfile.TemporaryDirectory()
    mgr = TimedManager(tmp.name)
    ops.reset_counts()
    losses = []
    for s in range(TRAIN_STEPS):
        if s == RESTART_AT:
            t = time.perf_counter()
            mgr.save_async(s, {"params": params, "opt": state})
            snap_s = time.perf_counter() - t
            t_write = time.perf_counter()
        params, state, met = step_fn(params, state, {"tokens": batches[s]})
        losses.append(float(met["loss"]))
    counts = ops.counts()
    assert all(v == {"kernel": 0, "plain": 0} for v in counts.values()), counts
    log(f"training restart: {layers}-layer {cfg.name}, {TRAIN_STEPS} steps, "
        f"save_async at step {RESTART_AT} (snapshot {snap_s:.3f} s); the "
        f"write goes on in the background")
    return dict(model=model, params=params, state=state, step_fn=step_fn,
                batches=batches, opt_cfg=opt_cfg, tmp=tmp, mgr=mgr,
                losses=losses, snap_s=snap_s, t_write=t_write, layers=layers)


def training_restart_end(torch, np, run):
    """Phase 18c's end: wait for the writer, restore a fresh template on
    the card from the file and run it to step 20: its state must equal
    the uninterrupted run's bit for bit, or the differing leaves are named
    and held at 2 lr a resumed step, the losses at rtol 1e-5.  Prints the
    checkpoint's bytes, write and read seconds."""
    import os

    from repro_torch.training import init_optimizer

    label = "training path"
    mgr, model, opt_cfg = run["mgr"], run["model"], run["opt_cfg"]
    t = time.perf_counter()
    mgr.wait()
    waited = time.perf_counter() - t
    overlap = t - run["t_write"]
    path = mgr._path(RESTART_AT)
    file_bytes = os.path.getsize(path)
    with open(path, "rb") as f:
        codec = "zstd" if f.read(47)[43:] == b"\x28\xb5\x2f\xfd" else "zlib"
    params, state = run["params"], run["state"]
    payload = sum(x.numel() * x.element_size() for _, x in
                  _leaf_items({"params": params, "opt": state}))
    fresh = model.init(1)
    template = {"params": fresh, "opt": init_optimizer(opt_cfg, fresh)}
    t = time.perf_counter()
    restored, meta = mgr.restore_latest(template)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t
    run["tmp"].cleanup()
    assert meta["step"] == RESTART_AT
    p2, s2 = restored["params"], restored["opt"]
    resumed = []
    for s in range(RESTART_AT, TRAIN_STEPS):
        p2, s2, met = run["step_fn"](p2, s2, {"tokens": run["batches"][s]})
        resumed.append(float(met["loss"]))
    diff = _differing_leaves(torch, (params, state), (p2, s2))
    losses = run["losses"]
    log(f"{label}: checkpoint of the {run['layers']}-layer state at step "
        f"{RESTART_AT}: {payload} bytes of leaves, {file_bytes} bytes on disk "
        f"({codec}), snapshot {run['snap_s']:.3f} s, write "
        f"{mgr.seconds:.2f} s in the background "
        f"({payload / mgr.seconds / 1e6:.2f} MB/s of leaves; {overlap:.2f} s "
        f"of other phases beside it, then {waited:.2f} s waited), restore "
        f"onto the card {read_s:.2f} s; resumed losses {resumed[-1]:.6f} vs "
        f"{losses[-1]:.6f}; resumed state == uninterrupted bit for bit: "
        f"{not diff}" + (f"; differing leaves {diff[:6]}" if diff else ""))
    assert np.isfinite(resumed).all()
    TRAINING.update(ckpt_bytes=file_bytes, ckpt_payload=payload,
                    write_s=mgr.seconds, read_s=read_s,
                    snapshot_s=run["snap_s"], resume_bit_exact=not diff)
    if diff:
        lim = 2 * opt_cfg.learning_rate * (TRAIN_STEPS - RESTART_AT)
        assert max(d for _, d in diff) <= lim, diff
        assert max(abs(x - y) / abs(x) for x, y in
                   zip(resumed, losses[RESTART_AT:])) <= 1e-5

MESH_STEPS = 32         # phase 19: greedy one-token windows a run
DRYRUN_CELLS = (("qwen2.5-3b", "decode_32k"), ("qwen2.5-3b", "train_4k"))
MESH = {}       # phase 19's numbers for the summary


def greedy_run(torch, model, params, cache, prompts, steps, put):
    """A prefill of ``prompts`` and ``steps`` greedy one-token
    ``forward_window`` steps: (logits of every step, as plain tensors,
    the tokens, host seconds of each step ending in a synchronize).
    ``put`` places each input (the identity, or the batch sharding)."""
    K, M = prompts.shape
    logits, tokens, secs = [], [], []

    def local(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def sync():
        if prompts.is_cuda:
            torch.cuda.synchronize(prompts.device)

    with torch.no_grad():
        t = time.perf_counter()
        out, cache, _ = model.prefill(params, put(prompts), cache)
        last = local(out[:, -1])
        sync()
        secs.append(time.perf_counter() - t)
        logits.append(last)
        for i in range(steps):
            nxt = last.argmax(-1).to(torch.int32)[:, None]
            tokens.append(nxt)
            pos = torch.full((K,), M + i, dtype=torch.int32,
                             device=prompts.device)
            t = time.perf_counter()
            out, cache = model.forward_window(params, put(nxt), cache,
                                              put(pos))
            last = local(out[:, -1])
            sync()
            secs.append(time.perf_counter() - t)
            logits.append(last)
    return logits, tokens, secs


def mesh_path(torch, ops, cfg, *, K=8, M=128, steps=MESH_STEPS, max_len=1024,
              device="cuda", backend="nccl", label="mesh path"):
    """Phase 19 (a)-(c): a one-rank process group and the (1, 1) mesh with
    the production axis names; ``cfg`` at full width and depth on
    contiguous caches, a prefill of ``K`` x ``M`` tokens then ``steps``
    greedy steps, once plain and once with params, caches and inputs
    placed as DTensors by the sharding rules under ``use_mesh``: logits
    and tokens equal bit for bit, the same B7/B8 launches, no plain call;
    then ``compressed_psum_int8`` over the group on a (151936, 2048)
    float32 leaf against its plain arithmetic, bit for bit.  The group is
    destroyed on return.  Returns (launch counts, per-step records,
    launch counts of the prefill) of the sharded run."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import build_model
    from repro_torch.roofline.analysis import record_collectives

    if device == "cuda":
        torch.cuda.set_device(0)    # NCCL's device, before the group
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_smoke_mesh(device_type=device)
        t0 = time.perf_counter()
        model = build_model(cfg, device=device)
        params = model.init(0)
        gen = torch.Generator(device=device).manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (K, M), generator=gen,
                                device=device, dtype=torch.int32)
        ops.reset_counts()
        plain = greedy_run(torch, model, params,
                           model.init_cache(K, max_len, torch.bfloat16),
                           prompts, steps, lambda t: t)
        plain_counts = ops.counts()
        log(f"{label}: {cfg.name} ({cfg.num_layers} layers, d "
            f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, D "
            f"{cfg.head_dim}, V {cfg.vocab_size}) weights and the plain run "
            f"in {time.perf_counter() - t0:.2f} s")

        dparams = shd.distribute_tree(params, shd.param_shardings(mesh,
                                                                 params))
        cache = model.init_cache(K, max_len, torch.bfloat16)
        c_sh = shd.cache_shardings(mesh, cache, model.CACHE_BATCH_AXES)
        cache = shd.distribute_tree(cache, c_sh)

        def put(t):
            return shd.distribute_tree(t, shd.batch_shardings(mesh, t))

        ops.reset_counts()
        with shd.use_mesh(mesh), record_collectives() as stats:
            sharded = greedy_run(torch, model, dparams, cache, prompts, steps,
                                 put)
        counts = ops.counts()
        # on the card every call launches a kernel (a CPU try runs the
        # plain versions)
        route, other = (("kernel", "plain") if device == "cuda"
                        else ("plain", "kernel"))
        for c in (counts, plain_counts):
            assert c["flash_attention"][route] == cfg.num_layers, c
            assert c["decode_attention"][route] == cfg.num_layers * steps, c
            assert all(v[other] == 0 for v in c.values()), c
        n_diff = sum(int((a != b).sum()) for a, b in zip(sharded[0],
                                                          plain[0]))
        assert n_diff == 0, f"{n_diff} logits differ between the runs"
        assert all(torch.equal(a, b) for a, b in zip(sharded[1], plain[1]))
        plain_ms = 1e3 * sum(plain[2][1:]) / steps
        sharded_ms = 1e3 * sum(sharded[2][1:]) / steps
        MESH.update(plain_step_ms=plain_ms, sharded_step_ms=sharded_ms,
                    plain_prefill_ms=1e3 * plain[2][0],
                    sharded_prefill_ms=1e3 * sharded[2][0],
                    collectives=stats.counts,
                    collective_bytes=stats.bytes_by_op,
                    cache_spec=c_sh["k"].spec)
        log(f"{label}: sharded (1, 1) mesh = plain bit for bit: "
            f"{len(plain[0])} logit rows of {K} x {cfg.vocab_size} and "
            f"{steps} greedy tokens; launches sharded "
            f"{ {k: v['kernel'] for k, v in counts.items() if v['kernel']} } "
            f"plain "
            f"{ {k: v['kernel'] for k, v in plain_counts.items() if v['kernel']} }"
            f"; record_collectives {stats.counts} ({stats.bytes_by_op} "
            f"bytes); cache spec {c_sh['k'].spec}")
        log(f"{label}: host-timed ms a step (ends in synchronize): plain "
            f"{plain_ms:.2f}, sharded {sharded_ms:.2f}; prefill plain "
            f"{1e3 * plain[2][0]:.2f} ms, sharded {1e3 * sharded[2][0]:.2f} "
            f"ms")
        records = [{"step": i, "ms": 1e3 * t}
                   for i, t in enumerate(sharded[2][1:])]
        # the prefill's launches: B8 runs there only, B7 in the steps only
        start = {k: {"kernel": v["kernel"] if k == "flash_attention" else 0,
                     "plain": 0} for k, v in counts.items()}
        del dparams, cache, params, model, plain, sharded

        # (c) the int8 all-reduce over the one-rank group
        x = torch.randn((151936, 2048), generator=gen, device=device)
        # one rank: the max scale is its own, and the sum is its codes
        # re-quantized against it, the reference's arithmetic written out
        q, scale = coll.quantize_int8(x)
        want = torch.clamp(torch.round(coll.dequantize_int8(q, scale) / scale),
                           -127, 127).to(torch.int32).to(torch.float32) * scale
        del q
        got = coll.compressed_psum_int8(x)
        n_diff = int((got != want).sum())
        assert n_diff == 0, f"compressed_psum_int8: {n_diff} values differ"
        times = []
        for _ in range(6):
            if x.is_cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            coll.compressed_psum_int8(x)
            if x.is_cuda:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        MESH["psum_int8_ms"] = 1e3 * min(times[1:])
        log(f"{label}: compressed_psum_int8 over the one-rank {backend} group "
            f"on a (151936, 2048) float32 leaf = its plain arithmetic bit "
            f"for bit; host-timed {MESH['psum_int8_ms']:.3f} ms (best of 5 "
            f"after one warm call, ends in synchronize)")
        del x, want, got
        return counts, records, start
    finally:
        dist.destroy_process_group()


def dryrun_begin():
    """Phase 19 (d), begun before phase 14: each of ``DRYRUN_CELLS`` traced
    by ``python -m repro_torch.launch.dryrun`` in a subprocess of its own
    (the main process holds the NCCL group of phase 19), on one thread at
    the lowest priority, results into a fresh directory under build/."""
    import os
    import shutil

    out = ROOT / "build" / "dryrun_chip"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        code = ("import sys; from repro_torch.launch import dryrun; "
                f"dryrun.RESULTS_DIR = {str(out)!r}; "
                f"sys.exit(dryrun.main(['--arch', {arch!r}, '--shape', "
                f"{shape!r}, '--mesh', 'single', '--force']))")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            preexec_fn=lambda: os.nice(19)))
    return out, procs


def dryrun_end(run, *, label="dry run"):
    """Phase 19 (d): wait for the cells; each must exit 0 with status ok.
    Prints per-device argument bytes and traced peak against the card's
    80 GB, and the roofline line."""
    out, procs = run
    for (arch, shape), proc in zip(DRYRUN_CELLS, procs):
        text, _ = proc.communicate(timeout=900)
        res = json.loads((out / f"{arch}__{shape}__pod16x16.json").read_text())
        assert proc.returncode == 0 and res["status"] == "ok", \
            (proc.returncode, res.get("error"), text[-2000:])
        mem, rf = res["memory_analysis"], res["roofline"]
        MESH.setdefault("dryrun", {})[shape] = res
        log(f"{label}: {arch} {shape} pod16x16 ok in {res['trace_s']} s: "
            f"per-device arguments "
            f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB, traced peak "
            f"temporaries {mem['traced_peak_temp_bytes'] / 1e9:.3f} GB "
            f"(card 80 GB: "
            f"{'fits' if mem['argument_size_in_bytes'] + mem['traced_peak_temp_bytes'] < 80e9 else 'does not fit'}"
            f"); collectives {res['collective_counts']}; roofline "
            f"(datasheet rates) bottleneck {rf['bottleneck']}, compute "
            f"{rf['compute_s']:.3e} s, memory {rf['memory_s']:.3e} s, "
            f"collective {rf['collective_s']:.3e} s, peak fraction "
            f"{rf['peak_fraction']:.3f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.kernels import build, cases, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_attention_q8 as daq
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_verify_sample as fvs
    from repro_torch.kernels import gather_softmax_prob as gsp
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_tree_attention as pta
    from repro_torch.kernels import residual_sample as rs
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import tree_attention as ta

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| device {kind} x{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    info = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall")
    for name, rec in info.items():
        log(f"  {name}: {rec['seconds']:.2f} s" + (" (cached)" if rec["cached"] else ""))
        for line in rec["ptxas"]:
            log(f"    {line}")

    # 3. kernels against their plain versions
    paged, verify = check_kernels(torch, cases, pa, fvs)
    tree = check_tree_kernels(torch, cases, pa, pta)
    softmax, residual = check_samplers(torch, cases, pa, fvs, gsp, rs)
    ctree, scan = check_contiguous_kernels(torch, cases, pa, pta, ta, ssd)
    decode, flash = check_decode_kernels(torch, cases, pa, ta, da, fa)
    q8 = check_q8_kernel(torch, cases, pa, da, daq)
    timed = len(cases.spin_overruns)
    log(f"timing spin check: {sum(1 for f, _, _ in cases.spin_overruns if f)} "
        f"of {timed} phase-3 timings had calls whose host enqueue outlasted "
        f"the {cases.SPIN_CYCLES}-cycle spin; "
        f"{sum(1 for _, o, _ in cases.spin_overruns if o)} still had some "
        f"after lengthening it (longest spin "
        f"{max(c for _, _, c in cases.spin_overruns)} cycles)")

    # 4. small-input reference check
    reference_check(torch, np)
    serving_engine_reference_check(torch, np)
    moe_vlm_encdec_reference_check(torch, np)

    # 5. the J=1 path, 6. the tree path, 7. the contiguous tree path,
    # 8. the hybrid path and 9. the plain decode path, each on its own
    # engine, the last one freed first; 10. the int8 path on 9's engine;
    # 11. the continuous path and 12. the gateway path, each on its own
    from repro_torch.configs import get_config

    def free(label):
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{label} engine freed: device memory allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    pair = (get_config("llama2-7b").replace(**bf16),
            get_config("tinyllama-1.1b").replace(**bf16), torch.bfloat16)
    runs = {}
    runs["j1"] = main_path(
        torch, np, ops, *pair, label="J=1 path", scheme="hete",
        scheme_params={}, path_ops=("paged_attention", "fused_verify_sample"),
        syncs=1, min_width=1, n_rounds=MAIN_ROUNDS)
    free("J=1")
    runs["tree"] = main_path(
        torch, np, ops, *pair, label="tree path", scheme="multidraft",
        scheme_params={"J_min": 2, "J_max": 3},
        path_ops=("paged_attention", "paged_tree_attention",
                  "gather_softmax_prob", "residual_sample"),
        syncs=2, min_width=2, n_rounds=TREE_ROUNDS)
    free("tree")
    runs["contiguous tree"] = main_path(
        torch, np, ops, *pair, label="contiguous tree path",
        scheme="multidraft", scheme_params={"J_min": 2, "J_max": 3},
        path_ops=("tree_attention", "gather_softmax_prob", "residual_sample",
                  "decode_attention"),
        syncs=2, min_width=2, n_rounds=CONTIGUOUS_ROUNDS,
        cache_kind="contiguous",
        start_ops={"flash_attention": pair[0].num_layers + pair[1].num_layers})
    free("contiguous tree")
    zamba = get_config("zamba2-2.7b").replace(**bf16)
    runs["hybrid"] = main_path(
        torch, np, ops, zamba, pair[1], torch.bfloat16, label="hybrid path",
        scheme="hete", scheme_params={},
        path_ops=("fused_verify_sample", "decode_attention"),
        syncs=1, min_width=1, n_rounds=HYBRID_ROUNDS, cache_kind="contiguous",
        start_ops={"ssd_scan": zamba.num_layers,
                   "flash_attention": (zamba.num_layers // zamba.hybrid_group
                                       + pair[1].num_layers)},
        NEW=10 ** 6, profile_start=("ssd_scan",))
    free("hybrid")
    runs["plain decode"], eng, state = plain_decode_path(torch, ops, pair[0])
    runs["int8 decode"] = int8_path(torch, ops, cases, da, daq, eng, state)
    del eng, state
    free("plain decode")
    runs["continuous"] = continuous_path(torch, np, ops, *pair, runs["j1"])
    free("continuous")
    runs["gateway"] = gateway_path(torch, ops)
    free("gateway")
    # 18c begins: the 1-layer training restart, whose checkpoint write runs
    # in the background through phases 14-17
    restart = training_restart_begin(torch, np, ops)
    # 19d begins: the two dry-run cells trace on the host's CPU in
    # subprocesses of their own while phases 14-18 run on the card
    dry = dryrun_begin()
    # 14. the MoE path, 15. gemma-7b's plain decode path (head dim 256),
    # 16. paligemma-3b and 17. whisper-large-v3 at full width, each freed
    # before the next
    for rounds_of, run in moe_path(torch, np, ops).items():
        runs[f"moe {rounds_of}"] = run
    free("MoE")
    gemma = get_config("gemma-7b").replace(**bf16)
    runs["gemma decode"], eng, state = plain_decode_path(
        torch, ops, gemma, steps=32, label="gemma-7b decode path")
    del eng, state
    free("gemma-7b")
    for layout, run in vlm_path(torch, ops).items():
        runs[f"paligemma {layout}"] = run
    free("paligemma-3b")
    runs["whisper"] = encdec_path(torch, ops)
    free("whisper-large-v3")
    # 18. the training path: smoke models card = CPU, the Mamba-2 refusal,
    # then tinyllama-1.1b at full width with a checkpoint restart
    training_reference_check(torch, np, ops)
    training_path(torch, np, ops)
    training_restart_end(torch, np, restart)
    del restart
    free("training")
    # 19. the mesh path: a one-rank NCCL group, qwen2.5-3b at full width
    # on the (1, 1) mesh = plain, the int8 all-reduce, the dry-run cells
    qwen = get_config("qwen2.5-3b").replace(**bf16)
    runs["mesh"] = mesh_path(torch, ops, qwen)
    free("mesh")
    dryrun_end(dry)

    for label, prof in PROFILES.items():
        log(f"summary {label}: device busy {prof['device_busy_ms']:.2f} "
            f"ms/{prof['unit']}, wall {prof['wall_ms']:.2f} ms/{prof['unit']} "
            f"(profiler on), idle share {prof['idle_share']:.3f}")
    labels = {"j1": "J=1 path", "tree": "tree path",
              "contiguous tree": "contiguous tree path",
              "hybrid": "hybrid path", "plain decode": "plain decode path",
              "continuous": "continuous path", "gateway": "gateway path",
              "moe J=1": "MoE path", "gemma decode": "gemma-7b decode path",
              "mesh": "mesh path"}
    for path, (counts, rounds, start) in runs.items():
        prof = PROFILES.get(labels.get(path), {}).get("window_ops", {})
        parts = []
        for op in ("paged_tree_attention", "tree_attention", "paged_attention",
                   "decode_attention", "fused_verify_sample",
                   "gather_softmax_prob", "residual_sample"):
            n = counts[op]["kernel"] - start[op]["kernel"]
            if n:
                ms, calls = prof.get(op, (0.0, 0.0))
                parts.append(f"{op} {n / len(rounds):.1f} launches per round "
                             f"({start[op]['kernel']} in start()), profiled "
                             f"{calls:.1f} calls and {ms:.3f} device ms per "
                             f"round")
        if parts:
            log(f"summary {path}: " + "; ".join(parts))
    log(f"summary mesh: qwen2.5-3b on the (1, 1) NCCL mesh = plain bit for "
        f"bit, host-timed ms a step sharded {MESH['sharded_step_ms']:.2f} / "
        f"plain {MESH['plain_step_ms']:.2f}, collectives "
        f"{sum(MESH['collectives'].values())}; compressed_psum_int8 "
        f"(151936, 2048) f32 {MESH['psum_int8_ms']:.3f} ms; dry run "
        + ", ".join(f"{shape} args "
                    f"{r['memory_analysis']['argument_size_in_bytes'] / 1e9:.3f}"
                    f" GB peak "
                    f"{r['memory_analysis']['traced_peak_temp_bytes'] / 1e9:.3f}"
                    f" GB" for shape, r in MESH["dryrun"].items()))
    log(f"summary gateway: {GATEWAY['requests']} requests at 32/s, "
        f"{GATEWAY['rounds']} rounds in {GATEWAY['wall_s']:.2f} s, TTFT p50 "
        f"{GATEWAY['ttft_p50_s']:.4f} s, p95 {GATEWAY['ttft_p95_s']:.4f} s, "
        f"{GATEWAY['tokens_per_s']:.2f} tokens/s")

    # 20. result lines
    def pick(recs, case, dtype=None):
        return next(r for r in recs if r["case"] == case
                    and (dtype is None or r["dtype"] == dtype))

    def entry(name, source, replaces, rec, recs, redesigned=None):
        """One kernel of the line; ``redesigned`` names what it (or its
        bf16 route) runs when that is a later design than the first port."""
        per_round = {path: (counts[name]["kernel"] - start[name]["kernel"])
                     / len(rounds)
                     for path, (counts, rounds, start) in runs.items()
                     if counts[name]["kernel"] > start[name]["kernel"]}
        per_start = {path: start[name]["kernel"]
                     for path, (_, _, start) in runs.items()
                     if start[name]["kernel"]}
        device_ms = {label: prof["window_ops"][name][0]
                     for label, prof in PROFILES.items()
                     if name in prof["window_ops"]}
        start_ms = {label: v["device_ms"]
                    for (label, op), v in START_PROFILES.items() if op == name}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "redesigned": redesigned,
                "launches": sum(c[name]["kernel"] for c, _, _ in runs.values()),
                "launches_per_round": per_round,
                "launches_per_admission": per_start,
                "profiled_device_ms_per_round": device_ms or None,
                "profiled_device_ms_per_admission": start_ms or None,
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
                "headline_case": f"{rec['case']} {rec.get('dtype', 'float32')}",
                "cases": recs}

    csrc, tpu = "src/repro_torch/csrc", "src/repro/kernels"
    kernels = [
        entry("paged_attention", f"{csrc}/paged_attention.cu",
              f"{tpu}/paged_attention.py:114", pick(paged, *PAGED_HEADLINE),
              paged, redesigned="bf16: mma.sync tiles, split slot axis"),
        entry("fused_verify_sample", f"{csrc}/fused_verify_sample.cu",
              f"{tpu}/fused_verify_sample.py:181", pick(verify, VERIFY_HEADLINE),
              verify, redesigned="vocab axis split across blocks, per-row "
              "waits under a cooperative launch"),
        entry("paged_tree_attention", f"{csrc}/paged_tree_attention.cu",
              f"{tpu}/tree_attention.py:256", pick(tree, *TREE_HEADLINE), tree,
              redesigned="bf16: the window body, tree mask, split key axis"),
        entry("gather_softmax_prob", f"{csrc}/gather_softmax_prob.cu",
              f"{tpu}/gather_softmax_prob.py:75",
              pick(softmax, SOFTMAX_HEADLINE), softmax,
              redesigned="vocab axis split across blocks, 16-byte loads, the "
              "last block of a row merges the partials in a fixed order"),
        entry("residual_sample", f"{csrc}/residual_sample.cu",
              f"{tpu}/residual_sample.py:91", pick(residual, RESIDUAL_HEADLINE),
              residual, redesigned="vocab axis split across blocks, 16-byte "
              "loads, the last block of a row adds the masses in chunk order "
              "and scans the crossing chunk"),
        entry("tree_attention", f"{csrc}/tree_attention.cu",
              f"{tpu}/tree_attention.py:145",
              pick(ctree, *CONTIGUOUS_TREE_HEADLINE), ctree,
              redesigned="bf16: the window body over contiguous keys, tree "
              "mask, split key axis"),
        entry("ssd_scan", f"{csrc}/ssd_scan.cu", f"{tpu}/ssd_scan.py:93",
              pick(scan, *SSD_HEADLINE), scan,
              redesigned="bf16: mma.sync chunk products, f32 operands as "
              "bf16 hi + lo, p cut at small batch"),
        entry("decode_attention", f"{csrc}/decode_attention.cu",
              f"{tpu}/decode_attention.py:81", pick(decode, *DECODE_HEADLINE),
              decode,
              redesigned="bf16: the window body at one row, split key axis"),
        entry("flash_attention", f"{csrc}/flash_attention.cu",
              f"{tpu}/flash_attention.py:95", pick(flash, *FLASH_HEADLINE),
              flash, redesigned="bf16: mma.sync tiles, cp.async ring"),
        entry("decode_attention_q8", f"{csrc}/decode_attention.cu",
              f"{tpu}/decode_attention.py:168", pick(q8, *Q8_HEADLINE), q8,
              redesigned="bf16 q: the window body over int8 rows, split key "
              "axis"),
    ]
    for k in kernels:
        assert k["launches"] > 0, f"{k['name']} launched on no path"
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
