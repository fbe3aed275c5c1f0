#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (``/usr/local/cuda``); exits non-zero, with no
result line, without them.  Imports nothing of jax and nothing of the JAX
package.  Phases (none catches a failure):

  1. the card: nvidia-smi's name and power limit, torch's device name
  2. build both kernels from ``src/repro_torch/csrc`` (one nvcc each, in
     parallel); print build seconds and ptxas register/smem/spill lines
  3. each kernel against its plain version on the card, float32 and
     bfloat16, at the shapes the main path gives it (attention is held
     against the plain version in float32 on the same inputs, tolerances
     ``cases.PAGED_TOL``; the error against the bfloat16 plain version is
     printed beside it): max error, exact-match
     counts, kernel / plain / library ms (CUDA events, L2 flushed between
     launches), and the bound from this run's inputs
  4. a small-input reference check: the smoke-size engine on the card
     (kernels) against the same engine on the CPU (plain versions), same
     weights and draws: identical committed tokens
  5. the main path at full width: Llama-2-7B verifying TinyLlama-1.1B drafts
     in bfloat16, paged (page_size 16, max_len 1024), under a
     ``MultiSpinCell`` (scheme hete) with 8 requests of 128-token prompts
     asking 64 new tokens each; rounds until drain or 20; per round: every
     unmasked stream commits >= 1 token, both kernels' launch counters grow,
     both plain counters stay 0, both page pools pass their invariants,
     exactly one host sync; then 3 more rounds under torch.profiler: device
     busy share and the kernels that take the time
  6. one ``{"kernels": [...]}`` JSON line, the card line, and as the last
     line ``{"ok": true, "device": {...}}``
"""

from __future__ import annotations

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
]
PAGED_HEADLINE = ("tinyllama-1.1b draft step", "bfloat16")
VERIFY_CASES = [("llama pair, V=32000", (8, 8, 32000, 64)),
                ("qwen3.5 pair, V=151936", (8, 8, 151936, 64))]
VERIFY_HEADLINE = "llama pair, V=32000"


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
    for name, shape in PAGED_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = cases.paged_case(*shape, dtype=dtype, device="cuda")
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
                "shape": dict(zip("B T H KV D ps ctx".split(), shape)),
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
            log(f"paged_attention  {name:28s} {rec['dtype']:8s} "
                f"max|err| {err:.3e} vs f32 plain (rtol {rtol}, atol {atol}), "
                f"{err_plain:.3e} vs {rec['dtype']} plain  kernel {rec['ms']:.4f} ms  "
                f"plain {rec['plain_ms']:.4f} ms  sdpa {rec['library_ms']:.4f} ms  "
                f"bound {bound_ms:.4f} ms ({bound_by})")
            if not close:
                raise AssertionError(f"paged_attention {name} {dtype}: kernel "
                                     f"disagrees with plain, max|err| {err}")
            paged.append(rec)
    verify = []
    for name, (B, L, V, vhat) in VERIFY_CASES:
        args = cases.verify_case(B, L, V, vhat, "cuda")
        got = fvs.fused_verify_sample_cuda(*args)
        want = fvs.fused_verify_sample_plain(*args)
        torch.cuda.synchronize()
        rep = cases.compare_verify(got, want, args)
        n_bytes, n_ops = cases.verify_work(*args)
        bound_ms, bound_by = cases.bound(n_bytes, n_ops, torch.float32)
        n_acc, dlen = rep["n_acc"], rep["draft_len"]
        rec = {
            "case": name, "shape": {"B": B, "L": L, "V": V, "vhat": vhat},
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
        log(f"fused_verify_sample {name:25s} accept equal {rep['accept_equal']}  "
            f"n_acc equal {rep['n_acc_equal']}  calibrated equal "
            f"{rep['calibrated_equal_rows']}/{B} (differing rows "
            f"{rep['calibrated_diff_rows']} at a CDF step: "
            f"{rep['diff_rows_at_cdf_step']})  reject rows {rec['rows_reject']} "
            f"full-accept rows {rec['rows_full_accept']}  kernel {rec['ms']:.4f} ms  "
            f"plain {rec['plain_ms']:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
        if not (rep["accept_equal"] and rep["n_acc_equal"]
                and rep["diff_rows_at_cdf_step"]):
            raise AssertionError(f"fused_verify_sample {name}: {rep}")
        if not (rec["rows_reject"] and rec["rows_full_accept"]):
            raise AssertionError(f"{name}: the case lost its reject or "
                                 f"full-accept rows: {rep}")
        verify.append(rec)
    return paged, verify


def reference_check(torch, np):
    """Phase 4: the smoke-size engine on the card against the same engine on
    the CPU (plain versions), same weights and draws."""
    from repro_torch.configs import get_config
    from repro_torch.core.draws import RoundDraws
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
        committed[dev] = [[int(t) for t in c] for c in st.committed]
    same = committed["cpu"] == committed["cuda"]
    log(f"reference check (smoke engine, 3 rounds): card == CPU committed "
        f"tokens: {same}; lengths {[len(c) for c in committed['cuda']]}")
    if not same:
        raise AssertionError(f"card {committed['cuda']} != CPU {committed['cpu']}")


def _to(torch, tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    return [_to(torch, v, device) for v in tree]


def main_path(torch, np, ops, tcfg, dcfg, cache_dtype, device="cuda",
              K=8, M=128, NEW=64, max_len=1024):
    """Phase 5: the port's serving path at full width, through the cell."""
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
                        cache_kind="paged", page_size=16, device=device)
    engine.init_params(0)
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, tcfg.vocab_size, (K, M), generator=gen,
                            device=device, dtype=torch.int32)
    state = engine.start(prompts)
    torch.cuda.synchronize()
    log(f"main path: weights + prefill of {K}x{M} in "
        f"{time.perf_counter() - t0:.2f} s; pool {engine.num_pages} pages; "
        f"params target {engine.target.num_params(engine.t_params)} "
        f"draft {engine.draft.num_params(engine.d_params)}")
    backend = EngineBackend(engine, state)
    rng = np.random.default_rng(0)
    cfg = CellConfig(scheme="hete",
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
    ops.reset_counts()
    rounds, total_tokens, total_s = [], 0, 0.0
    for i in range(MAIN_ROUNDS):
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
        for op in ops.OPS:
            assert after[op]["kernel"] > before[op]["kernel"], (i, op, after)
            assert after[op]["plain"] == 0, (i, op, after)
        engine.t_pages.check_invariants()
        engine.d_pages.check_invariants()
        assert engine.host_syncs - h0 == 1, f"round {i}: {engine.host_syncs - h0} syncs"
        assert sum(grew) == int(acc.sum()), (grew, acc)
        total_tokens += int(acc.sum())
        total_s += dt
        rounds.append({"round": i, "ms": 1e3 * dt, "lengths": rec.lengths.tolist(),
                       "accepted": acc.tolist(), "committed": int(acc.sum())})
        log(f"round {i:2d}: {1e3 * dt:9.2f} ms  L={rec.lengths.tolist()}  "
            f"accepted={acc.tolist()}  committed {int(acc.sum())}  "
            f"active {len(cell.scheduler.active)}")
    counts = ops.counts()
    for op in ops.OPS:
        assert counts[op]["kernel"] > 0 and counts[op]["plain"] == 0, counts
    profile_rounds(torch, cell, PROFILE_ROUNDS)
    vocab = tcfg.vocab_size
    for c in backend.state.committed:
        assert c is None or all(0 <= int(t) < vocab for t in c)
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: {len(rounds)} rounds, {total_tokens} tokens in "
        f"{total_s:.3f} s wall = {total_tokens / total_s:.2f} tokens/s; "
        f"peak memory {peak / 2**30:.2f} GiB; launches {counts}; "
        f"summary {cell.summary()}")
    return counts, rounds


def profile_rounds(torch, cell, n):
    """Phase 5b: ``n`` more rounds of the same session under torch.profiler
    (after the checked rounds, so their counts are not mixed in): device
    busy time against host wall time, the kernels that take it, and the
    host<->device copies and syncs the round makes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        done = 0
        for _ in range(n):
            if cell.step() is None:
                break
            done += 1
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    if not done:
        log("profile: the session had drained; nothing profiled")
        return
    avgs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in avgs if dev_us(e) > 0
               and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(dev_us(e) for e in kernels)
    log(f"profile: {done} rounds, wall {wall_us / 1e3 / done:.2f} ms/round "
        f"(profiler on), device busy {busy / 1e3 / done:.2f} ms/round, "
        f"idle share {1 - busy / wall_us:.3f}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3 / done:9.3f} ms/round  {e.count / done:7.1f} "
            f"calls/round  {e.key[:90]}")
    for name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize",
                 "cudaDeviceSynchronize", "cudaHostAlloc"):
        hit = [e for e in avgs if e.key == name]
        if hit:
            log(f"  host: {name} {hit[0].count / done:.1f} calls/round, "
                f"{hit[0].cpu_time_total / 1e3 / done:.3f} ms/round")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.kernels import build, cases, ops
    from repro_torch.kernels import fused_verify_sample as fvs
    from repro_torch.kernels import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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

    # 4. small-input reference check
    reference_check(torch, np)

    # 5. the main path
    from repro_torch.configs import get_config

    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    counts, rounds = main_path(
        torch, np, ops, get_config("llama2-7b").replace(**bf16),
        get_config("tinyllama-1.1b").replace(**bf16), torch.bfloat16)

    # 6. result lines
    head = next(r for r in paged if (r["case"], r["dtype"]) == PAGED_HEADLINE)
    vhead = next(r for r in verify if r["case"] == VERIFY_HEADLINE)

    def entry(name, source, replaces, rec, recs):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": counts[name]["kernel"],
                "launches_per_round": counts[name]["kernel"] / len(rounds),
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
                "headline_case": f"{rec['case']} {rec.get('dtype', 'float32')}",
                "cases": recs}

    kernels = [
        entry("paged_attention", "src/repro_torch/csrc/paged_attention.cu",
              "src/repro/kernels/paged_attention.py:114", head, paged),
        entry("fused_verify_sample",
              "src/repro_torch/csrc/fused_verify_sample.cu",
              "src/repro/kernels/fused_verify_sample.py:181", vhead, verify),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
