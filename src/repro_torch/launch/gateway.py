"""Multi-SPIN live serving gateway CLI of the port.

  PYTHONPATH=src python -m repro_torch.launch.gateway --port 8011  # synthetic
  PYTHONPATH=src python -m repro_torch.launch.gateway --backend engine \
      --arch qwen2.5-3b --smoke-arch --scheme hete

Stands up a ``MultiSpinCell`` and serves it live over HTTP/1.1 + SSE
(``POST /v1/generate`` streams committed tokens per round; ``GET /metrics``
is Prometheus; see ``repro_torch.serving.gateway``), as
``repro.launch.gateway`` does.  The synthetic backend needs no torch and
starts instantly; ``--backend engine`` builds a paged ``SpecEngine`` on
``--device`` (the card unless ``--device cpu``) and streams actual
committed token ids.  ``--compile jit`` / ``jit+donate`` serve the J=1
rounds through CUDA graphs of the round steps, captured at ``(max_batch,
L)`` for each ``--warmup-lengths`` L before serving; ``--compile-cache``
keeps the built kernels in a directory that outlives the process.

``--smoke`` does not serve: it runs an in-process loadgen burst against the
configured cell and prints the report, so the full client->server->cell
loop can be exercised from one command with no open port.
"""

from __future__ import annotations

import argparse
import asyncio
import json

from repro_torch.core.schemes import (
    available_schemes,
    parse_scheme_args,
    scheme_help_text,
)
from repro_torch.serving.cell import SCHEDULES


def build_cell(args):
    import numpy as np

    from repro_torch.api import CellConfig, MultiSpinCell
    from repro_torch.core.channel import ChannelConfig

    scheme_params = parse_scheme_args(args.scheme, args.scheme_arg)
    if args.backend == "synthetic":
        cfg = CellConfig(scheme=args.scheme, scheme_params=scheme_params,
                         schedule=args.schedule, max_batch=args.max_batch,
                         t_ver_fix=0.035, t_ver_lin=0.0177, L_max=args.L_max,
                         seed=args.seed)
        return MultiSpinCell(cfg)

    import torch

    from repro_torch.api import EngineBackend, SpecEngine
    from repro_torch.configs import get_config

    tcfg = get_config(args.arch)
    if args.smoke_arch:
        tcfg = tcfg.smoke()
    dcfg = tcfg.smoke().replace(num_layers=1, d_model=64, num_heads=2,
                                num_kv_heads=1, head_dim=32, d_ff=128,
                                vocab_size=tcfg.vocab_size, name="draft")
    engine = SpecEngine(tcfg, dcfg, max_len=args.max_len, cache_kind="paged",
                        num_pages=args.max_batch * 2 * (args.max_len // 16),
                        compile_mode=args.compile,
                        compile_cache=args.compile_cache, device=args.device)
    engine.init_params(args.seed)
    gen = torch.Generator(device=engine.device).manual_seed(args.seed + 1)
    prompts = torch.randint(0, tcfg.vocab_size, (args.max_batch, 8),
                            generator=gen, device=engine.device,
                            dtype=torch.int32)
    state = engine.start(prompts)
    if args.compile != "eager":
        # capture the round steps before the first live request; the cell
        # dispatches full-batch rounds at the draft depth the scheme picks,
        # so warm (max_batch, L) per length
        lengths = ([int(x) for x in args.warmup_lengths.split(",") if x]
                   if args.warmup_lengths else [args.L_max])
        state, info = engine.warmup(
            state, sorted({(args.max_batch, L) for L in lengths}))
        print(f"warmup: built {len(info)} bucket(s) in "
              f"{sum(info.values()):.1f}s "
              f"(compile cache: {args.compile_cache or 'off'})")
    backend = EngineBackend(engine, state, keep_finished_tokens=True)
    cfg = CellConfig(scheme=args.scheme, scheme_params=scheme_params,
                     schedule=args.schedule, max_batch=args.max_batch,
                     channel=ChannelConfig(vocab_size=tcfg.vocab_size),
                     t_ver_fix=0.035, t_ver_lin=0.0177, L_max=args.L_max,
                     seed=args.seed)
    return MultiSpinCell(cfg, backend=backend,
                         rng=np.random.default_rng(args.seed))


async def _serve(args):
    from repro_torch.serving.gateway import GatewayConfig, MetricsHub, serve

    cell = build_cell(args)
    hub = MetricsHub(trace_path=args.trace)
    gcfg = GatewayConfig(host=args.host, port=args.port,
                         trace_spans=args.trace_spans,
                         trace_device_sync=args.trace_device_sync)
    print(f"multi-spin gateway: scheme={args.scheme} backend={args.backend} "
          f"max_batch={args.max_batch}")
    print(f"  GET  http://{args.host}:{args.port}/              (dashboard)")
    print(f"  POST http://{args.host}:{args.port}/v1/generate   (SSE)")
    print(f"  GET  http://{args.host}:{args.port}/metrics       (Prometheus)")
    print(f"  GET  http://{args.host}:{args.port}/v1/stats      (JSON)")
    if args.trace_spans:
        print(f"  GET  http://{args.host}:{args.port}/v1/trace      "
              "(Perfetto JSON)")
    await serve(cell, config=gcfg, hub=hub)


async def _smoke(args):
    from repro_torch.serving.gateway import (
        GatewayClient,
        GatewayConfig,
        LoadGenConfig,
        MultiSpinGateway,
        run_loadgen,
    )

    cell = build_cell(args)
    gw = MultiSpinGateway(cell, GatewayConfig(port=0, idle_wait_s=0.02))
    await gw.start()
    try:
        report = await run_loadgen(
            "127.0.0.1", gw.port,
            LoadGenConfig(rate_per_s=32.0, n_requests=args.smoke_requests,
                          max_new_tokens_choices=(4, 8), seed=args.seed))
        stats = await GatewayClient(port=gw.port).stats()
    finally:
        await gw.stop()
    report.pop("records", None)
    report["rounds_total"] = stats["rounds_total"]
    print(json.dumps(report, indent=2, sort_keys=True))
    if report["n_error"]:
        raise SystemExit(f"gateway smoke FAILED: {report['errors']}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=scheme_help_text())
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8011,
                    help="0 picks an ephemeral port")
    ap.add_argument("--backend", default="synthetic",
                    choices=("synthetic", "engine"))
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help="target architecture (engine backend)")
    ap.add_argument("--smoke-arch", action="store_true",
                    help="shrink the engine arch to smoke scale")
    ap.add_argument("--max-len", type=int, default=256,
                    help="engine stream length ceiling")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: the card)")
    ap.add_argument("--compile", default="eager",
                    choices=("eager", "jit", "jit+donate"),
                    help="engine round-path compile mode (engine backend): "
                         "jit / jit+donate replay CUDA graphs of the round "
                         "steps")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="kernel build directory kept across restarts "
                         "(also: REPRO_COMPILE_CACHE)")
    ap.add_argument("--warmup-lengths", default="", metavar="L1,L2,...",
                    help="draft depths to capture at startup when "
                         "--compile != eager (default: L-max only)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--scheme", default="hete", choices=available_schemes())
    ap.add_argument("--scheme-arg", action="append", default=[],
                    metavar="KEY=VAL",
                    help="scheme parameter (repeatable); valid keys below")
    ap.add_argument("--schedule", default="sync", choices=SCHEDULES)
    ap.add_argument("--L-max", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="append per-round RoundMetrics JSONL here")
    ap.add_argument("--trace-spans", action="store_true",
                    help="install the span tracer; GET /v1/trace serves "
                         "Chrome trace-event JSON for Perfetto")
    ap.add_argument("--trace-device-sync", action="store_true",
                    help="synchronize the card at span exits so device time "
                         "lands in the enclosing span (slower rounds)")
    ap.add_argument("--smoke", action="store_true",
                    help="no server: in-process loadgen burst, print report")
    ap.add_argument("--smoke-requests", type=int, default=8)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    try:
        asyncio.run(_smoke(args) if args.smoke else _serve(args))
    except KeyboardInterrupt:
        print("\ngateway stopped")


if __name__ == "__main__":
    main()
