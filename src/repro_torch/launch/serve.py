"""Multi-SPIN serving command line of the port.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --smoke --devices 4 --rounds 6 --scheme hete

Stands up a ``MultiSpinCell`` (controller + channel + scheduler) with the
port's real-model ``EngineBackend`` on a ``SpecEngine`` and drives the
session loop, as ``repro.launch.serve`` does.  The engine is built as the
JAX CLI builds it, ``SpecEngine(target, draft, max_len=512)``: the default
contiguous cache layout, the batch fixed at start.  Runs on the card unless
``--device cpu``.  ``--dry-run`` traces the serve step of ``--shape`` under
the production mesh on fake tensors (``launch.dryrun.run_cell``) and prints
its status and roofline.
"""

from __future__ import annotations

import argparse

from repro_torch.core.schemes import (
    available_schemes,
    parse_scheme_args,
    scheme_help_text,
)
from repro_torch.serving.cell import SCHEDULES


def main(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=scheme_help_text())
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--scheme", default="hete", choices=available_schemes())
    ap.add_argument("--scheme-arg", action="append", default=[],
                    metavar="KEY=VAL",
                    help="scheme parameter (repeatable); the valid keys per "
                         "scheme are listed below, from each scheme's "
                         "declared Params schema")
    ap.add_argument("--schedule", default="sync", choices=SCHEDULES)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: the card)")
    args = ap.parse_args(argv)
    scheme_params = parse_scheme_args(args.scheme, args.scheme_arg)

    if args.dry_run:
        from repro_torch.launch.dryrun import run_cell
        res = run_cell(args.arch, args.shape, args.multi_pod, force=True)
        print(res.get("status"), res.get("roofline", res.get("error")))
        return

    import numpy as np
    import torch

    from repro_torch.api import (
        CellConfig,
        ChannelConfig,
        EngineBackend,
        MultiSpinCell,
        Request,
        SpecEngine,
    )
    from repro_torch.configs import get_config

    rng = np.random.default_rng(0)
    tcfg = get_config(args.arch)
    if args.smoke:
        tcfg = tcfg.smoke()
    dcfg = tcfg.smoke().replace(num_layers=1, d_model=64, num_heads=2,
                                num_kv_heads=1, head_dim=32, d_ff=128,
                                vocab_size=tcfg.vocab_size, name="draft")
    engine = SpecEngine(tcfg, dcfg, max_len=512, device=args.device)
    engine.init_params(0)

    K = args.devices
    gen = torch.Generator(device=engine.device).manual_seed(1)
    prompts = torch.randint(0, tcfg.vocab_size, (K, 8), generator=gen,
                            device=engine.device, dtype=torch.int32)
    backend = EngineBackend(engine, engine.start(prompts))

    cfg = CellConfig(
        scheme=args.scheme, scheme_params=scheme_params,
        schedule=args.schedule,
        channel=ChannelConfig(vocab_size=tcfg.vocab_size),
        t_ver_fix=0.035, t_ver_lin=0.0177, L_max=8, max_batch=K)
    cell = MultiSpinCell(cfg, backend=backend, rng=rng)
    for i in range(K):
        cell.submit(Request(rid=i, prompt_len=8,
                            max_new_tokens=args.max_new_tokens,
                            alpha=float(rng.choice([0.71, 0.74, 0.86])),
                            T_S=0.009 * float(rng.uniform(0.85, 1.15))))

    for i in range(args.rounds):
        rec = cell.step()
        if rec is None:
            break
        print(f"round {i}: J={rec.draft_width} L={rec.lengths} "
              f"accepted={rec.accepted} "
              f"goodput={rec.realized_goodput:.1f} tok/s "
              f"active={len(cell.scheduler.active)}")
    s = cell.scheduler.stats
    print(f"\ncompleted={s.completed} tokens={s.total_tokens} "
          f"goodput={s.goodput:.1f} tok/s over {s.wall_time:.2f}s simulated")


if __name__ == "__main__":
    main()
