#!/usr/bin/env python3
"""Time bf16 paged attention (B1) under several splits of its slot axis.

    python3 tools/paged_split_sweep.py [--always] [blocks per SM ...]

For each ``BLOCKS_PER_SM`` of ``kernels/paged_attention.py`` (default 1 2
4 8 16; with ``--always`` every grid is split, not only those of fewer
blocks than SMs), the kernel at the main-path shapes of ``chip_smoke.py`` (the
Llama-2-7B verify window, the TinyLlama-1.1B draft step and both prefills)
on the phase-3 tables and on 64-slot serving tables: the split plan, the
kernel's time (``cases.time_ms``) and its error against the float32 plain
version (held to ``cases.PAGED_TOL``).  One line per setting; the card's
name and power limit first.  Needs one CUDA card and nvcc.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [
    # name, (B, T, H, KV, D, ps, ctx), table width (None: the phase-3 table)
    ("verify", (8, 9, 32, 32, 128, 16, 512), None),
    ("verify, serving table", (8, 9, 32, 32, 128, 16, 512), 64),
    ("draft", (8, 1, 32, 4, 64, 16, 512), None),
    ("draft, serving table", (8, 1, 32, 4, 64, 16, 512), 64),
    ("llama prefill", (8, 127, 32, 32, 128, 16, 1), None),
    ("tinyllama prefill", (8, 127, 32, 4, 64, 16, 1), None),
]


def main(settings, always: bool) -> int:
    import torch

    from repro_torch.kernels import cases
    from repro_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        print("paged_split_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rtol, atol = cases.PAGED_TOL[torch.bfloat16]
    n_sm = pa.sm_count(torch.device("cuda"))
    ok = True
    if always:
        pa.SPLIT_BELOW = float("inf")
    for per_sm in settings:
        pa.BLOCKS_PER_SM = per_sm
        cells = []
        for name, shape, width in SHAPES:
            args = cases.paged_case(*shape, dtype=torch.bfloat16, device="cuda",
                                    width=width)
            B, T, H, D = args[0].shape
            plan = pa.split_plan(B, args[1].shape[2], T * (H // args[1].shape[2]),
                                 args[3].shape[1], args[1].shape[1], n_sm)
            got = pa.paged_attention_cuda(*args).float()
            want = cases.paged_attention_held(*args)
            err = float((got - want).abs().max())
            ok &= bool(torch.allclose(got, want, rtol=rtol, atol=atol))
            ms = cases.time_ms(lambda: pa.paged_attention_cuda(*args))
            cells.append(f"{name} ({args[3].shape[1]} slots) {plan[2]} splits "
                         f"of {plan[3]} {ms:.4f} ms err {err:.1e}")
        print(f"BLOCKS_PER_SM={per_sm} SPLIT_BELOW={pa.SPLIT_BELOW}: "
              + " | ".join(cells), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--always"]
    sys.exit(main([int(a) for a in args] or [1, 2, 4, 8, 16],
                  "--always" in sys.argv[1:]))
