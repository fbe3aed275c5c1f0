#!/usr/bin/env python3
"""Run the host-timed plain decode, int8, paligemma-3b and whisper-large-v3
paths of one checkout's ``chip_smoke.py`` on the card, to compare two
commits within one call.

    python3 tools/host_paths.py <checkout root> <label> [--beside WORK]

Imports ``chip_smoke`` and the port from ``<checkout root>`` (``.``, or
another commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists) and runs, in bfloat16: the Llama-2-7B plain decode
path (phase 9), its int8 pass (phase 10) three times on that engine (the
first pass is the one ``chip_smoke.py`` reports), the paligemma-3b path in
both cache layouts (phase 16) and the whisper-large-v3 path (phase 17),
each printing its times and launches.  ``--beside dryrun`` starts the
checkout's phase-19 dry-run cells (``chip_smoke.dryrun_begin``,
subprocesses on the host's CPU) just before the paligemma-3b path and
waits for them after the whisper path; ``--beside restart`` does the same
with phase 18c's training restart (``training_restart_begin``, whose
checkpoint write goes on in a thread of this process): this measures what
each costs the host-timed phases that run beside it in ``chip_smoke.py``.
Run one process per checkout, in turns: parent, change, change, parent.
Needs one CUDA card.
"""

import gc
import sys
import time


def main(root: str, label: str, beside: str | None) -> None:
    sys.path.insert(0, root + "/src")
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import cases, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_attention_q8 as daq

    print(label, cs.__file__, ops.__file__, cs.card_line(), flush=True)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = get_config("llama2-7b").replace(param_dtype="bfloat16",
                                         compute_dtype="bfloat16")
    _, eng, state = cs.plain_decode_path(torch, ops, cfg)
    for i in range(3):
        _, (rec,), _ = cs.int8_path(torch, ops, cases, da, daq, eng, state)
        print(f"{label} int8 pass {i}: {rec['wall_ms']:.2f} ms wall",
              flush=True)
    del eng, state
    free()
    if beside == "dryrun":
        work = cs.dryrun_begin()
    elif beside == "restart":
        work = cs.training_restart_begin(torch, np, ops)
    t1 = time.perf_counter()
    cs.vlm_path(torch, ops)
    free()
    cs.encdec_path(torch, ops)
    free()
    print(f"{label} paths in {time.perf_counter() - t0:.1f} s (paligemma "
          f"and whisper {time.perf_counter() - t1:.1f} s)", flush=True)
    if beside == "dryrun":
        cs.dryrun_end(work, label=f"{label} dry run")
    elif beside == "restart":
        cs.training_restart_end(torch, np, work)


if __name__ == "__main__":
    args = sys.argv[1:]
    main(args[0], args[1],
         args[args.index("--beside") + 1] if "--beside" in args else None)
