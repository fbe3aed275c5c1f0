"""Read the numbers that set a cell's limits: the program's check readings
over many seeds and the control's (the fp8 reference in the program's
place) over some of them, in one process.

    python3 perfbench/readings.py --workload <cell> --seeds 11 12 13 \
        --control 2 --seconds 15 [--out FILE]

Each seed is a whole run of the cell (its own weights, prompts and draws,
the timed path at the cell's load for ``--seconds``); the first
``--control`` seeds also read the control at the same positions.  One JSON
line a seed goes to standard output and to ``--out``.  The benchmark's own
runs never run the control.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import CACHE, ROOT, _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    _environment()
    from perfbench.lib import bench, manifest

    import torch

    spec = manifest.cell(manifest.load(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        t0 = T_PROC0 if i == 0 else time.perf_counter()
        out = bench.run_cell(spec, seed, args.seconds, False, "cuda", t0,
                             str(CACHE / "kernels"),
                             control=i < args.control)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "correct": out["correct"],
                           "check": out["check"],
                           "control": out.get("control"),
                           "metrics": out["metrics"], "info": out["info"]})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
