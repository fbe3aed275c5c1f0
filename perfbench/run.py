"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (a ``workloads`` entry of ``BENCHMARK.json``) names a configuration
and a traffic mix; weights, prompts and every random draw come from
``--seed``.  The process sets up (kernels from ``perfbench/cache/``, weights
on the card, the first requests admitted, the compiled round steps built),
serves the mix for ``--seconds`` and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the end-to-end metrics with ``--trace 0``, the per-layer ones with
``--trace 1``), ``device`` and, traced, ``breakdown``; its last key,
``check``, holds each number compared with its limit, which also close
standard error.  It exits non-zero with no result when the card is
missing, or when JAX or the JAX package was loaded.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "perfbench" / "cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Fixed cache directories inside the checkout, and the import path."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("REPRO_COMPILE_CACHE", None)
    os.environ.pop("REPRO_COMPILE", None)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from perfbench.lib import bench, manifest

    spec = manifest.cell(manifest.load(ROOT), args.workload)
    import torch

    torch.set_num_threads(2)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"perfbench: the cell needs {spec['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = bench.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_PROC0, str(CACHE / "kernels"))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, row in out["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
