#!/usr/bin/env python3
"""Per-phase timestamps of ``residual_sample`` (B5) on the card.

    python3 tools/sampler_stamps.py [N V ...]

Builds a stamped copy of ``src/repro_torch/csrc/residual_sample.cu`` into
``build/stamps/`` (the shipped kernel is not touched): thread 0 of each
block writes ``%globaltimer`` at the block's start (0), after its sweep and
block reductions (1), and, in the last block of a row to arrive, after the
prefix of the chunk masses (2), after the crossing chunk's first tile is
read back from L2 (3) and at its end (4).  Runs each (N, V) pair (default:
the path shapes of ``chip_smoke.RESIDUAL_CASES``, 8 x 32000 and
8 x 151936) on ``cases.residual_case`` inputs, 20 calls after 5 of warm-up,
and prints, over the rows that cross (row 3 on), the median in microseconds
of: the sweep (first block start to last block done), the tail after the
last arrival (to the end), its prefix part, the wait for the first tile
from L2, and the scan.
These say what a design in which the crossing chunk's own block scans from
registers could save (the L2 read) against what its per-row wait would
cost.  Needs one CUDA card and nvcc.
"""

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

N_STAMPS = 5
PRELUDE = r"""
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) \
  if (threadIdx.x == 0) \
    g_stamps[((size_t)blockIdx.x * gridDim.y + blockIdx.y) * 5 + (k)] = stamp_now()
extern "C" int residual_sample_set_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
"""
# (line of the kernel, stamp put before it)
ANCHORS = [
    ("  // ---- 1. this chunk's residual mass and argmax(p) ----\n", "STAMP(0);"),
    ("    if (C == 1) {\n      if (tid == 0) { zc_s = z;", "STAMP(1);"),
    ("  if (k < 0 || k >= C) return;     // block-uniform\n", "STAMP(2);"),
    ("    float total;\n    float cum = running", "if (base == k0) STAMP(3);"),
    ("  if (tid == 0) out[n] = found;\n", "STAMP(4);"),
]


def stamped_source() -> str:
    src = (ROOT / "src/repro_torch/csrc/residual_sample.cu").read_text()
    head, sep, rest = src.partition("namespace {\n")
    if not sep:
        raise SystemExit("residual_sample.cu: no anonymous namespace")
    src = head + PRELUDE + sep + rest
    for line, stamp in ANCHORS:
        if src.count(line) != 1:
            raise SystemExit(f"residual_sample.cu: anchor not found once: {line!r}")
        src = src.replace(line, stamp + "\n" + line)
    return src


def build() -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild

    out = ROOT / "build" / "stamps"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "residual_sample_stamps.cu"
    cu.write_text(stamped_source())
    lib = out / "libresidual_sample_stamps.so"
    subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-I",
                    str(kbuild.CSRC), "-o", str(lib), str(cu)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main(pairs) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import cases
    from repro_torch.kernels import fused_verify_sample as fvs
    from repro_torch.kernels import paged_attention as pa

    lib = build()
    launch = lib.residual_sample_launch
    launch.restype = ctypes.c_int
    launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    print("stamps", cs.card_line(), flush=True)
    for N, V in pairs:
        p, q, u = cases.residual_case(N, V, "cuda")
        dev = p.device
        C, chunk = fvs.row_split_plan(N, V, pa.sm_count(dev))
        stamps = torch.zeros(N * C * N_STAMPS, dtype=torch.int64, device=dev)
        if lib.residual_sample_set_stamps(ctypes.c_void_p(stamps.data_ptr())):
            raise SystemExit("cudaMemcpyToSymbol failed")
        scratch, tickets = pa.scratch_for(dev, 3 * N * C, N)
        out = torch.empty(N, dtype=torch.int32, device=dev)
        phases = {k: [] for k in ("sweep", "tail", "prefix", "first tile",
                                  "scan")}
        for it in range(25):
            stamps.zero_()
            err = launch(p.data_ptr(), q.data_ptr(), u.data_ptr(),
                         out.data_ptr(), N, V, C, chunk, scratch.data_ptr(),
                         tickets.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err or it < 5:
                if err:
                    raise SystemExit(f"launch error {err}")
                continue
            s = stamps.view(N, C, N_STAMPS).cpu()
            base = int(s[s > 0].min()) - 1      # ns, kept exact before float
            s = torch.where(s > 0, s - base, 0).double() / 1e3   # us, 0 = none
            for n in range(3, N):
                row = s[n]
                last = int(row[:, 4].argmax())
                if row[last, 4] == 0:
                    continue
                arrived = float(row[:, 1].max())
                phases["sweep"].append(arrived - float(row[:, 0].min()))
                phases["tail"].append(float(row[last, 4]) - arrived)
                phases["prefix"].append(float(row[last, 2]) - arrived)
                phases["first tile"].append(float(row[last, 3] - row[last, 2]))
                phases["scan"].append(float(row[last, 4] - row[last, 2]))
        print(f"residual_sample N={N} V={V} ({C} chunks of {chunk}): "
              + ", ".join(f"{k} {statistics.median(v):.3f} us"
                          for k, v in phases.items() if v)
              + f" (median over {len(phases['tail'])} rows x calls)",
              flush=True)


if __name__ == "__main__":
    nums = [int(a) for a in sys.argv[1:]]
    main(list(zip(nums[::2], nums[1::2])) or [(8, 32000), (8, 151936)])
