"""Build the CUDA kernels from ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (``extern "C"``
functions taking raw pointers, ints and a ``cudaStream_t``) and is compiled
on its own into ``build/kernels/lib<name>-<hash>.so`` under the repository
root, at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

The hash covers the source and the flags, so an edited kernel is rebuilt and
a stale library is never loaded.  ``build_all`` starts one nvcc per source
at once and waits for all of them.  Nothing here runs at import time: the
CPU tests import every module of the port on a host without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNELS = ("paged_attention", "fused_verify_sample")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per kernel: {"seconds": build wall time, "ptxas": nvcc's -Xptxas -v lines}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                       " the CUDA kernels are built from csrc/ at first use")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    src, out = _target(name)
    if out.exists():
        return name, out, None, time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, out, (proc, tmp, cmd), time.perf_counter()


def _finish(name: str, out: Path, job, t0: float) -> None:
    if job is None:
        build_info.setdefault(name, {"seconds": 0.0, "ptxas": [],
                                     "cached": True})
        return
    proc, tmp, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)        # atomic: a concurrent build never sees half a file
    build_info[name] = {
        "seconds": time.perf_counter() - t0,
        "ptxas": [ln.strip() for ln in log.splitlines()
                  if "ptxas info" in ln or "spill" in ln],
        "cached": False,
    }


def build_all(names=KERNELS) -> dict[str, dict]:
    """Compile every named kernel in parallel (one nvcc each) and load them.
    Returns ``build_info``."""
    with _lock:
        jobs = [_start(n) for n in names if n not in _libs]
        errors = []
        for job in jobs:             # wait for every nvcc, even after a failure
            try:
                _finish(*job)
            except RuntimeError as err:
                errors.append(err)
        if errors:
            raise errors[0]
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(_target(name)[1]))
    return build_info


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib


def check(err: int, name: str) -> None:
    """Raise on a CUDA error code returned by a kernel's C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch "
                           f"(cudaGetLastError after the kernel launch)")
