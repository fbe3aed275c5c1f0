"""Host ms a round in the CUDA runtime's launch calls
(``cudaGraphLaunch`` and ``cudaLaunchKernel``), from the profiled
stretch."""


def read(ctx):
    p = ctx["profile"]
    return 1e3 * p["launch_s"] / len(p["rounds"]) if p["rounds"] else None
