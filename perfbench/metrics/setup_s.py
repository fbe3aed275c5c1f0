"""Seconds from the process's start to the window's: imports, kernels
from the cache (built on a checkout's first run), weights, the first
admissions, the prefill shapes and the compiled steps."""


def read(ctx):
    return ctx["setup_s"]
