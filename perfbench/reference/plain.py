"""What every architecture's plain reference shares: float32 products with
TF32 off, and the control's W8A8 step.

``q8`` is the control (``fp8=True`` on a ``Reference``): a matrix
product's weight quantized per output column and its input per token to
float8_e4m3fn (scales by absolute maximum, products in float32), the step
below the configurations' bfloat16.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` through float8_e4m3fn with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN, the
    previous settings restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
