"""PyTorch/CUDA port of the Multi-SPIN reproduction.

The counterpart of the JAX package ``repro`` (which stays the reference):
the same module layout, torch tensors instead of jax arrays, and
hand-written CUDA kernels for Hopper (``kernels/``, ``csrc/``) in place of
the Pallas TPU kernels.  It imports neither jax nor anything of ``repro``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

import torch as _torch

# float32 matmuls and convolutions stay full float32 on the card (no TF32)
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
