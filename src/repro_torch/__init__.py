"""PyTorch/CUDA port of the Multi-SPIN reproduction.

The counterpart of the JAX package ``repro`` (which stays the reference):
the same module layout, torch tensors instead of jax arrays, and
hand-written CUDA kernels for Hopper (``kernels/``, ``csrc/``) in place of
the Pallas TPU kernels.  It imports neither jax nor anything of ``repro``.
Entry points run on the card unless the caller passes ``device="cpu"``.
Importing the package (or ``repro_torch.api``) loads no torch; the modules
that compute import ``repro_torch.precision``, which turns TF32 off.
"""
