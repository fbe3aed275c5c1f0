"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  Every share the
benchmark reports is taken against these, with the card's power limit
printed beside it."""

BF16_FLOPS = 989e12          # FLOP/s, bf16 and fp16 tensor cores
HBM_BYTES = 3.35e12          # bytes/s


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the compute peak and the bytes over the memory peak."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
