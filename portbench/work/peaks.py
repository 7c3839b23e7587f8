"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the card's full 700 W), as the port's
``launch/mesh.py`` states them.  A share of a peak is stated against these,
with the card's power limit beside it."""

PEAK_FLOPS_BF16 = 989e12     # FLOP/s, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12    # B/s


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card can take for a call: the larger of its
    operations over the bf16 peak and its bytes over the HBM rate."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)
