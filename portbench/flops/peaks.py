"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set below
700 W reaches less; the harness prints the card's limit beside every
share it reports."""

BF16_FLOPS = 989e12        # tensor cores, bf16 in, fp32 accumulate
FP32_FLOPS = 67e12         # fp32 outside the tensor cores
HBM_BYTES = 3.35e12        # HBM3 bytes a second


def bound_s(flops: float, nbytes: float, flops_peak: float = BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth."""
    return max(flops / flops_peak, nbytes / HBM_BYTES)
