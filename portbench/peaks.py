"""The table of peaks: NVIDIA's H100 SXM data sheet, dense rates, at the
card's full 700 W power limit. Every roofline and MFU of the benchmark is
a share of these, whatever unit a kernel runs on, so a kernel moved to
the tensor cores is judged against the same work."""

FP32_FLOPS = 67e12  # float32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12  # HBM3, bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the work can take: the larger of its operations over
    the float32 rate and its bytes over the memory rate."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES)
