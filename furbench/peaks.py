"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): the table `chip_smoke.bound` uses."""

PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_INT32_OPS = 33.5e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12  # HBM3


def bound_s(flops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the FP32 peak and the bytes at the memory rate."""
    return max(flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES)
