"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet,
dense rates, at the full 700 W power limit).  A card set below 700 W runs
slower under load: the result line gives the card's ``power.limit``."""

HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12          # outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12         # tensor cores, also fp16
INT8_OPS = 1979e12


def least_seconds(ops: float, nbytes: float, peak: float) -> tuple:
    """(least time, "bytes" or "ops"): the larger of bytes over HBM
    bandwidth and operations over the peak of the unit."""
    tb, to = nbytes / HBM_BYTES_S, ops / peak
    return (tb, "bytes") if tb >= to else (to, "ops")
