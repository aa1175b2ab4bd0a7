"""Work of kernel #4, ``fft_pow2`` (``csrc/fft.cu``): B complex transforms
of n points, given and returned as float32 re/im planes.

Bytes: the two input planes read once and the two output planes written
once, 16 bytes a point.  Operations: 5 n log2 n flops a complex transform
(the radix-2 count; split-radix needs ~4 n log2 n, still far below the
bytes), on the fp32 pipes.  At n = 4096 that is 3.75 flops a byte, so the
bytes set the least time."""
from portbench.roofline import peaks


def work(B: int, n: int) -> tuple:
    return 5.0 * B * n * (n.bit_length() - 1), 16.0 * B * n


def least_seconds(B: int, n: int) -> tuple:
    ops, nbytes = work(B, n)
    return peaks.least_seconds(ops, nbytes, peaks.FP32_FLOPS)
