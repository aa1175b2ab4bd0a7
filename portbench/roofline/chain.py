"""Work of kernel #3, ``fir_periodogram4096`` (``csrc/chain.cu``): a K-tap
FIR over C channels of N samples with a carried history, then the sum over
the N / 4096 frames of |DFT_4096|^2.

Bytes: each input sample read once (the block and the K - 1 history
samples), each spectrum bin written once as float32; the taps are noise.

Operations: the fewest of any method that computes the same function, not
what the kernel's Toeplitz blocks perform.  The cheapest known method is
an FFT-based FIR (overlap-save, one 8192-point real FFT of 4096 + K - 1
inputs, a product with the filter's spectrum, one inverse) followed by the
4096-point real FFT and |X|^2: with 2.5 n log2 n flops a real FFT of n
points, 2 x 2.5 x 8192 x 13 + 6 x 4097 + 2.5 x 4096 x 12 + 4 x 2049
= 688,138 flops a 4096-sample frame, 168 a sample (for K <= 4097).  They
are taken at the peak of the unit the tier multiplies on: the bf16 tiers
(int16, int8, bf16, split) on the bf16 tensor cores, "highest" on the
fp32 pipes.  At int16/2 on 256 x 2^22 that gives 0.18 ms against the
bytes' 0.64 ms, so the bytes set the least time, and no method, at any
precision, can read over 100 %.
"""
from portbench.roofline import peaks

FRAME = 4096
FLOPS_PER_FRAME = (2 * 2.5 * 8192 * 13 + 6 * 4097 + 2.5 * 4096 * 12
                   + 4 * 2049)
SAMPLE_BYTES = {"int16": 2, "int8": 1, "bf16": 2, "split": 4, "highest": 4}


def work(C: int, N: int, K: int, precision: str) -> tuple:
    """(operations, bytes) of one call."""
    sb = SAMPLE_BYTES[precision]
    nbytes = C * (N + K - 1) * sb + C * FRAME * 4
    ops = C * (N // FRAME) * FLOPS_PER_FRAME
    return ops, nbytes


def least_seconds(C: int, N: int, K: int, precision: str) -> tuple:
    ops, nbytes = work(C, N, K, precision)
    peak = peaks.FP32_FLOPS if precision == "highest" else peaks.BF16_FLOPS
    return peaks.least_seconds(ops, nbytes, peak)
