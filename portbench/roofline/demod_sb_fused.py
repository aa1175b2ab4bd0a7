"""Work of kernel #6, ``demod_sb_fused`` (``csrc/demod_sb.cu``): for C
channels, a block of n complex64 samples behind XOFF carried input
samples, the fp32 matched filter, the AGC pre-scale and the sub-block
timing / carrier / gain loop, n / osf symbols a channel.

Bytes: each input sample read once (the block and the carried tail), each
output written once (symbols complex64, decisions int32, valid flags one
byte), the 9 state rows of float32 read and written; the taps and the
constellation are noise.

Operations: no method can skip the per-symbol work, but it is small: the
fewest flops a symbol are the interpolation of the symbol and the
midpoint from the matched filter (the filter itself at the symbol and
midpoint instants only, Kmf taps each, complex by real), the rotation and
gain, and a decision on a square grid (a rounding, not a search):
2 x 2 (2 Kmf + 2 Kitrp) + 12 + 8 flops.  On the fp32 pipes that stays far
below the bytes, which set the least time."""
from portbench.roofline import peaks


def work(C: int, n: int, xoff: int, osf: int, kmf: int, kitrp: int) -> tuple:
    nsym = n // osf
    nbytes = C * (n + xoff) * 8 + C * nsym * (8 + 4 + 1) + 2 * 9 * C * 4
    ops = C * nsym * (4 * (2 * kmf + 2 * kitrp) + 20)
    return ops, nbytes


def least_seconds(C: int, n: int, xoff: int, osf: int, kmf: int,
                  kitrp: int) -> tuple:
    ops, nbytes = work(C, n, xoff, osf, kmf, kitrp)
    return peaks.least_seconds(ops, nbytes, peaks.FP32_FLOPS)
