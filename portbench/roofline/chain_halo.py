"""Work of kernel #11, the fused-halo ``fir_periodogram4096``
(``csrc/chain_halo.cu``), on one shard: the same function as kernel #3 on
the shard's samples with the left neighbour's tail as history, so the same
least work (``roofline/chain.py``).  The tail it stores for the right
neighbour (K - 1 samples a channel) and its partial spectra are counted
as bytes too."""
from portbench.roofline import chain, peaks


def work(C: int, N: int, K: int, precision: str) -> tuple:
    ops, nbytes = chain.work(C, N, K, precision)
    return ops, nbytes + C * (K - 1) * chain.SAMPLE_BYTES[precision]


def least_seconds(C: int, N: int, K: int, precision: str) -> tuple:
    ops, nbytes = work(C, N, K, precision)
    peak = peaks.FP32_FLOPS if precision == "highest" else peaks.BF16_FLOPS
    return peaks.least_seconds(ops, nbytes, peak)
