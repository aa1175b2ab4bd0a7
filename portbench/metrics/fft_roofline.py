"""fft_roofline (%): kernel #4's share of its roofline in the Welch step,
one launch of C x nseg transforms of nfft points a call."""
from portbench.roofline import fft


def read(tr):
    total, count = tr.kernel_seconds("fft_kernel")
    if count == 0:
        return None
    t, c = tr.cell.traffic, tr.cell.config
    n, N = c["welch_nfft"], t["block"]
    nseg = max(len(range(0, N - n, n // 2)), 1)
    least, _ = fft.least_seconds(t["channels"] * nseg, n)
    return 100.0 * least * count / total
