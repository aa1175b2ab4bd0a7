"""ops_psd.other_device_ms (ms): device time a Welch step spends in kernels
other than #4 (segment copies, the window, |X|^2, the sum, the dB), per
step of the traced window."""


def read(tr):
    _, count = tr.kernel_seconds("fft_kernel")
    if count == 0 or tr.steps == 0:
        return None
    return 1e3 * tr.kernels_other_than("fft_kernel") / tr.steps
