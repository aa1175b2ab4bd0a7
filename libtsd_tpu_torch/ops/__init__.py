from . import fft, filter_rt, fir_design, kernels, psd, window  # noqa: F401
