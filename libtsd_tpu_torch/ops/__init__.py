from . import (fft, filter_rt, fir_design, iir_design, kernels,  # noqa: F401
               psd, resample, signal, window)
