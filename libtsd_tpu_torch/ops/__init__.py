from . import (fft, filter_rt, fir_design, iir_design, kernels,  # noqa: F401
               poly, psd, resample, rng, signal, window)
