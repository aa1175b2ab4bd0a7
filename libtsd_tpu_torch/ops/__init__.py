from . import (corr, cqt, dwt, fft, filter_rt, fir_design,  # noqa: F401
               iir_design, kernels, poly, psd, resample, rng, signal, window)
