"""Plain reference of the Welch display, in float64 PyTorch.

Segments of nfft samples at starts 0, nfft/2, ... below n - nfft (the
start n - nfft itself left out, as libtsd's Welch does), each times the
periodic Hann window w[j] = 0.5 - 0.5 cos(2 pi j / nfft), an orthonormal
DFT (1/sqrt(nfft)), |X|^2 summed over the segments, bins fftshifted, then
10 log10(S + 1e-30).

``lower=True`` is the control: the samples and the window rounded to
bfloat16, the rest in float32 (torch has no bfloat16 FFT).

Imports neither JAX nor anything of the port.
"""
from __future__ import annotations

import numpy as np
import torch

_SEG = 4096   # segments a transform (~0.3 GiB of float64 work)


def psd_db(x: torch.Tensor, nfft: int, lower: bool = False) -> torch.Tensor:
    """x: (C, n) real.  Returns (C, nfft) float64 dB (float32 for the
    control) on x's device."""
    C, n = x.shape
    nseg = max(len(range(0, n - nfft, nfft // 2)), 1)
    dt = torch.float32 if lower else torch.float64
    j = torch.arange(nfft, device=x.device, dtype=torch.float64)
    w = 0.5 - 0.5 * torch.cos(2 * np.pi * j / nfft)
    xs = x
    if lower:
        w = w.to(torch.bfloat16)
        xs = x.to(torch.bfloat16)
    w = w.to(dt)
    out = torch.empty((C, nfft), dtype=dt, device=x.device)
    for c in range(C):
        S = torch.zeros(nfft // 2 + 1, dtype=dt, device=x.device)
        segs = xs[c].unfold(-1, nfft, nfft // 2)[:nseg]
        for s0 in range(0, nseg, _SEG):
            seg = segs[s0:s0 + _SEG].to(dt) * w
            S += (torch.fft.rfft(seg).abs().square() / nfft).sum(0)
        full = torch.cat([S, S[1:nfft // 2].flip(-1)])
        out[c] = torch.fft.fftshift(full)
    return 10.0 * torch.log10(out + 1e-30)
