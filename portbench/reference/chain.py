"""Plain reference of the spectral monitor's step, in float64 PyTorch.

For each channel: y = h * x, the FIR over the block with the last
len(h) samples of the block before it as history; then the sum over the
block's 4096-sample frames of |DFT_4096(frame of y)|^2, natural bin order,
unnormalised, no window.  The configuration's tier (int16 samples, taps
rounded to bfloat16 at int16/2) is stated arithmetic, so the taps are
rounded here too; everything else is float64.  The FIR runs as an exact
linear convolution through 8192-point FFTs, one frame at a time (4096
outputs need 4096 + len(h) - 1 inputs).

Imports neither JAX nor anything of the port.
"""
from __future__ import annotations

import numpy as np
import torch

NFFT = 4096
_CH = 8   # channels at a time (~2 GiB of float64 work)


def bf16_round(h: np.ndarray) -> np.ndarray:
    """Round float64 values to bfloat16 (nearest even), back to float64."""
    return torch.as_tensor(h).to(torch.bfloat16).to(torch.float64).numpy()


def spectra(x: torch.Tensor, prev: torch.Tensor, taps: np.ndarray,
            round_taps: bool) -> torch.Tensor:
    """x: (C, N) samples of this block; prev: (C, >= len(taps) - 1) the
    samples before it (zeros for a fresh stream); taps: float64.  Returns
    (C, 4096) float64 on x's device."""
    h = bf16_round(taps) if round_taps else np.asarray(taps, np.float64)
    K = len(h)
    C, N = x.shape
    nf = N // NFFT
    dev = x.device
    Hf = torch.fft.rfft(torch.as_tensor(h, device=dev), 2 * NFFT)
    out = torch.empty((C, NFFT), dtype=torch.float64, device=dev)
    for c0 in range(0, C, _CH):
        c1 = min(C, c0 + _CH)
        xe = torch.cat([prev[c0:c1, prev.shape[1] - (K - 1):], x[c0:c1]],
                       -1).to(torch.float64)
        # frame f of y needs xe[f 4096 .. f 4096 + 4096 + K - 2]
        seg = xe.unfold(-1, NFFT + K - 1, NFFT)            # (c, nf, .)
        y = torch.fft.irfft(torch.fft.rfft(seg, 2 * NFFT) * Hf, 2 * NFFT)
        y = y[..., K - 1:K - 1 + NFFT]
        del seg
        P = torch.fft.rfft(y).abs().square().sum(1)       # (c, 2049)
        del y
        out[c0:c1, :NFFT // 2 + 1] = P
        out[c0:c1, NFFT // 2 + 1:] = P[:, 1:NFFT // 2].flip(-1)
    assert nf * NFFT == N
    return out


def worst_bin_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| / want over every bin of every channel."""
    g = got.to(device=want.device, dtype=torch.float64)
    return float(((g - want).abs() / want).max())
