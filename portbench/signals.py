"""The traffic generator: rings of stream blocks made on the card from the
seed, in a few large calls, from the parameters of a traffic file.

Every ring is one period of a stream: block r of channel c holds samples
r N .. (r + 1) N - 1 of that channel, and the tones (and the QAM symbol
stream) complete whole cycles over the ring, so a path that carries state
sees the stream go on without a break where the ring wraps.
"""
from __future__ import annotations

import numpy as np
import torch

_ROWS = 1 << 24   # samples a generator call makes at most (per chunk)


def lowpass(ntaps: int, cutoff: float) -> np.ndarray:
    """Hann-windowed sinc lowpass, ``ntaps`` taps, cutoff in cycles a
    sample, unit gain at DC (float64)."""
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(ntaps) / (ntaps - 1))
    h = 2 * cutoff * np.sinc(2 * cutoff * n) * w
    return h / h.sum()


def _tone(m: torch.Tensor, start: int, count: int, period: int,
          device) -> torch.Tensor:
    """sin(2 pi m n / period) for n = start .. start + count - 1, for each
    integer cycle count m (a (rows,) int64 tensor): (rows, count) float32,
    the phase reduced exactly in integers first."""
    n = torch.arange(start, start + count, device=device, dtype=torch.int64)
    ph = torch.remainder(m[:, None] * n[None, :], period)
    return torch.sin(ph.to(torch.float64) * (2 * np.pi / period)).to(
        torch.float32)


def _cycles(gen, rows: int, lo: float, hi: float, period: int, device):
    """Integer cycle counts over the ring for frequencies drawn uniformly
    in [lo, hi) cycles a sample."""
    f = lo + (hi - lo) * torch.rand(rows, generator=gen, device=device,
                                    dtype=torch.float64)
    return torch.round(f * period).to(torch.int64)


def adc_ring(gen, R: int, C: int, N: int, sig: dict, device) -> torch.Tensor:
    """(R, C, N) int16 ADC samples: white Gaussian noise of std
    ``noise_std`` LSB plus one tone a channel of amplitude ``tone_amp`` LSB
    at a frequency in ``tone_band``, rounded and clipped to int16."""
    out = torch.empty((R, C, N), dtype=torch.int16, device=device)
    period = R * N
    m = _cycles(gen, C, *sig["tone_band"], period, device)
    step = max(1, _ROWS // N)
    for r in range(R):
        for c0 in range(0, C, step):
            c1 = min(C, c0 + step)
            x = torch.randn((c1 - c0, N), generator=gen, device=device)
            x.mul_(sig["noise_std"])
            x.add_(_tone(m[c0:c1], r * N, N, period, device),
                   alpha=sig["tone_amp"])
            out[r, c0:c1] = x.round_().clamp_(-32768, 32767).to(torch.int16)
    return out


def tone_ring(gen, R: int, C: int, N: int, sig: dict,
              device) -> torch.Tensor:
    """(R, C, N) float32: the tones of ``tone_amps`` at frequencies drawn in
    ``tone_band`` (each channel its own) plus white Gaussian noise of std
    ``noise_std``: a display's strong carriers over a low floor."""
    out = torch.empty((R, C, N), dtype=torch.float32, device=device)
    period = R * N
    amps = sig["tone_amps"]
    m = _cycles(gen, C * len(amps), *sig["tone_band"], period,
                device).reshape(C, len(amps))
    step = min(N, _ROWS)
    for r in range(R):
        for c in range(C):
            for s0 in range(0, N, step):
                x = torch.randn(step, generator=gen, device=device)
                x.mul_(sig["noise_std"])
                for k, a in enumerate(amps):
                    x.add_(_tone(m[c, k:k + 1], r * N + s0, step, period,
                                 device)[0], alpha=a)
                out[r, c, s0:s0 + step] = x
    return out


def qam16_points(device=None) -> torch.Tensor:
    """The 16 points on the grid {-1, -1/3, 1/3, 1}^2, column-major (the
    port's and libtsd's QAM-16 order), complex128."""
    x = np.arange(4) / 3.0 * 2 - 1
    re, im = np.meshgrid(x, x, indexing="ij")
    pts = (re + 1j * im).reshape(16, order="F")
    return torch.as_tensor(pts, dtype=torch.complex128, device=device)


def rrc_response(f: torch.Tensor, beta: float) -> torch.Tensor:
    """Root-raised-cosine frequency response at f cycles a symbol (1 in
    the flat band)."""
    a = f.abs()
    lo, hi = (1 - beta) / 2, (1 + beta) / 2
    mid = torch.sqrt(0.5 * (1 + torch.cos(np.pi / beta * (a - lo))))
    return torch.where(a <= lo, torch.ones_like(a),
                       torch.where(a <= hi, mid, torch.zeros_like(a)))


def qam_ring(gen, R: int, C: int, nsym: int, q: dict,
             device) -> torch.Tensor:
    """(R, C, nsym osf) complex64: one QAM-16 symbol stream of R nsym
    symbols, RRC-shaped (roll-off ``beta``) over the whole ring at once
    (a circular convolution, so the stream wraps without a break), seen
    through ``len(delays)`` fractional sample delays repeated over the C
    channels, normalised to unit power, plus independent complex white
    Gaussian noise of std ``noise_std`` a real dimension."""
    osf = q["osf"]
    L = R * nsym * osf
    idx = torch.randint(0, 16, (R * nsym,), generator=gen, device=device)
    u = torch.zeros(L, dtype=torch.complex128, device=device)
    u[::osf] = qam16_points(device)[idx]
    f = torch.fft.fftfreq(L, device=device, dtype=torch.float64)
    U = torch.fft.fft(u) * rrc_response(f * osf, q["beta"])
    d = torch.tensor(q["delays"], dtype=torch.float64, device=device)
    X = torch.fft.ifft(U[None, :] * torch.exp(-2j * np.pi * f[None, :]
                                              * d[:, None]))
    X = X / X.abs().square().mean().sqrt()
    X = X.to(torch.complex64).reshape(len(q["delays"]), R, nsym * osf)
    out = torch.empty((R, C, nsym * osf), dtype=torch.complex64,
                      device=device)
    nd = len(q["delays"])
    for r in range(R):
        w = torch.randn((2, C, nsym * osf), generator=gen, device=device)
        w.mul_(q["noise_std"])
        sig = X[:, r].repeat(C // nd + 1, 1)[:C]
        out[r] = sig + torch.complex(w[0], w[1])
    return out
