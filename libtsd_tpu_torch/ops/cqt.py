"""Constant-Q transform (PyTorch), ported from ``libtsd_tpu/ops/cqt.py``.

Parity: core/include/tsd/fourier/cqt.hpp:13-71, core/src/fourier/cqt.cc
(per-bin kernels of constant Q = fk / bandwidth, streaming decimation).

The kernel banks are built on the host in float64 numpy, as in the JAX
package (these functions are copies).  ``cqt`` is one fp32 matmul of the
signal's frames against the dense bank.

``cqt_stream`` computes what the JAX package's ``lax.scan`` over N/2 hops
computes, without a loop over hops.  Neither part of the scan's carry
depends on the data: the buffer of block b is the b-th length-N frame of
the stream after N/2 zeros (one ``unfold``), and each bin's evaluation
phase follows an integer recurrence on the kernel alone, run here on the
host once.  So the blocks take one batched FFT and one batched
contraction against their phase ramps.  The contraction runs over groups
of adjacent bins, each cut to the positions and spectral support its bins
use (a bin's valid positions are a prefix of the Mmax slots), in chunks of
blocks; the slots it leaves out are the zeros the scan writes there.  The
phase ramps are rounded in float32 exactly as the scan rounds them
(2 pi (kimin + j) tau, the two products in that order), so the outputs
agree with the JAX package's to float32 summation order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..config import complex_dtype, real_dtype
from .filter_rt import _fp32_matmul
from .signal import sliding_frames
from .window import window as make_window

__all__ = ["CqtKernel", "cqt_kernel", "cqt", "cqt_freqs",
           "CqtStreamKernel", "cqt_stream_kernel", "cqt_stream",
           "cqt_interpolate"]

# bytes of the phase-ramp temporaries of one chunk of ``cqt_stream``
_PHASE_BUDGET = 256 << 20


@dataclasses.dataclass(frozen=True)
class CqtKernel:
    bank_re: np.ndarray    # (nbins, Nmax)
    bank_im: np.ndarray
    freqs: np.ndarray      # (nbins,)
    lengths: np.ndarray    # (nbins,)

    @property
    def Nmax(self) -> int:
        return self.bank_re.shape[1]


def cqt_freqs(fmin: float, fmax: float, bins_per_octave: int = 12
              ) -> np.ndarray:
    """Geometric frequency grid (parity: CQT bin layout, cqt.cc)."""
    noct = np.log2(fmax / fmin)
    nbins = int(np.floor(noct * bins_per_octave)) + 1
    return fmin * 2.0 ** (np.arange(nbins) / bins_per_octave)


def cqt_kernel(fmin: float, fmax: float, bins_per_octave: int = 12,
               window: str = "hn") -> CqtKernel:
    """The CQT kernel bank (host, float64).  Frequencies are normalised
    (cycles a sample).  Bin k has Q = 1 / (2^(1/b) - 1) periods, window
    length Nk = Q / fk, Hann windowed, centred in the common Nmax frame."""
    freqs = cqt_freqs(fmin, fmax, bins_per_octave)
    Q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    lengths = np.minimum(np.ceil(Q / freqs).astype(int) | 1, 1 << 20)
    Nmax = int(lengths.max())
    nbins = len(freqs)
    bank = np.zeros((nbins, Nmax), np.complex128)
    for k in range(nbins):
        Nk = int(lengths[k])
        w = make_window(window, Nk, sym=True)
        t = np.arange(Nk) - Nk // 2
        ker = w * np.exp(-2j * np.pi * freqs[k] * t)
        ker /= np.sum(w)
        off = (Nmax - Nk) // 2
        bank[k, off:off + Nk] = ker
    return CqtKernel(bank_re=bank.real, bank_im=bank.imag,
                     freqs=freqs, lengths=lengths)


def cqt(x: torch.Tensor, kernel: CqtKernel, hop: int = 256) -> torch.Tensor:
    """CQT magnitude matrix (nframes, nbins): frames centred every ``hop``
    samples, one fp32 matmul against the kernel bank."""
    n = x.shape[-1]
    Nmax = kernel.Nmax
    xp = F.pad(x if x.is_complex() else x.to(real_dtype), (Nmax // 2, Nmax))
    nframes = len(range(0, n, hop))
    Fr = sliding_frames(xp, Nmax, hop, nframes)       # (nframes, Nmax)
    Br = torch.as_tensor(kernel.bank_re, dtype=real_dtype, device=x.device)
    Bi = torch.as_tensor(kernel.bank_im, dtype=real_dtype, device=x.device)
    with _fp32_matmul():
        if Fr.is_complex():
            re = Fr.real @ Br.T - Fr.imag @ Bi.T
            im = Fr.real @ Bi.T + Fr.imag @ Br.T
        else:
            re = Fr @ Br.T
            im = Fr @ Bi.T
    return torch.sqrt(re * re + im * im)


# ---------------------------------------------------------------------------
# Streaming / decimated CQT (parity: CQT::Impl, cqt.cc:255-443)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CqtStreamKernel:
    """Frequency-domain truncated kernels (parity: CQTNoyaux,
    cqt.cc:10-204): per bin, the FFT of the windowed tone kept only on its
    significant support [kimin, kimin + ksize) (kernel 'precision'), the
    bin evaluated every ktime/2 samples (constant-Q decimation: high bins
    give outputs more often than low bins)."""
    kern_re: np.ndarray     # (nbins, ksmax) truncated spectral kernels
    kern_im: np.ndarray
    kimin: np.ndarray       # (nbins,) first retained FFT bin
    ksize: np.ndarray       # (nbins,) retained support length
    ktime: np.ndarray       # (nbins,) time support (samples)
    freqs: np.ndarray       # (nbins,) normalised frequencies
    N: int                  # FFT / buffer size
    Mmax: int               # most evaluations a half-block advance


def cqt_stream_kernel(fmin: float, fmax: float, gamma: float = 2 ** (1 / 12),
                      Q: float = 34.0, kprec: float = 0.99,
                      window: str = "hm") -> CqtStreamKernel:
    """The truncated spectral kernel bank (host, float64; frequencies
    normalised; parity: CQTNoyaux::configure/init_noyau, cqt.cc:63-204).
    N >= 2 ktime_max, so that a bin's window fits the buffer at every block
    alignment with the fixed N/2 hop (the reference instead consumes
    chunks of variable size, cqt.cc step1 minimal_position)."""
    nbins = int(np.ceil(np.log(fmax / fmin) / np.log(gamma)))
    freqs = fmin * gamma ** np.arange(nbins)
    ideal_N = int(np.ceil(Q / fmin))
    N = 1
    while N < 2 * ideal_N:
        N *= 2
    ktime = np.minimum(np.ceil(Q / freqs).astype(int), N // 2 - 1)
    ktime = ktime + (1 - ktime % 2)          # odd
    kimin = np.zeros(nbins, int)
    ksize = np.zeros(nbins, int)
    kerns = []
    for i in range(nbins):
        kt = int(ktime[i])
        ol = np.cos(2 * np.pi * freqs[i] * np.arange(1, N + 1))
        fen = np.asarray(make_window(window, kt, sym=False), np.float64)
        tmp = np.zeros(N)
        k2 = kt // 2
        tmp[N // 2 - k2: N // 2 - k2 + kt] = \
            ol[N // 2 - k2: N // 2 - k2 + kt] * fen
        X = np.fft.fft(tmp)
        Xa = np.abs(X) ** 2
        total = Xa.sum()
        jmax = int(np.argmax(Xa[: N // 2]))
        Sp = np.cumsum(Xa)
        pv = Sp[jmax - 1] if jmax >= 1 else 0.0
        seg = Sp[jmax: N // 2]
        hit = np.nonzero(seg > Xa[jmax: N // 2].sum() * kprec + pv)[0]
        j2 = (jmax - 1) + hit[0] if len(hit) else N // 2
        hit1 = np.nonzero(Sp[:jmax] > Xa[:jmax].sum() * (1 - kprec))[0]
        j1 = hit1[0] if len(hit1) else 1
        if j2 - j1 < 4:
            j2 = j1 + 4
        kimin[i] = j1
        ksize[i] = j2 - j1 + 1
        kerns.append(X[j1: j2 + 1] / np.sqrt(total))
    ksmax = int(ksize.max())
    bank = np.zeros((nbins, ksmax), np.complex128)
    for i in range(nbins):
        bank[i, : ksize[i]] = kerns[i]
    dt = np.maximum(ktime // 2, 1)
    Mmax = int(np.ceil((N // 2) / dt.min())) + 1
    return CqtStreamKernel(kern_re=bank.real, kern_im=bank.imag,
                           kimin=kimin, ksize=ksize, ktime=ktime,
                           freqs=freqs, N=N, Mmax=Mmax)


def _stream_phases(K: CqtStreamKernel, nblk: int) -> np.ndarray:
    """(nblk, nbins) first evaluation position of each bin in each block:
    the scan's ``kphase`` carry, which reads only the kernel.  It starts at
    N/2 (the zero-padded start, cqt.cc:264) and moves on by the positions
    evaluated, re-based after each hop."""
    N, hop = K.N, K.N // 2
    dt = np.maximum(K.ktime // 2, 1).astype(np.int64)
    kt = K.ktime.astype(np.int64)
    kp = np.full(len(kt), hop, np.int64)
    out = np.empty((nblk, len(kt)), np.int64)
    for b in range(nblk):
        out[b] = kp
        nev = np.clip((N - kt - kp) // dt + 1, 0, K.Mmax)
        kp = kp + nev * dt - hop
    return out


def _bin_groups(ksize: np.ndarray, mneed: np.ndarray):
    """Runs of adjacent bins whose support and position counts stay within
    2x of the run's first bin (both grow with the bin index)."""
    groups, i0 = [], 0
    for i in range(1, len(ksize) + 1):
        if (i == len(ksize) or ksize[i] > 2 * ksize[i0]
                or mneed[i] > 2 * max(mneed[i0], 1)):
            groups.append((i0, i, int(ksize[i0:i].max()),
                           max(int(mneed[i0:i].max()), 1)))
            i0 = i
    return groups


def cqt_stream(x: torch.Tensor, K: CqtStreamKernel):
    """Streaming decimated CQT (parity: CQT::Impl::step/step1,
    cqt.cc:280-365, with the frequency-domain time-shift mixer).

    x: (n,) real, n a multiple of N/2.  Returns (times, mags, valid), each
    (nblocks, nbins, Mmax), on x's device: bin k is evaluated every
    ktime[k]/2 samples, so high bins hold more valid entries; times are
    the absolute sample indices of each kernel window's start (int32)."""
    N = K.N
    hop = N // 2
    n = x.shape[-1]
    if x.ndim != 1 or n % hop:
        raise ValueError(f"cqt_stream takes one real signal whose length "
                         f"is a multiple of N/2 = {hop}; got shape "
                         f"{tuple(x.shape)}")
    nblk = n // hop
    nbins, ksmax = K.kern_re.shape
    dev = x.device
    dt = np.maximum(K.ktime // 2, 1).astype(np.int64)
    kt = K.ktime.astype(np.int64)
    m = np.arange(K.Mmax)
    # the data-independent half, on the host: positions, valid masks, times
    kphase = _stream_phases(K, nblk)                        # (nblk, nbins)
    pos = kphase[:, :, None] + m * dt[:, None]              # (nblk, nbins, M)
    valid = pos + kt[:, None] <= N
    t0 = (np.arange(nblk, dtype=np.int64) - 1) * hop
    times = ((t0[:, None, None] + pos) * valid).astype(np.int32)
    # the scan's float32 tau, exact: (kt - 2 pos - N) / (2 N)
    tau = ((kt[:, None] - 2 * pos - N) / (2.0 * N)).astype(np.float32)
    mneed = valid.sum(axis=2).max(axis=0)                   # (nbins,)

    jidx = np.minimum(K.kimin[:, None] + np.arange(ksmax)[None, :], N - 1)
    jmask = np.arange(ksmax)[None, :] < K.ksize[:, None]
    kern = torch.complex(
        torch.as_tensor(K.kern_re, dtype=real_dtype, device=dev),
        torch.as_tensor(K.kern_im, dtype=real_dtype, device=dev)
    ) * torch.as_tensor(jmask, device=dev)
    jidx_t = torch.as_tensor(jidx, device=dev)
    # 2 pi (kimin + j), rounded in float32 as the scan rounds it
    kidx = torch.as_tensor((K.kimin[:, None] + np.arange(ksmax)[None, :])
                           .astype(np.float32), device=dev)
    ramp = kidx * torch.tensor(np.float32(2 * np.pi), device=dev)

    # block b's buffer is the b-th length-N frame of the stream after hop
    # zeros
    frames = F.pad(x.to(real_dtype), (hop, 0)).unfold(-1, N, hop)
    mags = torch.zeros((nblk, nbins, K.Mmax), dtype=real_dtype, device=dev)
    groups = _bin_groups(K.ksize, mneed)
    per_blk = N * 8 + nbins * ksmax * 16
    step = max(1, _PHASE_BUDGET // per_blk)
    tau_t = torch.as_tensor(tau, device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    for b0 in range(0, nblk, step):
        b1 = min(nblk, b0 + step)
        X = torch.fft.fft(frames[b0:b1].to(complex_dtype), dim=-1)
        base = kern * X[:, jidx_t].conj()                  # (nb, nbins, ks)
        del X
        for i0, i1, ks, M in groups:
            per = (i1 - i0) * M * ks * 20
            sub = max(1, _PHASE_BUDGET // per)
            for c0 in range(b0, b1, sub):
                c1 = min(b1, c0 + sub)
                arg = (tau_t[c0:c1, i0:i1, :M, None]
                       * ramp[None, i0:i1, None, :ks])
                ph = torch.complex(torch.cos(arg), torch.sin(arg))
                del arg
                with _fp32_matmul():
                    corr = torch.matmul(
                        ph, base[c0 - b0:c1 - b0, i0:i1, :ks, None])[..., 0]
                del ph
                mags[c0:c1, i0:i1, :M] = (corr.abs()
                                          * valid_t[c0:c1, i0:i1, :M])
    return (torch.as_tensor(times, device=dev), mags, valid_t)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def cqt_interpolate(times, mags, valid, K: CqtStreamKernel, hop_out: int):
    """Resample the irregular per-bin outputs onto a regular grid of one
    column every ``hop_out`` input samples (parity: CQT::interpolation,
    cqt.cc:368-421): host numpy, returns (t, freqs, A[nframes, nbins])."""
    times, mags, valid = _host(times), _host(mags), _host(valid)
    t = times.transpose(1, 0, 2).reshape(times.shape[1], -1)
    v = mags.transpose(1, 0, 2).reshape(mags.shape[1], -1)
    ok = valid.transpose(1, 0, 2).reshape(valid.shape[1], -1)
    tmax = int(t[ok].max()) if ok.any() else 0
    nout = max(1, tmax // hop_out + 1)   # include the final partial span
    grid = np.arange(nout) * hop_out
    A = np.zeros((nout, t.shape[0]), np.float32)
    for k in range(t.shape[0]):
        tk, vk = t[k][ok[k]], v[k][ok[k]]
        if len(tk):
            A[:, k] = np.interp(grid, tk, vk)
    return grid, K.freqs, A
