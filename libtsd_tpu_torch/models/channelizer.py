"""Polyphase-FFT channelizer (PyTorch), ported from
``libtsd_tpu/models/channelizer.py``: split a wideband signal into M
uniformly spaced channels, each decimated by M, in one pass.

The reference declares channelization (canalise/décanalise,
core/src/telecom/canalisation/canalisation.cc) but its polyphase-FFT path
is commented out; this is the completed design of the JAX package: the
polyphase partition is a reshape, each branch's FIR K shifted-slice
multiply-adds, and the channel separation one batched FFT across the
branches.  The FFTs are ``torch.fft`` calls, as the JAX package's are
``jnp.fft`` calls.

y[m, c] = channel c at decimated time m, centred at f_c = c/M.  The state
is complex64 (the JAX package keeps re/im planes).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..block import Block, pad_to_multiple
from ..config import complex_dtype, device as _device, real_dtype
from ..ops.fir_design import fir_lowpass, root_raised_cosine

__all__ = ["Channelizer", "channelize", "dechannelize",
           "wola_analysis", "wola_synthesis"]


def _branch_mac(full: torch.Tensor, taps: torch.Tensor,
                m: int) -> torch.Tensor:
    """sum_k full[:, k:k+m] taps[:, k], in the JAX package's order of
    terms (full: (M, K-1+m) complex, taps: (M, K) complex)."""
    out = None
    for k in range(taps.shape[1]):
        term = full[:, k:k + m] * taps[:, k:k + 1]
        out = term if out is None else out + term
    return out


class Channelizer(Block):
    """M-channel critically sampled polyphase-FFT analysis bank.

    The prototype lowpass h (length K M) is split into M branches
    P[p, j] = h[j M + p]; the input phases x_p[m] = x[m M - p] run through
    the branches, and an M-point IFFT across p gives all channels at once.
    """

    def __init__(self, P: torch.Tensor, M: int):
        super().__init__()
        self.register_buffer("P", P)       # (M, K) branch taps
        self.M = M

    @classmethod
    def create(cls, M: int, taps_per_branch: int = 8,
               h: Optional[np.ndarray] = None,
               device="cuda") -> "Channelizer":
        if h is None:
            h = fir_lowpass(M * taps_per_branch, 0.5 / M, "hn") * M
        K = len(h) // M
        h = np.asarray(h[:K * M], np.float64)
        P = h.reshape(K, M).T                 # P[p, j] = h[j M + p]
        return cls(torch.as_tensor(P, dtype=real_dtype,
                                   device=_device(device)), M)

    @property
    def ratio(self):
        return 1.0 / self.M

    def init(self):
        K = self.P.shape[1]
        dev = self.P.device
        return dict(
            hist=torch.zeros((self.M, K - 1), dtype=complex_dtype,
                             device=dev),
            raw=torch.zeros((self.M - 1,), dtype=complex_dtype,
                            device=dev),      # the last M-1 samples
        )

    def step(self, state, x: torch.Tensor):
        """x: (n,) with n % M == 0 -> (n // M, M) channel matrix."""
        M = self.M
        n = x.shape[-1]
        if n % M:
            raise ValueError(f"Channelizer.step: length {n} is not a "
                             f"multiple of M={M}")
        m = n // M
        xc = x.to(complex_dtype)
        # branch p takes x[m M - p] = x[(m-1) M + (M-p)]; row m = 0 of the
        # branches p >= 1 needs the last M-1 samples of the previous block
        Xf = xc.reshape(m, M)                 # Xf[m, q] = x[m M + q]
        first_row = state["raw"].flip(0)[None, :]   # [p-1] = x[-p]
        bp = torch.cat([first_row, Xf[:-1, 1:].flip(1)], dim=0)
        B = torch.cat([Xf[:, 0:1], bp], dim=1)      # B[m, p] = x[m M - p]
        full = torch.cat([state["hist"], B.T], dim=1)   # (M, K-1+m)
        taps = self.P.flip(1).to(complex_dtype)     # newest sample * h[0]
        Y = _branch_mac(full, taps, m)
        ch = torch.fft.ifft(Y, dim=0) * M           # IFFT across branches
        # shape-based slices: -(K-1) / -(M-1) would be -0 for K == 1 /
        # M == 1 and keep the whole buffer
        new_state = dict(hist=full[:, full.shape[1] - (self.P.shape[1] - 1):],
                         raw=xc[xc.shape[-1] - (M - 1):])
        return new_state, ch.T

    def frequencies(self) -> np.ndarray:
        """Channel centre frequencies (normalised)."""
        f = np.arange(self.M) / self.M
        return np.where(f >= 0.5, f - 1.0, f)


def channelize(x: torch.Tensor, M: int, taps_per_branch: int = 8,
               bank: Optional[Channelizer] = None) -> torch.Tensor:
    """One-shot channelization -> (n // M, M), on x's device.  ``bank``: a
    Channelizer built once, for loops over blocks (a bare call designs the
    prototype on the host and uploads the taps each time)."""
    c = bank if bank is not None else Channelizer.create(
        M, taps_per_branch, device=x.device)
    xp = pad_to_multiple(x, M, axis=x.ndim - 1)
    _, y = c.step(c.init(), xp)
    return y


def dechannelize(ch: torch.Tensor, M: int, taps_per_branch: int = 8,
                 bank: Optional[Channelizer] = None) -> torch.Tensor:
    """Synthesis bank: the wideband signal from its channels,
    x_hat[r M + q] = sum_j h[(r-j) M + q] V[q, j] with V = IFFT over the
    channels (the analysis' direction).  Unit passband gain.

    A critically sampled single-prototype DFT bank does not reconstruct
    perfectly: tones at channel centres round-trip to ~0.2 %, broadband
    content meets crossover aliasing (~ -13 dB).  For near-perfect
    reconstruction use the 2x oversampled WOLA pair."""
    m = ch.shape[0]
    V = torch.fft.ifft(ch.T, dim=0)   # the analysis' * M and this 1/M cancel
    c = bank if bank is not None else Channelizer.create(
        M, taps_per_branch, device=ch.device)
    K = c.P.shape[1]
    histf = torch.cat([torch.zeros((M, K - 1), dtype=complex_dtype,
                                   device=ch.device), V], dim=1)
    fb = _branch_mac(histf, c.P.flip(1).to(complex_dtype), m)   # (M, m)
    return fb.T.reshape(m * M)        # out[t M + q] = fb[q, t]


# ---------------------------------------------------------------------------
# 2x-oversampled WOLA channelizer pair: near-perfect reconstruction.  With
# the channels oversampled by M/R (R = hop, default M/2), the decimation
# aliases fall in the prototype's stopband, so the round trip's error is
# the stopband leakage, as small as a longer prototype makes it.
# ---------------------------------------------------------------------------

def _wola_prototype(M: int, K: int) -> np.ndarray:
    """Root-Nyquist prototype of length K M: root-raised-cosine with beta 1
    and symbol period M, so that analysis x synthesis is the raised
    cosine, an M-band Nyquist filter (host numpy)."""
    return root_raised_cosine(K * M, 1.0, M) * M


def wola_analysis(x: torch.Tensor, M: int, R: Optional[int] = None,
                  taps_per_branch: int = 16,
                  h: Optional[np.ndarray] = None) -> torch.Tensor:
    """Oversampled analysis bank: (..., n) -> (..., nj, M) with hop R
    (default M // 2: 2x oversampled channels).  Leading axes are
    independent streams.

    ch[j, c] = sum_n h[n] x[j R + n] e^{-2 i pi c (j R + n) / M}.  The
    polyphase fold takes K P shifted slices of the R-column reshape of x
    (M = P R), so that no (nj, K M) frame matrix is formed."""
    if R is None:
        R = M // 2
    if M % R:
        raise ValueError(f"wola_analysis: M={M} is not a multiple of R={R}")
    if h is None:
        h = _wola_prototype(M, taps_per_branch)
    K = len(h) // M
    n = x.shape[-1]
    xc = x.to(complex_dtype)
    nj = (n - K * M) // R + 1
    if nj < 1:
        raise ValueError("wola_analysis: signal shorter than the prototype")
    P = M // R
    total = (nj + K * P - 1) * R                   # = (nj-1) R + K M <= n
    Xr = xc[..., :total].reshape(*xc.shape[:-1], nj + K * P - 1, R)
    Hr = torch.as_tensor(np.asarray(h[:K * M], np.float64).reshape(K, P, R),
                         dtype=real_dtype, device=x.device)
    cols = []
    for p in range(P):
        acc = None
        for k in range(K):
            term = Xr[..., k * P + p:k * P + p + nj, :] * Hr[k, p]
            acc = term if acc is None else acc + term
        cols.append(acc)                           # (..., nj, R)
    Fm = torch.cat(cols, dim=-1)                   # (..., nj, M)
    # phase fix-up e^{-2 i pi c j R / M}: roll row j by +(j R mod M)
    Fsh = _roll_rows_mod(Fm, [(j * R) % M for j in range(M // R)])
    return torch.fft.fft(Fsh, dim=-1)              # (..., nj, M)


def _roll_rows_mod(F: torch.Tensor, shifts) -> torch.Tensor:
    """Roll row j (axis -2) of F by shifts[j mod P] along the last axis
    (pad the rows to a multiple of P, de-interleave, roll each residue,
    interleave, slice).  Batch axes lead."""
    P = len(shifts)
    nj, M = F.shape[-2:]
    njp = -(-nj // P) * P
    if njp > nj:
        z = torch.zeros(tuple(F.shape[:-2]) + (njp - nj, M), dtype=F.dtype,
                        device=F.device)
        F = torch.cat([F, z], dim=-2)
    G = F.reshape(*F.shape[:-2], njp // P, P, M)
    G = torch.stack([torch.roll(G[..., p, :], shifts[p], dims=-1)
                     for p in range(P)], dim=-2)
    return G.reshape(*G.shape[:-3], njp, M)[..., :nj, :]


def wola_synthesis(ch: torch.Tensor, M: int, R: Optional[int] = None,
                   taps_per_branch: int = 16,
                   h: Optional[np.ndarray] = None) -> torch.Tensor:
    """Inverse of :func:`wola_analysis` (same M, R and prototype):
    (..., nj, M) -> (..., (nj - 1) R + K M), unit passband gain and no net
    delay (xr[t] reconstructs x[t]).  The round trip's accuracy is the
    prototype's (~3e-4 broadband at taps_per_branch 16, ~7e-5 at 32)."""
    if R is None:
        R = M // 2
    if M % R:
        raise ValueError(f"wola_synthesis: M={M} is not a multiple of R={R}")
    if h is None:
        h = _wola_prototype(M, taps_per_branch)
    K = len(h) // M
    nj = ch.shape[-2]
    KM = K * M
    # u_j = IFFT(ch[j]), shifted back by +(j R mod M): the inverse of the
    # analysis' phase fix-up
    u = torch.fft.ifft(ch, dim=-1)                       # (..., nj, M)
    us = _roll_rows_mod(u, [(-(j * R)) % M for j in range(M // R)])
    # the overlap-add envelope env[q] = sum_s h[q + s R] (R-periodic),
    # divided out for unit in-band gain
    hn = np.asarray(h[:KM], np.float64)
    env = np.zeros(R)
    for s in range(KM // R):
        env += hn[s * R:(s + 1) * R]
    # polyphase overlap-add: out[(j + k P + p) R + s] += h[k M + p R + s]
    # us[j, p R + s], K P shifted adds of (nj, R) column blocks
    P = M // R
    S = KM // R                                          # = K P
    nrows = nj + S - 1
    b = tuple(us.shape[:-2])
    Hr = torch.as_tensor(hn.reshape(K, P, R), dtype=real_dtype,
                         device=ch.device)
    out = torch.zeros(b + (nrows, R), dtype=complex_dtype, device=ch.device)
    for p in range(P):
        up = us[..., p * R:(p + 1) * R]                  # (..., nj, R)
        for k in range(K):
            s0 = k * P + p
            out[..., s0:s0 + nj, :] += up * Hr[k, p]
    out = out / torch.as_tensor(env, dtype=real_dtype, device=ch.device)
    return out.reshape(*b, nrows * R)
