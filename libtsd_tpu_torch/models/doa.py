"""Direction of arrival: steering vectors, sensor covariance, 1-D MUSIC,
spatial smoothing and Capon/MVDR (PyTorch), ported from
``libtsd_tpu/models/doa.py``.

Parity: core/src/apps/doa.cc:17-84, core/include/tsd/apps/doa.hpp:25-48.

Every function runs on its input tensor's device; other input (an array)
goes to ``device``, the card unless the caller names another.  The
spectra are quadratic forms through the Hermitian eigenbasis
(``torch.linalg.eigh``), as the JAX package computes them.  The peak pick
is a stable descending sort (``jax.lax.top_k`` puts the lower index first
on ties; ``torch.topk`` promises no order); with fewer local maxima than
asked, the remaining picks are the zero-score grid points in index order,
as JAX returns them (doa.py:59).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import as_tensor, complex_dtype, real_dtype
from ..ops.filter_rt import _fp32_matmul
from ..ops.signal import top_k_stable

__all__ = ["steervec_1d", "sensorcov_1d", "musicdoa_1d",
           "spatial_smoothing", "capon_spectrum", "capondoa_1d"]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with _fp32_matmul():
        return a @ b


def steervec_1d(pos, angle, device="cuda") -> torch.Tensor:
    """Steering matrix A[i, j] = exp(i * pos_i * cos(angle_j)) for a linear
    array; pos in radians-per-wavelength units (parity: steervec_1d,
    stats.cc:258-268)."""
    pos = as_tensor(pos, real_dtype, angle.device
                    if isinstance(angle, torch.Tensor) else device)
    angle = as_tensor(angle, real_dtype, pos.device).to(pos.device)
    return torch.exp(1j * pos[:, None] * torch.cos(angle)[None, :]).to(
        complex_dtype)


def sensorcov_1d(pos, angle, snr_db: float = 20.0,
                 device="cuda") -> torch.Tensor:
    """Ideal sensor covariance R = A A^H + sigma^2 I for unit-power sources
    (parity: sensorcov_1d, stats.cc:270-281; the reference adds db2pow(SNR)
    * I, this adds the NOISE power 10^(-snr/10) * I, as the JAX package
    does)."""
    A = steervec_1d(pos, angle, device)
    Nr = A.shape[0]
    noise = 10.0 ** (-snr_db / 10.0)
    return _mm(A, A.conj().T) + noise * torch.eye(
        Nr, dtype=complex_dtype, device=A.device)


def _ula_scan(m: int, d: float, Nf: int, device):
    """Steering matrix over the scan grid phi in [0, pi] for an
    equispaced m-sensor array with spacing d wavelengths:
    A[f, k] = exp(2i pi d cos(phi_f) k).  Returns (phis, A)."""
    phis = torch.linspace(0.0, np.pi, Nf, dtype=real_dtype, device=device)
    k = torch.arange(m, dtype=real_dtype, device=device)
    A = torch.exp(2j * np.pi * (d * torch.cos(phis))[:, None] * k[None, :]
                  ).to(complex_dtype)
    return phis, A


def _top_peaks(S: torch.Tensor, phis: torch.Tensor, Ns: int) -> torch.Tensor:
    """Top-Ns local maxima of a spatial spectrum, strongest first."""
    left = torch.cat([S[:1] * 0, S[:-1]])
    right = torch.cat([S[1:], S[-1:] * 0])
    is_peak = (S > left) & (S >= right)
    Sm = torch.where(is_peak, S, torch.zeros_like(S))
    _, idx = top_k_stable(Sm, Ns)
    return phis[idx]


def spatial_smoothing(R, L: int, backward: bool = True,
                      device="cuda") -> torch.Tensor:
    """Forward(-backward) spatial smoothing of an m-sensor ULA covariance:
    average the covariances of every length-``L`` subarray (and, with
    ``backward=True``, their flipped conjugates), restoring the signal-
    subspace rank for COHERENT sources.  Returns the (L, L) smoothed
    covariance.  Beyond the reference (stats.cc:283-330 has no smoothing).
    """
    R = as_tensor(R, complex_dtype, device)
    m = R.shape[0]
    if not 1 <= L <= m:
        raise ValueError(f"subarray length L={L} must be in [1, {m}]")
    subs = torch.stack([R[k:k + L, k:k + L] for k in range(m - L + 1)])
    Rs = torch.mean(subs, dim=0)
    if backward:
        Rb = torch.flip(Rs.conj(), dims=(0, 1))
        Rs = 0.5 * (Rs + Rb)
    return Rs


def capon_spectrum(R, d: float, Nf: int = 512, diag_load: float = 1e-3,
                   device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Capon / MVDR spatial spectrum S(phi) = 1 / (a^H R^-1 a) over
    phi in [0, pi] for an equispaced array with spacing ``d`` wavelengths;
    ``diag_load`` regularizes R by that fraction of its mean eigenvalue.
    Returns (phis, S).  The quadratic form goes through the Hermitian
    eigenbasis, a^H R^-1 a = sum_i |v_i^H a|^2 / w_i (the JAX package's
    form, doa.py:100-116), not through a solve.  The eigenbasis is taken
    in float64 (an m x m problem): each term is weighted by 1 / w_i, and
    a float32 ``eigh`` on the card rotates the eigenvectors of noise
    eigenvalues that lie close together enough to move the spectrum by
    ~3e-4 of its peak (a coherent pair at 16 sensors; 3e-5 on the CPU)."""
    R = as_tensor(R, complex_dtype, device)
    m = R.shape[0]
    w, V = torch.linalg.eigh(R.to(torch.complex128))
    w, V = w.to(real_dtype), V.to(complex_dtype)
    load = diag_load * torch.mean(w)
    phis, A = _ula_scan(m, d, Nf, R.device)
    proj = _mm(A.conj(), V).abs() ** 2             # (Nf, m) |v_i^H a|^2
    denom = _mm(proj, 1.0 / torch.clamp(w + load, min=1e-30))
    return phis, 1.0 / torch.clamp(denom, min=1e-30)


def capondoa_1d(R, d: float, Ns: int, Nf: int = 512,
                diag_load: float = 1e-3, device="cuda") -> torch.Tensor:
    """Capon/MVDR DOA: the Ns strongest arrival angles (radians) from
    :func:`capon_spectrum` (``diag_load`` forwarded)."""
    phis, S = capon_spectrum(R, d, Nf, diag_load, device)
    return _top_peaks(S, phis, Ns)


def musicdoa_1d(R, d: float, Ns: int, Nf: int = 512,
                device="cuda") -> torch.Tensor:
    """1-D MUSIC DOA for an equispaced linear array with spacing d (in
    wavelengths); returns the Ns strongest arrival angles in radians
    (parity: musicdoa_1d, stats.cc:283-330).  The scan angle phi in
    [0, pi] maps to spatial frequency d*cos(phi)."""
    R = as_tensor(R, complex_dtype, device)
    m = R.shape[0]
    w, V = torch.linalg.eigh(R)
    noise = V[:, : m - Ns]
    phis, A = _ula_scan(m, d, Nf, R.device)
    proj = _mm(A.conj(), noise).abs() ** 2
    S = 1.0 / (torch.sum(proj, dim=-1) + 1e-30)
    return _top_peaks(S, phis, Ns)
