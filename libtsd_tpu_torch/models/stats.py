"""Statistics / linear prediction: Levinson-Durbin, general Toeplitz
Levinson, LPC, FIR Wiener, covariance matrix, subspace (MUSIC/EV) spectrum
(PyTorch), ported from ``libtsd_tpu/models/stats.py``.

Parity: core/src/stats.cc, core/include/tsd/stats.hpp:98-267.

The recursions (``levinson_real``, ``levinson``, ``lpc``, ``wiener_fir``)
and the MDL criteria run on the host in float64 numpy, as in the JAX
package; ``r2R``, ``covmtx``, ``subspace_spectrum`` and ``psd_subspace``
work on tensors, on the input's device (other input goes to ``device``, the
card unless the caller names another).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import as_tensor, complex_dtype, real_dtype
from ..ops.filter_rt import _fp32_matmul

__all__ = [
    "levinson_real", "levinson", "lpc", "wiener_fir", "r2R", "covmtx",
    "mdl_criterion", "mdl_source_count", "subspace_spectrum", "psd_subspace",
]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def levinson_real(r: np.ndarray) -> np.ndarray:
    """Levinson-Durbin for a real autocorrelation sequence; returns the
    prediction-error filter a (a[0]=1) (parity: levinson_reel,
    stats.cc:18-41)."""
    r = np.asarray(_host(r), np.float64)
    n = len(r)
    a = np.zeros(n)
    a[0] = 1.0
    if n == 1:          # order 0: trivial predictor
        return a
    k = -r[1] / r[0]
    a[1] = k
    alpha = r[0] * (1 - k * k)
    for i in range(2, n):
        s = np.sum(r[1:i] * a[1:i][::-1]) + r[i]
        k = -s / alpha
        a[1:i] = a[1:i] + k * a[1:i][::-1]
        a[i] = k
        alpha *= (1 - k * k)
    return a


def levinson(l1: np.ndarray, c1: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Solve T x = y for a general (non-symmetric) Toeplitz T given its
    first row l1 and first column c1 (parity: levinson, stats.cc:44-115)."""
    l1 = np.asarray(_host(l1), np.float64)
    c1 = np.asarray(_host(c1), np.float64)
    y = np.asarray(_host(y), np.float64)
    n = len(l1)
    if not (len(c1) == n and len(y) == n and l1[0] == c1[0]):
        raise ValueError("levinson: l1, c1 and y must have one length and "
                         "l1[0] == c1[0]")
    c1r = c1[1:][::-1]
    l1r = l1[1:]
    f = np.zeros(n)
    b = np.zeros(n)
    x = np.zeros(n)
    f[0] = 1 / l1[0]
    b[0] = 1 / c1[0]
    x[0] = y[0] / l1[0]
    for i in range(2, n + 1):
        fb = np.concatenate([f[:i - 1], [0.0]])
        bb = np.concatenate([[0.0], b[:i - 1]])
        ef = np.dot(c1r[-(i - 1):], f[:i - 1])
        eb = np.dot(l1r[:i - 1], b[:i - 1])
        fr = 1 / (1 - eb * ef)
        f[:i] = fr * fb - ef * fr * bb
        b[:i] = fr * bb - eb * fr * fb
        ex = np.dot(c1r[-(i - 1):], x[:i - 1])
        x[:i] = x[:i] + (y[i - 1] - ex) * b[:i]
    return x


def lpc(x: np.ndarray, order: int) -> Tuple[np.ndarray, float]:
    """Linear-prediction coefficients by autocorrelation + Levinson
    (parity: tsd::stats::lpc).  Returns (a, prediction_error_power)."""
    x = np.asarray(_host(x), np.float64)
    n = len(x)
    r = np.array([np.dot(x[: n - k], x[k:]) for k in range(order + 1)]) / n
    a = levinson_real(r)
    err = float(r[0] + np.sum(a[1:] * r[1:]))
    return a, err


def wiener_fir(rxx: np.ndarray, rxy: np.ndarray) -> np.ndarray:
    """FIR Wiener filter: solve the Toeplitz normal equations
    R h = rxy (parity: wiener_rif, stats.cc)."""
    rxx = np.asarray(_host(rxx), np.float64)
    rxy = np.asarray(_host(rxy), np.float64)
    n = len(rxy)
    return levinson(rxx[:n], rxx[:n], rxy)


def r2R(r, device="cuda") -> torch.Tensor:
    """Autocorrelation vector -> Hermitian Toeplitz autocorrelation matrix
    R[i,j] = r[|i-j|] (conjugated above the diagonal for complex r,
    matching the reference).
    Parity: dsp::stats::r2R / tsd::stats::r_vers_R (stats.hpp:114)."""
    r = as_tensor(r, device=device)
    n = r.shape[-1]
    ar = torch.arange(n, device=r.device)
    idx = ar[:, None] - ar[None, :]
    R = r[..., idx.abs()]         # (..., n, n), gathered on the last axis
    if r.is_complex():
        R = torch.where(idx < 0, R.conj(), R)
    return R


def covmtx(x: torch.Tensor, m: int, device="cuda") -> torch.Tensor:
    """Autocorrelation (Toeplitz) covariance matrix, built exactly as the
    reference does: unbiased xcorr positive lags -> Hermitian Toeplitz
    (parity: tsd::stats::covmtx, stats.hpp:146-156 = r_vers_R(xcorr(x,x,m)
    .tail(m))).

    The matrix built is the CONJUGATE of the one the reference's docstring
    names, R_ij = E[x*_{.+i} x_{.+j}], because its xcorr correlates
    x(k) conj(x(k+tau)): a tone at +f peaks at -f in the MUSIC spectrum,
    as in the reference binary (the JAX module explains it at length)."""
    from ..ops.corr import xcorr
    x = as_tensor(x, device=device)
    _, c = xcorr(x, None, m)      # unbiased, lags -(m-1)..m-1
    return r2R(c[..., m - 1:])    # lags 0..m-1


def mdl_criterion(R) -> Tuple[np.ndarray, int]:
    """MDL source-count criterion over a covariance matrix, EXACTLY as the
    reference computes it (parity: subspace_spectrum Ns==-1 branch,
    stats.cc:148-187).  Host float64.

    Returns (vmdl, Ns_ref): the criterion vector vmdl[k-1] for k = 1..m-1
    candidate sources, and the reference's selection Ns_ref.  Its two
    reference defects are kept on purpose, for the golden diff (the
    mis-expanded formula with N = m, and the argmax selection; see the JAX
    module's docstring); ``subspace_spectrum(Ns=-1)`` uses the correct
    Wax-Kailath MDL (:func:`mdl_source_count`).
    """
    R = _host(R)
    m = R.shape[0]
    w = np.linalg.eigvalsh(R)            # ascending
    la = np.abs(w[::-1]).astype(np.float64)   # descending magnitude
    N = m                                 # reference: N = m (stats.cc:168)
    vmdl = np.zeros(m - 1, np.float64)
    for k in range(1, m):
        somme = float(np.log(la[k:]).sum())
        vmdl[k - 1] = (-N * (somme - (k - m) * (-np.log(m - k) + somme))
                       + 0.5 * k * (2 * m - k) * np.log(N))
    return vmdl.astype(np.float32), int(np.argmax(vmdl) + 1)


def mdl_source_count(R, n_obs: Optional[int] = None
                     ) -> Tuple[int, np.ndarray]:
    """Correct MDL source-count estimate (Wax & Kailath 1985), on the host
    in float64 (R is read once to the host).

    MDL(k) = -N (m-k) log(GM_k / AM_k) + 0.5 k (2m-k) log N, with GM/AM
    the geometric/arithmetic means of the m-k smallest eigenvalues;
    the estimate is argmin_k MDL(k).  Returns (Ns, criterion)."""
    R = _host(R)
    m = R.shape[0]
    N = int(n_obs) if n_obs else m
    la = np.abs(np.linalg.eigvalsh(R)[::-1]).astype(np.float64)
    la = np.maximum(la, 1e-30)
    crit = np.zeros(m, np.float64)
    for k in range(m):
        noise = la[k:]
        gm = np.exp(np.mean(np.log(noise)))
        am = np.mean(noise)
        crit[k] = (-N * (m - k) * np.log(gm / am)
                   + 0.5 * k * (2 * m - k) * np.log(N))
    return int(np.argmin(crit)), crit.astype(np.float32)


def _cmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex matmul in true fp32 (TF32 off, whatever the caller set)."""
    with _fp32_matmul():
        return a @ b


def subspace_spectrum(R, Ns: int, Nf: int = 512,
                      steering: Optional[Callable] = None,
                      debug: bool = False, device="cuda",
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MUSIC pseudo-spectrum from a covariance matrix, on R's device (an
    array goes to ``device``).

    Returns (grid, spectrum_db).  ``steering(f, m)`` maps a grid value to an
    m-element steering vector (a tensor); default is the Fourier vector
    exp(2 pi i f k) over f in [-1/2, 1/2) (parity: subspace_spectrum,
    stats.cc:143-236).

    Ns = -1 selects the source count by the (corrected) Wax-Kailath MDL
    criterion, :func:`mdl_source_count`.  ``debug=True`` additionally
    shows the eigenvalue + MDL figures like the reference's
    ``debug_actif`` (stats.cc:182-190), into ``viz``'s active report
    (matplotlib needed then).
    """
    R = as_tensor(R, complex_dtype, device)
    m = R.shape[0]
    if Ns == -1:
        Ns, crit = mdl_source_count(R)
        Ns = max(Ns, 1)                  # keep >=1 noise-subspace split
        if debug:
            from ..viz.figure import Figures
            la = np.abs(np.linalg.eigvalsh(_host(R))[::-1])
            figs = Figures()
            f1 = figs.subplot()
            f1.plot(10 * np.log10(np.maximum(la, 1e-30)))
            f1.titles("Eigenvalues (log)", "index", "dB")
            f2 = figs.subplot()
            f2.plot(np.arange(m), crit)
            f2.titles("MDL criterion", "source count", "MDL")
            figs.show("MDL")
    if not Ns < m:
        raise ValueError(f"Ns={Ns} must be < the matrix size {m}")
    w, V = torch.linalg.eigh(R)  # ascending eigenvalues
    noise = V[:, : m - Ns]       # noise subspace
    grid = torch.linspace(-0.5, 0.5 - 1.0 / Nf, Nf, dtype=real_dtype,
                          device=R.device)
    if steering is None:
        k = torch.arange(m, dtype=real_dtype, device=R.device)
        A = torch.exp(2j * np.pi * grid[:, None] * k[None, :]).to(
            complex_dtype)
    else:
        A = torch.stack([torch.as_tensor(steering(float(f), m),
                                         device=R.device).to(complex_dtype)
                         for f in grid.cpu().numpy()])
    # S(f) = 1 / sum_j |a(f)^H v_j|^2  over noise eigenvectors
    proj = _cmm(A.conj(), noise).abs() ** 2  # (Nf, m-Ns)
    S = 1.0 / (torch.sum(proj, dim=-1) + 1e-30)
    return grid, 10.0 * torch.log10(S)


def psd_subspace(x: torch.Tensor, Ns: int, Nf: int = 512,
                 m: int = 0, device="cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """High-resolution line spectrum by MUSIC on the signal covariance
    (parity: psd_sousesp, stats.cc:240-255)."""
    if m == 0:
        m = min(x.shape[-1] // 2, 64)
    R = covmtx(x, m, device)
    return subspace_spectrum(R, Ns, Nf)
