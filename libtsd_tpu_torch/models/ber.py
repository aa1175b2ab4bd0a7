"""BER measurement: bit alignment by correlation, error counting, phase
ambiguity resolution (host numpy), ported from
``libtsd_tpu/models/ber.py``.

Parity: cmp_bits / cmp_bits_psk (core/include/tsd/telecom.hpp:1745-1792).
Inputs may be tensors on any device or numpy arrays; the counting runs on
the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["cmp_bits", "cmp_bits_psk", "cmp_bits_rot", "ber_count"]


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _align_bits(a: np.ndarray, b: np.ndarray, max_lag: int = 256) -> int:
    """Best integer lag of b relative to a by +-1 correlation."""
    aa = 2.0 * a - 1
    bb = 2.0 * b - 1
    nmax = min(len(aa), len(bb))
    best = (0, -1e30)
    for lag in range(-max_lag, max_lag + 1):
        if lag >= 0:
            x, y = aa[lag:nmax], bb[:nmax - lag]
        else:
            x, y = aa[:nmax + lag], bb[-lag:nmax]
        if len(x) < 8:
            continue
        c = float(np.dot(x, y)) / len(x)
        if c > best[1]:
            best = (lag, c)
    return best[0]


def ber_count(a, b) -> Tuple[float, int]:
    """Error rate and count over the common length (no alignment)."""
    a, b = _np(a).astype(np.int32), _np(b).astype(np.int32)
    n = min(len(a), len(b))
    errs = int(np.sum(a[:n] ^ b[:n]))
    return errs / max(n, 1), errs


def cmp_bits(tx, rx, max_lag: int = 256) -> Tuple[float, int, int]:
    """Align rx to tx by correlation and count bit errors; returns
    (ber, nerrs, lag) (parity: cmp_bits, telecom.hpp:1745)."""
    a = _np(tx).astype(np.int8)
    b = _np(rx).astype(np.int8)
    lag = _align_bits(a, b, max_lag)
    if lag >= 0:
        x, y = a[lag:], b[:len(a) - lag]
    else:
        x, y = a[:len(a) + lag], b[-lag:]
    n = min(len(x), len(y))
    errs = int(np.sum(x[:n] != y[:n]))
    return errs / max(n, 1), errs, lag


def _indices(bits: np.ndarray, k: int) -> np.ndarray:
    nsym = -(-len(bits) // k)
    b = np.zeros(nsym * k, np.int64)
    b[:len(bits)] = bits
    return (b.reshape(nsym, k) << np.arange(k)).sum(1)


def _bits(idx: np.ndarray, k: int) -> np.ndarray:
    return ((idx[:, None] >> np.arange(k)) & 1).astype(np.int8).reshape(-1)


def cmp_bits_psk(tx, rx, k: int, max_lag: int = 256
                 ) -> Tuple[float, int, int]:
    """cmp_bits after resolving the M-PSK phase ambiguity: every index
    rotation of the received symbols is tried and the best kept (parity:
    cmp_bits_psk, telecom.hpp:1760-1792)."""
    M = 1 << k
    a = _np(tx).astype(np.int8)
    rx = _np(rx).astype(np.int8)
    rxi = _indices(rx, k)
    best = None
    for rot in range(M):
        # trimmed to rx's length: the zero pad of a partial last symbol
        # would map to nonzero bits under a rotation
        rb = _bits((rxi + rot) % M, k)[:len(rx)]
        out = cmp_bits(a, rb, max_lag)
        if best is None or out[0] < best[0]:
            best = out
    return best


def cmp_bits_rot(tx, rx_syms, wf, max_lag: int = 256,
                 rotations: int = 4) -> Tuple[float, int, int]:
    """Resolve the geometric rotation ambiguity of a blind carrier loop on
    any constellation (square QAM with per-axis mapping, where a 90-degree
    lock is not an index rotation): rotate the received symbols by each
    multiple of 2 pi / rotations, decide on ``wf``, keep the best.
    rx_syms: converged received symbols (already masked)."""
    k = wf.info.k
    s = _np(rx_syms)
    best = None
    for r in range(rotations):
        sr = torch.as_tensor((s * np.exp(2j * np.pi * r / rotations))
                             .astype(np.complex64), device=wf.device)
        rb = _bits(_np(wf.closest(sr)).astype(np.int64), k)
        out = cmp_bits(tx, rb, max_lag)
        if best is None or out[0] < best[0]:
            best = out
    return best
