"""Base signal toolbox: generators and vector utilities (PyTorch), ported
from ``libtsd_tpu/ops/signal.py``.

Parity: core/include/tsd/tsd.hpp:103-1360, core/src/tsd.cc.  Generators
take a normalised frequency f in [-1/2, 1/2] (cycles a sample) and a length
n, as the reference does, and evaluate directly (no recursive oscillator),
the phase reduced in cycles first.  Functions that make a signal from
nothing build it on ``device`` (the card unless the caller names another).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..block import Block
from ..config import complex_dtype, device as _device, real_dtype

__all__ = [
    "cycles",
    "sigexp", "sigsin", "sigcos", "sigtri", "sigsquare", "sigsawtooth",
    "sigimp", "siggsin", "siggauss", "sigchirp", "signyquist",
    "linspace", "logspace", "irange",
    "diff", "cumsum", "unwrap_phase",
    "db2mag", "mag2db", "db2pow", "pow2db",
    "wrap_2pi", "wrap_pm_pi",
    "downsample", "upsample", "zero_pad", "rotate_vec", "top_k_stable",
    "find", "find_first", "find_last", "find_first_local_max",
    "length_match", "sample_hold", "trange",
    "sinc", "NCO", "nco_phase", "sliding_frames",
]

_L = 4096   # table length of the two-table form (n > 2^16)


def cycles(f, n: int, device="cuda") -> torch.Tensor:
    """Wrapped cycle ramp (f*k) mod 1 for k = 0..n-1, float32.

    A host scalar f is multiplied in float64 and reduced mod 1 BEFORE the
    float32 cast, so the phase handed to sin/cos keeps full float32
    precision for any n (the float32 product f*k alone is ~1e-5 cycle off
    by k ~ 2000).  Above 2^16 samples two float64-exact tables, t1[q] =
    (f L q) mod 1 and t0[r] = (f r) mod 1, are summed in float32 and
    reduced again: the same values as the JAX package.  A tensor f is
    multiplied in float32 on its own device."""
    if isinstance(f, torch.Tensor):
        k = torch.arange(n, dtype=real_dtype, device=f.device)
        return torch.remainder(f.to(real_dtype) * k, 1.0)
    dev = _device(device)
    f = np.float64(f)
    if n <= (1 << 16):
        c = np.mod(f * np.arange(n, dtype=np.float64), 1.0)
        return torch.as_tensor(c.astype(np.float32), device=dev)
    nq = -(-n // _L)
    t0 = np.mod(f * np.arange(_L, dtype=np.float64), 1.0).astype(np.float32)
    t1 = np.mod(f * _L * np.arange(nq, dtype=np.float64),
                1.0).astype(np.float32)
    c = torch.remainder(torch.as_tensor(t1, device=dev)[:, None]
                        + torch.as_tensor(t0, device=dev)[None, :], 1.0)
    return c.reshape(-1)[:n]


# ---------------------------------------------------------------- generators

def _k(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=real_dtype, device=_device(device))


def sigexp(f: float, n: int, device="cuda") -> torch.Tensor:
    """y_k = exp(2 pi i k f) (parity: tsd.hpp:1113)."""
    return torch.exp(2j * np.pi * cycles(f, n, device)).to(complex_dtype)


def sigsin(f: float, n: int, device="cuda") -> torch.Tensor:
    """y_k = sin(2 pi k f) (parity: tsd.hpp:1134)."""
    return torch.sin(2 * np.pi * cycles(f, n, device))


def sigcos(f: float, n: int, device="cuda") -> torch.Tensor:
    """y_k = cos(2 pi k f) (parity: tsd.hpp:1155)."""
    return torch.cos(2 * np.pi * cycles(f, n, device))


def sigtri(p: int, n: int, device="cuda") -> torch.Tensor:
    """Periodic triangle, period p samples, in [-1, 1], starting at 1
    (parity: tsd.hpp:1169)."""
    k = torch.arange(n, device=_device(device))
    ph = (k % p).to(real_dtype) / p
    return 1.0 - 4.0 * torch.minimum(ph, 1.0 - ph)


def sigsquare(p: int, n: int, device="cuda") -> torch.Tensor:
    """Periodic square wave, period p samples (parity: sigcar,
    tsd.hpp:1182)."""
    k = torch.arange(n, device=_device(device))
    one = torch.ones((), dtype=real_dtype, device=k.device)
    return torch.where((k % p) < (p + 1) // 2, one, -one)


def sigsawtooth(p: int, n: int, device="cuda") -> torch.Tensor:
    """Sawtooth, period p, -1..1 (parity: sigscie, tsd.hpp:1208)."""
    k = torch.arange(n, device=_device(device))
    return 2.0 * (k % p).to(real_dtype) / max(p - 1, 1) - 1.0


def sigimp(n: int, p: int = 0, device="cuda") -> torch.Tensor:
    """Discrete impulse at position p (parity: tsd.hpp:1194)."""
    return (torch.arange(n, device=_device(device)) == p).to(real_dtype)


def siggauss(n: int, a: float = 10.0, device="cuda") -> torch.Tensor:
    """Gaussian pulse exp(-a ((k - N/2) / (N/2))^2) (parity:
    tsd.hpp:1249)."""
    t = (_k(n, device) - n / 2) / (n / 2)
    return torch.exp(-a * t * t)


def siggsin(f: float, n: int, a: float = 10.0,
            device="cuda") -> torch.Tensor:
    """Gaussian-windowed sine (parity: tsd.hpp:1236)."""
    return siggauss(n, a, device) * sigsin(f, n, device)


def sigchirp(f0: float, f1: float, n: int, mode: str = "l",
             device="cuda") -> torch.Tensor:
    """Linear ('l') or quadratic ('q') chirp x_k = cos(2 pi cumsum(f_k)),
    the instantaneous frequency swept f0 -> f1 (parity: tsd.hpp:1297)."""
    k = _k(n, device) / max(n - 1, 1)
    if mode == "l":
        f = f0 + (f1 - f0) * k
    elif mode == "q":
        f = f0 + (f1 - f0) * k * k
    else:
        raise ValueError("mode must be 'l' or 'q'")
    return torch.cos(2 * np.pi * torch.cumsum(f, 0))


def signyquist(n: int, device="cuda") -> torch.Tensor:
    """Alternating -1, 1, -1, 1, ... (parity: tsd.hpp:1316)."""
    k = torch.arange(n, device=_device(device))
    one = torch.ones((), dtype=real_dtype, device=k.device)
    return torch.where(k % 2 == 0, -one, one)


# ------------------------------------------------------------------ ranges

def linspace(a: float, b: float, n: int, device="cuda") -> torch.Tensor:
    return torch.linspace(a, b, n, dtype=real_dtype, device=_device(device))


def logspace(a: float, b: float, n: int, device="cuda") -> torch.Tensor:
    """n log-spaced points from a to b (the values, not exponents)."""
    return torch.logspace(float(np.log10(a)), float(np.log10(b)), n,
                          dtype=real_dtype, device=_device(device))


def irange(a: int, b: int, device="cuda") -> torch.Tensor:
    """Integer range a..b inclusive (parity: intervalle_entier)."""
    return torch.arange(a, b + 1, device=_device(device))


# ------------------------------------------------------------- differences

def diff(x: torch.Tensor) -> torch.Tensor:
    """First difference, length n - 1."""
    return x[1:] - x[:-1]


def cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0)


def unwrap_phase(x: torch.Tensor) -> torch.Tensor:
    """Unwrap phase jumps > pi (parity: déplie_phase): numpy's unwrap."""
    d = diff(x)
    dd = torch.remainder(d + np.pi, 2 * np.pi) - np.pi
    dd = torch.where((dd == -np.pi) & (d > 0), torch.full_like(dd, np.pi), dd)
    corr = torch.where(d.abs() < np.pi, torch.zeros_like(d), dd - d)
    return torch.cat([x[:1], x[1:] + torch.cumsum(corr, 0)])


# ------------------------------------------------------------------- dB

def db2mag(x):
    return 10.0 ** (torch.as_tensor(x) / 20.0)


def mag2db(x):
    return 20.0 * torch.log10(torch.as_tensor(x))


def db2pow(x):
    return 10.0 ** (torch.as_tensor(x) / 10.0)


def pow2db(x):
    return 10.0 * torch.log10(torch.as_tensor(x))


# --------------------------------------------------------------- wrapping

def wrap_2pi(x):
    """Wrap to [0, 2 pi) (parity: modulo_2π)."""
    return torch.remainder(x, 2 * np.pi)


def wrap_pm_pi(x):
    """Wrap to [-pi, pi) (parity: modulo_pm_π)."""
    return torch.remainder(x + np.pi, 2 * np.pi) - np.pi


# ------------------------------------------------------------- re-sampling

def downsample(x: torch.Tensor, r: int, phase: int = 0) -> torch.Tensor:
    """Keep one sample in r (parity: sousech)."""
    return x[phase::r]


def upsample(x: torch.Tensor, r: int) -> torch.Tensor:
    """Insert r - 1 zeros between samples (parity: surech)."""
    n = x.shape[0]
    y = torch.zeros((n, r), dtype=x.dtype, device=x.device)
    y[:, 0] = x
    return y.reshape(n * r)


def sample_hold(x: torch.Tensor, r: int) -> torch.Tensor:
    """Repeat each sample r times (parity: sah, dsp/telecom.hpp:513)."""
    return torch.repeat_interleave(x, r, dim=0)


def trange(n: int, fs: float, device="cuda") -> torch.Tensor:
    """k / fs for k < n (parity: intervalle_temporel, tsd.hpp:989)."""
    return _k(n, device) / fs


def zero_pad(x: torch.Tensor, n: int) -> torch.Tensor:
    """Pad with zeros (or cut) to length n."""
    if n <= x.shape[0]:
        return x[:n]
    return F.pad(x, (0, n - x.shape[0]))


def rotate_vec(x: torch.Tensor, k: int) -> torch.Tensor:
    """Circular rotation by k (parity: rotation_vec)."""
    return torch.roll(x, -k)


def length_match(x: torch.Tensor, y: torch.Tensor):
    """Zero-pad the shorter of two vectors so that the lengths match."""
    n = max(x.shape[0], y.shape[0])
    return zero_pad(x, n), zero_pad(y, n)


# ------------------------------------------------------------------ find

def find(mask: torch.Tensor, size: Optional[int] = None,
         fill: int = -1) -> torch.Tensor:
    """Indices where mask is true (parity: trouve); with ``size`` a static
    length, the spare slots ``fill``."""
    idx = torch.nonzero(mask).reshape(-1)
    if size is None:
        return idx
    out = torch.full((size,), fill, dtype=idx.dtype, device=mask.device)
    m = min(size, idx.shape[0])
    out[:m] = idx[:m]
    return out


def find_first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true element, -1 if none (parity:
    trouve_premier)."""
    idx = torch.argmax(mask.to(torch.int32))
    return torch.where(mask.any(), idx, torch.full_like(idx, -1))


def find_last(mask: torch.Tensor) -> torch.Tensor:
    """Index of the last true element, -1 if none (parity: trouve_dernier,
    tsd.hpp:322)."""
    n = mask.shape[0]
    idx = n - 1 - torch.argmax(mask.flip(0).to(torch.int32))
    return torch.where(mask.any(), idx, torch.full_like(idx, -1))


def find_first_local_max(x: torch.Tensor) -> torch.Tensor:
    """Index of the first interior strict local maximum, -1 if none
    (parity: trouve_premier_max_local, tsd.hpp:327)."""
    if x.shape[0] < 3:
        return torch.tensor(-1, device=x.device)
    interior = (x[1:-1] > x[:-2]) & (x[1:-1] > x[2:])
    idx = find_first(interior)
    return torch.where(idx >= 0, idx + 1, idx)


# ------------------------------------------------------------------- misc

def sinc(x):
    """sin(pi x) / (pi x) (parity: tsd::sinc, core/src/divers.cc:6-30)."""
    return torch.sinc(torch.as_tensor(x))


def nco_phase(freq, n: int, phase0=0.0, device="cuda") -> torch.Tensor:
    """Phase ramp 2 pi f k + phase0, wrapped, the ramp reduced in cycles
    before the scaling to radians."""
    k = _k(n, device)
    cyc = torch.remainder(torch.as_tensor(freq, dtype=real_dtype,
                                          device=k.device) * k, 1.0)
    return wrap_pm_pi(phase0 + 2 * np.pi * cyc)


class NCO(Block):
    """Streaming complex oscillator z_k = exp(2 pi i (k0 + k) f) (parity:
    source_ohc / source_ohr, tsd.hpp:1318-1356).  The frequency is a host
    float, so the per-block phase increment (f n) mod 1 is exact and long
    streams do not drift.  State: the phase in radians."""

    def __init__(self, freq: float = 0.0, device="cuda"):
        super().__init__()
        self.freq = float(freq)
        self.device = _device(device)

    @classmethod
    def create(cls, freq: float, device="cuda") -> "NCO":
        return cls(freq, device=device)

    def init(self):
        return torch.zeros((), dtype=real_dtype, device=self.device)

    def gen(self, state, n: int):
        k = torch.arange(n, dtype=real_dtype, device=state.device)
        cyc = torch.remainder(np.float32(self.freq) * k, 1.0)
        ph = state + 2 * np.pi * cyc
        new_state = wrap_pm_pi(
            state + np.float32(2 * np.pi * ((self.freq * n) % 1.0)))
        return new_state, torch.exp(1j * ph).to(complex_dtype)

    def step(self, state, x):
        """Mix the input with the oscillator (x exp(i phase))."""
        if x.ndim < 1:
            raise ValueError("NCO.step mixes a sample block, not a scalar")
        state, lo = self.gen(state, x.shape[-1])
        return state, x * lo


def sliding_frames(x: torch.Tensor, width: int, hop: int,
                   nframes: int) -> torch.Tensor:
    """Overlapping frames (..., nframes, width), frame j = x[..., j hop :
    j hop + width]; x zero-padded as needed."""
    need = (nframes - 1) * hop + width
    if need > x.shape[-1]:
        x = F.pad(x, (0, need - x.shape[-1]))
    return x[..., :need].unfold(-1, width, hop)[..., :nframes, :]


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis,
    largest first and the lower index first among equals, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order among
    ties, on the card least of all): a stable descending sort, then the
    first k."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]
