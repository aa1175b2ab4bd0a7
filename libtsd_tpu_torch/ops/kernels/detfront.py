"""Kernel #10: the pattern detector's fused front end (``csrc/detfront.cu``).

Replaces ``libtsd_tpu/ops/pallas/detfront.py::_detfront_jit`` (reached
through ``DetFront.step``).  In one pass over complex x it computes the
complex pattern correlation c[t] = sum_k h[k] x[t-k], the window energy
en[t] = sum_{k<M} |x[t-k]|^2 and the raw score sqrt(|c|^2 / (en + 1e-20)),
as four fp32 planes.  What bounds it on the H100 and what its design does
about it is set out at the top of ``csrc/detfront.cu``: its direct form
does ~10 M flop a sample against 24 bytes, so FMA issue bounds it (the
function's least work is bound by the bytes), and the MACs are
register-blocked as the FIR kernel's are.

The JAX kernel's tiers ("split": bf16 hi/lo, ~1e-5; "bf16": ~2.5e-3) were
MXU choices; this kernel and its plain version compute in fp32 whatever the
tier, so the port is at least as close to fp32 as the JAX "split" tier.

A wrapper given CPU tensors runs the plain version (:func:`detfront_plain`:
real/imag ``F.conv1d`` groups and a ones-kernel ``conv1d`` on |x|^2, fp32,
cuDNN's TF32 off); given CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ...block import Block
from ...config import complex_dtype, device as _device, real_dtype
from . import _build

__all__ = ["detfront_plan", "DetFront", "detfront", "detfront_plain"]

_L = 128           # block-length quantum and context-row width (the JAX API)
TILE = 2048        # outputs per block (DF_TILE)
_TAP_QUANTUM = 128  # taps zero-padded to a multiple (DF_TAP_QUANTUM)


def detfront_plan(n: int) -> tuple[int, int]:
    """(outputs per block, blocks per channel) of the kernel for a block of
    n samples.  A ragged last tile is masked in the kernel, so the tile
    never shrinks with awkward lengths."""
    return TILE, -(-n // TILE)


def _taps_mats(pattern_taps) -> tuple[np.ndarray, int, int, int]:
    """The kernel's taps: complex64 (Mp,), the pattern taps zero-padded to
    the kernel's tap quantum, and (M, D, V): D - 1 = the context rows of
    128 samples the state holds (the JAX package's D, so V = (D - 1) 128 >=
    M - 1 and the states of both packages have one shape)."""
    h = np.asarray(pattern_taps, np.complex128)
    M = len(h)
    D = (M - 2) // _L + 2
    Mp = -(-M // _TAP_QUANTUM) * _TAP_QUANTUM
    hp = np.zeros(Mp, np.complex64)
    hp[:M] = h
    return hp, M, D, (D - 1) * _L


@contextlib.contextmanager
def _fp32_conv():
    """cuDNN convolutions in true fp32 (PyTorch allows TF32 by default),
    the caller's setting restored after."""
    flags = torch.backends.cudnn
    saved = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = saved


def _check(x, state, taps, M: int):
    if x.ndim != 2 or state.ndim != 2 or x.shape[0] != state.shape[0]:
        raise ValueError(f"x and state must be (C, n) and (C, V), got "
                         f"{tuple(x.shape)} and {tuple(state.shape)}")
    if state.shape[1] < M - 1:
        raise ValueError(f"state holds {state.shape[1]} samples, the "
                         f"pattern needs {M - 1}")
    if taps.ndim != 1 or taps.shape[0] < M or taps.shape[0] % _TAP_QUANTUM:
        raise ValueError(f"taps must be ({M} padded to a multiple of "
                         f"{_TAP_QUANTUM},), got {tuple(taps.shape)}")


def detfront_plain(x: torch.Tensor, state: torch.Tensor, taps: torch.Tensor,
                   M: int):
    """Plain PyTorch version: x (C, n) complex, state (C, V) complex, taps
    (Mp,) complex (the first M used).  Returns (cr, ci, en, sc), (C, n)
    fp32 each."""
    _check(x, state, taps, M)
    V = state.shape[1]
    xx = torch.cat([state.to(complex_dtype), x.to(complex_dtype)],
                   dim=-1)[:, V - (M - 1):]
    h = taps[:M].to(complex_dtype).flip(0)   # conv1d correlates
    hr, hi = h.real, h.imag
    w = torch.stack([torch.stack([hr, -hi]), torch.stack([hi, hr])])
    planes = torch.stack([xx.real, xx.imag], dim=1)           # (C, 2, L)
    e2 = (xx.real * xx.real + xx.imag * xx.imag)[:, None]
    ones = torch.ones((1, 1, M), dtype=real_dtype, device=x.device)
    with _fp32_conv():
        c = F.conv1d(planes, w)
        en = F.conv1d(e2, ones)[:, 0].clamp(min=0.0)
    cr, ci = c[:, 0].contiguous(), c[:, 1].contiguous()
    sc = torch.sqrt((cr * cr + ci * ci) / (en + 1e-20))
    return cr, ci, en.contiguous(), sc


def detfront(x: torch.Tensor, state: torch.Tensor, taps: torch.Tensor,
             M: int):
    """c, energy and raw score of complex x (C, n) with complex state
    (C, V) and padded taps (Mp,): (cr, ci, en, sc), (C, n) fp32 each."""
    _check(x, state, taps, M)
    if _build.use_plain(x):
        return detfront_plain(x, state, taps, M)
    x = x.to(complex_dtype).contiguous()
    state = state.to(complex_dtype).contiguous()
    taps = taps.to(complex_dtype).contiguous()
    C, n = x.shape
    out = [torch.empty((C, n), dtype=real_dtype, device=x.device)
           for _ in range(4)]
    if C and n:
        _build.require_cuda(x, state, taps, *out)
        err = _build.lib().detfront_f32(
            _build.ptr(x), _build.ptr(state), _build.ptr(taps),
            *map(_build.ptr, out), C, n, M, taps.shape[0], state.shape[1],
            _build.stream_ptr(x.device))
        _build.check(err, "detfront_f32")
        detfront.launches += 1
    return tuple(out)


detfront.launches = 0


class DetFront(Block):
    """Streaming fused correlation + window-energy engine with the Fir
    block's state protocol (state = the last V complex input samples, V =
    (D - 1) 128 >= M - 1), drop-in for the detector's (corr, energy) pair.
    ``step(state, x)`` takes x (n,) or (C, n) with n % 128 == 0 and
    returns (new_state, (cr, ci, en, score_raw)), real planes shaped like
    x.  It has no precision tiers: it computes in fp32."""

    def __init__(self, taps: torch.Tensor, M: int, D: int):
        super().__init__()
        self.register_buffer("taps", taps)
        self.M = int(M)
        self.D = int(D)
        self.V = (self.D - 1) * _L

    @classmethod
    def create(cls, pattern_taps, device="cuda") -> "DetFront":
        hp, M, D, _ = _taps_mats(pattern_taps)
        if D - 1 > _L - 1:
            raise ValueError(
                f"pattern too long for the fused detector engine: M={M} "
                f"needs {D - 1} context rows (max {_L - 1}); use the "
                f"torch/cuda OLA engines for patterns this long")
        return cls(torch.as_tensor(hp, device=_device(device)), M, D)

    def init(self):
        return torch.zeros((self.V,), dtype=complex_dtype,
                           device=self.taps.device)

    def init_for(self, x: torch.Tensor):
        return torch.zeros(tuple(x.shape[:-1]) + (self.V,),
                           dtype=complex_dtype, device=self.taps.device)

    @property
    def tail_state(self) -> bool:
        return True

    @property
    def delay(self) -> float:
        return (self.M - 1) / 2

    def step(self, state, x: torch.Tensor):
        n = x.shape[-1]
        if n % _L:
            raise ValueError(f"block length {n} is not a multiple of {_L}")
        squeeze = x.ndim == 1
        x2 = x.to(complex_dtype).reshape(-1, n)
        st2 = state.reshape(-1, self.V)
        planes = detfront(x2, st2, self.taps, self.M)
        xx = x2 if n >= self.V else torch.cat([st2, x2], dim=-1)
        new_state = xx[:, xx.shape[-1] - self.V:]
        shape = (n,) if squeeze else tuple(x.shape)
        return (new_state.reshape(tuple(x.shape[:-1]) + (self.V,)),
                tuple(p.reshape(shape) for p in planes))
