"""Kernel #9: streaming overlap-save FFT convolution (``csrc/ola.cu``).

Replaces ``libtsd_tpu/ops/pallas/ola.py::_ola_filter_planes`` (reached
through ``ola_stream_planes`` / ``ola_filter_stream`` / ``ola_filter``).
What bounds it on the H100 and what its design does about it is set out at
the top of ``csrc/ola.cu``: a window moves 16 bytes a sample and costs
~10 log2 Nf flop a sample, so it is bound by device memory, and each
window stays in shared memory from its load to its store.

Semantics (the JAX package's): x is (C, N) complex with N a multiple of
the hop Ne, the state the last V input samples of each channel (zeros for
a fresh signal); window w of a channel is [the V samples before it | Ne
new ones], filtered by Nf-point FFT, x H, inverse FFT, keeping the last Ne
outputs.  The new state is the last V samples of [state | x].  Complex taps
are supported.

The JAX kernel's precision tiers ("highest", "split") have no counterpart
here: the kernel's radix-16 FFT and the plain version's ``torch.fft`` are
fp32 throughout, so ``OlaFft`` runs both tiers this way and the port is
held to the "highest" tier's gate (1e-5 of the peak) on both.

A wrapper given CPU tensors runs the plain version (:func:`ola_stream_plain`:
unfold the windows, ``torch.fft.fft``, x H, ``torch.fft.ifft``, discard);
given CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ...config import complex_dtype
from . import _build

__all__ = ["ola_plan", "freq_response", "ola_stream", "ola_stream_plain",
           "ola_filter_stream", "ola_filter"]

_L = 128


def ola_plan(ntaps: int, Nf: int | None = None) -> tuple[int, int, int]:
    """(Nf, Ne, V): FFT size, hop (valid samples per window), overlap.
    V = K-1 rounded up to a multiple of 128; Nf defaults to the smallest
    power of two >= max(4096, 16 (K-1)), at most 16384 (the JAX package's
    plan, ``ops/pallas/ola.py:43-67``, kept so that both give the same
    block granularity)."""
    V = max(_L, ((ntaps - 1 + _L - 1) // _L) * _L)
    if Nf is None:
        Nf = 4096
        while Nf < 16 * max(ntaps - 1, 1):
            Nf *= 2
        Nf = min(Nf, 16384)
    if Nf % _L or Nf & (Nf - 1):
        raise ValueError(f"Nf={Nf} must be a power of two >= {_L}")
    if Nf < V + _L:
        raise ValueError(
            f"filter too long for the cuda OLA engine: ntaps={ntaps} "
            f"needs overlap V={V} but the largest FFT size is "
            f"{Nf} (< V + {_L}); use the torch engine (OlaFft "
            f"engine='torch') for filters this long.")
    return Nf, Nf - V, V


def freq_response(h, Nf: int, device) -> torch.Tensor:
    """H = FFT_Nf(h) in natural bin order, complex64 on ``device``, float64
    on the host and rounded once: the response :func:`ola_stream` takes (the
    JAX package's ``_freq_response`` gives its own kernel's [k1, q] layout
    in the same role).  The kernel reads it in its FFT's position order
    itself."""
    H = np.fft.fft(np.asarray(h), Nf).astype(np.complex64)
    return torch.as_tensor(H, device=device)


def _check(x, state, H, ntaps: int, Nf: int):
    Nf, Ne, V = ola_plan(ntaps, Nf)
    if x.ndim != 2 or state.ndim != 2:
        raise ValueError(f"x and state must be (C, N) and (C, V), got "
                         f"{tuple(x.shape)} and {tuple(state.shape)}")
    C, N = x.shape
    if N % Ne:
        raise ValueError(f"N={N} is not a multiple of the hop Ne={Ne}")
    if tuple(state.shape) != (C, V):
        raise ValueError(f"state must be ({C}, {V}), got "
                         f"{tuple(state.shape)}")
    if tuple(H.shape) != (Nf,):
        raise ValueError(f"H must be ({Nf},), got {tuple(H.shape)}")
    return Nf, Ne, V


def _new_state(x: torch.Tensor, state: torch.Tensor, V: int):
    if x.shape[-1] >= V:
        return x[:, x.shape[-1] - V:].contiguous()
    return torch.cat([state, x], dim=-1)[:, -V:].contiguous()


def ola_stream_plain(x: torch.Tensor, state: torch.Tensor, H: torch.Tensor,
                     ntaps: int, Nf: int):
    """Plain PyTorch version: the windows unfolded from [state | x], then
    ``torch.fft.fft`` -> x H -> ``torch.fft.ifft`` -> the last Ne samples,
    in fp32.  Returns complex (y, new_state)."""
    Nf, Ne, V = _check(x, state, H, ntaps, Nf)
    x = x.to(complex_dtype)
    state = state.to(complex_dtype)
    C, N = x.shape
    xx = torch.cat([state, x], dim=-1)
    win = xx.unfold(-1, Nf, Ne)                      # (C, N / Ne, Nf)
    y = torch.fft.ifft(torch.fft.fft(win, dim=-1)
                       * H.to(complex_dtype), dim=-1)[..., V:]
    return y.reshape(C, N), _new_state(x, state, V)


def ola_stream(x: torch.Tensor, state: torch.Tensor, H: torch.Tensor,
               ntaps: int, Nf: int):
    """Streaming overlap-save filtering of complex x (C, N), N a multiple
    of the hop, with complex state (C, V) and the frequency response H
    (Nf,) in natural bin order (:func:`freq_response`).  Returns complex
    (y, new_state)."""
    Nf, Ne, V = _check(x, state, H, ntaps, Nf)
    if _build.use_plain(x):
        return ola_stream_plain(x, state, H, ntaps, Nf)
    x = x.to(complex_dtype).contiguous()
    state = state.to(complex_dtype).contiguous()
    hp = H.to(complex_dtype).contiguous()
    C, N = x.shape
    y = torch.empty_like(x)
    if C and N:
        _build.require_cuda(x, state, hp, y)
        err = _build.lib().ola_f32(
            _build.ptr(x), _build.ptr(state), _build.ptr(hp), _build.ptr(y),
            C, N, Nf.bit_length() - 1, V, _build.stream_ptr(x.device))
        _build.check(err, "ola_f32")
        ola_stream.launches += 1
    return y, _new_state(x, state, V)


ola_stream.launches = 0


def ola_filter_stream(x: torch.Tensor, h, state: torch.Tensor,
                      Nf: int | None = None):
    """Streaming overlap-save filtering with host taps h: x (C, N), N a
    multiple of the hop, state (C, V) complex input history.  Returns (y,
    new_state); y is real when x and h are both real.  Recomputes the
    taps' FFT on every call: a serving loop keeps H (``OlaFft``)."""
    h = np.asarray(h)
    K = len(h)
    Nf, Ne, V = ola_plan(K, Nf)
    out_complex = x.is_complex() or np.iscomplexobj(h)
    H = freq_response(h, Nf, x.device)
    y, new_state = ola_stream(x.to(complex_dtype), state.to(complex_dtype),
                              H, K, Nf)
    return (y if out_complex else y.real), new_state


def ola_filter(x: torch.Tensor, h, Nf: int | None = None) -> torch.Tensor:
    """Causal FIR filtering of (C, N) or (N,) signals through the
    overlap-save kernel, zero initial state, real or complex taps (the
    semantics of ``filter_rt.fir_filter``).  N is padded to a multiple of
    the hop and the output sliced back."""
    h = np.asarray(h)
    Nf, Ne, V = ola_plan(len(h), Nf)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    C, N = x.shape
    xp = torch.nn.functional.pad(x, (0, (-N) % Ne))
    state = torch.zeros((C, V), dtype=complex_dtype, device=x.device)
    y, _ = ola_filter_stream(xp, h, state, Nf=Nf)
    y = y[:, :N]
    return y[0] if squeeze else y
