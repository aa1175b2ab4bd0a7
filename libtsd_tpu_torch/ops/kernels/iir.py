"""Kernel #7: a fused cascade of IIR sections in frame state-space form
(``csrc/iir.cu``).

Replaces ``libtsd_tpu/ops/pallas/iir.py`` (``IirCascadePallas``,
``iir_cascade_pallas``), with its call signature and state layout: x (C, N)
float32 with N a multiple of tb * 128, the stacked section operators of
``IirCascade`` (T (nsec, 128, 128) as the right operand of x, S (nsec, 8,
128), W (nsec, 128, 8), M (nsec, 8, 8), zero-padded to the state width 8),
and the state (C, nsec, 8) in the canonical coordinates of
``filter_rt._iir_frame_mats``, so a JAX state carries over unchanged.  It
returns (y, final state); complex input is refused.

Per section: u_j = x_j W (the input -> state update of frame j), the hop
s_{j+1} = M s_j + u_j across frames, y_j = x_j T + s_j S; the sections
chain on chip.  What bounds the kernel and what its design does about it is
set out at the top of ``csrc/iir.cu``: a grid over (channel, chunk of 64
frames) whose blocks hand each section's end state to the next chunk
through a workspace of flags and carries, which the wrapper keeps per
device and stream and tags with a per-call epoch.

A wrapper given CPU tensors runs the plain version (:func:`iir_cascade_plain`:
the same frame algebra, the hop as a loop over the frames as the Pallas
kernel's ``fori_loop`` runs it, every product an explicit sum in a fixed
order, so a stream cut at frames is bit-identical to one call); given CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...config import device as _device, real_dtype
from ..filter_rt import _iir_frame_mats
from . import _build

__all__ = ["IirCascade", "iir_cascade", "iir_cascade_plain",
           "workspace_words"]

_L = 128
_KP = 8      # padded state width (k <= _KP)


class IirCascade:
    """The stacked frame operators of a cascade of (b, a) sections, applied
    in order (the JAX package's ``IirCascadePallas``), on ``device``."""

    def __init__(self, sections: Sequence[Tuple[np.ndarray, np.ndarray]],
                 L: int = _L, device="cuda"):
        if L != _L:
            raise ValueError(f"the frame length is {_L}, got {L}")
        Ts, Ss, Ws, Ms, ks = [], [], [], [], []
        for b, a in sections:
            T, S, W, Apow = _iir_frame_mats(b, a, L)
            k = S.shape[1]
            if k > _KP:
                raise ValueError(f"section order {k} > {_KP}")
            ks.append(k)
            Sp = np.zeros((_KP, L), np.float32)
            Sp[:k] = S.T
            Wp = np.zeros((L, _KP), np.float32)
            Wp[:, :k] = W[:, ::-1].T              # frame update flip
            Mp = np.zeros((_KP, _KP), np.float32)
            Mp[:k, :k] = Apow[L]
            Ts.append(T.T)                        # x @ T.T
            Ss.append(Sp)
            Ws.append(Wp)
            Ms.append(Mp)
        device = _device(device)
        def t(v):
            return torch.as_tensor(np.ascontiguousarray(np.stack(v)),
                                   dtype=real_dtype, device=device)
        self.nsec = len(ks)
        self.k = max(ks)
        self.T, self.S, self.W, self.M = t(Ts), t(Ss), t(Ws), t(Ms)

    @classmethod
    def from_operators(cls, T, S, W, M, k: int) -> "IirCascade":
        """A cascade from its stacked operators as they are (tensors of
        the layout above, on one device)."""
        self = cls.__new__(cls)
        self.nsec, self.k = T.shape[0], int(k)
        self.T, self.S, self.W, self.M = T, S, W, M
        return self

    def init(self, C: int) -> torch.Tensor:
        return torch.zeros((C, self.nsec, _KP), dtype=real_dtype,
                           device=self.T.device)

    def __call__(self, x: torch.Tensor, state: Optional[torch.Tensor] = None,
                 tb: int = 64):
        return iir_cascade(x, self.T, self.S, self.W, self.M, state, tb=tb)


def _check(x, T, S, W, M, state, tb: int):
    if x.is_complex():
        raise TypeError(
            "iir_cascade is a REAL-plane kernel: a complex cast would "
            "silently drop the imaginary plane.  For complex IQ run the "
            "re/im planes separately, or use IirFrame (which splits them "
            "internally)")
    if x.ndim != 2:
        raise ValueError(f"x must be (C, N), got {tuple(x.shape)}")
    C, N = x.shape
    nsec = T.shape[0]
    chunk = tb * _L
    if N % chunk:
        raise ValueError(f"N must be a multiple of {chunk} (tb * 128), "
                         f"got {N}")
    shapes = {"T": (T, (nsec, _L, _L)), "S": (S, (nsec, _KP, _L)),
              "W": (W, (nsec, _L, _KP)), "M": (M, (nsec, _KP, _KP))}
    for name, (v, want) in shapes.items():
        if tuple(v.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(v.shape)}")
    if state is None:
        state = torch.zeros((C, nsec, _KP), dtype=real_dtype, device=x.device)
    if tuple(state.shape) != (C, nsec, _KP):
        raise ValueError(f"state must be {(C, nsec, _KP)}, got "
                         f"{tuple(state.shape)}")
    return C, N, nsec, state


def _dot(a: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ B (K, n) as an explicit sum over K in ascending order:
    the same rounding for every row, whatever the shape around it."""
    acc = a[..., 0, None] * B[0]
    for i in range(1, B.shape[0]):
        acc = acc + a[..., i, None] * B[i]
    return acc


def iir_cascade_plain(x: torch.Tensor, T, S, W, M,
                      state: Optional[torch.Tensor] = None, tb: int = 64):
    """Plain PyTorch version of :func:`iir_cascade`: (y, final state)."""
    C, N, nsec, state = _check(x, T, S, W, M, state, tb)
    nf = N // _L
    cur = x.to(real_dtype).reshape(C, nf, _L)
    state = state.to(real_dtype)
    out = []
    for s in range(nsec):
        u = _dot(cur, W[s])                        # (C, nf, 8)
        sv = state[:, s]
        sst = []
        for j in range(nf):
            sst.append(sv)
            sv = (sv[:, None, :] * M[s]).sum(-1) + u[:, j]
        out.append(sv)
        cur = _dot(cur, T[s]) + _dot(torch.stack(sst, 1), S[s])
    return cur.reshape(C, N), torch.stack(out, 1)


_FR = 64     # frames per chunk of the kernel's grid (csrc/iir.cu's FR)


def workspace_words(C: int, N: int, nsec: int) -> int:
    """32-bit words of the kernel's workspace: the ticket and 3 words of
    padding, then a flag and an 8-float carry per (channel, chunk of 64
    frames, section)."""
    nchunk = -(-(N // _L) // _FR)
    return 4 + C * nchunk * nsec * (1 + _KP)


class _Workspace:
    """The carries, flags and ticket of the kernel, kept per (device,
    stream) and reused across calls; zeroed when made or grown.  Each call
    takes the next epoch (never 0), which tags the flags it sets."""

    def __init__(self):
        self.buf = None
        self.epoch = 0

    def take(self, words: int, device) -> tuple:
        if self.buf is None or self.buf.numel() < words:
            self.buf = torch.zeros(words, dtype=torch.int32, device=device)
        self.epoch = self.epoch % 0xFFFFFFFF + 1
        return self.buf, self.epoch


_workspaces: dict = {}


def iir_cascade(x: torch.Tensor, T, S, W, M,
                state: Optional[torch.Tensor] = None, tb: int = 64):
    """x (C, N) float32, N % (tb * 128) == 0; T/S/W/M the stacked section
    operators of :class:`IirCascade`; state (C, nsec, 8) or None for zeros.
    Returns (y, final state)."""
    C, N, nsec, state = _check(x, T, S, W, M, state, tb)
    if _build.use_plain(x):
        return iir_cascade_plain(x, T, S, W, M, state, tb)
    # contiguous and 16-byte aligned: the kernel reads x, S and W as float4
    args = [v.to(real_dtype).contiguous() for v in (x, T, S, W, M, state)]
    args = [v if v.data_ptr() % 16 == 0 else v.clone() for v in args]
    y = torch.empty_like(args[0])
    st = torch.empty_like(args[5])
    if C and N:
        _build.require_cuda(*args, y, st)
        stream = torch.cuda.current_stream(x.device)
        ws = _workspaces.setdefault((x.device, stream.cuda_stream),
                                    _Workspace())
        buf, epoch = ws.take(workspace_words(C, N, nsec), x.device)
        err = _build.lib().iir_cascade_f32(
            *map(_build.ptr, args), _build.ptr(y), _build.ptr(st), C, N, nsec,
            _build.ptr(buf), epoch, _build.stream_ptr(x.device))
        _build.check(err, "iir_cascade_f32")
        iir_cascade.launches += 1
    else:
        st = args[5].clone()
    return y, st


iir_cascade.launches = 0
