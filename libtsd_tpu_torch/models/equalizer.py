"""Adaptive and zero-forcing equalizers (PyTorch), ported from
``libtsd_tpu/models/equalizer.py``.

Parity: core/src/telecom/egalisation.cc (EgaliseurRIF LMS FFE/DFE with
DEC/CMA error functions :29-178; ZFE design + convolution matrix :187-247),
header core/include/tsd/telecom.hpp:1502-1579.

The LMS update is an irreducible per-symbol feedback loop: a Python loop
of device operations (the JAX package's ``lax.scan``), one step per input
sample, with no host synchronisation inside a step (the decision's argmin
and the constellation lookup stay on the device).  ``convolution_matrix``
and ``zfe_design`` are host numpy copies.
"""
from __future__ import annotations

import numpy as np
import torch

from ..block import Block
from ..config import complex_dtype, real_dtype
from .waveform import Waveform

__all__ = ["LmsEqualizer", "zfe_design", "convolution_matrix"]


def _push(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The window shifted left by one with v as its newest (last) entry
    (``jnp.roll(w, -1).at[-1].set(v)``)."""
    return torch.cat([w[1:], v.reshape(1).to(w.dtype)])


class LmsEqualizer(Block):
    """FFE (optionally DFE) adaptive equalizer, error = DEC (decision
    directed) or CMA (constant modulus).  Operates at symbol rate (K=1) or
    fractionally (K>1 input samples per output).

    Parity: EgaliseurRIF, egalisation.cc:29-178, same update rules
    (Wirtinger gradient for out = sum h*wnd, no conjugation on h):
      DEC: h += alpha * e * conj(wnd),          e = decision - out
      CMA: h += alpha * (1-|out|^2) * out * conj(wnd)

    ``ref_mode=True`` reproduces the reference's EgaliseurRIF exactly
    (golden-diffed in tests/test_golden_ref4.py): REAL taps updated with
    alpha*real(wnd*conj(e)) and the identity at the NEWEST tap
    (egalisation.cc:89-91, 147-158).  The default is complex taps with the
    spike at the centre.  ``step`` takes a 1-D input on the waveform's
    device and returns (state, (out, err, active)), one entry per input
    sample.
    """

    # MAINTENANCE NOTE: init() and step() keep the ref_mode
    # (reference-trajectory-parity) and default branches as separate literal
    # blocks, as the JAX module does: the golden tests pin ref_mode
    # trajectory-exactly.  ANY fix to the active-gating / wnd_d shift /
    # state bookkeeping must be applied to BOTH branches.

    def __init__(self, wf: Waveform, structure: str = "ffe",
                 errf: str = "dec", K: int = 1, alpha: float = 0.01,
                 N1: int = 11, N2: int = 11, ref_mode: bool = False):
        super().__init__()
        self.wf = wf
        self.structure = structure
        self.errf = errf
        self.K = int(K)
        self.alpha = float(alpha)
        self.N1 = int(N1)
        self.N2 = int(N2)
        self.ref_mode = bool(ref_mode)

    @property
    def device(self) -> torch.device:
        return self.wf.device

    def init(self):
        dev = self.device
        if self.ref_mode:
            h_fwd = torch.zeros((self.N1,), dtype=real_dtype, device=dev)
            h_fwd[-1] = 1.0
            st = dict(h_fwd=h_fwd,
                      wnd=torch.zeros((self.N1,), dtype=complex_dtype,
                                      device=dev),
                      cnt=torch.zeros((), dtype=torch.int32, device=dev))
            if self.structure == "dfe":
                st["h_bwd"] = torch.zeros((self.N2,), dtype=real_dtype,
                                          device=dev)
                st["wnd_d"] = torch.zeros((self.N2,), dtype=complex_dtype,
                                          device=dev)
            return st
        # unit spike at the CENTER: the equalizer then spans both precursor
        # and postcursor ISI (zfe_design centres its delay for the same
        # reason)
        h_fwd = torch.zeros((self.N1,), dtype=complex_dtype, device=dev)
        h_fwd[self.N1 // 2] = 1.0
        st = dict(h_fwd=h_fwd,
                  wnd=torch.zeros((self.N1,), dtype=complex_dtype,
                                  device=dev),
                  cnt=torch.zeros((), dtype=torch.int32, device=dev))
        if self.structure == "dfe":
            st["h_bwd"] = torch.zeros((self.N2,), dtype=complex_dtype,
                                      device=dev)
            st["wnd_d"] = torch.zeros((self.N2,), dtype=complex_dtype,
                                      device=dev)
        return st

    def step(self, state, x: torch.Tensor):
        symbols = self.wf.symbols
        alpha = self.alpha
        dfe = self.structure == "dfe"
        cma = self.errf == "cma"
        K = self.K
        always = torch.ones((), dtype=torch.bool, device=x.device)
        st = dict(state)
        ys, errs, acts = [], [], []
        for i in range(x.shape[0]):
            xi = x[i]
            wnd = _push(st["wnd"], xi)
            st = {**st, "wnd": wnd}
            cnt = (st["cnt"] + 1) % K
            active = cnt == 0 if K > 1 else always
            out = torch.sum(st["h_fwd"] * wnd)
            if dfe:
                fb = torch.sum(st["h_bwd"] * st["wnd_d"])
                out = out + fb
            d_idx = torch.argmin((out - symbols).abs() ** 2)
            dec = symbols[d_idx]
            if self.ref_mode:
                # reference update rules (egalisation.cc:147-158): REAL
                # taps, gradient = alpha * real(wnd * conj(e))
                if cma:
                    e = 1.0 - out.abs() ** 2
                    err = e.abs()
                    h_fwd = st["h_fwd"] + alpha * e * torch.real(
                        wnd * torch.conj(out))
                    if dfe:
                        h_bwd = st["h_bwd"] + alpha * e * torch.real(
                            st["wnd_d"] * torch.conj(fb))
                else:
                    ec = dec - out
                    err = ec.abs()
                    h_fwd = st["h_fwd"] + alpha * torch.real(
                        wnd * torch.conj(ec))
                    if dfe:
                        h_bwd = st["h_bwd"] + alpha * torch.real(
                            st["wnd_d"] * torch.conj(ec))
                new = {**st, "cnt": cnt,
                       "h_fwd": torch.where(active, h_fwd, st["h_fwd"])}
                if dfe:
                    new["h_bwd"] = torch.where(active, h_bwd, st["h_bwd"])
                    new["wnd_d"] = torch.where(
                        active, _push(st["wnd_d"], dec), st["wnd_d"])
                st = new
                ys.append(out)
                errs.append(err)
                acts.append(active)
                continue
            if cma:
                # CMA gradient: h += alpha*(1-|y|^2)*y*conj(w)
                e = 1.0 - out.abs() ** 2
                h_fwd = st["h_fwd"] + alpha * e * out * torch.conj(wnd)
                err = e.abs()
                if dfe:
                    # the same Wirtinger gradient w.r.t. h_bwd: proportional
                    # to the TOTAL output (h_bwd starts at zero, so an
                    # fb-proportional update could never bootstrap)
                    h_bwd = st["h_bwd"] + alpha * e * out * torch.conj(
                        st["wnd_d"])
            else:
                # LMS: h += alpha * e * conj(w), e = decision - out
                ec = dec - out
                err = ec.abs()
                h_fwd = st["h_fwd"] + alpha * ec * torch.conj(wnd)
                if dfe:
                    h_bwd = st["h_bwd"] + alpha * ec * torch.conj(
                        st["wnd_d"])
            new = {**st, "cnt": cnt,
                   "h_fwd": torch.where(active, h_fwd, st["h_fwd"])}
            if dfe:
                new["h_bwd"] = torch.where(active, h_bwd, st["h_bwd"])
                new["wnd_d"] = torch.where(
                    active, _push(st["wnd_d"], dec), st["wnd_d"])
            st = new
            ys.append(out)
            errs.append(err)
            acts.append(active)
        return st, (torch.stack(ys), torch.stack(errs), torch.stack(acts))


def convolution_matrix(h: np.ndarray, n: int) -> np.ndarray:
    """Toeplitz convolution matrix: C @ x = conv(h, x)[:n+len(h)-1] rows
    (parity: égaliseur convolution matrix, egalisation.cc:187-210)."""
    h = np.asarray(h)
    m = len(h)
    C = np.zeros((n + m - 1, n), dtype=h.dtype)
    for i in range(n):
        C[i:i + m, i] = h
    return C


def zfe_design(h: np.ndarray, n: int) -> np.ndarray:
    """Zero-forcing equalizer: least-squares inverse of the channel
    (parity: égaliseur_zfe, egalisation.cc:212-247), g minimizing
    ||conv(h, g) - delta||, delay at the center (host float64)."""
    h = np.asarray(h, np.complex128)
    m = len(h)
    C = convolution_matrix(h, n)
    d = np.zeros(n + m - 1, np.complex128)
    d[(n + m - 1) // 2] = 1.0
    g, *_ = np.linalg.lstsq(C, d, rcond=None)
    return g
