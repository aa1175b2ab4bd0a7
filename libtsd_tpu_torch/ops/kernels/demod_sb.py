"""Kernels #5 and #6: the batched sub-block decision-directed demodulator
(``csrc/demod_sb.cu``), each beside its plain PyTorch version.

* :func:`demod_sb` (#5) replaces ``libtsd_tpu/ops/pallas/demod_sb.py::
  demod_sb_pallas``: the sub-block loop over the matched filter's output.
* :func:`demod_sb_fused` (#6) replaces ``demod_sb_pallas_fused``: the same
  loop with the matched filter (fp32) and a streaming power-EMA AGC
  pre-scale inside the kernel, from the raw input.

What bounds them on the H100 and what their design does about it is set
out at the top of ``csrc/demod_sb.cu``: the loop is a chain of nsb
dependent steps per channel, so one group of lanes of a warp serves one
channel and shuffles carry the per-sub-block sums.

The loop (``libtsd_tpu/models/demod_sb.py:363-444``), per channel and
sub-block t of S symbols, nominal pointer nom = t S osf: one fractional
phase tau for all S symbols and midpoints; closed-form interpolator taps
at the LUT-quantised tau; the carrier phase ramped as theta + j mu / S;
nearest-point decisions; the Gardner TED summed over the sub-block; the
mean decision-directed phase error into a second-order loop filter; the
mean AGC error into the gain; one timing correction per sub-block.  State
rows (8, C): ptr, theta, gain, lf_theta, lf_mu, lf_last, yprev re/im (and
the power EMA as a ninth row for #6).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...config import complex_dtype, real_dtype
from . import _build

__all__ = ["LoopParams", "ITRP", "APW", "pick_tb", "fused_layout",
           "interp_taps", "demod_sb", "demod_sb_plain", "demod_sb_fused",
           "demod_sb_fused_plain"]

ITRP = {"cspline": 0, "linear": 1, "lagrange": 2, "sinc": 3}
APW = 0.25      # power-EMA update per superframe (the JAX package's _APW)
_S_MAX = 32     # symbols per sub-block that one warp's lanes can carry
_M_MAX = 4096   # constellation points held in shared memory


@dataclasses.dataclass(frozen=True)
class LoopParams:
    """Static parameters of the sub-block loop (one DecisionDemodSB)."""
    itrp: str
    K: int            # interpolator taps
    nph: int          # interpolator phases
    osf: int
    S: int
    n: int            # samples in the block
    tgain: float      # timing gain
    aga: float        # AGC coefficient per sub-block
    gamma: float      # LoopFilter2 gains
    rho: float
    carrier: bool
    clock: bool
    agc: bool

    @property
    def T(self) -> int:
        """Carried matched-filter tail (see DecisionDemodSB.T)."""
        return self.K + self.osf // 2 + self.S * self.osf

    @property
    def nsb(self) -> int:
        return self.n // (self.osf * self.S)

    @property
    def fs0(self) -> int:
        """zp index of sub-block 0's frame start."""
        return self.T - self.S * self.osf - (self.K - 1) - self.osf // 2

    @property
    def flags(self) -> int:
        return int(self.carrier) | 2 * int(self.clock) | 4 * int(self.agc)


def pick_tb(nsb: int) -> int:
    """Sub-blocks per superframe: the largest power-of-2 divisor of nsb up
    to 8 (the JAX package's _pick_tb; the fused AGC's EMA steps once per
    superframe, so this is part of #6's semantics)."""
    tb = 1
    while tb < 8 and nsb % (tb * 2) == 0:
        tb *= 2
    return tb


def fused_layout(osf: int, S: int, K: int, n: int) -> dict:
    """Layout of the fused engine (the JAX package's fused_layout): XOFF
    input samples are carried between blocks; superframe t's window starts
    at x_g = t tb S osf + Z00 (x_g = 0 is the block's first sample) and
    spans SFZ matched-filter rows."""
    hop = S * osf
    nsb = n // hop
    tb = pick_tb(nsb)
    HOPT = tb * hop
    ML, MH = S * osf, 2 * osf
    F = (ML + MH + K) + (S - 1) * osf + osf // 2
    Z00 = -(ML + (K - 1) + osf // 2)
    Z0a0 = 128 * (Z00 // 128)
    off = Z00 - Z0a0
    SFZ = HOPT + (F - hop)
    nfz = -(-(off + SFZ) // 128)
    nT = nsb // tb
    return dict(tb=tb, hopt=HOPT, nfz=nfz, off=off, Z00=Z00, SFZ=SFZ,
                XOFF=128 - Z0a0,
                rows_total=(nT - 1) * HOPT + 128 * (nfz + 1))


def _div(a, b) -> torch.Tensor:
    """a / b, one IEEE division per element.  (On CUDA, PyTorch turns a
    division by a host number into a multiplication by its reciprocal,
    which rounds twice; the kernels divide.)"""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)


def _f32(v: float) -> float:
    """v rounded to float32 (a host constant as the kernel holds it)."""
    return float(np.float32(v))


def interp_taps(kind: str, tau: torch.Tensor, nph: int,
                K: int) -> torch.Tensor:
    """Closed-form fractional-delay taps at the LUT-quantised tau (any
    shape -> (..., K)): the formulas of ops/resample.py's builders
    (cspline, linear, Lagrange of degree K - 1, windowed sinc with
    fc = 0.5 and the tau-shifted Hann window), in float32, one rounding
    per operation in the kernel's order."""
    t = _div(torch.round(torch.clamp(tau, 0.0, 1.0) * nph), float(nph))
    if kind == "cspline":
        tm = t - 1
        tm2 = tm * tm
        h0 = (1 + 2 * t) * tm2
        h1 = t * tm2
        h2 = (t * t) * (3 - 2 * t)
        h3 = (t * t) * tm
        rows = [-(h1 * 0.5), h0 - h3 * 0.5, h2 + h1 * 0.5, h3 * 0.5]
    elif kind == "linear":
        rows = [1 - t, t]
    elif kind == "lagrange":
        d = K - 1
        tt = t + 0.5 * (d - 1)
        rows = []
        for i in range(d + 1):
            hh = torch.ones_like(tt)
            for j in range(d + 1):
                if i != j:
                    hh = _div(hh * (tt - j), float(i - j))
            rows.append(hh)
    elif kind == "sinc":
        pi = _f32(np.pi)
        w = _f32(np.float32(2) * np.float32(np.pi) / np.float32(K))
        rows, ssum = [], torch.zeros_like(t)
        for i in range(K):
            k = float(i - K // 2) - t
            px = pi * k
            s = torch.where(px.abs() < 1e-6, 1 - _div(px * px, 6.0),
                            _div(torch.sin(px),
                                 torch.where(px == 0, 1.0, px)))
            rows.append(s * (0.5 + 0.5 * torch.cos(k * w)))
            ssum = ssum + rows[-1]
        den = torch.where(ssum.abs() > 1e-12, ssum, 1.0)
        rows = [_div(r, den) for r in rows]
    else:
        raise ValueError(f"no closed-form taps for interpolator {kind!r}; "
                         f"use one of {tuple(ITRP)}")
    return torch.stack(rows, dim=-1).to(real_dtype)


def _group_sum(v: torch.Tensor, S: int) -> torch.Tensor:
    """Sum over the last axis (S lanes) as the kernels' xor butterfly over
    G = pow2 >= S lanes adds it (zero lanes past S)."""
    G = 1 << (S - 1).bit_length()
    if G > S:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (G - S,))], -1)
    lanes = torch.arange(G, device=v.device)
    m = G // 2
    while m:
        v = v + v[..., lanes ^ m]
        m //= 2
    return v[..., 0]


# --------------------------------------------------------------- plain


def demod_sb_plain(zp: torch.Tensor, state8: torch.Tensor,
                   sym: torch.Tensor, p: LoopParams,
                   scale: torch.Tensor | None = None):
    """Plain PyTorch version of #5: a Python loop over the sub-blocks,
    batched over the channels, on re/im planes, with the kernel's order of
    operations (it agrees with the kernel bit for bit on the card).

    zp: (C, L) complex64, the matched-filter output z behind its carried
    tail (zp[:, T + i] = z[i]), L >= n + T + K + osf; state8: (8, C)
    float32; sym: (M,) complex64; scale: optional (C, nsb) factor on each
    sub-block's interpolated sums (#6's AGC pre-scale).

    Returns y (C, nsb S) complex64, sidx (C, nsb S) int32, valid
    (C, nsb S) bool, state8 out (8, C)."""
    C = zp.shape[0]
    osf, S, K = p.osf, p.S, p.K
    h = osf // 2
    ML, MH = S * osf, 2 * osf
    dev = zp.device
    zr_, zi_ = zp.real.contiguous(), zp.imag.contiguous()
    sr, si = sym.real.contiguous(), sym.imag.contiguous()
    gamma, aga = _f32(p.gamma), _f32(p.aga)
    opr = _f32(np.float32(1) + np.float32(p.rho))     # 1 + rho in float32
    oma = _f32(np.float32(1) - np.float32(aga))       # 1 - aga in float32
    ptr, theta, gain, lf_th, lf_mu, lf_last, ypr, ypi = state8.unbind(0)
    jf = torch.arange(S, dtype=real_dtype, device=dev)
    rows = torch.arange(C, device=dev)[:, None, None]
    offs = (torch.arange(S, device=dev)[:, None] * osf
            + torch.arange(K, device=dev)[None, :])           # (S, K)
    zero = torch.zeros((), dtype=real_dtype, device=dev)
    ys, ss, vs = [], [], []
    for t in range(p.nsb):
        nom = float(t * S * osf)
        ready = (ptr + (S - 1) * osf) < p.n
        pc = torch.where(ready, ptr, nom + 0.5 * osf)
        ip = torch.floor(pc)
        tau = pc - ip
        o_raw = (ip - nom) + ML
        o = torch.clamp(o_raw, 0, ML + MH).to(torch.int64)
        inrange = (o_raw >= 0) & (o_raw <= ML + MH)
        taps = interp_taps(p.itrp, tau, p.nph, K)              # (C, K)
        idx = (p.fs0 + t * S * osf + o)[:, None, None] + offs  # (C, S, K)
        wm_r, wm_i = zr_[rows, idx], zi_[rows, idx]
        ws_r, ws_i = zr_[rows, idx + h], zi_[rows, idx + h]
        tk = taps[:, None, 0]
        mr, mi, yr, yi = (tk * wm_r[..., 0], tk * wm_i[..., 0],
                          tk * ws_r[..., 0], tk * ws_i[..., 0])
        for k in range(1, K):
            tk = taps[:, None, k]
            mr = mr + tk * wm_r[..., k]
            mi = mi + tk * wm_i[..., k]
            yr = yr + tk * ws_r[..., k]
            yi = yi + tk * ws_i[..., k]
        if scale is not None:
            sc = scale[:, t, None]
            mr, mi, yr, yi = mr * sc, mi * sc, yr * sc, yi * sc
        th = theta[:, None] + jf * _div(lf_mu, float(S))[:, None]
        cs, sn = torch.cos(th), torch.sin(th)
        g = gain[:, None]
        y_r = (yr * cs + yi * sn) * g
        y_i = (yi * cs - yr * sn) * g
        m_r = (mr * cs + mi * sn) * g
        m_i = (mi * cs - mr * sn) * g
        dr, di = y_r[..., None] - sr, y_i[..., None] - si
        s_idx = torch.argmin(dr * dr + di * di, dim=-1)
        ye_r, ye_i = sr[s_idx], si[s_idx]
        p_r = torch.cat([ypr[:, None], y_r[:, :-1]], dim=1)
        p_i = torch.cat([ypi[:, None], y_i[:, :-1]], dim=1)
        e_t = (y_r - p_r) * m_r + (y_i - p_i) * m_i
        z_r = y_r * ye_r + y_i * ye_i
        z_i = y_i * ye_r - y_r * ye_i
        y2 = y_r * y_r + y_i * y_i
        e_ph = torch.where(y2 > 0, torch.atan2(z_i, z_r), zero)
        eg = _div(torch.sqrt(y2),
                  torch.clamp(torch.sqrt(ye_r * ye_r + ye_i * ye_i),
                              min=1e-9))
        e_g = _div(1.0, torch.clamp(eg, min=1e-9))
        dec = torch.clamp(p.tgain * _group_sum(e_t, S), -0.5 * osf,
                          0.5 * osf)
        e_mean = _div(_group_sum(e_ph, S), float(S))
        upd = ready & inrange
        if p.carrier:
            th2 = lf_th + lf_mu
            mu2 = lf_mu + gamma * (opr * e_mean - lf_last)
            theta = torch.where(upd, th2, theta)
            lf_th = torch.where(upd, th2, lf_th)
            lf_mu = torch.where(upd, mu2, lf_mu)
            lf_last = torch.where(upd, e_mean, lf_last)
        if p.agc:
            g_mean = _div(_group_sum(e_g, S), float(S))
            gain = torch.where(upd, oma * gain + aga * g_mean, gain)
        ptr_adv = (ptr + S * osf) - torch.where(
            inrange & p.clock, dec, zero)
        ptr_adv = torch.where(inrange, ptr_adv,
                              torch.full_like(ptr, nom + S * osf + 0.5 * osf))
        ptr = torch.where(ready, ptr_adv, ptr)
        ypr = torch.where(upd, y_r[:, -1], ypr)
        ypi = torch.where(upd, y_i[:, -1], ypi)
        ok = upd[:, None]
        ys.append(torch.complex(torch.where(ok, y_r, zero),
                                torch.where(ok, y_i, zero)))
        ss.append(torch.where(ok, s_idx, torch.zeros_like(s_idx)))
        vs.append(ok.expand(C, S))
    st = torch.stack([ptr, theta, gain, lf_th, lf_mu, lf_last, ypr, ypi])
    if not ys:
        e = zp.new_zeros((C, 0))
        return e, e.real.to(torch.int32), e.real.bool(), st
    return (torch.stack(ys, 1).reshape(C, -1).to(complex_dtype),
            torch.stack(ss, 1).reshape(C, -1).to(torch.int32),
            torch.stack(vs, 1).reshape(C, -1), st)


def _mf_direct(h_mf: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    """Direct-form fp32 matched filter, tap by tap in the kernel's order:
    out[:, i] = sum_k h[k] xp[:, i + Kmf - 1 - k], i.e. the filter's output
    at xp index i + Kmf - 1 (no initial state needed there)."""
    kmf = h_mf.shape[0]
    N = xp.shape[-1] - (kmf - 1)
    xr, xi = xp.real.contiguous(), xp.imag.contiguous()
    zr = h_mf[0] * xr[:, kmf - 1:kmf - 1 + N]
    zi = h_mf[0] * xi[:, kmf - 1:kmf - 1 + N]
    for k in range(1, kmf):
        zr = zr + h_mf[k] * xr[:, kmf - 1 - k:kmf - 1 - k + N]
        zi = zi + h_mf[k] * xi[:, kmf - 1 - k:kmf - 1 - k + N]
    return torch.complex(zr, zi)


def _fused_scales(z: torch.Tensor, p_ema: torch.Tensor, lay: dict,
                  p: LoopParams, rms_ref: float, a: int):
    """Per-superframe AGC pre-scales (C, nsb) and the final power EMA.
    z[:, a + g] is the matched-filter output at x_g.  Superframe t's power
    is the mean |z|^2 over x_g in [t tb S osf + Z00, + tb S osf), summed as
    the kernel's lanes sum it."""
    tb, hopt = lay["tb"], lay["hopt"]
    G = 1 << (p.S - 1).bit_length()
    a = a + lay["Z00"]
    sc = []
    for t in range(p.nsb // tb):
        zt = z[:, a + t * hopt:a + (t + 1) * hopt]
        q = zt.real * zt.real + zt.imag * zt.imag
        q = torch.cat([q, q.new_zeros((q.shape[0], (-hopt) % G))], -1)
        q = q.reshape(q.shape[0], -1, G)
        lane = q[:, 0]
        for r in range(1, q.shape[1]):
            lane = lane + q[:, r]
        pw = _div(_group_sum(lane, G), float(hopt))
        s = torch.ones_like(p_ema)
        if p.agc:
            s = torch.where(p_ema > 0, _div(_f32(rms_ref), torch.sqrt(
                torch.clamp(p_ema, min=1e-20))), s)
            p_ema = torch.where(p_ema > 0, (1 - APW) * p_ema + APW * pw, pw)
        sc.append(s[:, None].expand(-1, tb))
    scale = torch.cat(sc, 1) if sc else p_ema.new_zeros((p_ema.shape[0], 0))
    return scale, p_ema


def demod_sb_fused_plain(x: torch.Tensor, xtail: torch.Tensor,
                         state9: torch.Tensor, sym: torch.Tensor,
                         h_mf: torch.Tensor, p: LoopParams, rms_ref: float):
    """Plain PyTorch version of #6: the fp32 matched filter over
    [xtail | x | zero pad] (direct form, the kernel's order, where the JAX
    package's fused kernel rounds x and the taps to bf16 for its MXU), the
    power EMA per superframe (applied one superframe late, a fresh stream
    at scale 1), then #5's plain loop with those scales."""
    lay = _check_fused(x, xtail, p)
    C, n = x.shape
    kmf = h_mf.shape[0]
    pad = lay["rows_total"] - lay["XOFF"] - n
    xp = torch.cat([xtail, x, x.new_zeros((C, pad))], dim=-1)
    z = _mf_direct(h_mf.to(device=x.device, dtype=real_dtype), xp)
    a = lay["XOFF"] - (kmf - 1)                # z[:, a + g] is at x_g
    if a < p.T:
        # zp[:, 0] (x_g = -T) is never read; keep the index map
        z = torch.cat([z.new_zeros((C, p.T - a)), z], -1)
        a = p.T
    scale, p_ema = _fused_scales(z, state9[8], lay, p, rms_ref, a)
    zp = z[:, a - p.T:]
    y, sidx, valid, st8 = demod_sb_plain(zp, state9[:8], sym, p, scale)
    return y, sidx, valid, torch.cat([st8, p_ema[None]])


def _check_fused(x, xtail, p: LoopParams) -> dict:
    """The fused engine's block rules, with the JAX package's messages."""
    osf, S = p.osf, p.S
    n = x.shape[-1]
    if n != p.n:
        raise ValueError(f"block of {n} samples, parameters for {p.n}")
    if n % (osf * S):
        raise ValueError(
            f"engine='cuda-fused' processes whole {osf * S}-sample "
            f"sub-blocks per step (osf={osf} x S={S}); got a block of "
            f"n={n} samples — re-block the stream or use engine='cuda', "
            f"which carries the remainder in its tail")
    lay = fused_layout(osf, S, p.K, n)
    if n < lay["XOFF"]:
        raise ValueError(
            f"engine='cuda-fused' needs blocks of at least {lay['XOFF']} "
            f"samples (the carried superframe margin); got n={n}")
    if xtail.shape[-1] != lay["XOFF"]:
        raise ValueError(f"xtail holds {xtail.shape[-1]} samples, the "
                         f"layout carries {lay['XOFF']}")
    return lay


# ------------------------------------------------------------- kernels


def _kmax(K: int) -> int:
    for km in (4, 16, 32):
        if K <= km:
            return km
    raise ValueError(f"the kernels take at most 32 interpolator taps, "
                     f"got {K}")


def _check_kernel(p: LoopParams, sym: torch.Tensor) -> None:
    if p.S > _S_MAX:
        raise ValueError(f"the kernels take S <= {_S_MAX} symbols per "
                         f"sub-block (one warp's lanes), got S={p.S}")
    if p.itrp not in ITRP:
        raise ValueError(f"no closed-form taps for interpolator "
                         f"{p.itrp!r}; use one of {tuple(ITRP)}")
    if not 0 < sym.shape[0] <= _M_MAX:
        raise ValueError(f"constellation of {sym.shape[0]} points; the "
                         f"kernels take 1..{_M_MAX}")


def _outputs(C: int, p: LoopParams, dev):
    m = p.nsb * p.S
    return (torch.empty((C, m), dtype=complex_dtype, device=dev),
            torch.empty((C, m), dtype=torch.int32, device=dev),
            torch.empty((C, m), dtype=torch.bool, device=dev))


def demod_sb(zp: torch.Tensor, state8: torch.Tensor, sym: torch.Tensor,
             p: LoopParams):
    """#5.  Same arguments and results as :func:`demod_sb_plain`."""
    if _build.use_plain(zp):
        return demod_sb_plain(zp, state8, sym, p)
    C, L = zp.shape
    if L < p.n + p.T + p.K + p.osf:
        raise ValueError(f"zp of {L} samples per channel, the loop reads "
                         f"{p.n + p.T + p.K + p.osf}")
    _check_kernel(p, sym)
    zp = zp.to(complex_dtype).contiguous()
    state8 = state8.to(real_dtype).contiguous()
    sym = sym.to(complex_dtype).contiguous()
    y, sidx, valid = _outputs(C, p, zp.device)
    st = torch.empty_like(state8)
    _build.require_cuda(zp, state8, sym, y, sidx, valid, st)
    if C and p.nsb:
        err = _build.lib().demod_sb_f32(
            _build.ptr(zp), L, _build.ptr(state8), _build.ptr(st),
            _build.ptr(sym), sym.shape[0], _build.ptr(y), _build.ptr(sidx),
            _build.ptr(valid), C, p.nsb, p.S, p.osf, p.K, p.nph,
            ITRP[p.itrp], p.n, p.fs0, p.tgain, p.aga, p.gamma, p.rho,
            p.flags, _kmax(p.K), _build.stream_ptr(zp.device))
        _build.check(err, "demod_sb_f32")
        demod_sb.launches += 1
    else:
        st.copy_(state8)
    return y, sidx, valid, st


demod_sb.launches = 0


def demod_sb_fused(x: torch.Tensor, xtail: torch.Tensor,
                   state9: torch.Tensor, sym: torch.Tensor,
                   h_mf: torch.Tensor, p: LoopParams, rms_ref: float):
    """#6.  x (C, n) complex raw input, xtail (C, XOFF) the input carried
    from the last block, state9 (9, C), h_mf (Kmf,) float32 matched-filter
    taps (Kmf <= 129).  Same results as :func:`demod_sb_fused_plain`."""
    if _build.use_plain(x):
        return demod_sb_fused_plain(x, xtail, state9, sym, h_mf, p, rms_ref)
    lay = _check_fused(x, xtail, p)
    _check_kernel(p, sym)
    kmf = h_mf.shape[0]
    if not 0 < kmf <= 129:
        raise ValueError(f"the fused engine takes 1..129 matched-filter "
                         f"taps, got {kmf}")
    C, n = x.shape
    x = x.to(complex_dtype).contiguous()
    xtail = xtail.to(complex_dtype).contiguous()
    state9 = state9.to(real_dtype).contiguous()
    sym = sym.to(complex_dtype).contiguous()
    h_mf = h_mf.to(device=x.device, dtype=real_dtype).contiguous()
    y, sidx, valid = _outputs(C, p, x.device)
    st = torch.empty_like(state9)
    _build.require_cuda(x, xtail, state9, sym, h_mf, y, sidx, valid, st)
    G = 1 << (p.S - 1).bit_length()
    smem = (sym.shape[0] * 8 + ((kmf + 1) & ~1) * 4
            + (128 // G) * lay["SFZ"] * 8)
    if smem > _build.SMEM_MAX:
        raise ValueError(f"a superframe of {lay['SFZ']} rows needs {smem} "
                         f"bytes of shared memory")
    if C:
        err = _build.lib().demod_sb_fused_f32(
            _build.ptr(x), _build.ptr(xtail), lay["XOFF"], _build.ptr(h_mf),
            kmf, _build.ptr(state9), _build.ptr(st), _build.ptr(sym),
            sym.shape[0], _build.ptr(y), _build.ptr(sidx), _build.ptr(valid),
            C, p.nsb, lay["tb"], lay["SFZ"], p.S, p.osf, p.K, p.nph,
            ITRP[p.itrp], n, rms_ref, p.tgain, p.aga, p.gamma, p.rho,
            p.flags, _kmax(p.K), smem, _build.stream_ptr(x.device))
        _build.check(err, "demod_sb_fused_f32")
        demod_sb_fused.launches += 1
    return y, sidx, valid, st


demod_sb_fused.launches = 0
