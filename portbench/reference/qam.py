"""Plain reference of the QAM-16 bank's step, in float32 PyTorch.

A frozen copy of the plain version of the port's fused sub-block
demodulator (the loop of libtsd's DemodGen2 in its shared-tau sub-block
form): the fp32 direct-form matched filter over [carried input | block |
zero pad], the per-superframe power-EMA AGC pre-scale (applied one
superframe late), then per sub-block of S symbols one fractional phase,
closed-form cubic-spline interpolation of the S symbols and S Gardner
midpoints, the carrier ramp, nearest-point decisions, the Gardner timing
error, the decision-directed phase error into a second-order loop filter,
the AGC gain, and one timing correction.  Everything it needs is worked
out here from the configuration: the RRC matched taps, the QAM-16 points,
the loop gains and the initial state.

``lower=True`` is the control: the input rounded to bfloat16 first.

Imports neither JAX nor anything of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

F32 = torch.float32
C64 = torch.complex64
APW = 0.25      # power-EMA update a superframe


# ------------------------------------------------------------- design


def rrc_taps(n: int, beta: float, osf: int) -> np.ndarray:
    """Root-raised-cosine FIR of n taps (libtsd's design_rif_rcs1, unit
    DC sum), float64."""
    def rcs(t):
        if t == 0:
            return (1 - beta) + 4 * beta / np.pi
        if beta > 0 and abs(abs(t) - 1 / (4 * beta)) < 1e-7:
            return (beta / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        return ((np.sin(np.pi * t * (1 - beta))
                 + 4 * beta * t * np.cos(np.pi * t * (1 + beta)))
                / (np.pi * t * (1 - (4 * beta * t) ** 2)))
    m = n // 2
    h = np.array([rcs((i - m) / osf) for i in range(n)])
    return h / h.sum()


def matched_taps(beta: float, osf: int) -> np.ndarray:
    """The matched filter: 5 osf + 1 RRC taps (odd), energy-normalised to
    h / sqrt(sum h^2 osf)."""
    n = 5 * osf + 1
    n += 1 - n % 2
    h = rrc_taps(n, beta, osf)
    return h / np.sqrt(np.sum(h * h) * osf)


def qam16() -> np.ndarray:
    x = np.arange(4) / 3.0 * 2 - 1
    re, im = np.meshgrid(x, x, indexing="ij")
    return (re + 1j * im).reshape(16, order="F")


@dataclasses.dataclass(frozen=True)
class Params:
    osf: int
    S: int
    n: int
    K: int          # interpolator taps (cubic spline: 4)
    nph: int        # interpolator phases
    tgain: float
    aga: float
    gamma: float
    rho: float

    @property
    def T(self) -> int:
        return self.K + self.osf // 2 + self.S * self.osf

    @property
    def nsb(self) -> int:
        return self.n // (self.osf * self.S)

    @property
    def fs0(self) -> int:
        return self.T - self.S * self.osf - (self.K - 1) - self.osf // 2


def params(cfg: dict, n: int) -> Params:
    """Loop gains from the configuration: timing gain osf (1 - e^(-1/tc)),
    AGC coefficient 1 - e^(-1/agc_tc) folded over S updates, the
    second-order loop at bandwidth BL S (gamma = 16 eta^2 BL' / (1 + 4
    eta^2), rho = 4 BL' / (1 + 4 eta^2))."""
    S, osf = cfg["S"], cfg["osf"]
    a = 1.0 - np.exp(-1.0 / cfg["agc_tc"])
    bl, eta = cfg["BL"] * S, cfg["eta"]
    return Params(osf=osf, S=S, n=n, K=cfg["itrp_taps"], nph=cfg["itrp_phases"],
                  tgain=float(osf * (1.0 - np.exp(-1.0 / cfg["tc"]))),
                  aga=float(1.0 - (1.0 - a) ** S),
                  gamma=float(16 * eta ** 2 * bl / (1 + 4 * eta ** 2)),
                  rho=float(4 * bl / (1 + 4 * eta ** 2)))


def pick_tb(nsb: int) -> int:
    tb = 1
    while tb < 8 and nsb % (tb * 2) == 0:
        tb *= 2
    return tb


def layout(osf: int, S: int, K: int, n: int) -> dict:
    """Superframes of tb sub-blocks; XOFF input samples carried between
    blocks."""
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
    return dict(tb=tb, hopt=HOPT, Z00=Z00, XOFF=128 - Z0a0,
                rows_total=(nT - 1) * HOPT + 128 * (nfz + 1))


def initial_state(C: int, p: Params, device) -> tuple:
    """(state9 (9, C), xtail (C, XOFF)) of a fresh stream: pointer osf / 2,
    gain 1, everything else 0."""
    st = torch.zeros((9, C), dtype=F32, device=device)
    st[0] = p.osf / 2.0
    st[2] = 1.0
    xoff = layout(p.osf, p.S, p.K, p.n)["XOFF"]
    return st, torch.zeros((C, xoff), dtype=C64, device=device)


# ------------------------------------------------------------- the step


def _f32(v: float) -> float:
    return float(np.float32(v))


def _div(a, b) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)


def cspline_taps(tau: torch.Tensor, nph: int) -> torch.Tensor:
    t = _div(torch.round(torch.clamp(tau, 0.0, 1.0) * nph), float(nph))
    tm = t - 1
    tm2 = tm * tm
    h0 = (1 + 2 * t) * tm2
    h1 = t * tm2
    h2 = (t * t) * (3 - 2 * t)
    h3 = (t * t) * tm
    return torch.stack([-(h1 * 0.5), h0 - h3 * 0.5, h2 + h1 * 0.5, h3 * 0.5],
                       dim=-1).to(F32)


def _group_sum(v: torch.Tensor, S: int) -> torch.Tensor:
    G = 1 << (S - 1).bit_length()
    if G > S:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (G - S,))], -1)
    lanes = torch.arange(G, device=v.device)
    m = G // 2
    while m:
        v = v + v[..., lanes ^ m]
        m //= 2
    return v[..., 0]


def _loop(zp, state8, sym, p: Params, scale):
    C = zp.shape[0]
    osf, S, K = p.osf, p.S, p.K
    h = osf // 2
    ML, MH = S * osf, 2 * osf
    dev = zp.device
    zr_, zi_ = zp.real.contiguous(), zp.imag.contiguous()
    sr, si = sym.real.contiguous(), sym.imag.contiguous()
    gamma, aga = _f32(p.gamma), _f32(p.aga)
    opr = _f32(np.float32(1) + np.float32(p.rho))
    oma = _f32(np.float32(1) - np.float32(aga))
    ptr, theta, gain, lf_th, lf_mu, lf_last, ypr, ypi = state8.unbind(0)
    jf = torch.arange(S, dtype=F32, device=dev)
    rows = torch.arange(C, device=dev)[:, None, None]
    offs = (torch.arange(S, device=dev)[:, None] * osf
            + torch.arange(K, device=dev)[None, :])
    zero = torch.zeros((), dtype=F32, device=dev)
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
        taps = cspline_taps(tau, p.nph)
        idx = (p.fs0 + t * S * osf + o)[:, None, None] + offs
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
        th2 = lf_th + lf_mu
        mu2 = lf_mu + gamma * (opr * e_mean - lf_last)
        theta = torch.where(upd, th2, theta)
        lf_th = torch.where(upd, th2, lf_th)
        lf_mu = torch.where(upd, mu2, lf_mu)
        lf_last = torch.where(upd, e_mean, lf_last)
        g_mean = _div(_group_sum(e_g, S), float(S))
        gain = torch.where(upd, oma * gain + aga * g_mean, gain)
        ptr_adv = (ptr + S * osf) - torch.where(inrange, dec, zero)
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
    return (torch.stack(ys, 1).reshape(C, -1),
            torch.stack(ss, 1).reshape(C, -1).to(torch.int32),
            torch.stack(vs, 1).reshape(C, -1), st)


def _mf(h: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    kmf = h.shape[0]
    N = xp.shape[-1] - (kmf - 1)
    xr, xi = xp.real.contiguous(), xp.imag.contiguous()
    zr = h[0] * xr[:, kmf - 1:kmf - 1 + N]
    zi = h[0] * xi[:, kmf - 1:kmf - 1 + N]
    for k in range(1, kmf):
        zr = zr + h[k] * xr[:, kmf - 1 - k:kmf - 1 - k + N]
        zi = zi + h[k] * xi[:, kmf - 1 - k:kmf - 1 - k + N]
    return torch.complex(zr, zi)


def _scales(z, p_ema, lay, p: Params, rms_ref: float, a: int):
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
        s = torch.where(p_ema > 0, _div(_f32(rms_ref), torch.sqrt(
            torch.clamp(p_ema, min=1e-20))), torch.ones_like(p_ema))
        p_ema = torch.where(p_ema > 0, (1 - APW) * p_ema + APW * pw, pw)
        sc.append(s[:, None].expand(-1, tb))
    return torch.cat(sc, 1), p_ema


class Reference:
    """The bank's receivers for one configuration and block length."""

    def __init__(self, cfg: dict, n: int, device, lower: bool = False):
        self.p = params(cfg, n)
        self.lay = layout(self.p.osf, self.p.S, self.p.K, n)
        self.sym = torch.as_tensor(qam16(), dtype=C64, device=device)
        self.rms_ref = float(np.sqrt(np.mean(np.abs(qam16()) ** 2)))
        self.h = torch.as_tensor(matched_taps(cfg["beta"], cfg["osf"]),
                                 dtype=F32, device=device)
        self.lower = lower

    def step(self, x: torch.Tensor, state9: torch.Tensor,
             xtail: torch.Tensor):
        """One block: x (C, n) complex64 with the carried input xtail and
        state rows (9, C): pointer (relative to the block's first sample),
        carrier phase, gain, the loop filter's phase, frequency and last
        error, the last symbol's re and im, the power EMA.  Returns (y,
        sidx, valid, state9', xtail')."""
        if self.lower:
            x = torch.complex(x.real.to(torch.bfloat16).to(F32),
                              x.imag.to(torch.bfloat16).to(F32))
        p, lay = self.p, self.lay
        C, n = x.shape
        kmf = self.h.shape[0]
        pad = lay["rows_total"] - lay["XOFF"] - n
        xp = torch.cat([xtail, x, x.new_zeros((C, pad))], dim=-1)
        z = _mf(self.h, xp)
        a = lay["XOFF"] - (kmf - 1)
        if a < p.T:
            z = torch.cat([z.new_zeros((C, p.T - a)), z], -1)
            a = p.T
        scale, p_ema = _scales(z, state9[8], lay, p, self.rms_ref, a)
        y, sidx, valid, st8 = _loop(z[:, a - p.T:], state9[:8], self.sym, p,
                                    scale)
        st8[0] -= n                   # the pointer, re-based to the next block
        return (y, sidx, valid, torch.cat([st8, p_ema[None]]),
                x[:, n - lay["XOFF"]:].clone())
