"""Sub-block decision-directed demodulator (PyTorch), ported from
``libtsd_tpu/models/demod_sb.py``.

Within a sub-block of S consecutive symbols the read pointer advances by
exactly ``osf`` samples a symbol, so all S symbol centres (and, for even
osf, all S Gardner midpoints) share one fractional phase tau.  Each
sub-block therefore does one window read, S symbols and S midpoints from
one tap vector, decisions and error terms for all S symbols, and ONE
timing / carrier / AGC loop update, with the carrier phase ramped inside
the sub-block from the loop filter's frequency estimate
(theta_j = theta + j mu / S).  The loop filters run at the sub-block rate
(BL_sb = S BL, alpha_sb = 1 - (1 - alpha)^S), so the loop bandwidths per
symbol match the per-symbol architecture.

Parity anchor: the loop equations of the reference's DemodGen2
(core/src/telecom/demod-dec.cc:193-625), with RecHorloge's per-sample
interpolation replaced by the shared-tau sub-block form.

Two paths with the same loop math:

* x (n,): the 1-D reference path, plain PyTorch on any device.
* x (C, n) (or (..., n), flattened): the batched serving path.  Engines:

  - ``"auto"`` / ``"cuda"``: matched filter (``Fir``, tier
    ``mf_precision``) -> block AGC -> kernel #5 (``ops.kernels.demod_sb``);
  - ``"cuda-fused"``: kernel #6, the matched filter (fp32) and a streaming
    power-EMA AGC inside the kernel, from the raw input.

  A CPU tensor runs each kernel's plain version; a CUDA tensor runs the
  kernel or raises.  Any channel count C works.

The fused engine's serving semantics (as in the JAX package): the AGC
pre-scale is a per-channel power EMA updated once per superframe of
``pick_tb(nsb)`` sub-blocks and applied one superframe late (a fresh
stream starts at scale 1, the gain loop absorbs the rest), and block-edge
windows read the true matched filter of the carried input tail.  The JAX
kernel rounds x and the taps to bf16 for its MXU; the port's matched
filter is fp32 in the kernel and in its plain version.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..block import Block
from ..config import complex_dtype, device as _device, real_dtype
from ..ops.filter_rt import Fir
from ..ops.iir_design import lexp_tc_to_coef
from ..ops.kernels import demod_sb as KSB
from ..ops.resample import make_interpolator
from .carrier_rec import LoopFilter2
from .demod_dec import DecDemodConfig
from .waveform import symbol_indices_to_bits

__all__ = ["SBDemodConfig", "DecisionDemodSB", "ENGINES", "pack_state"]

ENGINES = ("auto", "cuda", "cuda-fused")


@dataclasses.dataclass(frozen=True)
class SBDemodConfig(DecDemodConfig):
    """DecDemodConfig plus the sub-block size S (symbols per loop update).

    Pick S well below the loop time constants (tc, 1/BL in symbols); the
    default S = 16 with tc = 32, BL = 0.005 keeps acquisition stable."""
    S: int = 16
    tc: float = 32.0
    BL: float = 0.005
    # matched-filter matmul tier of the "auto"/"cuda" engines (the port's
    # Fir tiers: "highest", "split", "bf16")
    mf_precision: str = "highest"
    # batched engine, one of ENGINES
    engine: str = "auto"
    # round the matched filter's output to bfloat16 before the loop (both
    # the kernel and its plain version): the JAX package's opt-in for
    # serving; decisions may then differ where a symbol sits on a boundary
    frames_bf16: bool = False


class DecisionDemodSB(Block):
    """step(state, x) -> (state, (bits, symbols, valid, bit_valid));
    (len(x) // (osf S)) S symbols a step.

    The batched path's frames are anchored at the nominal pointer grid
    t S osf; the channel's integer offset o = ip - t S osf + ML is applied
    by reading the window at that offset.  Backward margin ML = S osf
    (the carried tail), forward margin MH = 2 osf; a pointer outside
    [0, ML + MH] flags the sub-block invalid and re-anchors to the next
    nominal centre."""

    def __init__(self, itrp, mf, wf, cfg: SBDemodConfig):
        super().__init__()
        if cfg.engine not in ENGINES:
            raise ValueError(
                f"engine={cfg.engine!r}: the port's engines are "
                f"{ENGINES} ('xla' and 'pallas*' are the JAX package's)")
        self.itrp = itrp
        self.mf = mf
        self.wf = wf
        self.cfg = cfg
        self.register_buffer("h_mf", torch.as_tensor(
            wf.shaping.matched_taps(0, cfg.osf), dtype=real_dtype,
            device=wf.device))
        # the constellation's rms, the AGC's target (host float, read once)
        self.rms_ref = float(torch.sqrt((wf.symbols.abs() ** 2).mean()))

    @classmethod
    def create(cls, wf, cfg: SBDemodConfig,
               device="cuda") -> "DecisionDemodSB":
        if cfg.osf % 2:
            raise ValueError("DecisionDemodSB requires even osf (the "
                             "Gardner midpoint must share the symbols' "
                             "fractional phase); use DecisionDemod2")
        device = _device(device)
        mf = Fir.create(wf.shaping.matched_taps(0, cfg.osf),
                        precision=cfg.mf_precision, device=device)
        return cls(make_interpolator(cfg.itrp, device=device), mf,
                   wf.on(device), cfg)

    @property
    def device(self) -> torch.device:
        return self.wf.device

    @property
    def _timing_gain(self) -> float:
        return self.cfg.osf * lexp_tc_to_coef(self.cfg.tc)

    @property
    def _agc_alpha_sb(self) -> float:
        # S per-symbol updates folded into one: 1 - (1 - a)^S
        return 1.0 - (1.0 - lexp_tc_to_coef(self.cfg.agc_tc)) ** self.cfg.S

    @property
    def _lf(self) -> LoopFilter2:
        # loop bandwidth per update; updates run S-fold slower
        return LoopFilter2(self.cfg.BL * self.cfg.S, self.cfg.eta)

    @property
    def T(self) -> int:
        """Carried matched-filter tail: after a not-ready bubble the
        pointer re-enters the next block as low as -(S - 1) osf, and the
        midpoint windows reach K + osf / 2 further back."""
        return self.itrp.K + self.cfg.osf // 2 + self.cfg.S * self.cfg.osf

    def loop_params(self, n: int) -> KSB.LoopParams:
        cfg, lf = self.cfg, self._lf
        return KSB.LoopParams(
            itrp=cfg.itrp, K=self.itrp.K, nph=self.itrp.nphases, osf=cfg.osf,
            S=cfg.S, n=n, tgain=float(self._timing_gain),
            aga=float(self._agc_alpha_sb), gamma=float(lf.gamma),
            rho=float(lf.rho), carrier=bool(cfg.carrier_active),
            clock=bool(cfg.clock_active), agc=bool(cfg.agc_active))

    # --- state ----------------------------------------------------------
    def init(self):
        dev = self.device
        return dict(
            mf=self.mf.init(),
            lf=self._lf.init(dev),
            theta=torch.zeros((), dtype=real_dtype, device=dev),
            gain=torch.ones((), dtype=real_dtype, device=dev),
            ptr=torch.tensor(self.cfg.osf / 2.0, dtype=real_dtype,
                             device=dev),
            yprev_ri=torch.zeros((2,), dtype=real_dtype, device=dev),
            tail=torch.zeros((self.T,), dtype=complex_dtype, device=dev))

    def _loop_state(self, b: tuple) -> dict:
        dev = self.device
        z = torch.zeros(b, dtype=real_dtype, device=dev)
        return dict(
            lf=(z, z.clone(), z.clone()), theta=z.clone(),
            gain=torch.ones(b, dtype=real_dtype, device=dev),
            ptr=torch.full(b, self.cfg.osf / 2.0, dtype=real_dtype,
                           device=dev),
            yprev_ri=torch.zeros(b + (2,), dtype=real_dtype, device=dev))

    def init_for(self, x: torch.Tensor):
        """Batched state for a (..., n) input (the fused layout for the
        ``"cuda-fused"`` engine)."""
        if self.cfg.engine == "cuda-fused":
            return self.init_for_fused(x)
        b = tuple(x.shape[:-1])
        return dict(self._loop_state(b),
                    mf=self.mf.init_for(x.to(complex_dtype)),
                    tail=torch.zeros(b + (self.T,), dtype=complex_dtype,
                                     device=self.device))

    def init_for_fused(self, x: torch.Tensor):
        """State of the fused engine: the carried INPUT tail (the matched
        filter over it reproduces the same z) and the power EMA of the AGC
        pre-scale."""
        b = tuple(x.shape[:-1])
        lay = KSB.fused_layout(self.cfg.osf, self.cfg.S, self.itrp.K,
                               max(x.shape[-1], 1))
        return dict(self._loop_state(b),
                    p_ema=torch.zeros(b, dtype=real_dtype,
                                      device=self.device),
                    xtail=torch.zeros(b + (lay["XOFF"],),
                                      dtype=complex_dtype,
                                      device=self.device))

    # --- step -----------------------------------------------------------
    def step(self, state, x: torch.Tensor):
        if x.ndim > 2:
            # the (..., n) contract: flatten the leading axes, run batched
            b = tuple(x.shape[:-1])
            C = int(np.prod(b))
            nb = len(b)
            flat = lambda a: a.reshape((C,) + a.shape[nb:])      # noqa
            unflat = lambda a: a.reshape(b + a.shape[1:])        # noqa
            sf = _tree_map(flat, state)
            sf, out = self._step_batched(sf, x.reshape(C, x.shape[-1]))
            return _tree_map(unflat, sf), _tree_map(unflat, out)
        if x.ndim == 2:
            return self._step_batched(state, x)
        if self.cfg.engine == "cuda-fused":
            raise ValueError(
                "engine='cuda-fused' is batched-only: pass x as (C, n) "
                "(use engine='auto' or 'cuda' for single-stream input)")
        return self._step_1d(state, x)

    def _outputs(self, sidx, valid):
        k = self.wf.info.k
        return symbol_indices_to_bits(sidx, k), valid.repeat_interleave(
            k, dim=-1)

    def matched_zp(self, state, x: torch.Tensor):
        """The batched path's front: matched filter, block AGC to the
        constellation's rms, [carried tail | z | zero guard].  Returns
        (mf state, zp (C, n + T + K + osf)), kernel #5's input."""
        cfg = self.cfg
        mf_state, z = self.mf.step(state["mf"], x.to(complex_dtype))
        if cfg.agc_active:
            p = (z.abs() ** 2).mean(-1, keepdim=True)
            z = z * (self.rms_ref / torch.sqrt(p + 1e-20))
        guard = z.new_zeros((z.shape[0], self.itrp.K + cfg.osf))
        return mf_state, torch.cat([state["tail"], z, guard], -1)

    def _step_batched(self, state, x: torch.Tensor):
        if self.cfg.engine == "cuda-fused":
            return self._step_batched_fused(state, x)
        n = x.shape[-1]
        mf_state, zp = self.matched_zp(state, x)
        zk = zp
        if self.cfg.frames_bf16:
            zk = torch.complex(zp.real.to(torch.bfloat16).to(real_dtype),
                               zp.imag.to(torch.bfloat16).to(real_dtype))
        y, sidx, valid, st8 = KSB.demod_sb(
            zk, pack_state(state), self.wf.symbols, self.loop_params(n))
        # a copy, so that the state does not keep the whole of zp alive
        new_state = dict(_unpack(st8, n), mf=mf_state,
                         tail=zp[:, n:n + self.T].clone())
        bits, bvalid = self._outputs(sidx, valid)
        return new_state, (bits, y, valid, bvalid)

    def _step_batched_fused(self, state, x: torch.Tensor):
        """Batched path through kernel #6: matched filter, AGC pre-scale
        and demodulation in one kernel."""
        n = x.shape[-1]
        x = x.to(complex_dtype)
        st9 = pack_state(state)
        y, sidx, valid, st9 = KSB.demod_sb_fused(
            x, state["xtail"], st9, self.wf.symbols, self.h_mf,
            self.loop_params(n), self.rms_ref)
        xoff = state["xtail"].shape[-1]
        new_state = dict(_unpack(st9, n), p_ema=st9[8],
                         xtail=x[:, n - xoff:].clone())
        bits, bvalid = self._outputs(sidx, valid)
        return new_state, (bits, y, valid, bvalid)

    def _step_1d(self, state, x: torch.Tensor):
        """The 1-D reference path: a per-step window read from zp, the LUT
        taps of the interpolator."""
        cfg = self.cfg
        osf, S = cfg.osf, cfg.S
        h = osf // 2
        K = self.itrp.K
        lf = self._lf
        symbols = self.wf.symbols
        tgain = self._timing_gain
        aga = self._agc_alpha_sb
        n = x.shape[-1]
        nsb = n // (osf * S)
        T = self.T
        dev = x.device

        mf_state, z = self.mf.step(state["mf"], x.to(complex_dtype))
        if cfg.agc_active:
            z = z * (self.rms_ref / torch.sqrt((z.abs() ** 2).mean()
                                               + 1e-20))
        # [carried tail | block | guard pad]; z[t] sits at index T + t
        zp = torch.cat([state["tail"], z, z.new_zeros(K + osf)])
        j = torch.arange(S, device=dev)[:, None] * osf
        idx_mid = j + torch.arange(K, device=dev)[None, :]      # (S, K)
        idx_sym = idx_mid + h
        jsym = torch.arange(S, dtype=real_dtype, device=dev)
        zero = torch.zeros((), dtype=real_dtype, device=dev)
        st = {k: state[k] for k in ("lf", "theta", "gain", "ptr",
                                    "yprev_ri")}
        ys, ss, vs = [], [], []
        for t in range(nsb):
            p = st["ptr"]
            nom = float(t * S * osf)
            # the sub-block must lie inside the arrived samples (else wait
            # for the next block); a pointer below the carried tail
            # (sustained negative drift) re-anchors to the nominal grid
            inlow = p > -(S * osf) * 1.0
            ready = ((p + (S - 1) * osf) < n) & inlow
            pc = torch.where(ready, p, torch.where(
                inlow, zero, torch.full_like(p, nom + osf / 2.0)))
            ip = torch.floor(pc).to(torch.int64)
            tau = pc - ip.to(real_dtype)
            # the window start T + ip + 1 - K - h, clamped like
            # lax.dynamic_slice
            W = (S - 1) * osf + K + h
            start = torch.clamp(T + ip + 1 - K - h, 0, zp.shape[0] - W)
            taps = self.itrp.taps(tau).to(real_dtype)
            y_raw = (zp[start + idx_sym] * taps).sum(-1)          # (S,)
            ymid_raw = (zp[start + idx_mid] * taps).sum(-1)
            rot = torch.exp(-1j * (st["theta"] + jsym * (st["lf"][1] / S)))
            y = y_raw * rot * st["gain"]
            ymid = ymid_raw * rot * st["gain"]
            s_idx = torch.argmin((y[:, None] - symbols[None, :]).abs() ** 2,
                                 dim=-1).to(torch.int32)
            ye = symbols[s_idx.long()]
            yprev = torch.complex(st["yprev_ri"][0], st["yprev_ri"][1])
            yprev_v = torch.cat([yprev[None], y[:-1]])
            e_t = ((y - yprev_v) * ymid.conj()).real
            dec = torch.clamp(tgain * e_t.sum(), -osf / 2.0, osf / 2.0)
            e_ph = torch.where(y.abs() > 0, torch.angle(y * ye.conj()),
                               zero)
            lf_state, theta = lf.step(st["lf"], e_ph.mean())
            if not cfg.carrier_active:
                lf_state, theta = st["lf"], st["theta"]
            gain = st["gain"]
            if cfg.agc_active:
                eg = y.abs() / torch.clamp(ye.abs(), min=1e-9)
                gain = (1 - aga) * gain + aga * (
                    1.0 / torch.clamp(eg, min=1e-9)).mean()
            adv = p + S * osf - (dec if cfg.clock_active else 0.0)
            st = dict(
                lf=tuple(torch.where(ready, a, b)
                         for a, b in zip(lf_state, st["lf"])),
                theta=torch.where(ready, theta, st["theta"]),
                gain=torch.where(ready, gain, st["gain"]),
                # waiting: hold; fell behind: continue from the re-anchored
                # nominal pointer
                ptr=torch.where(ready, adv,
                                torch.where(inlow, p, pc + S * osf)),
                yprev_ri=torch.where(
                    ready, torch.stack([y[-1].real, y[-1].imag]),
                    st["yprev_ri"]))
            ys.append(torch.where(ready, y, torch.zeros_like(y)))
            ss.append(torch.where(ready, s_idx, torch.zeros_like(s_idx)))
            vs.append(ready.expand(S))
        if nsb:
            syms, sidx, valid = torch.cat(ys), torch.cat(ss), torch.cat(vs)
        else:
            syms = z.new_zeros(0)
            sidx = torch.zeros(0, dtype=torch.int32, device=dev)
            valid = torch.zeros(0, dtype=torch.bool, device=dev)
        new_state = dict(st, mf=mf_state, ptr=st["ptr"] - n,
                         tail=zp[n:n + T])
        bits, bvalid = self._outputs(sidx, valid)
        return new_state, (bits, syms, valid, bvalid)


def pack_state(state) -> torch.Tensor:
    """A batched state's loop part as the kernels' rows: (8, C), or
    (9, C) with the power EMA for the fused layout."""
    lf0, lf1, lf2 = state["lf"]
    rows = [state["ptr"], state["theta"], state["gain"], lf0, lf1, lf2,
            state["yprev_ri"][..., 0], state["yprev_ri"][..., 1]]
    if "p_ema" in state:
        rows.append(state["p_ema"])
    return torch.stack(rows).to(real_dtype)


def _unpack(st: torch.Tensor, n: int) -> dict:
    """(8 or 9, C) rows back to the state dict; the pointer is re-based
    to the next block."""
    return dict(lf=(st[3], st[4], st[5]), theta=st[1], gain=st[2],
                ptr=st[0] - n, yprev_ri=torch.stack([st[6], st[7]], -1))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)
