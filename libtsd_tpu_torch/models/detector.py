"""Pattern detector (PyTorch), ported from ``libtsd_tpu/models/detector.py``:
streaming normalised cross-correlator with peak extraction -> Detection
records.  Core of frame synchronisation.

Parity: Detecteur / DetecteurImpl, core/src/fourier/detection.cc:26-517,
core/include/tsd/fourier.hpp:546-683.

The correlation is computed densely; peak extraction takes a per-M-segment
maximum, neighbourhood suppression, and a FIXED number of candidate peaks
per block with a validity mask, so shapes never depend on the data and the
host stays out of the loop.

Engines (``DetectorConfig.engine``; the JAX package's names in brackets):
"torch" ("xla", the default: ``OlaFft`` on ``torch.fft`` plus a
``MovingAverage`` energy), "cuda" ("pallas": ``OlaFft`` through kernel #9
plus the same energy), "cuda-fused" ("fused": kernel #10 computes the
correlation, the window energy and the raw score in one pass).  The JAX
names raise a ``ValueError`` naming the port's.

Batching: ``step`` takes x (n,) or (C, n); the state's leaves carry the
same leading axis (the JAX package vmaps over channels instead).  Every
reduction is per channel.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch

from ..block import Block, tree_map
from ..config import complex_dtype, device as _device, real_dtype
from ..ops.filter_rt import Fir, MovingAverage, OlaFft
from ..ops.kernels.detfront import DetFront

__all__ = ["DetectorConfig", "Detection", "Detector", "detect_pattern",
           "detect_with_callback", "ENGINES"]

ENGINES = ("torch", "cuda", "cuda-fused")
_JAX_ENGINES = {"xla": "torch", "pallas": "cuda", "fused": "cuda-fused"}
_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Parity: DetecteurConfig, fourier.hpp:576-640."""
    threshold: float = 0.7       # seuil, in [0, 1]
    max_peaks: int = 4           # per block (static)
    Ne: int = 0                  # OLA input block (0 = auto)
    mode: str = "ola"            # "ola" (FFT) | "rif" (direct FIR)
    engine: str = "torch"        # "torch" | "cuda" (#9) | "cuda-fused" (#10)
    precision: str = "highest"   # the JAX kernels' tiers; see DetFront, OlaFft


@dataclasses.dataclass
class Detection:
    """Parity: Detection, fourier.hpp:546-574.  Tensors of shape
    (..., max_peaks) with a ``valid`` mask; the fields' order is the JAX
    package's (checkpoints flatten it in this order)."""
    position: torch.Tensor       # start of the pattern in the block (int32)
    position_frac: torch.Tensor  # sub-sample refinement (add to position)
    score: torch.Tensor          # normalised correlation in [0, 1]
    gain: torch.Tensor           # estimated channel amplitude
    theta: torch.Tensor          # estimated carrier phase (rad)
    snr_db: torch.Tensor         # SNR estimate from the score
    valid: torch.Tensor          # bool mask

    def replace(self, **kw) -> "Detection":
        return dataclasses.replace(self, **kw)


def empty_detection(P: int, lead: tuple = (), device="cuda") -> Detection:
    """All-invalid detections of shape lead + (P,)."""
    z = torch.zeros(tuple(lead) + (P,), dtype=real_dtype, device=device)
    return Detection(position=torch.zeros_like(z, dtype=torch.int32),
                     position_frac=z, score=z.clone(), gain=z.clone(),
                     theta=z.clone(), snr_db=z.clone(),
                     valid=torch.zeros_like(z, dtype=torch.bool))


class Detector(Block):
    """step(state, x) -> (state, (Detection, score_track)).

    Positions are relative to the current input block x (they may be
    negative: the peak started in the carried tail of the previous block).
    """

    def __init__(self, corr, energy: MovingAverage, pattern_norm: float,
                 M: int, cfg: DetectorConfig):
        super().__init__()
        self.corr = corr
        self.energy = energy
        self.pattern_norm = float(pattern_norm)
        self.M = int(M)
        self.cfg = cfg

    @classmethod
    def create(cls, pattern, cfg: DetectorConfig = DetectorConfig(),
               device="cuda") -> "Detector":
        device = _device(device)
        if cfg.engine not in ENGINES:
            hint = (f" (the JAX package's {cfg.engine!r} is the port's "
                    f"{_JAX_ENGINES[cfg.engine]!r})"
                    if cfg.engine in _JAX_ENGINES else "")
            raise ValueError(f"engine={cfg.engine!r}: the port's detector "
                             f"engines are {ENGINES}{hint}")
        p = np.asarray(pattern, np.complex128)
        M = len(p)
        norm = float(np.linalg.norm(p))
        # correlation as a FIR with taps conj(reversed normalised pattern)
        # (parity: detection.cc:178-188)
        taps = np.conj((p / norm)[::-1])
        if cfg.mode == "rif" and cfg.engine == "cuda-fused":
            raise ValueError(
                "DetectorConfig(mode='rif', engine='cuda-fused') conflicts: "
                "the fused engine IS a direct-form kernel -- use "
                "mode='ola' (default) with engine='cuda-fused'")
        if cfg.engine == "cuda-fused" and cfg.Ne and cfg.Ne % 128:
            raise ValueError(
                f"engine='cuda-fused' needs Ne to be a multiple of 128, got "
                f"{cfg.Ne}")
        if cfg.mode == "rif":
            # direct-form correlation (parity: MODE_RIF, detection.cc:68-96)
            corr = Fir.create(taps, device=device)
        elif cfg.engine == "cuda-fused":
            if cfg.precision not in ("highest", "split", "bf16"):
                from ..utils.log import msg_warn
                msg_warn(
                    f"DetectorConfig(engine='cuda-fused'): precision "
                    f"{cfg.precision!r} is not a tier of the fused kernel "
                    f"-- it runs the 'split' tier whatever the tier")
            corr = DetFront.create(taps, device=device)
        else:
            corr = OlaFft.create(taps, Ne=cfg.Ne if cfg.Ne else None,
                                 engine=cfg.engine, precision=cfg.precision,
                                 device=device)
        return cls(corr=corr, energy=MovingAverage(M, device=device),
                   pattern_norm=norm, M=M, cfg=cfg)

    @property
    def _fused(self) -> bool:
        return isinstance(self.corr, DetFront)

    @property
    def device(self) -> torch.device:
        return self.energy.device

    @property
    def Ne(self) -> int:
        """Streaming block granularity (1 in RIF mode; the fused kernel
        honours a configured Ne, a multiple of 128, and defaults to 1024)."""
        if isinstance(self.corr, OlaFft):
            return self.corr.Ne
        if self._fused:
            return self.cfg.Ne if self.cfg.Ne else 1024
        return 1

    def init(self):
        dev = self.device
        z = lambda *s, dt=real_dtype: torch.zeros(s, dtype=dt, device=dev)
        return dict(
            corr=self.corr.init(),
            # fused engine: the energy comes from the carried complex input
            # tail inside the kernel -- no separate |x|^2 state
            en=z(0 if self._fused else self.M - 1),
            # carried tail of correlation/energy for boundary peaks
            tail_c=z(self.M, dt=complex_dtype),
            tail_e=z(self.M),
            # each block's LAST segment is decided next block, when its
            # right neighbourhood is known
            seg_prev=dict(
                m=torch.full((), -1.0, dtype=real_dtype, device=dev),
                pe=torch.zeros((), dtype=torch.int32, device=dev),
                ok_left=torch.ones((), dtype=torch.bool, device=dev),
                ref5=z(5),      # peak refinement row [c1r, c1i, s0, s1, s2]
            ),
        )

    def init_for(self, x: torch.Tensor):
        """State for x (n,) or (C, n): the leaves of :meth:`init` with x's
        leading axes in front."""
        lead = tuple(x.shape[:-1])
        return tree_map(lambda a: a.expand(lead + tuple(a.shape)).clone(),
                        self.init())

    def step(self, state, x: torch.Tensor):
        if x.ndim == 1:
            st, (det, score) = self.step(
                tree_map(lambda a: a[None], state), x[None])
            return (tree_map(lambda a: a[0], st),
                    (tree_map(lambda a: a[0], det), score[0]))
        M = self.M
        n = x.shape[-1]
        xc = x.to(complex_dtype)
        if self._fused:
            # one kernel pass: correlation planes, window energy, raw score
            cstate, (cr, ci, en, sc) = self.corr.step(state["corr"], xc)
            estate = state["en"]
            tail_c = state["tail_c"]
            tr, ti = tail_c.real, tail_c.imag
            cxr = torch.cat([tr, cr], dim=-1)
            cxi = torch.cat([ti, ci], dim=-1)
            ex = torch.cat([state["tail_e"], en], dim=-1)
            sc_tail = torch.sqrt((tr * tr + ti * ti)
                                 / (state["tail_e"] + 1e-20))
            score = torch.cat([sc_tail, sc], dim=-1)
        else:
            cstate, c = self.corr.step(state["corr"], xc)
            estate, en = self.energy.step(state["en"], xc.abs() ** 2)
            en = en * M            # MovingAverage divides by K: the sum
            cx = torch.cat([state["tail_c"], c.to(complex_dtype)], dim=-1)
            ex = torch.cat([state["tail_e"], en], dim=-1)
            cxr, cxi = cx.real, cx.imag
            score = cx.abs() / torch.sqrt(ex * 1.0 + 1e-20)
        # relative energy floor, per channel: a true detection needs real
        # window energy; +1e-30 catches the all-zero buffer
        en_floor = 1e-6 * ex.mean(dim=-1, keepdim=True) + 1e-30
        score = torch.where(ex < en_floor, torch.zeros_like(score), score)
        score = torch.clamp(score, max=1.0)
        lo = M // 2
        nseg = (n + M - 1) // M
        det, seg_prev = self._extract_peaks(cxr, cxi, score, lo, n, nseg,
                                            state["seg_prev"])
        new_state = dict(corr=cstate, en=estate,
                         tail_c=torch.complex(cxr[..., -M:].contiguous(),
                                              cxi[..., -M:].contiguous()),
                         tail_e=ex[..., -M:], seg_prev=seg_prev)
        # score track at WINDOW-END positions: track[i] belongs to the
        # window ending at block sample i (Detection.position + M - 1)
        return new_state, (det, score[..., M:M + n])

    def _extract_peaks(self, cxr, cxi, score, lo, n, nseg, prev):
        M = self.M
        P = self.cfg.max_peaks
        B = score.shape[0]
        dev = score.device
        region = score[:, lo:lo + n]
        # segment-wise max (erosion, parity: detection.cc:264-270)
        seg = torch.nn.functional.pad(region, (0, nseg * M - n)).reshape(
            B, nseg, M)
        seg_max, arg = seg.max(dim=-1)
        seg_argr = arg + torch.arange(nseg, device=dev) * M
        # per-segment refinement rows [c1r; c1i; s0; s1; s2] (B, 5, nseg)
        exi = seg_argr + lo
        L = score.shape[-1]
        refin = torch.stack([
            torch.gather(cxr, -1, exi), torch.gather(cxi, -1, exi),
            torch.gather(score, -1, (exi - 1).clamp(min=0)),
            torch.gather(score, -1, exi),
            torch.gather(score, -1, (exi + 1).clamp(max=L - 1))], dim=1)
        # window-end BLOCK position of each segment's peak
        pe = (exi - M).to(torch.int32)

        # decided this block: [previous block's deferred last segment |
        # current segments 0..nseg-2], with left/right neighbours taken
        # from one extended row [left sentinel | prev | current]
        m_ext = torch.cat([torch.full((B, 1), -1.0, dtype=real_dtype,
                                      device=dev),
                           prev["m"][:, None], seg_max], dim=-1)
        pe_ext = torch.cat([torch.full((B, 1), -(10 ** 9), dtype=torch.int32,
                                       device=dev),
                            prev["pe"][:, None], pe], dim=-1)
        em, left_m, right_m = m_ext[:, 1:-1], m_ext[:, :-2], m_ext[:, 2:]
        epe, left_pe, right_pe = (pe_ext[:, 1:-1], pe_ext[:, :-2],
                                  pe_ext[:, 2:])
        erefin = torch.cat([prev["ref5"][:, :, None], refin[:, :, :-1]],
                           dim=-1)
        ok = em > self.cfg.threshold
        okl = ~((left_m > em) & (epe - left_pe < M))
        okl = torch.cat([prev["ok_left"][:, None], okl[:, 1:]], dim=-1)
        ok = ok & okl
        ok = ok & ~((right_m >= em) & (right_pe - epe < M))
        masked = torch.where(ok, em, torch.full_like(em, -1.0))
        if nseg < P:
            # pad so short blocks still give (max_peaks,) shapes; epe's
            # zero pad is what the last-segment verdict below reads, as in
            # the JAX package (ROADMAP.md, fault at detector.py:320)
            z = P - nseg
            masked = torch.cat([masked, torch.full((B, z), -1.0,
                                                   device=dev)], dim=-1)
            epe = torch.cat([epe, torch.zeros((B, z), dtype=epe.dtype,
                                              device=dev)], dim=-1)
            erefin = torch.cat([erefin, torch.zeros((B, 5, z),
                                                    dtype=erefin.dtype,
                                                    device=dev)], dim=-1)
        # top-P by score, ties to the lower index (lax.top_k's rule): a
        # stable descending sort, then reorder in TIME (occurrence order);
        # invalid slots last, in index order
        order = torch.sort(masked, dim=-1, descending=True,
                           stable=True).indices[:, :P]
        val = torch.gather(masked, -1, order) > 0
        tkey = torch.where(val, torch.gather(epe, -1, order),
                           torch.full_like(order, _INT32_MAX,
                                           dtype=torch.int32))
        reorder = torch.sort(tkey, dim=-1, stable=True).indices
        order = torch.gather(order, -1, reorder)
        val = torch.gather(val, -1, reorder)
        g5 = torch.gather(erefin, -1, order[:, None, :].expand(B, 5, P))
        c1or, c1oi, s0o, s1o, s2o = g5.unbind(1)

        # sub-sample refinement + gain/theta from the complex correlation
        denom = s0o - 2 * s1o + s2o
        frac = torch.where(denom.abs() > 1e-12,
                           0.5 * (s0o - s2o) / denom,
                           torch.zeros_like(denom))
        frac = torch.clamp(frac, -0.5, 0.5)
        # window = g e^{i theta} pattern  ->  corr = g e^{i theta} ||pattern||
        gain = torch.sqrt(c1or * c1or + c1oi * c1oi) / self.pattern_norm
        theta = torch.atan2(c1oi, c1or)
        s1c = torch.clamp(s1o, 0.0, 0.999999)
        snr = s1c ** 2 / (1 - s1c ** 2)
        snr_db = 10.0 * torch.log10(snr + 1e-12)
        # the peak marks the window END; the pattern START is M - 1 earlier
        pos = torch.gather(epe, -1, order) - (M - 1)
        det = Detection(position=pos.to(torch.int32),
                        position_frac=frac.to(real_dtype),
                        score=s1o.to(real_dtype), gain=gain.to(real_dtype),
                        theta=theta.to(real_dtype),
                        snr_db=snr_db.to(real_dtype), valid=val)
        # defer the last current segment (re-based by -n for the next
        # block); its left verdict is decided now
        ok_left_new = ~((em[:, -1] > seg_max[:, -1])
                        & (pe[:, -1] - epe[:, -1] < M))
        seg_prev_new = dict(m=seg_max[:, -1], pe=pe[:, -1] - n,
                            ok_left=ok_left_new,
                            ref5=refin[:, :, -1].to(real_dtype))
        return det, seg_prev_new


def detect_pattern(x: torch.Tensor, pattern,
                   cfg: DetectorConfig = DetectorConfig()):
    """One-shot detection over a whole buffer (n,) or (C, n), on x's
    device; returns (Detection, score).  Pads 2M trailing zeros: the last
    segment's decision is deferred to a next block that never comes
    otherwise."""
    from ..block import pad_to_multiple
    det = Detector.create(pattern, cfg, device=x.device)
    n = x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, 2 * det.M))
    xp = pad_to_multiple(xp, det.Ne, axis=x.ndim - 1)
    _, (d, score) = det.step(det.init_for(xp), xp)
    return d, score[..., :n]


def detect_with_callback(x: torch.Tensor, pattern, callback,
                         cfg: DetectorConfig = DetectorConfig()):
    """Host-side detection loop calling ``callback(dict)`` once per valid
    detection of a 1-D buffer, in position order (parity: the
    gere_detection callback, detection.cc:357-364 / fourier.hpp:605).
    Returns the raw (Detection, score) as well."""
    det, score = detect_pattern(x, pattern, cfg)
    host = {f.name: getattr(det, f.name).cpu().numpy()
            for f in dataclasses.fields(det)}
    for i in np.argsort(host["position"], kind="stable"):
        if host["valid"][i]:
            callback(dict(position=int(host["position"][i]),
                          position_frac=float(host["position_frac"][i]),
                          score=float(host["score"][i]),
                          gain=float(host["gain"][i]),
                          theta=float(host["theta"][i]),
                          snr_db=float(host["snr_db"][i])))
    return det, score
