"""Frame transmitter and receiver (PyTorch), ported from
``libtsd_tpu/models/frame.py``.

Parity: Émetteur (core/src/telecom/emetteur.cc:14-125) and Récepteur
(core/src/telecom/recepteur.cc:31-785), the reference's flagship composite
(SURVEY §3.4).

The receiver computes the header correlation densely (``Detector``), then
extracts a FIXED-length frame at each detected position by an index gather
with a validity mask, so no shape depends on the data.  Header-derived RF
parameters (gain, phase, fractional delay) correct the frame before the
matched filter; symbol timing comes from the header position; a decision
PLL tracks the residual phase.

Batching: ``Receiver.step`` takes x (n,) or (C, n), with the state's
leaves batched alike (the JAX package vmaps the step over channels
instead), and extracts all 2 max_peaks slots of every channel as one
(C, 2 max_peaks) batch: one gather, per-slot interpolator taps, one
matched-filter call and one batched PLL.  There is no host sync inside a
step; ``StreamReceiver`` copies each block's frames to the host once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..block import Block, pad_to_multiple, tree_flatten, tree_map
from ..config import complex_dtype, device as _device, real_dtype
from ..ops.filter_rt import Fir
from ..ops.resample import Interpolator, make_interpolator
from ..ops.signal import cycles
from ..utils.monitor import Monitors, block_until_ready
from .carrier_rec import Cpll, CpllConfig
from .detector import Detection, Detector, DetectorConfig, empty_detection
from .modulator import ModConfig, Modulator
from .waveform import Waveform, symbol_indices_to_bits

__all__ = ["FrameFormat", "Transmitter", "Receiver", "FrameRx",
           "MonitoredReceiver", "StreamReceiver"]


@dataclasses.dataclass(frozen=True)
class FrameFormat:
    """Parity: TrameFormat, telecom.hpp:1205-1218.

    ``header_wf``: optional distinct waveform for the sync header (parity:
    fo_entete, telecom.hpp:1214), sharing the payload waveform's pulse
    shape (the emitter shapes both through one filter, emetteur.cc:80-95).
    Rotating payload waveforms (pi/4-QPSK) cannot take a distinct
    header."""
    modulation: ModConfig = None
    header_bits: tuple = ()        # sync word (entête)
    payload_bits: int = 256        # payload bits per frame
    header_wf: object = None       # fo_entete (None = payload waveform)


def _static(fmt: FrameFormat) -> FrameFormat:
    """The format without its waveforms (blocks keep those as modules)."""
    return dataclasses.replace(
        fmt, header_wf=None,
        modulation=dataclasses.replace(fmt.modulation, wf=None))


class Transmitter(Block):
    """header + payload -> modulated frame samples (parity: Émetteur,
    emetteur.cc:14-125; distinct header waveform per emetteur.cc:80-95)."""

    def __init__(self, mod: Modulator, hdr_wf: Optional[Waveform],
                 fmt: FrameFormat):
        super().__init__()
        self.mod = mod
        self.hdr_wf = hdr_wf
        self.fmt = fmt
        self.register_buffer("hdr", torch.as_tensor(
            np.asarray(fmt.header_bits, np.int8),
            device=mod.wf.device).reshape(-1))

    @classmethod
    def create(cls, fmt: FrameFormat, device="cuda") -> "Transmitter":
        device = _device(device)
        hdr_wf = fmt.header_wf
        if hdr_wf is not None:
            if fmt.modulation.wf.rotating:
                raise ValueError("distinct header waveform + rotating "
                                 "payload waveform is unsupported")
            if len(fmt.header_bits) % hdr_wf.info.k:
                raise ValueError("header bit count must be a multiple of "
                                 "the header waveform's bits/symbol")
            hdr_wf = hdr_wf.on(device)
        return cls(Modulator.create(fmt.modulation, device=device), hdr_wf,
                   _static(fmt))

    def init(self):
        return self.mod.init()

    @property
    def delay(self):
        return self.mod.delay

    def _symbols(self, payload_bits: torch.Tensor) -> torch.Tensor:
        """Header + payload symbols, last axis (leading axes = frames)."""
        lead = tuple(payload_bits.shape[:-1])
        hdr = self.hdr.expand(lead + (self.hdr.shape[0],))
        bits = payload_bits.to(torch.int8)
        if self.hdr_wf is None:
            return self.mod.wf.make_symbols(torch.cat([hdr, bits], dim=-1))
        # fo_entete: header symbols from the header waveform, payload
        # symbols from the payload waveform, one shared shaping filter
        return torch.cat([self.hdr_wf.make_symbols(hdr),
                          self.mod.wf.make_symbols(bits)], dim=-1)

    def step(self, state, payload_bits: torch.Tensor):
        if self.hdr_wf is None:
            hdr = self.hdr.expand(tuple(payload_bits.shape[:-1])
                                  + (self.hdr.shape[0],))
            return self.mod.step(state, torch.cat(
                [hdr, payload_bits.to(torch.int8)], dim=-1))
        return self.mod.step_symbols(state, self._symbols(payload_bits))

    def transmit(self, payload_bits: torch.Tensor) -> torch.Tensor:
        """One-shot: frame samples including the modulator flush.
        ``payload_bits`` (nbits,) or (F, nbits): F frames at once."""
        syms = self._symbols(payload_bits)
        st = self.mod.init_for(syms)
        st, y1 = self.mod.step_symbols(st, syms)
        _, y2 = self.mod.flush(st)
        return torch.cat([y1, y2], dim=-1)


@dataclasses.dataclass
class FrameRx:
    """Received frames (parity: RécepteurTrame, telecom.hpp:1256-1272);
    every field has the slots' leading axes."""
    bits: torch.Tensor        # decoded payload bits (int8)
    symbols: torch.Tensor     # payload symbols after correction
    detection: Detection      # the header detections
    EbN0_db: torch.Tensor
    valid: torch.Tensor


class Receiver(Block):
    """Streaming frame receiver (parity: Récepteur/RécepteurImpl,
    recepteur.cc:31-785).

    step(state, x) processes one block and returns ``2 max_peaks`` frame
    slots per channel with validity flags: last block's deferred
    detections, then this block's complete ones.  A frame whose payload
    extends past the block edge is carried and extracted next block
    against the ``hist_len`` history.  Each block must be at least
    ``frame_len + 2 itp.K`` samples."""

    def __init__(self, det: Detector, mf: Fir, pll: Cpll, wf: Waveform,
                 hdr_wf: Optional[Waveform], itp: Interpolator,
                 fmt: FrameFormat, nsym_header: int, nsym_payload: int,
                 frame_len: int, hist_len: int, mod_delay: float,
                 dt_mod: float, pll_stride: int = 1):
        super().__init__()
        self.det, self.mf, self.pll, self.wf = det, mf, pll, wf
        self.hdr_wf = hdr_wf
        self.itp = itp
        self.fmt = fmt
        self.nsym_header = int(nsym_header)
        self.nsym_payload = int(nsym_payload)
        self.frame_len = int(frame_len)
        self.hist_len = int(hist_len)
        self.mod_delay = float(mod_delay)
        self.dt_mod = float(dt_mod)           # δt_modulateur
        # residual-phase PLL update stride (1 = per-symbol loop; G > 1 =
        # one update per G symbols, Cpll.step_grouped)
        self.pll_stride = int(pll_stride)
        hw = wf if hdr_wf is None else hdr_wf
        self.register_buffer("ref_h", hw.make_symbols(torch.as_tensor(
            np.asarray(fmt.header_bits, np.int8), device=wf.device
        ).reshape(-1)).to(complex_dtype))

    @classmethod
    def create(cls, fmt: FrameFormat,
               det_cfg: DetectorConfig = DetectorConfig(),
               pll_stride: int = 1, device="cuda") -> "Receiver":
        device = _device(device)
        wf = fmt.modulation.wf.on(device)
        if fmt.header_wf is not None and wf.rotating:
            raise ValueError("distinct header waveform + rotating "
                             "payload waveform is unsupported")
        hdr_wf = fmt.header_wf.on(device) if fmt.header_wf is not None \
            else None
        hw = wf if hdr_wf is None else hdr_wf
        osf = fmt.modulation.osf
        k, k_hdr = wf.info.k, hw.info.k
        if len(fmt.header_bits) % k_hdr or fmt.payload_bits % k:
            raise ValueError(
                f"header ({len(fmt.header_bits)}) bits must be a multiple "
                f"of the header waveform's k={k_hdr} and payload "
                f"({fmt.payload_bits}) of the payload waveform's k={k} "
                f"bits/symbol -- a partial symbol would shift every "
                f"following symbol (pad the sync word: e.g. 66 header bits "
                f"for 8-PSK)")
        # header reference waveform at BASEBAND (an IF signal is mixed
        # down first, recepteur.cc:236-238): header symbols from the
        # header waveform through the payload modulator's shaping filter
        mod = Modulator.create(dataclasses.replace(fmt.modulation, fi=0.0,
                                                   wf=wf), device=device)
        hdr_bits = torch.as_tensor(np.asarray(fmt.header_bits, np.int8),
                                   device=device).reshape(-1)
        st, y1 = mod.step_symbols(mod.init(), hw.make_symbols(hdr_bits))
        _, y2 = mod.flush(st)
        hdr_wave = torch.cat([y1, y2]).cpu().numpy()
        nsym_header = len(fmt.header_bits) // k_hdr
        nsym_payload = fmt.payload_bits // k
        d = int(round(mod.delay))
        # non-integer modulator latency: the pattern starts dt_mod samples
        # after the first symbol centre (recepteur.cc:95,249)
        dt_mod = d - mod.delay
        hdr_ref = hdr_wave[d:d + nsym_header * osf]
        mf = wf.shaping.matched_filter(fmt.modulation.ncoefs, osf,
                                       device=device)
        frame_len = ((nsym_header + nsym_payload) * osf
                     + 2 * int(mf.delay) + osf)
        det = Detector.create(hdr_ref, det_cfg, device=device)
        pll = Cpll(CpllConfig(ped="dec", M=wf.info.M, order=2, BL=0.02),
                   wf=wf)
        # fractional-delay interpolator bank (itrp_sinc + regle_delais,
        # recepteur.cc:131-160; fcut 0.45 per recepteur.cc:293)
        itp = make_interpolator("sinc", device=device, ncoefs=15,
                                nphases=256, fcut=0.45 if osf > 1 else 0.5)
        # history: a deferred detection is re-extracted next block up to
        # frame_len + 2K + int(mf.delay) samples back, plus the detector's
        # own M-sample lag
        hist_len = frame_len + det.M + 3 * itp.K + int(mf.delay)
        return cls(det=det, mf=mf, pll=pll, wf=wf, hdr_wf=hdr_wf, itp=itp,
                   fmt=_static(fmt), nsym_header=nsym_header,
                   nsym_payload=nsym_payload, frame_len=frame_len,
                   hist_len=hist_len, mod_delay=mod.delay, dt_mod=dt_mod,
                   pll_stride=pll_stride)

    @property
    def device(self) -> torch.device:
        return self.det.device

    def init(self):
        return dict(
            det=self.det.init(),
            # carried raw samples, so that frames across block edges survive
            hist=torch.zeros((self.hist_len,), dtype=complex_dtype,
                             device=self.device),
            # IF mixer NCO phase in cycles, wrapped to [0, 1) every block
            phi0=torch.zeros((), dtype=real_dtype, device=self.device),
            # detections whose payload had not arrived at the block edge
            pending=empty_detection(self.det.cfg.max_peaks,
                                    device=self.device),
        )

    def init_for(self, x: torch.Tensor):
        """State for x (n,) or (C, n)."""
        lead = tuple(x.shape[:-1])
        return tree_map(lambda a: a.expand(lead + tuple(a.shape)).clone(),
                        self.init())

    def _front(self, state, x: torch.Tensor):
        """Stage 1 ("recepteur/ola"): IF mixdown, header detection and
        block-edge deferral, on x (C, n).  Returns (new_state, dets, buf,
        score): buf = [hist | x] at baseband, dets = [last block's
        deferred detections | this block's complete ones]."""
        n = x.shape[-1]
        x = x.to(complex_dtype)
        fi = self.fmt.modulation.fi
        if fi != 0.0:
            # phase-continuous NCO: phase = phi0 + f m cycles, phi0 wrapped
            # every block, the per-block increment reduced mod 1 in host
            # float64
            f = fi / self.fmt.modulation.fe
            ph = state["phi0"][..., None] + cycles(f, n, device=x.device)
            x = x * torch.exp(-2j * np.pi * ph).to(complex_dtype)
            phi0 = torch.remainder(state["phi0"] + np.float32((f * n) % 1.0),
                                   1.0)
        else:
            phi0 = state["phi0"]
        dstate, (dets, score) = self.det.step(state["det"], x)
        buf = torch.cat([state["hist"], x], dim=-1)
        # complete when the whole frame (+ interpolator support) is in buf
        safe = dets.valid & (dets.position
                             <= n - self.frame_len - 2 * self.itp.K)
        cur = dets.replace(valid=safe)
        pend = dets.replace(position=dets.position - n,
                            valid=dets.valid & ~safe)
        alldets = tree_map(lambda a, b: torch.cat([a, b], dim=-1),
                           state["pending"], cur)
        new_state = dict(det=dstate, hist=buf[..., -self.hist_len:],
                         phi0=phi0, pending=pend)
        return new_state, alldets, buf, score

    def _extract_all(self, buf: torch.Tensor, dets: Detection,
                     debug: bool = False):
        """Stage 2 ("recepteur/demod"): every slot's frame extraction,
        fractional-delay correction, matched filter and decisions, as one
        batch over buf (C, Lb) and dets (C, S).  ``debug=True`` also
        returns every stage's signal per slot (recepteur.cc:589-618,
        726-757)."""
        osf = self.fmt.modulation.osf
        k = self.wf.info.k
        H, K, L = self.hist_len, self.itp.K, self.frame_len
        B, S = dets.position.shape
        # matched-filter delay = integer e + fraction r (r rides the
        # fractional interpolator)
        e = int(np.floor(self.mf.delay))
        r = float(self.mf.delay) - e
        eff = dets.position_frac - self.dt_mod + r
        fshift = torch.floor(eff)
        tau = eff - fshift                                   # [0, 1)
        # slot starts in buf: K // 2 early for the interpolator's left
        # support, e early for the matched filter's warm-up
        start = (dets.position + H + fshift.to(torch.int32) - K // 2 - e)
        start = start.clamp(0, buf.shape[-1] - (L + K)).to(torch.int64)
        idx = start[..., None] + torch.arange(L + K, device=buf.device)
        raw = torch.gather(buf, -1, idx.reshape(B, S * (L + K))
                           ).reshape(B, S, L + K)
        # RF corrections from the header detection
        fr = (raw * torch.exp(-1j * dets.theta).to(complex_dtype)[..., None]
              / dets.gain.clamp(min=1e-6)[..., None])
        # fractional delay: y[i] = sum_k fr[i + k] taps[k], per-slot taps
        taps = self.itp.taps(tau).to(real_dtype)             # (B, S, K)
        y = None
        for j in range(K):
            t = fr[..., j:j + L] * taps[..., j:j + 1]
            y = t if y is None else y + t
        if self.wf.info.is_fsk:
            # FSK decodes the instantaneous frequency, scaled so that the
            # constellation levels come out directly
            from .demod import quadrature_discriminator
            om_max = np.pi * self.wf.info.index / osf
            y = (quadrature_discriminator(y) / om_max).to(complex_dtype)
        # matched filter (warm: y starts e samples before the pattern)
        _, z = self.mf.step(self.mf.init_for(y), y)
        nsym = self.nsym_header + self.nsym_payload
        sym_idx = 2 * e + osf * torch.arange(nsym, device=buf.device)
        syms = z[..., sym_idx]
        if self.wf.info.is_fsk:
            syms_c = syms      # a real frequency track: no phase to track
        elif self.hdr_wf is None:
            if self.pll_stride > 1:
                _, syms_c = self.pll.step_grouped(self.pll.init(), syms,
                                                  self.pll_stride)
            else:
                _, syms_c = self.pll.step(self.pll.init(), syms)
        else:
            # fo_entete: track the known header data-aided, then
            # decision-directed on the payload
            refs = torch.cat([self.ref_h, torch.zeros(
                (self.nsym_payload,), dtype=complex_dtype,
                device=buf.device)])
            aided = torch.arange(nsym, device=buf.device) < self.nsym_header
            _, syms_c = self.pll.step_aided(self.pll.init(), syms, refs,
                                            aided, G=self.pll_stride)
        pay = syms_c[..., self.nsym_header:]
        sidx = self.wf.closest(pay)
        bits = symbol_indices_to_bits(sidx, k)
        if self.wf.rotating:
            # EVM reference on the union constellation (closest()
            # de-rotates internally)
            cpts = self.wf.constellation()
            du = (pay[..., None] - cpts).abs() ** 2
            ref_p = cpts[torch.argmin(du, dim=-1)]
        else:
            ref_p = self.wf.symbols[sidx.long()]
        # Eb/N0 from the full-frame error vector (known header symbols and
        # decision-directed payload); bits per symbol averaged over the
        # frame when the header rides another waveform
        ref = torch.cat([self.ref_h.expand(B, S, -1), ref_p], dim=-1)
        evm2 = ((syms_c - ref).abs() ** 2).mean(-1)
        sig = (ref.abs() ** 2).mean(-1)
        esn0 = sig / evm2.clamp(min=1e-12)
        hw = self.wf if self.hdr_wf is None else self.hdr_wf
        k_eff = (self.nsym_header * hw.info.k + self.nsym_payload * k) / nsym
        ebn0_db = 10 * torch.log10(esn0 / k_eff + 1e-12)
        frames = FrameRx(bits=bits, symbols=pay, detection=dets,
                         EbN0_db=ebn0_db, valid=dets.valid)
        if not debug:
            return frames
        dbg = dict(x=raw, x1=fr, y=y, z=z, syms=syms, syms_c=syms_c,
                   pll_phase=torch.angle(syms * syms_c.conj() + 1e-30),
                   err=syms_c - ref)
        return frames, dbg

    def _batched(self, fn, state, x):
        """Run fn(state, x) on (C, n); a 1-D x runs as one channel."""
        if x.ndim == 2:
            return fn(state, x)
        out = fn(tree_map(lambda a: a[None], state), x[None])
        return tree_map(lambda a: a[0], out)

    def step(self, state, x: torch.Tensor):
        def run(st, xb):
            new_state, dets, buf, _ = self._front(st, xb)
            return new_state, self._extract_all(buf, dets)
        return self._batched(run, state, x)

    # the JAX package's jit-cached step; PyTorch runs eagerly
    step_jit = step

    def step_debug(self, state, x: torch.Tensor):
        """``step`` plus every stage's signal for the first valid slot of
        each channel (parity: the reference's debug_actif observability,
        recepteur.cc:144-150, 589-618, 726-757).  Returns (state, frames,
        debug); ``debug["has_detection"]`` is False where a channel had no
        valid slot (its captures are then meaningless)."""
        def run(st, xb):
            new_state, dets, buf, score = self._front(st, xb)
            frames, dbg = self._extract_all(buf, dets, debug=True)
            i = torch.argmax(dets.valid.to(torch.int8), dim=-1)
            rows = torch.arange(i.shape[0], device=i.device)
            dbg1 = {kk: v[rows, i] for kk, v in dbg.items()}
            dbg1["corr_score"] = score
            dbg1["has_detection"] = dets.valid[rows, i]
            return new_state, frames, dbg1
        return self._batched(run, state, x)

    def receive(self, x: torch.Tensor) -> FrameRx:
        """One-shot receive over a buffer (n,) or (C, n): zero-padded far
        enough past the end that every detection completes in one step."""
        extra = max(self.frame_len, 2 * self.det.M) + 2 * self.itp.K
        xp = torch.nn.functional.pad(x.to(complex_dtype), (0, extra))
        xp = pad_to_multiple(xp, self.det.Ne, axis=xp.ndim - 1)
        _, frames = self.step(self.init_for(xp), xp)
        return frames


def _pull_tree(tree):
    """A tree of device tensors as host numpy arrays through ONE
    device -> host copy: every leaf packed into one float32 vector
    (complex as re/im pairs; int8 bits, int32 positions below 2^24 and
    bools are exact in float32), then unpacked with its shape and dtype."""
    leaves, unflatten = tree_flatten(tree)
    parts = [(torch.view_as_real(l) if l.is_complex() else l)
             .to(torch.float32).reshape(-1) for l in leaves]
    flat = torch.cat(parts).cpu().numpy()
    host, off = [], 0
    for l, p in zip(leaves, parts):
        a = flat[off:off + p.numel()]
        off += p.numel()
        if l.is_complex():
            a = a.reshape(tuple(l.shape) + (2,))
            host.append((a[..., 0] + 1j * a[..., 1]).astype(np.complex64))
        else:
            host.append(a.reshape(tuple(l.shape)).astype(
                torch.empty((), dtype=l.dtype).numpy().dtype))
    return unflatten(host)


class StreamReceiver:
    """Any-push-size streaming front around :class:`Receiver` (parity: the
    reference receiver's re-blocking, recepteur.cc:404-650 via
    tampon_création, tsd.cc:303-386).

    A host ring buffer re-blocks pushes of any size to ``block_len`` (a
    multiple of the detector's granularity ``det.Ne``), each full block
    runs through ``Receiver.step`` on the receiver's device, and each
    block's frames come back to the host in one copy.  Frames go to the
    callback (host trees, one per valid slot) or to ``frames``; ``flush``
    zero-pads the residue so that trailing detections are emitted."""

    def __init__(self, rx: Receiver, block_len: int = 0, callback=None,
                 monitor: bool = False):
        from ..io.streamio import Rebuffer
        ne = rx.det.Ne
        if block_len <= 0:
            block_len = max(4096, rx.frame_len + 2 * rx.itp.K + ne)
        block_len = max(block_len, rx.frame_len + 2 * rx.itp.K)
        block_len = -(-block_len // ne) * ne
        self.rx = rx
        self.block_len = block_len
        self.callback = callback
        self.state = rx.init()
        self.frames = []
        self.nframes = 0
        # monitor=True steps through a MonitoredReceiver: front end and
        # extraction as separate, synchronised stages with wall-clock
        # scopes (parity: RécepteurImpl moniteurs(), recepteur.cc:83-110)
        self._monitored = MonitoredReceiver(rx) if monitor else None
        self._rb = Rebuffer(block_len, self._on_block, complex_iq=True)

    def moniteurs(self):
        """Per-stage monitor stats (needs monitor=True)."""
        if self._monitored is None:
            return {}
        return self._monitored.moniteurs()

    def _on_block(self, blk: np.ndarray):
        xd = torch.from_numpy(np.ascontiguousarray(blk, np.complex64)).to(
            self.rx.device)
        if self._monitored is not None:
            self.state, frames = self._monitored.step(self.state, xd)
        else:
            self.state, frames = self.rx.step(self.state, xd)
        host = _pull_tree(frames)
        for i in np.nonzero(host.valid)[0]:
            fr = tree_map(lambda a, i=i: a[i], host)
            self.nframes += 1
            if self.callback is not None:
                self.callback(fr)
            else:
                self.frames.append(fr)

    def push(self, x):
        """Accept any number of samples; runs zero or more block steps."""
        self._rb.push(np.asarray(x))

    def flush(self):
        """Zero-pad so that any frame still in the residue (or deferred at
        a block edge) is extracted."""
        pad = self.block_len + self.rx.frame_len + 2 * self.rx.itp.K
        self._rb.push(np.zeros(pad, np.complex64))

    # ------------------------------------------------- checkpoint/resume
    def checkpoint(self, path: str) -> None:
        """Write the whole mid-stream serving state to ``path`` (.npz, the
        shared protocol of ``utils.checkpoint.save_stream_state``): the
        receiver state, the host ring residue and the frame counter.
        :meth:`restore` continues bit-identically."""
        from ..utils.checkpoint import save_stream_state
        save_stream_state(path, self.state, self._rb.snapshot(),
                          {"nframes": self.nframes})

    def restore(self, path: str) -> None:
        """Load a :meth:`checkpoint` (of this package or of the JAX
        package's StreamReceiver) into this StreamReceiver (same receiver
        configuration and block_len), validated against the receiver's
        state structure and leaf shapes; the ring residue is re-queued."""
        from ..io.streamio import Rebuffer
        from ..utils.checkpoint import load_stream_state
        state, residue, ctr = load_stream_state(path, self.state)
        self.state = state
        self._rb = Rebuffer(self.block_len, self._on_block, complex_iq=True)
        if len(residue):
            self._rb.push(residue)
        self.nframes = ctr["nframes"]
        self.frames = []


class MonitoredReceiver:
    """Host-side stepper with per-stage monitors (parity:
    RécepteurImpl::moniteurs(), recepteur.cc:83-110, telecom.hpp:1291):
    scopes "recepteur/ola" (detection front end), "recepteur/demod"
    (extraction and decisions), "recepteur/misc".  Each stage ends with a
    device synchronisation so that the wall-clock split is honest."""

    def __init__(self, rx: Receiver):
        self.rx = rx
        self.monitors = Monitors()

    def init(self):
        return self.rx.init()

    def step(self, state, x: torch.Tensor):
        rx = self.rx
        n = int(x.shape[-1])
        m = self.monitors["recepteur/ola"]
        m.start()
        squeeze = x.ndim == 1
        if squeeze:
            state, x = tree_map(lambda a: a[None], state), x[None]
        new_state, dets, buf, _ = rx._front(state, x)
        block_until_ready(dets)
        m.stop(samples=n)
        m = self.monitors["recepteur/demod"]
        m.start()
        frames = block_until_ready(rx._extract_all(buf, dets))
        m.stop(samples=n)
        if squeeze:
            new_state, frames = tree_map(lambda a: a[0], (new_state, frames))
        return new_state, frames

    def receive(self, x: torch.Tensor) -> FrameRx:
        m = self.monitors["recepteur/misc"]
        m.start()
        extra = max(self.rx.frame_len, 2 * self.rx.det.M) + 2 * self.rx.itp.K
        xp = torch.nn.functional.pad(x.to(complex_dtype), (0, extra))
        xp = pad_to_multiple(xp, self.rx.det.Ne, axis=xp.ndim - 1)
        state = self.rx.init_for(xp)
        m.stop(samples=0)
        _, frames = self.step(state, xp)
        return frames

    def moniteurs(self):
        """Per-stage stats (parity: MoniteursStats, telecom.hpp:1291)."""
        return self.monitors.stats()
