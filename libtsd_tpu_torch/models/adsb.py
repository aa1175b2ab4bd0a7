"""ADS-B (Mode S 1090ES) demodulator / decoder (PyTorch), ported from
``libtsd_tpu/models/adsb.py``.

Parity: the reference DECLARES this component but never implements it
(`demodulateur_adsb()` and the `ADSBDecodeurConfig{fe, Ne}` /
`ADSBTrame{bs, score, texte}` structs exist only as a header,
core/include/tsd/telecom/protocols.hpp:12-48).  This module is the JAX
package's working superset of the declared API:

* the preamble search is dense: half-slot sliding sums give the 4-pulse
  correlation and the 8-us window energy at every sample offset;
* peak extraction emits a FIXED ``max_frames`` candidates per block with a
  validity mask, by a stable descending sort (``jax.lax.top_k``'s order:
  the lower position first among equal scores);
* the 112 PPM bits of every candidate are gathered at once and decided by
  comparing half-bit energies;
* the Mode S CRC-24 (polynomial 0x1FFF409) is a GF(2) matrix product,
  syndrome = bits @ H^T mod 2, as a float32 matmul with TF32 off (exact:
  at most 112 terms of 0/1; ``torch.matmul`` has no int32 CUDA form);
* text decoding (callsign / altitude / CPR position) is host-side string
  work on the validated bits.

``AdsbDecoder._decode_block`` takes any leading batch shape ``(..., n)``:
C receivers decode in one call (the torch form of
``jax.vmap(dec._decode_block)``).  ``decode`` and ``AdsbStream`` keep the
JAX package's host logic, with one device-to-host copy per block.  The
sliding sums come from a float64 cumulative sum on the device (the JAX
package sums in float32), so a window sum is exact to float32 rounding at
any block length.

Signal model (1090 MHz Extended Squitter): pulse-position modulation at
1 Mbit/s; preamble pulses at 0, 1.0, 3.5, 4.5 us; each data bit occupies
1 us split into two 0.5 us half-slots; energy in the FIRST half means
'1', in the second '0'.  fe must be an even integer multiple of 1 MHz
(>= 2 MS/s; 2 MS/s is the classic RTL-SDR rate).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import device as _device, real_dtype
from ..ops.filter_rt import _fp32_matmul
from ..ops.signal import top_k_stable

__all__ = ["AdsbConfig", "AdsbFrame", "AdsbDecoder", "AdsbStream", "adsb_crc",
           "adsb_waveform", "cpr_global", "decode_adsb_text"]

_GEN = 0x1FFF409            # Mode S CRC-24 generator (25 bits)
_PREAMBLE_HALFSLOTS = (0, 2, 7, 9)   # pulse positions in 0.5-us units
_PREAMBLE_US = 8
_FRAME_BITS = 112


# ----------------------------------------------------------------------
# CRC-24 as GF(2) linear algebra
# ----------------------------------------------------------------------

def _crc_bits_np(bits: np.ndarray) -> np.ndarray:
    """Bitwise long-division CRC-24 of a bit vector (MSB first)."""
    r = 0
    for b in bits:
        r = ((r << 1) | int(b)) & 0x1FFFFFF
        if r & 0x1000000:
            r ^= _GEN
    # flush 24 zero bits
    for _ in range(24):
        r = (r << 1) & 0x1FFFFFF
        if r & 0x1000000:
            r ^= _GEN
    return np.array([(r >> (23 - i)) & 1 for i in range(24)], np.int8)


def _crc_matrix(nbits: int) -> np.ndarray:
    """H with H[i, j] = CRC bit i of the unit message e_j (CRC is GF(2)-
    linear, so crc(m) = H @ m mod 2)."""
    H = np.zeros((24, nbits), np.int8)
    for j in range(nbits):
        e = np.zeros(nbits, np.int8)
        e[j] = 1
        H[:, j] = _crc_bits_np(e)
    return H


_H112 = _crc_matrix(112)
_H56 = _crc_matrix(56)


def adsb_crc(bits) -> np.ndarray:
    """CRC-24 remainder of a 56/112-bit Mode S frame INCLUDING its parity
    field (all-zero iff the frame checks, modulo interrogator overlay)."""
    b = np.asarray(bits, np.int8)
    H = _H112 if len(b) == 112 else _H56
    return (H @ b) % 2


# ----------------------------------------------------------------------
# Waveform synthesis (for tests / loopback benches)
# ----------------------------------------------------------------------

def adsb_waveform(bits, osf: int = 2) -> np.ndarray:
    """Unit-amplitude magnitude envelope of preamble + PPM payload
    (osf samples per us, even)."""
    bits = np.asarray(bits, np.int8)
    hs = osf // 2                       # samples per half-slot
    pre = np.zeros(_PREAMBLE_US * osf, np.float32)
    for p in _PREAMBLE_HALFSLOTS:
        pre[p * hs:(p + 1) * hs] = 1.0
    pay = np.zeros(len(bits) * osf, np.float32)
    for k, b in enumerate(bits):
        off = k * osf + (0 if b else hs)
        pay[off:off + hs] = 1.0
    return np.concatenate([pre, pay])


# ----------------------------------------------------------------------
# Decoder
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdsbConfig:
    """Parity: ADSBDecodeurConfig{fe, Ne}, protocols.hpp:12-16."""
    fe: float = 2e6              # sample rate (even integer x 1 MHz)
    Ne: int = 1 << 16            # block size (samples)
    threshold: float = 0.55      # preamble energy-concentration score
    max_frames: int = 8          # static candidate count per block

    @property
    def osf(self) -> int:
        osf = int(round(self.fe / 1e6))
        if not (osf >= 2 and osf % 2 == 0 and abs(osf * 1e6 - self.fe) < 1):
            raise ValueError("fe must be an even integer multiple of 1 MHz")
        return osf


@dataclasses.dataclass
class AdsbDecode:
    """Device-side decode result: fixed shapes, ``valid`` mask, with the
    input's leading axes in front."""
    position: torch.Tensor   # preamble start (sample index, int32, (..., K))
    score: torch.Tensor      # preamble energy concentration in [0,1]
    bits: torch.Tensor       # (..., K, 112) int8 PPM decisions
    crc_ok: torch.Tensor     # (..., K) bool: CRC-24 syndrome == 0
    valid: torch.Tensor      # (..., K) bool: candidate mask


@dataclasses.dataclass
class AdsbFrame:
    """Parity: ADSBTrame{bs, score, texte}, protocols.hpp:18-23."""
    bits: np.ndarray
    score: float
    text: str
    position: int = 0
    crc_ok: bool = True


def _sliding_sums(mag: torch.Tensor, w: int) -> torch.Tensor:
    """s[..., i] = sum mag[..., i : i + w], float32, from a float64
    cumulative sum (length n - w + 1; the whole sum when w >= n)."""
    n = mag.shape[-1]
    c = F.pad(torch.cumsum(mag.to(torch.float64), dim=-1), (1, 0))
    s = c[..., w:] - c[..., :-w] if w < n else c[..., -1:] - c[..., :1]
    return s.to(real_dtype)


class AdsbDecoder:
    """One-shot / blockwise Mode S decoder.

    ``decode_block(x)`` is the device path (magnitude (..., n) in, fixed-K
    `AdsbDecode` out, on x's device); ``decode(x)`` wraps it and returns
    CRC-validated `AdsbFrame` records with decoded text.  ``device``: where
    ``decode`` puts host input (the card unless the caller names another).
    """

    def __init__(self, cfg: AdsbConfig = AdsbConfig(), device="cuda"):
        self.cfg = cfg
        osf = cfg.osf
        self.device = _device(device)
        self._H = torch.as_tensor(_H112.T.astype(np.float32),
                                  device=self.device)       # (112, 24)
        self._frame_len = (_PREAMBLE_US + _FRAME_BITS) * osf

    # -------------------------------------------------- device path --
    def _decode_block(self, mag: torch.Tensor) -> AdsbDecode:
        cfg, osf = self.cfg, self.cfg.osf
        hs, K = osf // 2, cfg.max_frames
        n = mag.shape[-1]
        lead = tuple(mag.shape[:-1])
        mag = mag.to(real_dtype)
        dev = mag.device

        ps = _sliding_sums(mag, hs)                   # len n-hs+1
        we = _sliding_sums(mag, _PREAMBLE_US * osf)   # 8-us window energy

        # 4-pulse correlation at every offset
        L = n - _PREAMBLE_US * osf + 1
        corr = sum(ps[..., p * hs:p * hs + L] for p in _PREAMBLE_HALFSLOTS)
        score = corr / (we[..., :L] + 1e-9)
        # absolute floor: pulses must rise above the block's mean level
        floor = torch.mean(mag, dim=-1, keepdim=True) * (4 * hs)
        zero = torch.zeros((), dtype=real_dtype, device=dev)
        score = torch.where(corr > 2.0 * floor, score, zero)

        # a full frame must fit in the block, including the last data
        # half-slot's width-hs sum over ps (len n-hs+1): the JAX package's
        # dynamic_slice would clamp and decode the final bits one sample
        # off, so those starts are masked (adsb.py:186-193)
        last = n - self._frame_len - (hs - 1)
        idx = torch.arange(L, device=dev)
        score = torch.where(idx <= last, score, zero)

        # non-max suppression over +-1 preamble length, then top-K
        w = _PREAMBLE_US * osf
        ext = F.pad(score.reshape(-1, 1, L), (w, w), value=-1.0)
        wmax = F.max_pool1d(ext, 2 * w + 1, stride=1).reshape(score.shape)
        ismax = score >= wmax
        cand = torch.where(ismax & (score > cfg.threshold), score, zero)
        top_s, top_p = top_k_stable(cand, K)
        valid = top_s > 0.0

        # PPM bit decisions: compare half-bit energies.  The start is
        # clamped as dynamic_slice clamps it (valid starts never are)
        nseg = _FRAME_BITS * osf
        base = torch.clamp(top_p + _PREAMBLE_US * osf, 0,
                           ps.shape[-1] - nseg)
        at = (base[..., None] + osf * torch.arange(
            _FRAME_BITS, device=dev)).reshape(*lead, -1)
        first = torch.gather(ps, -1, at)
        second = torch.gather(ps, -1, at + hs)
        bits = (first > second).to(torch.int8).reshape(*lead, K,
                                                       _FRAME_BITS)

        # CRC syndrome for all K frames in one matmul mod 2.  The all-zero
        # word is a codeword of any linear code, and silence (the zero pad
        # of a flushed partial block) decodes to exactly that: reject
        # degenerate frames explicitly
        with _fp32_matmul():
            syn = torch.remainder(bits.to(real_dtype) @ self._H.to(dev), 2)
        crc_ok = (syn.sum(-1) == 0) & (bits != 0).any(-1)

        return AdsbDecode(position=top_p.to(torch.int32), score=top_s,
                          bits=bits, crc_ok=crc_ok, valid=valid)

    def decode_block(self, mag: torch.Tensor) -> AdsbDecode:
        if mag.shape[-1] < self._frame_len:
            raise ValueError(f"a block needs >= {self._frame_len} samples, "
                             f"got {mag.shape[-1]}")
        return self._decode_block(mag)

    # ---------------------------------------------------- host path --
    def _magnitude(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            x = torch.as_tensor(np.abs(x) if np.iscomplexobj(x) else x,
                                device=self.device)
        return (x.abs() if x.is_complex() else x).to(real_dtype)

    def decode(self, x, crc_filter: bool = True) -> List[AdsbFrame]:
        """x: magnitude (real) or IQ (complex) samples at cfg.fe, one
        signal; a tensor is decoded on its device, an array on
        ``device``."""
        d = self.decode_block(self._magnitude(x))
        K = self.cfg.max_frames
        # one device-to-host copy per block
        packed = torch.cat([d.position.to(real_dtype), d.score,
                            d.crc_ok.to(real_dtype), d.valid.to(real_dtype),
                            d.bits.to(real_dtype).reshape(-1)]).cpu().numpy()
        pos = packed[:K].astype(np.int64)
        sc = packed[K:2 * K]
        ok = packed[2 * K:3 * K] > 0
        val = packed[3 * K:4 * K] > 0
        bits = packed[4 * K:].astype(np.int8).reshape(K, _FRAME_BITS)
        out = []
        for k in np.argsort(pos, kind="stable"):
            if not val[k] or (crc_filter and not ok[k]):
                continue
            out.append(AdsbFrame(bits=bits[k], score=float(sc[k]),
                                 text=decode_adsb_text(bits[k]),
                                 position=int(pos[k]), crc_ok=bool(ok[k])))
        return out


class AdsbStream:
    """Streaming wrapper: push arbitrary-size sample chunks, get frames
    (parity: the declared `ProtocoleDemodulateur` is a push Sink,
    protocols.hpp:44-47).  Re-blocks on the host to the decoder's block
    size with a one-frame overlap, so that frames straddling a push/block
    boundary are never lost; overlap duplicates are deduped by absolute
    position.  Each block is decoded on ``device``."""

    def __init__(self, cfg: AdsbConfig = AdsbConfig(), device="cuda"):
        self.dec = AdsbDecoder(cfg, device=device)
        # a block only emits starts p <= Ne - frame_len - (hs-1) (the
        # decoder's tail mask), so the next block must rewind far enough
        # to see p = Ne - frame_len - hs + 2 at a non-negative index
        self._overlap = self.dec._frame_len + cfg.osf // 2 - 2
        if cfg.Ne <= 2 * self._overlap:
            raise ValueError("Ne too small for the overlap")
        self._buf = np.zeros((0,), np.float32)
        self._base = 0            # absolute index of _buf[0]
        self._seen: set = set()

    def _emit(self, block: np.ndarray) -> List[AdsbFrame]:
        out: List[AdsbFrame] = []
        for fr in self.dec.decode(block):
            p = self._base + fr.position
            # +-2 tolerance: a boundary frame can re-detect one sample
            # off in the next (overlapped) block
            if all(abs(p - q) > 2 for q in self._seen):
                self._seen.add(p)
                fr.position = p
                out.append(fr)
        return out

    def push(self, x) -> List[AdsbFrame]:
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        xa = np.asarray(x)
        mag = np.abs(xa).astype(np.float32) if np.iscomplexobj(xa) else \
            xa.astype(np.float32)
        self._buf = np.concatenate([self._buf, mag])
        Ne = self.dec.cfg.Ne
        out: List[AdsbFrame] = []
        while len(self._buf) >= Ne:
            out += self._emit(self._buf[:Ne])
            adv = Ne - self._overlap
            self._buf = self._buf[adv:]
            self._base += adv
            # positions older than the retained overlap can never recur
            self._seen = {p for p in self._seen if p >= self._base}
        return out

    def flush(self) -> List[AdsbFrame]:
        """Decode the final partial block of a finite capture (zero-pad
        to the block size); call once at end of stream."""
        Ne = self.dec.cfg.Ne
        out: List[AdsbFrame] = []
        if len(self._buf) > 0:
            # re-decoding the already-seen overlap region is harmless:
            # _seen dedupes, and a capture shorter than one block has
            # never been decoded at all
            blk = np.concatenate([self._buf,
                                  np.zeros((Ne - len(self._buf),),
                                           np.float32)])
            out = self._emit(blk)
        # advance by the samples actually consumed, NOT the padded block
        # size: a later push on this object must report absolute
        # positions continuous with the true sample count
        self._base += len(self._buf)
        self._buf = np.zeros((0,), np.float32)
        self._seen = set()
        return out


# ----------------------------------------------------------------------
# Host-side field decoding (texte)
# ----------------------------------------------------------------------

_CHARSET = "#ABCDEFGHIJKLMNOPQRSTUVWXYZ#####_###############0123456789######"


def _field(bits: np.ndarray, lo: int, hi: int) -> int:
    """Bits [lo, hi) MSB-first as an integer."""
    v = 0
    for b in bits[lo:hi]:
        v = (v << 1) | int(b)
    return v


def decode_adsb_text(bits) -> str:
    """Render a validated frame as text: DF, ICAO, and (DF17/18) the ME
    payload — callsign for TC 1-4, barometric altitude for TC 9-18."""
    b = np.asarray(bits, np.int8)
    df = _field(b, 0, 5)
    if df not in (17, 18) or len(b) < 112:
        return f"DF{df}"
    icao = _field(b, 8, 32)
    tc = _field(b, 32, 37)
    txt = f"DF{df} ICAO {icao:06X} TC{tc}"
    if 1 <= tc <= 4:
        cs = "".join(_CHARSET[_field(b, 40 + 6 * i, 46 + 6 * i)]
                     for i in range(8))
        txt += f" ident {cs.rstrip('_#')}"
    elif 9 <= tc <= 18:
        alt = _field(b, 40, 52)
        q = (alt >> 4) & 1
        if q:
            n = ((alt >> 5) << 4) | (alt & 0xF)      # drop the Q bit
            txt += f" alt {25 * n - 1000} ft"
        oddflag = b[53]
        lat = _field(b, 54, 71)
        lon = _field(b, 71, 88)
        txt += f" cpr[{int(oddflag)}] lat {lat} lon {lon}"
    return txt


# ----------------------------------------------------------------------
# CPR global position decoding (even/odd frame pair)
# ----------------------------------------------------------------------

def _nl(lat: float) -> int:
    """Number of longitude zones at latitude (CPR NL function)."""
    if abs(lat) >= 87.0:
        return 1 if abs(lat) > 87.0 else 2
    a = 1 - np.cos(np.pi / 30)
    return int(np.floor(2 * np.pi / np.arccos(
        1 - a / np.cos(np.pi / 180 * lat) ** 2)))


def cpr_global(lat_even: int, lon_even: int, lat_odd: int, lon_odd: int,
               newest_odd: bool = True) -> Optional[Tuple[float, float]]:
    """Globally-unambiguous airborne position from an even/odd CPR pair
    (17-bit fields as transmitted).  Returns (lat, lon) in degrees, or
    None if the pair straddles a latitude-zone boundary."""
    sc = 1.0 / (1 << 17)
    ce, co = lat_even * sc, lat_odd * sc
    j = np.floor(59 * ce - 60 * co + 0.5)
    dlat_e, dlat_o = 360.0 / 60, 360.0 / 59
    lat_e = dlat_e * (j % 60 + ce)
    lat_o = dlat_o * (j % 59 + co)
    lat_e -= 360.0 * (lat_e >= 270)
    lat_o -= 360.0 * (lat_o >= 270)
    if _nl(lat_e) != _nl(lat_o):
        return None
    lat = lat_o if newest_odd else lat_e
    nl = _nl(lat)
    i_ = 1 if newest_odd else 0
    ni = max(nl - i_, 1)
    xe, xo = lon_even * sc, lon_odd * sc
    m = np.floor(xe * (nl - 1) - xo * nl + 0.5)
    lon = (360.0 / ni) * (m % ni + (xo if newest_odd else xe))
    lon -= 360.0 * (lon >= 180)
    return float(lat), float(lon)
