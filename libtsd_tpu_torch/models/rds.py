"""RDS (Radio Data System, IEC 62106) encoder and decoder for the
broadcast FM receiver (PyTorch), ported from ``libtsd_tpu/models/rds.py``.

The reference starts an RDS decode inside its FM demodulator, but that
code is dead as shipped (core/src/telecom/analogique.cc:528-560); this is a
working implementation of what it attempts, checked against the public
standard:

* the (26,16) shortened cyclic block code, g(x) = x^10 + x^8 + x^7 + x^5
  + x^4 + x^3 + 1 (0x5B9); checkword = m(x) x^10 mod g(x); offset words
  A = 0x0FC, B = 0x198, C = 0x168, C' = 0x350, D = 0x1B4 added to the
  check bits;
* 1187.5 bit/s = 57 kHz / 48, differentially encoded, then biphase
  symbols on a 57 kHz subcarrier locked to the 3rd harmonic of the 19 kHz
  stereo pilot;
* the decoder regenerates the subcarrier from the stereo path's pilot PLL
  (``analog.fm_pilot_unit`` cubed), filters and resamples to 16 samples a
  bit (19 kHz: the bit clock is exact), then runs a dense bit-phase
  search, differential decoding, syndrome block sync over every bit
  offset and burst correction (bursts of <= 5 bits) from a syndrome table.

The signal path (pilot, mixers, filter, resampler) runs on the tensors'
device; the bit and string work (syndromes, groups, the encoders' bit
streams) is host numpy, copied from the JAX package.  ``rds_decode_mpx``
copies the baseband to the host once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import complex_dtype, device as _device, real_dtype
from ..ops.filter_rt import fir_filter
from ..ops.fir_design import fir_lowpass
from ..ops.resample import resample
from ..ops.signal import cycles

__all__ = ["RdsGroup", "rds_checkword", "rds_encode_block",
           "rds_encode_groups", "rds_group_0a", "rds_group_2a",
           "rds_subcarrier", "rds_baseband", "rds_decode_baseband",
           "rds_decode_mpx", "rds_decode",
           "rds_station_name", "rds_radiotext", "OFFSET_WORDS"]

_G_POLY = 0b10110111001          # g(x), degree 10
_NDATA, _NCHECK, _NBLK = 16, 10, 26
OFFSET_WORDS: Dict[str, int] = {
    "A": 0x0FC, "B": 0x198, "C": 0x168, "Cp": 0x350, "D": 0x1B4}
_BITRATE = 1187.5                # = 57e3 / 48
_OSF = 16                        # samples per bit at the 19 kHz tap
_FS_DEC = _BITRATE * _OSF        # 19000.0 — decoder working rate


def rds_checkword(data: int) -> int:
    """10 check bits of a 16-bit information word: m(x)*x^10 mod g(x)."""
    r = data << _NCHECK
    for i in range(_NDATA + _NCHECK - 1, _NCHECK - 1, -1):
        if r & (1 << i):
            r ^= _G_POLY << (i - _NCHECK)
    return r & ((1 << _NCHECK) - 1)


def rds_encode_block(data: int, offset: str) -> int:
    """26-bit transmitted block: data(16) | checkword ^ offset word."""
    return (data << _NCHECK) | (rds_checkword(data)
                                ^ OFFSET_WORDS[offset])


def _syndrome_matrix() -> np.ndarray:
    """H^T as a (26, 10) GF(2) matrix: row j is the syndrome of the
    single-bit error at position j (bit 25-j first on air), i.e.
    x^(25-j) mod g(x).  syndrome(r) = bits(r) @ Ht mod 2."""
    Ht = np.zeros((_NBLK, _NCHECK), np.uint8)
    for j in range(_NBLK):
        deg = _NBLK - 1 - j
        r = 1 << deg
        for i in range(_NBLK - 1, _NCHECK - 1, -1):
            if r & (1 << i):
                r ^= _G_POLY << (i - _NCHECK)
        Ht[j] = [(r >> (9 - b)) & 1 for b in range(_NCHECK)]
    return Ht


_HT = _syndrome_matrix()


def _synd_int(word: int) -> int:
    bits = np.array([(word >> (_NBLK - 1 - j)) & 1
                     for j in range(_NBLK)], np.uint8)
    s = bits @ _HT % 2
    return int(s @ (1 << np.arange(_NCHECK - 1, -1, -1)))


_OFFSET_SYND = {k: _synd_int(v) for k, v in OFFSET_WORDS.items()}


def _burst_table() -> Dict[int, int]:
    """syndrome(e) -> error pattern e, for every burst of length <= 5
    (the code corrects any single burst spanning at most 5 bits).
    367 patterns; collisions are dropped (kept = shortest burst)."""
    tab: Dict[int, int] = {}
    for length in range(1, 6):
        inner = 1 << max(0, length - 2)
        for start in range(_NBLK - length + 1):
            for mid in range(inner):
                if length == 1:
                    e = 1 << (_NBLK - 1 - start)
                else:
                    body = (1 << (length - 1)) | 1 | (mid << 1)
                    e = body << (_NBLK - length - start)
                s = _synd_int(e)
                if s and s not in tab:
                    tab[s] = e
    return tab


_BURST = _burst_table()


@dataclasses.dataclass(frozen=True)
class RdsGroup:
    """One decoded RDS group (4 blocks).  ``errors[k]`` is the number of
    corrected bits in block k, or -1 if the block was uncorrectable
    (its data word is then untrusted)."""
    blocks: Tuple[int, int, int, int]
    errors: Tuple[int, int, int, int]
    version_b: bool

    @property
    def pi(self) -> int:
        return self.blocks[0]

    @property
    def group_type(self) -> int:
        return self.blocks[1] >> 12

    @property
    def pty(self) -> int:
        return (self.blocks[1] >> 5) & 0x1F


# ------------------------------------------------------------------ TX

def rds_group_0a(pi: int, pty: int, segment: int, chars: str) -> Tuple[int, ...]:
    """Type 0A group carrying 2 characters of the 8-char PS name."""
    b = (0 << 12) | (0 << 11) | (pty << 5) | (1 << 2) | (segment & 3)
    c0, c1 = (ord(c) for c in chars.ljust(2)[:2])
    return (pi, b, 0xE0E0, (c0 << 8) | c1)


def rds_group_2a(pi: int, pty: int, addr: int, chars: str) -> Tuple[int, ...]:
    """Type 2A group carrying 4 characters of the 64-char RadioText."""
    b = (2 << 12) | (0 << 11) | (pty << 5) | (addr & 0xF)
    c = chars.ljust(4)[:4]
    return (pi, b, (ord(c[0]) << 8) | ord(c[1]),
            (ord(c[2]) << 8) | ord(c[3]))


def rds_encode_groups(groups: Sequence[Sequence[int]]) -> np.ndarray:
    """Groups of 4 16-bit words -> on-air bit array (104 bits/group).
    Block 3 uses offset C' when the group's version bit (B block bit 11)
    is set (version B), per the standard."""
    bits: List[int] = []
    for g in groups:
        version_b = bool(g[1] & (1 << 11))
        offs = ("A", "B", "Cp" if version_b else "C", "D")
        for data, off in zip(g, offs):
            blk = rds_encode_block(int(data), off)
            bits.extend((blk >> (_NBLK - 1 - j)) & 1
                        for j in range(_NBLK))
    return np.asarray(bits, np.uint8)


def rds_subcarrier(bits: np.ndarray, fe: float, n: int,
                   level: float = 0.06, device="cuda") -> torch.Tensor:
    """57 kHz RDS multiplex component at rate ``fe`` (n samples) on
    ``device``, locked to the pilot (the carrier is the 3rd harmonic of the
    19 kHz NCO that fm_broadcast_multiplex uses): differential encoding,
    biphase symbols (bit 1 = +,- / bit 0 = -,+ over one bit period), ~2.4
    kHz band limiting, coherent product with cos(3 pilot)."""
    dev = _device(device)
    d = np.bitwise_xor.accumulate(np.asarray(bits, np.uint8))
    t = np.arange(n) * (_BITRATE / fe)
    idx = np.minimum(t.astype(np.int64), len(d) - 1)
    half = (t - np.floor(t)) >= 0.5
    pm = 1.0 - 2.0 * d[idx]
    wave = torch.as_tensor(np.where(half, -pm, pm) * (t < len(d)),
                           dtype=real_dtype, device=dev)
    # the tap count scales with fe so that the windowed-sinc transition
    # (~3.3/N normalised) stays ~1.5 kHz wide: 255 taps at fe ~ 1 MHz
    # would leave the biphase sidebands almost whole out to the 53 kHz
    # edge of the L-R band
    nt = min(4095, int(np.ceil(3.3 * fe / 1500.0)) | 1)
    h = fir_lowpass(nt, 2400.0 / fe)
    bb = fir_filter(h, wave)
    c57 = torch.cos(2 * np.pi * 3.0 * cycles(19e3 / fe, n, device=dev))
    return level * bb * c57


# ------------------------------------------------------------------ RX

def _mf_bits(zbb_r: np.ndarray) -> List[np.ndarray]:
    """Biphase matched filter at 16 samples/bit + dense bit-phase
    search: returns candidate hard-bit streams (differentially decoded,
    polarity-free), best phases first."""
    k = np.r_[np.ones(_OSF // 2), -np.ones(_OSF // 2)]
    mf = np.convolve(zbb_r, k[::-1], mode="valid")
    scores = [(np.mean(np.abs(mf[p::_OSF])), p)
              for p in range(_OSF)]
    scores.sort(reverse=True)
    outs = []
    for _, p in scores[:4]:
        soft = mf[p::_OSF]
        hard = (soft > 0).astype(np.uint8)
        outs.append(np.bitwise_xor(hard[1:], hard[:-1]))
    return outs


def _sync_and_decode(bits: np.ndarray) -> Tuple[int, List[RdsGroup]]:
    """Syndrome block sync over every bit offset + group decode with
    burst correction.  Returns (chain_score, groups)."""
    nb = len(bits)
    if nb < 104:
        return 0, []
    win = np.lib.stride_tricks.sliding_window_view(bits, _NBLK)
    S = (win.astype(np.uint8) @ _HT % 2) @ (
        1 << np.arange(_NCHECK - 1, -1, -1))
    sA, sB, sC, sCp, sD = (_OFFSET_SYND[k]
                           for k in ("A", "B", "C", "Cp", "D"))
    nw = len(S)
    n4 = nw - 3 * _NBLK
    if n4 <= 0:
        return 0, []
    mA = (S == sA).astype(np.int8)
    mB = (S == sB).astype(np.int8)
    mC = ((S == sC) | (S == sCp)).astype(np.int8)
    mD = (S == sD).astype(np.int8)
    score = (mA[:n4] + mB[26:26 + n4]
             + mC[52:52 + n4] + mD[78:78 + n4])
    best_p = int(np.argmax(score))          # earliest maximal chain
    best_score = int(score[best_p])
    if best_score < 3:
        return best_score, []
    groups: List[RdsGroup] = []
    p = best_p
    while p + 104 <= nb:
        blks, errs = [], []
        version_b = False
        for k, off in enumerate(("A", "B", "C", "D")):
            w = bits[p + 26 * k: p + 26 * (k + 1)]
            word = int(w @ (1 << np.arange(_NBLK - 1, -1, -1,
                                           dtype=np.int64)))
            s = _synd_int(word)
            if off == "C":
                # The group's version bit (block B bit 11, decoded at
                # k==1 before we get here) selects offset C vs C'.  Try
                # the expected offset FIRST: a corrupted block 3 whose
                # syndrome lands in the 367-entry burst table for the
                # WRONG offset (~36 % chance) would otherwise be
                # silently miscorrected against it.
                expect = ([_OFFSET_SYND["Cp"], _OFFSET_SYND["C"]]
                          if version_b else
                          [_OFFSET_SYND["C"], _OFFSET_SYND["Cp"]])
            else:
                expect = [_OFFSET_SYND[off]]
            if s in expect:
                blks.append(word >> _NCHECK)
                errs.append(0)
            else:
                fixed = -1
                for exp in expect:
                    e = _BURST.get(s ^ exp)
                    if e is not None:
                        fixed = bin(e).count("1")
                        word ^= e
                        break
                blks.append(word >> _NCHECK)
                errs.append(fixed)
            if k == 1 and errs[-1] >= 0:
                version_b = bool(blks[1] & (1 << 11))
        groups.append(RdsGroup(tuple(blks), tuple(errs), version_b))
        p += 104
    return best_score, groups


def rds_baseband(a3: torch.Tensor, fech2: float) -> torch.Tensor:
    """Device half of the RDS decoder, on a3's device: pilot recovery,
    coherent 57 kHz downconversion, band filter, resampling to the 19 kHz
    rate whose bit clock is exact.  Returns the real biphase baseband (16
    samples a bit)."""
    from .analog import fm_pilot_unit
    z19 = fm_pilot_unit(a3, fech2)
    z57 = z19 * z19 * z19           # unit analytic 57 kHz, pilot-locked
    bb = a3.to(complex_dtype) * z57.conj()
    bb = fir_filter(fir_lowpass(255, 2400.0 / fech2), bb)
    return resample(bb.real, _FS_DEC / fech2)


def rds_decode_mpx(a3: torch.Tensor, fech2: float) -> List[RdsGroup]:
    """Decode RDS groups from a demodulated FM multiplex at rate fech2
    (the signal fm_broadcast_demodulate calls ``a3``)."""
    y = rds_baseband(a3, fech2)
    return rds_decode_baseband(y.cpu().numpy().astype(np.float64))


def rds_decode_baseband(y: np.ndarray) -> List[RdsGroup]:
    """Host-side half: matched filter + bit-phase search + differential
    decode + syndrome sync + burst correction (numpy bit/string work,
    like the other protocol decoders)."""
    best: Tuple[int, List[RdsGroup]] = (0, [])
    for bits in _mf_bits(y):
        score, groups = _sync_and_decode(bits)
        ok = sum(1 for g in groups for e in g.errors if e == 0)
        if (score, ok) > (best[0], sum(
                1 for g in best[1] for e in g.errors if e == 0)):
            best = (score, groups)
        if score == 4 and groups:
            break
    return best[1]


def rds_decode(x: torch.Tensor, fe: float) -> List[RdsGroup]:
    """Decode RDS from a broadcast FM IF signal (the front end of
    fm_broadcast_demodulate)."""
    from .analog import _fm_broadcast_front
    a3, fech2, _ = _fm_broadcast_front(x, fe)
    return rds_decode_mpx(a3, fech2)


def rds_station_name(groups: Sequence[RdsGroup]) -> str:
    """Assemble the 8-char PS name from type-0 groups."""
    ps = [" "] * 8
    for g in groups:
        if g.group_type != 0 or g.errors[1] != 0:
            continue
        seg = g.blocks[1] & 3
        if g.errors[3] == 0:
            ps[2 * seg] = chr((g.blocks[3] >> 8) & 0x7F)
            ps[2 * seg + 1] = chr(g.blocks[3] & 0x7F)
    return "".join(ps).rstrip()


def rds_radiotext(groups: Sequence[RdsGroup]) -> str:
    """Assemble RadioText from type-2A groups (64 chars max)."""
    rt = [" "] * 64
    for g in groups:
        if g.group_type != 2 or g.version_b or g.errors[1] != 0:
            continue
        addr = g.blocks[1] & 0xF
        if g.errors[2] == 0:
            rt[4 * addr] = chr((g.blocks[2] >> 8) & 0x7F)
            rt[4 * addr + 1] = chr(g.blocks[2] & 0x7F)
        if g.errors[3] == 0:
            rt[4 * addr + 2] = chr((g.blocks[3] >> 8) & 0x7F)
            rt[4 * addr + 3] = chr(g.blocks[3] & 0x7F)
    return "".join(rt).rstrip()
