"""POCSAG pager protocol: encoder, FSK waveform, and decoder (PyTorch),
ported from ``libtsd_tpu/models/pocsag.py``.

Parity: the reference DECLARES this component but never implements it
(`demodulateur_pocsag()` and the `POCSAGDecodeurConfig{fe, fi, debit}` /
`POCSAGMessage{ric, function, texte}` structs exist only as a header,
core/include/tsd/telecom/protocols.hpp:25-48).  This module is the JAX
package's working superset of the declared API.

Protocol (ITU-R M.584): 2-FSK (+-4.5 kHz) at 512/1200/2400 baud.  A
transmission is a >=576-bit alternating preamble followed by batches:
a 32-bit frame-sync codeword (0x7CD215D8) + 8 frames x 2 codewords.
Each 32-bit codeword is BCH(31,21) (generator x^10+x^9+x^8+x^6+x^5+x^3+1
= 0x769) plus an even-parity bit; address codewords carry the 18 RIC
MSBs (the 3 LSBs are the frame index) and 2 function bits; message
codewords carry 20 data bits (7-bit ASCII LSB-first for alpha, 4-bit
BCD for numeric).  Idle codeword: 0x7A89C197.

The encoder, the BCH tables and the text assembly are host code copied
from the JAX package.  The device path, ``PocsagDecoder._scan``, runs on
the discriminator output's device:

* the front end is the port's ``models.demod.quadrature_discriminator``
  (after a mix by fi through ``ops.signal.cycles``) and
  ``ops.resample.resample`` to 8 samples a bit;
* bit-rate detection (``debit = -1``) runs the dense sync scan at each
  candidate baud and keeps the best normalized score;
* frame sync is dense: the +-1 sync template is correlated at every
  sample offset over 32 shifted slices of the sliding bit-integral, so
  clock phase and polarity come from the score;
* the candidates are picked by a stable descending sort (the lower
  position first among equal scores, ``jax.lax.top_k``'s order: noise-free
  signals give flat plateaus), each at the first index of its plateau,
  as the JAX decoder picks it;
* all 16 codewords of every detected batch are gathered at once and
  BCH-checked by GF(2) products, float32 matmuls with TF32 off (exact:
  at most 465 terms of 0/1; ``torch.matmul`` has no int32 CUDA form); 1-
  and 2-bit errors are corrected by matching the 10-bit syndrome against
  the 31 single-column and 465 pair syndromes.

The bit integral comes from a float64 cumulative sum on the device (the
JAX package sums in float32).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import complex_dtype, device as _device, real_dtype
from ..ops.filter_rt import _fp32_matmul
from ..ops.resample import resample
from ..ops.signal import cycles, top_k_stable
from .demod import quadrature_discriminator

__all__ = ["PocsagConfig", "PocsagMessage", "PocsagDecoder",
           "pocsag_encode", "pocsag_waveform", "bch3121_encode",
           "FSC", "IDLE"]

FSC = 0x7CD215D8
IDLE = 0x7A89C197
_G = 0x769                    # BCH(31,21) generator polynomial
_BAUDS = (512, 1200, 2400)
_OSF = 8                      # samples per bit after the front end
_CW_BITS = 32
_BATCH_CW = 16                # codewords after the sync word
_BATCH_BITS = _CW_BITS * (1 + _BATCH_CW)   # 544


# ----------------------------------------------------------------------
# BCH(31,21) + parity as GF(2) linear algebra
# ----------------------------------------------------------------------

def bch3121_encode(data21: int) -> int:
    """21 data bits -> 32-bit codeword (BCH check bits + even parity)."""
    rem = data21 << 10
    for i in range(30, 9, -1):
        if rem & (1 << i):
            rem ^= _G << (i - 10)
    cw31 = (data21 << 10) | rem
    parity = bin(cw31).count("1") & 1
    return (cw31 << 1) | parity


def _syndrome_matrix() -> np.ndarray:
    """S (10, 31): column j = x^(30-j) mod g(x) — the syndrome of an
    error in TRANSMITTED bit j of the 31-bit codeword."""
    S = np.zeros((10, 31), np.int8)
    for j in range(31):
        rem = 1 << (30 - j)
        for i in range(30, 9, -1):
            if rem & (1 << i):
                rem ^= _G << (i - 10)
        S[:, j] = [(rem >> (9 - k)) & 1 for k in range(10)]
    return S


_SYN = _syndrome_matrix()


def _word_bits(w: int, n: int = 32) -> np.ndarray:
    return np.array([(w >> (n - 1 - i)) & 1 for i in range(n)], np.int8)


# ----------------------------------------------------------------------
# Encoder (host) — also the test oracle
# ----------------------------------------------------------------------

_NUMCHARS = "0123456789*U -)("


def pocsag_encode(ric: int, function: int, text: str = "",
                  numeric: bool = False, npreamble: int = 576) -> np.ndarray:
    """Bit sequence of one POCSAG transmission carrying a single message
    (preamble + batches, idle-filled)."""
    frame = ric & 7
    # address data21 = flag(0) | 18 address MSBs | 2 function bits
    addr_cw = bch3121_encode(((ric >> 3) << 2) | (function & 3))
    msg_cws = []
    if text:
        if numeric:
            chunks = [_NUMCHARS.index(ch) for ch in text]
            # pad to the 20-bit codeword boundary with SPACE nibbles
            # (0xC) — zero-padding would decode as spurious '0' digits
            while (4 * len(chunks)) % 20:
                chunks.append(0xC)
            bits = []
            for v in chunks:
                bits += [(v >> k) & 1 for k in range(4)]   # LSB first
        else:
            bits = []
            for ch in text:
                v = ord(ch) & 0x7F
                bits += [(v >> k) & 1 for k in range(7)]   # LSB first
            while len(bits) % 20:
                bits.append(0)
        for i in range(0, len(bits), 20):
            data20 = 0
            for b in bits[i:i + 20]:
                data20 = (data20 << 1) | b
            msg_cws.append(bch3121_encode((1 << 20) | data20))

    # lay codewords into batches: address at its frame slot, message
    # words immediately after, idle elsewhere
    slots = [IDLE] * (2 * 8)
    pos = 2 * frame
    slots[pos] = addr_cw
    k = pos + 1
    extra: List[int] = []
    for cw in msg_cws:
        if k < 16:
            slots[k] = cw
            k += 1
        else:
            extra.append(cw)
    batches = [slots]
    while extra:
        nxt, extra = extra[:16], extra[16:]
        batches.append(nxt + [IDLE] * (16 - len(nxt)))

    out = [np.tile([1, 0], npreamble // 2).astype(np.int8)]
    for b in batches:
        out.append(_word_bits(FSC))
        for cw in b:
            out.append(_word_bits(cw))
    return np.concatenate(out)


def pocsag_waveform(bits, fe: float, debit: int, fi: float = 0.0,
                    deviation: float = 4500.0) -> np.ndarray:
    """Complex-baseband 2-FSK signal at fe: bit '0' -> +deviation,
    bit '1' -> -deviation (ITU-R M.584 sense), carrier offset fi."""
    bits = np.asarray(bits, np.int8)
    osf = fe / debit
    n = int(np.ceil(len(bits) * osf))
    t = np.arange(n)
    nrz = 1.0 - 2.0 * bits[np.minimum((t / osf).astype(np.int64),
                                      len(bits) - 1)]
    finst = fi + deviation * nrz
    phase = 2 * np.pi * np.cumsum(finst) / fe
    return np.exp(1j * phase).astype(np.complex64)


# ----------------------------------------------------------------------
# Decoder
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PocsagConfig:
    """Parity: POCSAGDecodeurConfig{debug_actif, fe, fi, debit},
    protocols.hpp:25-35 (debit -1 = auto detection)."""
    fe: float = 38400.0
    fi: float = 0.0
    debit: int = -1              # 512 | 1200 | 2400 | -1 (auto)
    threshold: float = 0.6       # normalized sync-correlation score
    max_batches: int = 8         # static candidate count per call


@dataclasses.dataclass
class PocsagMessage:
    """Parity: POCSAGMessage{ric, function, texte}, protocols.hpp:37-42."""
    ric: int
    function: int
    text: str


@dataclasses.dataclass
class PocsagBatches:
    """Device-side scan result: fixed shapes, ``valid`` mask."""
    position: torch.Tensor  # sync-word start in 8-samp/bit stream, (B,)
    score: torch.Tensor     # |normalized sync correlation|, (B,)
    bits: torch.Tensor      # (B, 16, 32) int8 corrected codeword bits
    cw_ok: torch.Tensor     # (B, 16) bool: BCH + parity valid
    valid: torch.Tensor     # (B,) bool


class PocsagDecoder:
    """decode(x) -> list[PocsagMessage].  x: complex IQ at cfg.fe
    (discriminated internally) or an already-discriminated real NRZ
    baseband; a tensor is decoded on its device, an array on ``device``
    (the card unless the caller names another)."""

    def __init__(self, cfg: PocsagConfig = PocsagConfig(), device="cuda"):
        self.cfg = cfg
        self.device = _device(device)
        dev = self.device
        self._sync = (1.0 - 2.0 * _word_bits(FSC)).astype(np.float32)
        self._S = torch.as_tensor(_SYN.T.astype(np.float32),
                                  device=dev)                  # (31, 10)
        # two-error tables: pair syndromes and their flip masks.  d=5
        # guarantees every pair syndrome is nonzero, distinct from every
        # single-column syndrome and from every other pair: the compares
        # below are one-hot
        pairs = [(i, j) for i in range(31) for j in range(i + 1, 31)]
        self._S2 = torch.as_tensor(
            np.array([_SYN[:, i] ^ _SYN[:, j] for i, j in pairs],
                     np.float32), device=dev)                  # (465, 10)
        M2 = np.zeros((len(pairs), 31), np.float32)
        for k, (i, j) in enumerate(pairs):
            M2[k, i] = M2[k, j] = 1
        self._M2 = torch.as_tensor(M2, device=dev)             # (465, 31)

    # -------------------------------------------------- device path --
    def _scan(self, d: torch.Tensor, baud: int) -> PocsagBatches:
        """d: discriminator output at cfg.fe (1-D); returns batch
        candidates in the resampled 8-samples/bit domain, on d's device."""
        cfg = self.cfg
        dev = d.device
        # trailing silence: flushes the resampler's group delay and
        # guarantees a transmission ending at the signal's last sample
        # still has a full batch window after its sync position
        npad = int(np.ceil(64 * cfg.fe / baud))
        d = F.pad(d.to(real_dtype), (0, npad))
        y = resample(d, _OSF * baud / cfg.fe)
        # sliding one-bit integral; s > 0 <=> '0' (positive deviation)
        c = F.pad(torch.cumsum(y.to(torch.float64), 0), (1, 0))
        s = (c[_OSF:] - c[:-_OSF]).to(real_dtype)
        # zero-pad so a full batch always fits after any candidate sync
        # position (even when probing a wrong baud on a short signal)
        need = _BATCH_BITS * _OSF + cfg.max_batches
        if s.shape[0] < need:
            s = F.pad(s, (0, need - s.shape[0]))
        L = s.shape[0] - _BATCH_BITS * _OSF
        # dense +-1 sync correlation (bit k at offset 8k), summed in the
        # JAX package's order
        corr = 0
        nrm = 0
        for k, t in enumerate(self._sync):
            sl = s[k * _OSF:k * _OSF + L]
            corr = corr + float(t) * sl
            nrm = nrm + sl.abs()
        # bit '0' -> +deviation -> positive bit integral, template +1:
        # score -> +1 at a sync with normal polarity, -1 inverted (the sign
        # comes from the sync: the complement of a codeword is one too).
        # Energy floor: inside the alternating preamble at half-bit
        # offsets every bit integral is ~0 and corr/nrm would be an
        # amplified noise ratio
        floor = 0.5 * _CW_BITS * torch.mean(s.abs())
        zero = torch.zeros((), dtype=real_dtype, device=dev)
        score = torch.where(nrm > floor, corr / (nrm + 1e-9), zero)
        a = score.abs()

        # EXACT non-max suppression over +-w, two stages: (1) one winner
        # per w-sized block (argmax: the first index on ties); (2) a winner
        # dies only to a strictly-better winner whose POSITION is within w
        # (ties go to the earlier); pocsag.py:262-290 explains why this is
        # exhaustive and never over-suppresses
        w = _BATCH_BITS * _OSF // 2
        nb = -(-L // w)
        blocks = F.pad(a, (0, nb * w - L)).reshape(nb, w)
        bm = blocks.max(dim=1).values
        am = torch.argmax(blocks, dim=1)
        wi = am + torch.arange(nb, device=dev) * w      # flat positions
        pv = torch.cat([bm[:1] * 0, bm[:-1]])
        pw = torch.cat([wi[:1] * 0 - 2 * w, wi[:-1]])
        nv = torch.cat([bm[1:], bm[-1:] * 0])
        nw = torch.cat([wi[1:], wi[-1:] * 0 + 3 * nb * w])
        lose_prev = (wi - pw <= w) & (pv >= bm)       # earlier wins ties
        lose_next = (nw - wi <= w) & (nv > bm)
        keep = ~(lose_prev | lose_next)
        onehot = torch.arange(w, device=dev)[None, :] == am[:, None]
        ismax = (onehot & keep[:, None]).reshape(-1)[:L]
        cand = torch.where(ismax & (a > cfg.threshold), a, zero)
        top_s, top_p = top_k_stable(cand, cfg.max_batches)
        valid = top_s > 0.0
        pol = torch.sign(score[top_p])         # +1 normal, -1 inverted

        # the 16 codewords after each sync word; the start is clamped as
        # dynamic_slice clamps it
        nseg = _BATCH_CW * _CW_BITS * _OSF
        start = torch.clamp(top_p + _CW_BITS * _OSF, 0, s.shape[0] - nseg)
        at = start[:, None] + _OSF * torch.arange(_BATCH_CW * _CW_BITS,
                                                  device=dev)
        soft = -pol[:, None] * s[at]              # >0 <=> bit '1'
        bits = (soft > 0).to(torch.int8).reshape(-1, _BATCH_CW, _CW_BITS)

        # BCH syndrome decoding, all codewords at once.  BCH(31,21) has
        # minimum distance 5: match the syndrome against the 31 single-bit
        # columns AND the 465 two-bit pair syndromes (single preferred)
        S, S2, M2 = (t.to(dev) for t in (self._S, self._S2, self._M2))
        cw31 = bits[..., :31]
        with _fp32_matmul():
            syn = torch.remainder(cw31.to(real_dtype) @ S, 2)  # (B, 16, 10)
        clean = syn.sum(-1) == 0
        hit1 = (syn[..., None, :] == S[None, None]).all(-1)
        hit2 = (syn[..., None, :] == S2[None, None]).all(-1)
        with _fp32_matmul():
            flip2 = torch.remainder(hit2.to(real_dtype) @ M2, 2)
        single = hit1.any(-1)
        double = hit2.any(-1)
        flip = torch.where(single[..., None], hit1.to(torch.int8),
                           flip2.to(torch.int8))
        corrected = cw31 ^ flip
        bits = torch.cat([corrected, bits[..., 31:]], -1)
        # decision table over (syndrome class, PRE-correction overall
        # parity par0): accept clean, single, and double with even par0
        # (double + odd par0 means >= 3 errors); pocsag.py:342-353
        par0 = ((corrected ^ flip).to(torch.int32).sum(-1)
                + bits[..., 31].to(torch.int32)) % 2
        cw_ok = clean | single | (double & (par0 == 0))
        return PocsagBatches(position=top_p.to(torch.int32), score=top_s,
                             bits=bits, cw_ok=cw_ok, valid=valid)

    def scan(self, d: torch.Tensor, baud: int) -> PocsagBatches:
        return self._scan(d, baud)

    # ---------------------------------------------------- host path --
    def _front(self, x) -> torch.Tensor:
        """The discriminator output on the device: a complex input is
        mixed down by fi (phase in wrapped cycles, float64-exact) and
        discriminated; a real one is taken as the NRZ baseband."""
        cfg = self.cfg
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x), device=self.device)
        if not x.is_complex():
            return x.to(real_dtype)
        z = x.to(complex_dtype)
        if cfg.fi:
            cyc = cycles(cfg.fi / cfg.fe, z.shape[-1], device=z.device)
            z = z * torch.exp(-2j * np.pi * cyc).to(complex_dtype)
        return quadrature_discriminator(z)

    def decode(self, x, return_baud: bool = False):
        cfg = self.cfg
        d = self._front(x)
        bauds = _BAUDS if cfg.debit == -1 else (cfg.debit,)
        best, best_peak, best_baud = None, -1.0, 0
        for baud in bauds:
            r = self.scan(d, baud)
            psv = self._readback(r)
            B = cfg.max_batches
            peak = float(np.max(np.where(psv[2 * B:] > 0, psv[B:2 * B],
                                         0.0), initial=0.0))
            if best is None or peak > best_peak:
                best, best_peak, best_baud = (r, psv), peak, baud
        msgs = self._assemble(*best)
        return (msgs, best_baud) if return_baud else msgs

    def _readback(self, r: PocsagBatches) -> np.ndarray:
        """One packed (3B,) host read of position/score/valid."""
        return torch.cat([r.position.to(real_dtype), r.score,
                          r.valid.to(real_dtype)]).cpu().numpy()

    def _assemble(self, r: PocsagBatches,
                  psv: Optional[np.ndarray] = None) -> List[PocsagMessage]:
        """Walk validated codewords in transmission order (parity: the
        reference's declared callback yielding POCSAGMessage records)."""
        if psv is None:
            psv = self._readback(r)
        B = self.cfg.max_batches
        pos = psv[:B].astype(np.int64)
        # one more host read: the bits and the codeword flags together
        bo = torch.cat([r.bits.reshape(B, -1),
                        r.cw_ok.to(torch.int8)], -1).cpu().numpy()
        bits = bo[:, :_BATCH_CW * _CW_BITS].reshape(B, _BATCH_CW, _CW_BITS)
        ok = bo[:, _BATCH_CW * _CW_BITS:] > 0
        val = psv[2 * B:] > 0
        order = [k for k in np.argsort(pos, kind="stable") if val[k]]
        msgs: List[PocsagMessage] = []
        cur: Optional[Tuple[int, int]] = None   # (ric, function)
        data_bits: List[int] = []

        def flush():
            nonlocal cur, data_bits
            if cur is not None:
                ric, fn = cur
                msgs.append(PocsagMessage(
                    ric=ric, function=fn,
                    text=_decode_text(data_bits, fn)))
            cur, data_bits = None, []

        for k in order:
            for f in range(_BATCH_CW):
                if not ok[k, f]:
                    flush()
                    continue
                w = bits[k, f]
                word = 0
                for b in w:
                    word = (word << 1) | int(b)
                if w[0] == 0:                       # address / idle
                    flush()
                    if word == IDLE:
                        continue
                    # RIC = 18 transmitted address bits << 3 | frame index
                    addr18 = (word >> 13) & 0x3FFFF
                    fn = (word >> 11) & 3
                    cur = ((addr18 << 3) | (f // 2), fn)
                else:                               # message
                    if cur is not None:
                        data_bits += [int(b) for b in w[1:21]]
        flush()
        return msgs


def _decode_text(data_bits: List[int], function: int) -> str:
    """Message payload: alpha (7-bit ASCII, LSB transmitted first) for
    function 3, numeric (4-bit BCD) for functions 0-2."""
    if not data_bits:
        return ""
    if function == 3:
        out = []
        for i in range(0, len(data_bits) - 6, 7):
            v = sum(b << k for k, b in enumerate(data_bits[i:i + 7]))
            if v == 0:
                break
            out.append(chr(v))
        return "".join(out).rstrip("\x04\x17")
    out = []
    for i in range(0, len(data_bits) - 3, 4):
        v = sum(b << k for k, b in enumerate(data_bits[i:i + 4]))
        out.append(_NUMCHARS[v])
    # trailing SPACE nibbles are codeword padding (see pocsag_encode)
    return "".join(out).rstrip(" ")
