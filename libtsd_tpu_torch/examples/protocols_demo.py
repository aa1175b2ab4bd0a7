"""Protocol decoders on the port: ADS-B (Mode S 1090ES), POCSAG paging and
RDS.  The twin of ``examples/protocols_demo.py``.

* ADS-B: three publicly documented DF17 squitters (an aircraft ident and
  an even/odd airborne-position pair) placed in a noisy magnitude stream
  (numpy), pushed through the streaming ``AdsbStream`` in odd-size
  chunks, decoded on the device; the even/odd pair gives a global CPR
  position fix.
* POCSAG: an alphanumeric page FSK-modulated at 1200 baud with a carrier
  offset and AWGN (numpy), decoded on the device with automatic baud
  detection (``debit=-1``).
* RDS: 0A (station name) and 2A (RadioText) groups on the 57 kHz
  subcarrier of a stereo FM multiplex made on the device, decoded through
  the full FM front end by ``rds_decode``.

    python -m libtsd_tpu_torch.examples.protocols_demo [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import device as _device
from ..models import adsb as A
from ..models import pocsag as P

ADSB_FRAMES = {   # documented example squitters (mode-s.org guide)
    4000: "8D4840D6202CC371C32CE0576098",   # ident KLM1023
    9000: "8D40621D58C382D690C8AC2863A7",   # position, even
    15000: "8D40621D58C386435CC412692AD6",  # position, odd
}
POCSAG_PAGE = (1300500, 3, "CALL DISPATCH 555-0117")


def hexbits(h: str) -> np.ndarray:
    v = int(h, 16)
    n = 4 * len(h)
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.int8)


def adsb_stream(osf: int = 2) -> np.ndarray:
    """The magnitude stream at osf MS/s: noise, then the squitters."""
    rng = np.random.default_rng(0)
    x = 0.02 * np.abs(rng.standard_normal(1 << 15)).astype(np.float32)
    for pos, h in ADSB_FRAMES.items():
        wf = A.adsb_waveform(hexbits(h), osf=osf)
        x[pos:pos + len(wf)] += 0.8 * wf
    return x


def adsb_demo(device="cuda") -> tuple:
    """Returns ([AdsbFrame], (lat, lon) or None)."""
    print("== ADS-B ==")
    osf = 2                                     # 2 MS/s capture
    x = adsb_stream(osf)
    sink = A.AdsbStream(A.AdsbConfig(fe=osf * 1e6, Ne=1 << 13),
                        device=device)
    got = []
    i = 0
    while i < len(x):                            # odd-size SDR pushes
        n = int(min(len(x) - i, 3000 + 500 * (i % 3)))
        got += sink.push(x[i:i + n])
        i += n
    cpr = {}
    for fr in got:
        print(f"  @{fr.position:6d} score {fr.score:.2f}  {fr.text}")
        b = fr.bits
        if 9 <= A._field(b, 32, 37) <= 18:
            cpr[int(b[53])] = (A._field(b, 54, 71), A._field(b, 71, 88))
    fix = None
    if len(cpr) == 2:
        fix = A.cpr_global(*cpr[0], *cpr[1], newest_odd=False)
        print(f"  CPR global fix: lat {fix[0]:.5f}  lon {fix[1]:.5f}")
    return got, fix


def pocsag_signal() -> np.ndarray:
    """The page at 1200 baud, fi 3 kHz, fe 48 kHz, IF AWGN 0.25."""
    fe, fi, baud = 48000.0, 3000.0, 1200
    ric, fn, text = POCSAG_PAGE
    bits = P.pocsag_encode(ric=ric, function=fn, text=text)
    z = P.pocsag_waveform(bits, fe=fe, debit=baud, fi=fi)
    rng = np.random.default_rng(1)
    return z + 0.25 * (rng.standard_normal(len(z)) + 1j *
                       rng.standard_normal(len(z))).astype(np.complex64)


def pocsag_demo(device="cuda") -> tuple:
    """Returns ([PocsagMessage], detected baud)."""
    print("== POCSAG ==")
    dec = P.PocsagDecoder(P.PocsagConfig(fe=48000.0, fi=3000.0, debit=-1),
                          device=device)
    msgs, got_baud = dec.decode(pocsag_signal(), return_baud=True)
    print(f"  detected baud: {got_baud}")
    for m in msgs:
        print(f"  RIC {m.ric}  fn {m.function}  text: {m.text!r}")
    return msgs, got_baud


def rds_demo(device="cuda") -> dict:
    """Returns the groups decoded, the clean ones, the PS name and the
    RadioText."""
    print("== RDS ==")
    from ..models import rds as R
    from ..models.analog import fm_broadcast_multiplex
    from ..ops.signal import cycles
    fe = 1.024e6
    pi, pty = 0xF201, 10
    groups = [R.rds_group_0a(pi, pty, s, "TSD TPU!"[2 * s:2 * s + 2])
              for s in range(4)]
    groups += [R.rds_group_2a(pi, pty, a, "TPU NATIVE DSP! "[4 * a:4 * a + 4])
               for a in range(4)]
    bits = R.rds_encode_groups(groups * 3)
    n = int(len(bits) / R._BITRATE * fe) + 65536
    al = 0.3 * torch.sin(2 * np.pi * cycles(440.0 / fe, n, device=device))
    ar = 0.3 * torch.sin(2 * np.pi * cycles(1000.0 / fe, n, device=device))
    x = fm_broadcast_multiplex(al, ar, fe,
                               rds=R.rds_subcarrier(bits, fe, n,
                                                    device=device))
    got = R.rds_decode(x, fe)     # full FM front end + coherent decode
    ok = [g for g in got if g.errors[0] == 0]
    print(f"  groups decoded: {len(got)} ({len(ok)} clean)")
    if ok:
        print(f"  PI: 0x{ok[0].pi:04X}  PTY: {ok[0].pty}")
    else:
        print("  no clean PI block decoded (all groups carry errors)")
    ps, rt = R.rds_station_name(got), R.rds_radiotext(got)
    print(f"  PS name:   {ps!r}")
    print(f"  RadioText: {rt!r}")
    return {"groups": len(got), "clean": len(ok), "ps": ps, "rt": rt,
            "samples": n}


def main(device="cuda") -> dict:
    """The three decoders on ``device``."""
    device = _device(device)
    frames, fix = adsb_demo(device)
    msgs, baud = pocsag_demo(device)
    out = {"adsb": [(int(f.position), f.text, bool(f.crc_ok))
                    for f in frames],
           "cpr": fix and tuple(float(v) for v in fix),
           "pocsag": [(int(m.ric), int(m.function), m.text) for m in msgs],
           "baud": int(baud), "rds": rds_demo(device)}
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
