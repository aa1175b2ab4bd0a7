"""The port's ADS-B and POCSAG decoders (models.adsb, models.pocsag)
against the JAX package on the same numpy inputs, on the CPU: the cases of
tests/test_protocols.py, each through both packages.

Tolerances: CRC and BCH tables, waveforms and encoders bit for bit;
decoded bits, positions, CRC flags, RICs, functions, texts and detected
bauds exactly; the device results of a block (candidate positions, bits,
flags) exactly; the sync scores within 1e-5; the preamble scores within
1e-6 of float64 numpy and within 1e-4 of JAX's (the port sums its sliding
windows from a float64 cumulative sum, the JAX package from a float32 one,
whose rounding reaches ~5e-5 of a score on 2^14 samples of unit noise).

The POCSAG sync pick is JAX's: the first index of the flat normalised-score
plateau (libtsd_tpu/models/pocsag.py:278-300), which lies ~half a bit
before the bit centres, so that the bit decisions sit near the bit
boundaries and noise flips bits there; ``test_pocsag_plateau_edge_as_in_jax``
holds the port to JAX on a capture where that loses codewords."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.models import adsb as Aj
from libtsd_tpu.models import pocsag as Pj
from libtsd_tpu.models.demod import quadrature_discriminator as qd_j
from libtsd_tpu_torch.models import adsb as At
from libtsd_tpu_torch.models import pocsag as Pt

import torch_compare  # noqa: F401  (thread caps)

CPU = "cpu"
IDENT = "8D4840D6202CC371C32CE0576098"
POS_EVEN = "8D40621D58C382D690C8AC2863A7"
POS_ODD = "8D40621D58C386435CC412692AD6"


def _hexbits(h: str) -> np.ndarray:
    v = int(h, 16)
    n = 4 * len(h)
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.int8)


def _same_frames(ft, fj):
    assert len(ft) == len(fj)
    for a, b in zip(ft, fj):
        assert (a.position, a.text, a.crc_ok) == (b.position, b.text,
                                                  b.crc_ok)
        assert np.array_equal(a.bits, b.bits)
        assert abs(a.score - b.score) < 1e-5


def _score64(x, p, osf):
    """The preamble score at start p in float64: the 4 pulses' half-slot
    energy over the 8-us window's (above the block's mean floor)."""
    x = np.asarray(x, np.float64)
    hs = osf // 2
    corr = sum(x[p + q * hs:p + (q + 1) * hs].sum() for q in (0, 2, 7, 9))
    return corr / (x[p:p + 8 * osf].sum() + 1e-9)


def _same_decode(dt, dj, x=None, osf=2):
    for f in ("position", "bits", "crc_ok", "valid"):
        assert np.array_equal(getattr(dt, f).numpy(),
                              np.asarray(getattr(dj, f))), f
    assert np.abs(dt.score.numpy() - np.asarray(dj.score)).max() < 1e-4
    if x is not None:
        xs = np.asarray(x).reshape(-1, np.shape(x)[-1])
        pos = dt.position.numpy().reshape(len(xs), -1)
        sc = dt.score.numpy().reshape(len(xs), -1)
        ok = dt.valid.numpy().reshape(len(xs), -1)
        for c in range(len(xs)):
            for k in np.flatnonzero(ok[c]):
                assert abs(sc[c, k] - _score64(xs[c], pos[c, k], osf)) < 1e-6


# ------------------------------------------------------------ ADS-B, host

def test_crc24_waveform_text_cpr_host_copies():
    for h in (IDENT, POS_EVEN, POS_ODD):
        b = _hexbits(h)
        assert At.adsb_crc(b).sum() == 0
        assert np.array_equal(At.adsb_crc(b[:56]), Aj.adsb_crc(b[:56]))
        assert At.decode_adsb_text(b) == Aj.decode_adsb_text(b)
        for osf in (2, 4, 6):
            assert np.array_equal(At.adsb_waveform(b, osf),
                                  Aj.adsb_waveform(b, osf))
    b = _hexbits(IDENT)
    b[37] ^= 1
    assert At.adsb_crc(b).sum() != 0
    assert np.array_equal(At._H112, Aj._H112)
    be, bo = _hexbits(POS_EVEN), _hexbits(POS_ODD)
    args = (At._field(be, 54, 71), At._field(be, 71, 88),
            At._field(bo, 54, 71), At._field(bo, 71, 88))
    for newest_odd in (False, True):
        p = At.cpr_global(*args, newest_odd=newest_odd)
        assert p == Aj.cpr_global(*args, newest_odd=newest_odd)
    lat, lon = At.cpr_global(*args, newest_odd=False)
    assert abs(lat - 52.2572) < 2e-3 and abs(lon - 3.91937) < 2e-3


# ------------------------------------------------------------ ADS-B

def test_adsb_loopback_decode():
    rng = np.random.default_rng(7)
    osf = 4
    kw = dict(fe=osf * 1e6, Ne=1 << 14, threshold=0.55, max_frames=8)
    x = 0.02 * np.abs(rng.standard_normal(1 << 14)).astype(np.float32)
    frames = {3000: IDENT, 8000: POS_EVEN, 12000: POS_ODD}
    for pos, h in frames.items():
        wf = At.adsb_waveform(_hexbits(h), osf=osf)
        x[pos:pos + len(wf)] += 0.9 * wf
    dt = At.AdsbDecoder(At.AdsbConfig(**kw), device=CPU)
    dj = Aj.AdsbDecoder(Aj.AdsbConfig(**kw))
    got = dt.decode(x)
    _same_frames(got, dj.decode(x))
    _same_frames(dt.decode(torch.as_tensor(x)), got)
    assert [f.position for f in got] == sorted(frames)
    assert "ident KLM1023" in got[0].text and "alt 38000 ft" in got[1].text
    _same_decode(dt.decode_block(torch.as_tensor(x)),
                 dj.decode_block(jnp.asarray(x)), x, osf)
    # complex IQ: the magnitude is decoded
    z = (x * np.exp(1j * rng.uniform(0, 6.3, len(x)))).astype(np.complex64)
    _same_frames(dt.decode(z), dj.decode(z))
    with pytest.raises(ValueError):
        dt.decode_block(torch.zeros(100))


def test_adsb_noise_and_overlap_rejection():
    rng = np.random.default_rng(3)
    dt = At.AdsbDecoder(At.AdsbConfig(fe=2e6, max_frames=8), device=CPU)
    dj = Aj.AdsbDecoder(Aj.AdsbConfig(fe=2e6, max_frames=8))
    x = np.abs(rng.standard_normal(1 << 14)).astype(np.float32)
    assert dt.decode(x) == [] == dj.decode(x)
    _same_decode(dt.decode_block(torch.as_tensor(x)),
                 dj.decode_block(jnp.asarray(x)), x)
    b = _hexbits(IDENT)
    b[40] ^= 1
    wf = At.adsb_waveform(b, osf=2)
    x = 0.01 * np.abs(rng.standard_normal(4096)).astype(np.float32)
    x[500:500 + len(wf)] += wf
    assert dt.decode(x, crc_filter=True) == []
    got = dt.decode(x, crc_filter=False)
    _same_frames(got, dj.decode(x, crc_filter=False))
    assert any(abs(f.position - 500) <= 1 for f in got)
    assert not any(f.crc_ok for f in got)


def _stream(mod, cfg, x, sizes, device=None):
    st = (mod.AdsbStream(cfg, device=device) if device
          else mod.AdsbStream(cfg))
    got, i = [], 0
    for sz in sizes:
        got += st.push(x[i:i + sz])
        i += sz
    got += st.push(x[i:])
    return got + st.flush()


def test_adsb_streaming_across_boundaries():
    rng = np.random.default_rng(11)
    Ne = 4096
    x = 0.02 * np.abs(rng.standard_normal(20000)).astype(np.float32)
    wf = At.adsb_waveform(_hexbits(IDENT), osf=2)
    positions = [1000, Ne - len(wf) // 2, 3 * Ne // 2 + 700, 19000]
    for p in positions:
        x[p:p + len(wf)] += 0.8 * wf
    sizes = [1111, 2048, 5000, 3333, 4096, 4096, 4096]
    kw = dict(fe=2e6, Ne=Ne, max_frames=8)
    got = _stream(At, At.AdsbConfig(**kw), x, sizes, device=CPU)
    _same_frames(got, _stream(Aj, Aj.AdsbConfig(**kw), x, sizes))
    assert sorted(f.position for f in got) == positions


def test_adsb_streaming_osf4_boundary_gap():
    """tests/test_protocols.py:179: at osf 4 a frame starting in the
    last hs - 1 positions of a block is masked there and must come from
    the next, overlapped block (adsb.py:186-193's bound)."""
    rng = np.random.default_rng(13)
    osf, Ne = 4, 4096
    wf = At.adsb_waveform(_hexbits(IDENT), osf=osf)
    start = Ne - len(wf)
    x = 0.02 * np.abs(rng.standard_normal(2 * Ne)).astype(np.float32)
    x[start:start + len(wf)] += 0.9 * wf
    kw = dict(fe=osf * 1e6, Ne=Ne, max_frames=8)
    st = At.AdsbStream(At.AdsbConfig(**kw), device=CPU)
    got = st.push(torch.as_tensor(x)) + st.flush()
    sj = Aj.AdsbStream(Aj.AdsbConfig(**kw))
    _same_frames(got, sj.push(x) + sj.flush())
    assert [f.position for f in got] == [start]
    # the mask on the block itself: start is the last unmasked position
    # + 1 in block 1, which JAX and the port both leave out
    dt = At.AdsbDecoder(At.AdsbConfig(**kw), device=CPU)
    dj = Aj.AdsbDecoder(Aj.AdsbConfig(**kw))
    _same_decode(dt.decode_block(torch.as_tensor(x[:Ne])),
                 dj.decode_block(jnp.asarray(x[:Ne])), x[:Ne], osf)


@pytest.mark.parametrize("C,osf", [(4, 2), (3, 4)])
def test_adsb_batched_channels_against_vmap(C, osf):
    """decode_block on (C, n) against jax.vmap(_decode_block): every
    candidate's position, bits and flags, the scores within 1e-5."""
    rng = np.random.default_rng(2)
    kw = dict(fe=osf * 1e6, Ne=8192, max_frames=4)
    wf = At.adsb_waveform(_hexbits(IDENT), osf=osf)
    x = 0.02 * np.abs(rng.standard_normal((C, 8192))).astype(np.float32)
    pos = [700, 1500, 2500, 4000][:C]
    for c in range(C):
        x[c, pos[c]:pos[c] + len(wf)] += 0.9 * wf
    dj = Aj.AdsbDecoder(Aj.AdsbConfig(**kw))
    ref = jax.jit(jax.vmap(dj._decode_block))(jnp.asarray(x))
    dt = At.AdsbDecoder(At.AdsbConfig(**kw), device=CPU)
    got = dt.decode_block(torch.as_tensor(x))
    _same_decode(got, ref, x, osf)
    ok = got.valid & got.crc_ok
    for c in range(C):
        assert got.position[c][ok[c]].tolist() == [pos[c]]
    # a (2, C, n) batch: each slice as its own call
    x2 = np.stack([x, x[::-1].copy()])
    g2 = dt.decode_block(torch.as_tensor(x2))
    for b in range(2):
        gb = dt.decode_block(torch.as_tensor(x2[b]))
        assert torch.equal(g2.position[b], gb.position)
        assert torch.equal(g2.bits[b], gb.bits)


# ------------------------------------------------------------ POCSAG, host

def test_pocsag_bch_encoder_waveform_host_copies():
    for w in (Pt.FSC, Pt.IDLE):
        assert Pt.bch3121_encode(w >> 11) == w
    for k in range(32):
        assert Pt.bch3121_encode((Pt.FSC ^ (1 << k)) >> 11) != Pt.FSC ^ (
            1 << k)
    assert np.array_equal(Pt._SYN, Pj._SYN)
    for args in ((0x12345, 3, "HELLO TPU", False), (77, 0, "911", True),
                 (0x3FFFD, 3, "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG",
                  False)):
        bt = Pt.pocsag_encode(*args)
        assert np.array_equal(bt, Pj.pocsag_encode(*args))
        for baud in (512, 1200):
            assert np.array_equal(
                Pt.pocsag_waveform(bt, 38400.0, baud, fi=1000.0),
                Pj.pocsag_waveform(bt, 38400.0, baud, fi=1000.0))
    d = [1, 0, 0, 1, 0, 1, 1] * 6
    for fn in (0, 3):
        assert Pt._decode_text(d, fn) == Pj._decode_text(d, fn)


# ------------------------------------------------------------ POCSAG

def _both(x, **cfg):
    mt, bt = Pt.PocsagDecoder(Pt.PocsagConfig(**cfg), device=CPU).decode(
        x, return_baud=True)
    mj, bj = Pj.PocsagDecoder(Pj.PocsagConfig(**cfg)).decode(
        x, return_baud=True)
    assert _msgs(mt) == _msgs(mj) and bt == bj
    return mt, bt


def _msgs(ms):
    return [(m.ric, m.function, m.text) for m in ms]


@pytest.mark.parametrize("baud,auto", [(1200, True), (512, False),
                                       (2400, False)])
def test_pocsag_loopback(baud, auto):
    fe = 38400.0
    bits = Pt.pocsag_encode(ric=0x12345, function=3, text="HELLO TPU")
    x = Pt.pocsag_waveform(bits, fe=fe, debit=baud, fi=0.0)
    rng = np.random.default_rng(1)
    x = x + 0.05 * (rng.standard_normal(len(x))
                    + 1j * rng.standard_normal(len(x))).astype(np.complex64)
    msgs, got_baud = _both(x, fe=fe, debit=-1 if auto else baud)
    assert got_baud == baud and len(msgs) == 1
    assert (msgs[0].ric, msgs[0].function) == (0x12345, 3)
    assert msgs[0].text.startswith("HELLO TPU")
    # the device scan itself, on the same discriminator output
    dt = Pt.PocsagDecoder(Pt.PocsagConfig(fe=fe), device=CPU)
    dj = Pj.PocsagDecoder(Pj.PocsagConfig(fe=fe))
    d = np.asarray(qd_j(jnp.asarray(x)))
    rt = dt._scan(torch.as_tensor(d), baud)
    rj = dj.scan(jnp.asarray(d), baud)
    for f in ("position", "bits", "cw_ok", "valid"):
        assert np.array_equal(getattr(rt, f).numpy(),
                              np.asarray(getattr(rj, f))), f
    assert np.abs(rt.score.numpy() - np.asarray(rj.score)).max() < 1e-5


def test_pocsag_numeric_offset_carrier_and_padding():
    fe, fi, baud = 48000.0, 4000.0, 1200
    bits = Pt.pocsag_encode(ric=1234567, function=0, text="0123 456-789",
                            numeric=True)
    x = Pt.pocsag_waveform(bits, fe=fe, debit=baud, fi=fi)
    msgs, _ = _both(x, fe=fe, fi=fi, debit=baud)
    assert len(msgs) == 1 and msgs[0].ric == 1234567
    assert msgs[0].text.startswith("0123 456-789")
    # the discriminated baseband as a real input
    d = Pt.PocsagDecoder(Pt.PocsagConfig(fe=fe, fi=fi), device=CPU)._front(
        torch.as_tensor(x))
    assert _msgs(Pt.PocsagDecoder(Pt.PocsagConfig(fe=fe, debit=baud),
                                  device=CPU).decode(d)) == _msgs(msgs)
    bits = Pt.pocsag_encode(ric=77, function=0, text="911", numeric=True)
    x = Pt.pocsag_waveform(bits, fe=38400.0, debit=baud)
    msgs, _ = _both(x, fe=38400.0, debit=baud)
    assert len(msgs) == 1 and msgs[0].text == "911"


@pytest.mark.parametrize("flips,ok", [([7], True), ([3, 19], True),
                                      ([31], True), ([7, 31], True),
                                      ([3, 19, 27], False)])
def test_pocsag_error_correction(flips, ok):
    """Single, double, parity-bit and data+parity errors corrected; three
    errors never accepted as the sent text."""
    fe, baud = 38400.0, 1200
    base = 576 + 32 + 5 * 32          # first message codeword (frame 2)
    bits = Pt.pocsag_encode(ric=42, function=3, text="BCH OK").copy()
    for k in flips:
        bits[base + k] ^= 1
    msgs, _ = _both(Pt.pocsag_waveform(bits, fe=fe, debit=baud), fe=fe,
                    debit=baud)
    good = bool(msgs) and msgs[0].text.startswith("BCH OK")
    assert good == ok


def test_pocsag_message_spans_batches_and_noise():
    fe, baud = 38400.0, 1200
    text = "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG 0123456789"
    bits = Pt.pocsag_encode(ric=0x3FFFD, function=3, text=text)
    msgs, _ = _both(Pt.pocsag_waveform(bits, fe=fe, debit=baud), fe=fe,
                    debit=baud)
    assert len(msgs) == 1 and msgs[0].text.startswith(text)
    bits = Pt.pocsag_encode(ric=99, function=3, text="NOISY")
    x0 = Pt.pocsag_waveform(bits, fe=fe, debit=baud)
    rng = np.random.default_rng(5)
    nz = rng.standard_normal(len(x0)) + 1j * rng.standard_normal(len(x0))
    msgs, _ = _both(x0 + 0.35 * nz.astype(np.complex64), fe=fe, debit=baud)
    assert len(msgs) == 1 and msgs[0].text.startswith("NOISY")


def test_pocsag_several_pages_and_inverted_polarity():
    """Two transmissions back to back (two RICs, alpha and numeric) in one
    signal, and the same signal with the FSK sense inverted (both
    packages resolve the polarity from the sync score)."""
    fe, baud = 38400.0, 2400
    b1 = Pt.pocsag_encode(ric=1000, function=3, text="FIRST PAGE")
    b2 = Pt.pocsag_encode(ric=2001, function=1, text="5551234",
                          numeric=True)
    x = np.concatenate([Pt.pocsag_waveform(b1, fe, baud),
                        Pt.pocsag_waveform(b2, fe, baud)])
    msgs, _ = _both(x, fe=fe, debit=baud)
    assert [(m.ric, m.function) for m in msgs] == [(1000, 3), (2001, 1)]
    assert msgs[0].text == "FIRST PAGE" and msgs[1].text == "5551234"
    inv, _ = _both(np.conj(x), fe=fe, debit=baud)
    assert _msgs(inv) == _msgs(msgs)


def _pages_transmission(baud, seconds, rng):
    """One POCSAG transmission of several pages (a 576-bit preamble, then
    batches back to back: each address codeword in its RIC's frame, its
    message codewords after it, an idle word between pages), as a paging
    transmitter sends a queue; returns (bits, pages, batches)."""
    texts = ["CALL DISPATCH 555-0117", "UNIT 12 RESPOND TO STATION 4",
             "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG 0123456789", "OK"]
    nums = ["5551234", "911", "0123 456-789"]
    nb = (int(seconds * baud) - 576) // 544
    cws, pages, i = [], [], 0
    while True:
        ric = int(rng.integers(8, 1 << 21))
        num = i % 3 == 2
        text = nums[i % 3] if num else texts[i % 4]
        fn = int(rng.integers(0, 3)) if num else 3
        one = Pt.pocsag_encode(ric, fn, text, numeric=num, npreamble=0)
        words = [int("".join(map(str, w)), 2)
                 for w in one[32:].reshape(-1, 32)]
        first = 2 * (ric & 7)
        body = [w for w in words[first + 1:] if w >> 31]   # message words
        add = []
        while ((len(cws) + len(add)) % 16) // 2 != (ric & 7):
            add.append(Pt.IDLE)
        add += [words[first]] + body + [Pt.IDLE]
        if len(cws) + len(add) > 16 * nb:
            break
        cws += add
        pages.append((ric, fn, text))
        i += 1
    cws += [Pt.IDLE] * (16 * nb - len(cws))
    out = [np.tile([1, 0], 288).astype(np.int8)]
    for b in range(nb):
        out.append(Pt._word_bits(Pt.FSC))
        out += [Pt._word_bits(w) for w in cws[16 * b:16 * (b + 1)]]
    return np.concatenate(out), pages, nb


def test_pocsag_plateau_edge_as_in_jax():
    """12 batches of pages at 2400 baud, IF noise 0.1 (fe 48 kHz, fi 3
    kHz): on the same discriminator output, the decisions at the plateau's
    first index lose codewords and pages in both packages, the same ones
    (positions, bits and flags exact; the same pages decoded)."""
    fe, fi, baud = 48000.0, 3000.0, 2400
    rng = np.random.default_rng(0)
    bits, pages, nb = _pages_transmission(baud, 3.0, rng)
    z = Pt.pocsag_waveform(bits, fe=fe, debit=baud, fi=fi)
    z = (z + 0.1 * (rng.standard_normal(len(z))
                    + 1j * rng.standard_normal(len(z)))).astype(np.complex64)
    kw = dict(fe=fe, fi=fi, debit=baud, max_batches=nb + 4)
    dt = Pt.PocsagDecoder(Pt.PocsagConfig(**kw), device=CPU)
    dj = Pj.PocsagDecoder(Pj.PocsagConfig(**kw))
    d = dt._front(torch.as_tensor(z))
    rt, rj = dt._scan(d, baud), dj.scan(jnp.asarray(d.numpy()), baud)
    assert int(rt.valid.sum()) == int(np.asarray(rj.valid).sum()) == nb
    for f in ("position", "bits", "cw_ok", "valid"):
        assert np.array_equal(getattr(rt, f).numpy(),
                              np.asarray(getattr(rj, f))), f
    assert (~rt.cw_ok.numpy()[rt.valid.numpy()]).sum() > 0
    got = _msgs(dt.decode(z))
    assert got == _msgs(dj.decode(z)) and got != pages
