"""The frame receiver's ops and detector in the port against the JAX
package on the CPU, on the same numpy inputs: the OLA cost model and plan,
the FFT passes kernel #9 is built from, ``MovingAverage``, the quadrature
discriminator, ``OlaFft``, kernel #9's and #10's plain versions and the
``Detector`` on its three engines.

Tolerances and why:

* exact: ``ola_complexity(_optimize)`` and ``ola_plan`` (host arithmetic
  copied as is), the state of #9's plain version continued block by block
  (a slice of the input), and detections split over block sizes (the
  carried state is the whole streaming state).
* 1e-6 of the peak: #9's plain output continued block by block against
  one shot, and #10's plain planes of a (C, n) batch against one channel
  (the same windows, but the CPU's FFT and convolution round a batch of
  other size in another order; on the card each window is its own block
  and tests/test_torch_cuda.py holds the kernel's continuation exact).
* 1e-6: ``MovingAverage`` relative to the running sum's magnitude (a
  float32 cumsum difference: XLA and PyTorch sum the prefix in other
  orders, and its rounding scales with the running total, not with the
  window's mean) and the discriminator (one ``angle`` of a product).
* 1e-5 of the peak: ``OlaFft`` against JAX's "xla" engine, #9's plain
  version against a float64 ``np.convolve`` (the JAX gate of
  tests/test_pallas.py:148), the numpy model of the kernel's FFT passes
  against ``np.fft``: float32 FFTs in other butterfly orders.
* #10's plain version and the ``Detector`` against JAX, the gates of
  tests/test_detfront.py:36-42: valid masks and positions equal, score
  within 5e-4, gain and theta within 1e-3 (the JAX fused engine computes
  in bf16 hi/lo "split", ~1e-5; the port's engines in fp32).

The file's one Pallas-interpreter call is JAX's ``DetFront`` at M = 128,
n = 8192.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.models import demod as DMj
from libtsd_tpu.models import detector as DETj
from libtsd_tpu.ops import fft as FFj
from libtsd_tpu.ops import filter_rt as FRj
from libtsd_tpu.ops.pallas import detfront as DFj
from libtsd_tpu.ops.pallas import ola as OLj
from libtsd_tpu_torch.models import demod as DMt
from libtsd_tpu_torch.models import detector as DETt
from libtsd_tpu_torch.ops import fft as FFt
from libtsd_tpu_torch.ops import filter_rt as FRt
from libtsd_tpu_torch.ops.kernels import detfront as DFt
from libtsd_tpu_torch.ops.kernels import ola as OLt

CPU = "cpu"


def rel(a, b):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _sig(n, rng, pat, places, lead=()):
    """Noise 0.05 per dimension with g e^{i theta} pattern copies."""
    x = (0.05 * cplx(rng, *lead, n)).astype(np.complex64)
    for pos, g, th in places:
        x[..., pos:pos + len(pat)] += (g * np.exp(1j * th) * pat
                                       ).astype(np.complex64)
    return x


# ------------------------------------------------------ OLA plan and FFT


@pytest.mark.parametrize("M", [1, 2, 48, 88, 128, 255, 1000, 5000])
def test_ola_complexity_exact(M):
    assert FFt.ola_complexity_optimize(M) == FFj.ola_complexity_optimize(M)
    for Ne in (1, 100, 4000):
        assert FFt.ola_complexity(M, Ne) == FFj.ola_complexity(M, Ne)


def test_ola_plan_exact():
    for K in (1, 2, 48, 128, 129, 300, 1000, 2000, 16000):
        for Nf in (None, 256, 4096, 16384):
            try:
                want = OLj.ola_plan(K, Nf)
            except ValueError:
                with pytest.raises(ValueError, match="too long"):
                    OLt.ola_plan(K, Nf)
                continue
            assert OLt.ola_plan(K, Nf) == want


def _fft_bin(log2n):
    """Bin held by each position of fft_forward's output (its mixed-radix
    digit reversal: one first pass of radix 2, 4 or 8 when log2n is not a
    multiple of 4, then radix 16), as fft_bin in csrc/fft_smem.cuh."""
    p = np.arange(1 << log2n)
    b = np.zeros_like(p)
    rem, shift = log2n, 0
    rb = (log2n & 3) or 4
    while rem > 0:
        rem -= rb
        b += (p >> rem) << shift
        p = p & ((1 << rem) - 1)
        shift += rb
        rb = 4
    return b


def _fft_model(x, transposed):
    """numpy model of csrc/fft_smem.cuh: fft_forward (each pass an R-point
    DFT then twiddles; the remainder radix first) or fft_forward_t (the
    transposed passes in reverse order, twiddles first)."""
    n = x.shape[-1]
    L = n.bit_length() - 1
    rb = L & 3
    passes = ([(rb, L)] if rb else []) + [(4, m) for m in
                                           range(L - rb, 3, -4)]
    if transposed:
        passes = passes[::-1]
    buf = x.astype(np.complex128).copy()
    for LR, log2m in passes:
        R, lq = 1 << LR, log2m - LR
        c = np.arange(1 << (L - LR))
        t = c & ((1 << lq) - 1)
        idx = (((c >> lq) << log2m) + t)[:, None] + (np.arange(R) << lq)
        e = (t[:, None] * np.arange(R)) << (L - log2m)
        w = np.exp(-2j * np.pi * e / n)
        v = buf[idx]
        v = np.fft.fft(v * w, axis=-1) if transposed else \
            np.fft.fft(v, axis=-1) * w
        buf[idx] = v
    return buf


@pytest.mark.parametrize("L", [4, 5, 6, 7, 8, 12, 13, 14])
def test_fft_passes_and_transpose(L):
    """fft_forward leaves bin fft_bin(p) at position p; fft_forward_t takes
    that position order back to natural order, so #9's inverse
    conj(F_t(conj(Y H))) / Nf needs no permuting pass."""
    rng = np.random.default_rng(L)
    x = cplx(rng, 1 << L).astype(np.complex128)
    perm = _fft_bin(L)
    X = np.fft.fft(x)
    assert rel(_fft_model(x, False), X[perm]) < 1e-12
    assert rel(_fft_model(X[perm], True), np.fft.fft(X)) < 1e-12
    y = np.conj(_fft_model(np.conj(X[perm]), True)) / (1 << L)
    assert rel(y, x) < 1e-12


# ---------------------------------------------------- filters and demod


@pytest.mark.parametrize("K", [1, 7, 128])
def test_moving_average_matches_jax(K):
    rng = np.random.default_rng(K)
    x = rng.standard_normal((2, 900)).astype(np.float32) ** 2
    mj = FRj.MovingAverage(K=K)
    mt = FRt.MovingAverage(K, device=CPU)
    sj, st = mj.init_for(jnp.asarray(x)), mt.init_for(torch.as_tensor(x))
    for a, b in ((0, 500), (500, 900)):
        sj, yj = mj.step(sj, jnp.asarray(x[:, a:b]))
        st, yt = mt.step(st, torch.as_tensor(x[:, a:b]))
        run = np.abs(x[:, max(a - K + 1, 0):b]).sum(-1).max()
        assert np.abs(yt.numpy() - np.asarray(yj)).max() * K / run < 1e-6
        assert np.array_equal(st.numpy(), np.asarray(sj))
    assert mt.init().shape == (K - 1,) and mt.delay == (K - 1) / 2


def test_quadrature_discriminator_matches_jax():
    rng = np.random.default_rng(2)
    x = cplx(rng, 3, 500)
    assert rel(DMt.quadrature_discriminator(torch.as_tensor(x)),
               DMj.quadrature_discriminator(jnp.asarray(x))) < 1e-6
    p = cplx(rng, 3, 1)
    assert rel(DMt.quadrature_discriminator(torch.as_tensor(x),
                                            torch.as_tensor(p)),
               DMj.quadrature_discriminator(jnp.asarray(x),
                                            jnp.asarray(p))) < 1e-6


@pytest.mark.parametrize("complex_x", [False, True])
@pytest.mark.parametrize("complex_taps", [False, True])
def test_olafft_torch_engine_matches_jax_xla(complex_taps, complex_x):
    """OlaFft "torch" against JAX "xla", streaming in two halves (the
    carried state is the overlap-add output residue)."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal(60)
    if complex_taps:
        h = h + 1j * rng.standard_normal(60)
    bj = FRj.OlaFft.create(h)
    bt = FRt.OlaFft.create(h, device=CPU)
    assert (bt.Ne, bt.Nf, bt.tail_state) == (bj.Ne, bj.Nf, bj.tail_state)
    x = cplx(rng, 2, 4 * bt.Ne) if complex_x else \
        rng.standard_normal((2, 4 * bt.Ne)).astype(np.float32)
    sj, st = bj.init_for(jnp.asarray(x)), bt.init_for(torch.as_tensor(x))
    for half in (x[:, :2 * bt.Ne], x[:, 2 * bt.Ne:]):
        sj, yj = bj.step(sj, jnp.asarray(half))
        st, yt = bt.step(st, torch.as_tensor(half))
        assert yt.is_complex() == np.iscomplexobj(np.asarray(yj))
        assert rel(yt, yj) < 1e-5
    assert rel(st, sj) < 1e-5
    y = FRt.filter_signal(h, torch.as_tensor(x[0]), mode="fft")
    assert rel(y, FRj.filter_signal(h, jnp.asarray(x[0]), mode="fft")) < 1e-5


def test_olafft_cuda_engine_plan_and_names():
    """The "cuda" engine takes kernel #9's plan (a requested Ne is the
    least hop), carries the last V inputs and equals one-shot FIR
    filtering; the JAX engine names raise, naming the port's."""
    h = np.random.default_rng(4).standard_normal(200)
    bj = FRj.OlaFft.create(h, engine="pallas")
    bt = FRt.OlaFft.create(h, engine="cuda", device=CPU)
    assert (bt.Nf, bt.Ne, bt.tail_state) == (bj.Nf, bj.Ne, True)
    bj2 = FRj.OlaFft.create(h, Ne=1000, engine="pallas")
    bt2 = FRt.OlaFft.create(h, Ne=1000, engine="cuda", device=CPU)
    assert (bt2.Nf, bt2.Ne) == (bj2.Nf, bj2.Ne)
    assert bt.init().shape == tuple(bj.init().shape)
    for name, port in (("xla", "torch"), ("pallas", "cuda")):
        with pytest.raises(ValueError, match=port):
            FRt.OlaFft.create(h, engine=name, device=CPU)
    x = np.random.default_rng(5).standard_normal(3 * bt.Ne).astype(
        np.float32)
    _, y = bt.step(bt.init(), torch.as_tensor(x))
    assert not y.is_complex()
    ref = np.convolve(x.astype(np.float64), h)[:len(x)]
    assert rel(y, ref) < 1e-5


# ------------------------------------------------- #9's plain version


@pytest.mark.parametrize("complex_taps", [False, True])
@pytest.mark.parametrize("K,Nf", [(201, None), (129, 256), (1000, 16384)])
def test_ola_plain_matches_direct_form(K, Nf, complex_taps):
    """ola_filter (plain on the CPU) against float64 np.convolve, and a
    stream continued in blocks equal to one shot."""
    rng = np.random.default_rng(K)
    h = rng.standard_normal(K)
    if complex_taps:
        h = h + 1j * rng.standard_normal(K)
    x = cplx(rng, 2, 5000)
    y = OLt.ola_filter(torch.as_tensor(x), h, Nf=Nf)
    ref = np.stack([np.convolve(r.astype(np.complex128), h)[:5000]
                    for r in x])
    assert rel(y, ref) < 1e-5
    Nf, Ne, V = OLt.ola_plan(K, Nf)
    xs = torch.as_tensor(cplx(rng, 2, 4 * Ne))
    H = OLt.freq_response(h, Nf, CPU)
    st0 = torch.zeros(2, V, dtype=torch.complex64)
    y1, st = OLt.ola_stream(xs[:, :Ne], st0, H, K, Nf)
    y2, st = OLt.ola_stream(xs[:, Ne:], st, H, K, Nf)
    yo, sto = OLt.ola_stream(xs, st0, H, K, Nf)
    assert rel(torch.cat([y1, y2], -1), yo.numpy()) < 1e-6
    assert torch.equal(st, sto) and torch.equal(st, xs[:, -V:])


# ------------------------------------------------ #10's plain version


def test_detfront_plain_matches_jax_interpret():
    """#10's plain version against JAX's DetFront in interpret mode
    (M = 128, n = 8192, a carried state), and the detector gates on the
    planes' score."""
    rng = np.random.default_rng(10)
    M, n = 128, 8192
    pat = cplx(rng, M)
    taps = np.conj(pat[::-1]) / np.linalg.norm(pat)
    x = _sig(n, rng, pat, [(1000, 1.0, 0.3), (5000, 0.8, -0.4)])
    st0 = cplx(rng, 128)
    fj = DFj.DetFront.create(taps)
    ft = DFt.DetFront.create(taps, device=CPU)
    assert (ft.M, ft.D, ft.V) == (fj.M, fj.D, fj.V)
    sj, pj = fj.step(jnp.asarray(st0), jnp.asarray(x), interpret=True)
    stt, pt = ft.step(torch.as_tensor(st0), torch.as_tensor(x))
    assert rel(stt, sj) == 0
    for a, b in zip(pt[:3], pj[:3]):
        assert rel(a, b) < 1e-4
    assert np.abs(pt[3].numpy() - np.asarray(pj[3])).max() < 5e-4
    # the same planes as a (C, n) batch
    stb, pb = ft.step(torch.as_tensor(np.stack([st0, st0])),
                      torch.as_tensor(np.stack([x, x])))
    for a, b in zip(pb, pt):
        assert rel(a[0], b.numpy()) < 1e-6 and rel(a[1], b.numpy()) < 1e-6


def test_detfront_plain_against_direct_sums():
    """#10's plain version against the defining sums in float64, at a
    pattern whose energy window spans two context rows (M = 200)."""
    rng = np.random.default_rng(11)
    M, n = 200, 1024
    h = cplx(rng, M)
    ft = DFt.DetFront.create(h, device=CPU)
    x, st = cplx(rng, 2, n), cplx(rng, 2, ft.V)
    cr, ci, en, sc = DFt.detfront(torch.as_tensor(x), torch.as_tensor(st),
                                  ft.taps, M)
    xx = np.concatenate([st, x], -1).astype(np.complex128)
    c = np.stack([np.convolve(r, h)[ft.V:ft.V + n] for r in xx])
    e = np.stack([np.convolve(np.abs(r) ** 2, np.ones(M))[ft.V:ft.V + n]
                  for r in xx])
    assert rel(torch.complex(cr, ci), c) < 1e-5
    assert rel(en, e) < 1e-5
    assert rel(sc, np.abs(c) / np.sqrt(e)) < 1e-5
    with pytest.raises(ValueError, match="multiple of 128"):
        ft.step(ft.init(), torch.zeros(100, dtype=torch.complex64))


# ------------------------------------------------------------ Detector


ENGINES = ["torch", "cuda", "cuda-fused"]


@pytest.mark.parametrize("M", [128, 88, 48])
def test_detector_engines_match_jax_xla(M):
    """Every engine (plain versions on the CPU), on two channels at once,
    against JAX's "xla" detector run channel by channel."""
    rng = np.random.default_rng(M)
    pat = cplx(rng, M)
    x = np.stack([_sig(8192, rng, pat, [(1200, 0.9, 0.5),
                                        (5000 + 3 * c, 1.1, -0.8)])
                  for c in range(2)])
    cfg = dict(threshold=0.5, max_peaks=6)
    refs = [DETj.detect_pattern(jnp.asarray(r), pat,
                                DETj.DetectorConfig(**cfg)) for r in x]
    for eng in ENGINES:
        d, s = DETt.detect_pattern(torch.as_tensor(x), pat,
                                   DETt.DetectorConfig(engine=eng, **cfg))
        for c, (dj, sj) in enumerate(refs):
            vj = np.asarray(dj.valid)
            assert np.array_equal(d.valid[c].numpy(), vj)
            assert vj.sum() == 2
            assert np.array_equal(d.position[c].numpy(),
                                  np.asarray(dj.position))
            assert np.abs(s[c].numpy() - np.asarray(sj)).max() < 5e-4
            for f in ("gain", "theta"):
                a = getattr(d, f)[c].numpy()[vj]
                assert np.abs(a - np.asarray(getattr(dj, f))[vj]).max() < 1e-3


@pytest.mark.parametrize("engine", ENGINES)
def test_detector_split_invariance(engine):
    """Feeding one signal in different block splits gives the same
    detections (tests/test_detfront.py:45-74 for every engine)."""
    rng = np.random.default_rng(7)
    M = 256
    pat = cplx(rng, M)
    det = DETt.Detector.create(pat, DETt.DetectorConfig(threshold=0.5,
                                                        engine=engine),
                               device=CPU)
    Ne = det.Ne
    n = 6 * Ne
    x = _sig(n, rng, pat, [(Ne // 3, 1.0, 0.3), (2 * Ne + 100, 0.8, -0.4),
                           (4 * Ne - M // 2, 1.2, 1.0)])

    def run(block):
        st, out = det.init(), []
        for off in range(0, n, block):
            st, (d, _) = det.step(st, torch.as_tensor(x[off:off + block]))
            out += [int(p) + off for p, v in zip(d.position.tolist(),
                                                 d.valid.tolist()) if v]
        return sorted(out)

    a = run(n)
    assert a == run(Ne) == run(3 * Ne)
    assert len(a) == 3


def test_detector_short_blocks_and_rif_match_jax():
    """Blocks with fewer segments than max_peaks keep the JAX package's
    behaviour (ROADMAP.md: the zero pad read at detector.py:320), and the
    direct-form ("rif") mode matches JAX's."""
    rng = np.random.default_rng(12)
    M = 48
    pat = cplx(rng, M)
    x = _sig(1792, rng, pat, [(100, 1.0, 0.2), (600, 0.9, 1.0),
                              (1300, 1.1, -0.5)])
    for mode, engine, blk in (("ola", "torch", 256), ("rif", "torch", 256)):
        cfg = dict(threshold=0.5, max_peaks=8, mode=mode)
        dj = DETj.Detector.create(pat, DETj.DetectorConfig(**cfg))
        dt = DETt.Detector.create(pat, DETt.DetectorConfig(engine=engine,
                                                           **cfg),
                                  device=CPU)
        if mode == "ola":
            blk = dt.Ne
        sj, st = dj.init(), dt.init()
        for off in range(0, len(x) - blk + 1, blk):
            sj, (a, scj) = dj.step(sj, jnp.asarray(x[off:off + blk]))
            st, (b, sct) = dt.step(st, torch.as_tensor(x[off:off + blk]))
            assert np.array_equal(b.valid.numpy(), np.asarray(a.valid))
            v = np.asarray(a.valid)
            assert np.array_equal(b.position.numpy()[v],
                                  np.asarray(a.position)[v])
            assert np.abs(sct.numpy() - np.asarray(scj)).max() < 5e-4
            for k in ("m", "pe", "ok_left"):
                assert np.array_equal(st["seg_prev"][k].numpy(),
                                      np.asarray(sj["seg_prev"][k])) or \
                    k == "m"


def test_detector_config_errors_and_callback():
    pat = cplx(np.random.default_rng(1), 128)
    for name, port in (("xla", "torch"), ("pallas", "cuda"),
                       ("fused", "cuda-fused")):
        with pytest.raises(ValueError, match=port):
            DETt.Detector.create(pat, DETt.DetectorConfig(engine=name),
                                 device=CPU)
    with pytest.raises(ValueError, match="conflicts"):
        DETt.Detector.create(pat, DETt.DetectorConfig(mode="rif",
                                                      engine="cuda-fused"),
                             device=CPU)
    with pytest.raises(ValueError, match="multiple of 128"):
        DETt.Detector.create(pat, DETt.DetectorConfig(engine="cuda-fused",
                                                      Ne=1000), device=CPU)
    det = DETt.Detector.create(pat, DETt.DetectorConfig(
        engine="cuda-fused", Ne=2048), device=CPU)
    assert det.Ne == 2048
    rng = np.random.default_rng(3)
    x = _sig(6000, rng, pat, [(4000, 1.0, 0.1), (700, 0.8, -1.0)])
    cfg = dict(threshold=0.5)
    got, want = [], []
    DETt.detect_with_callback(torch.as_tensor(x), pat, got.append,
                              DETt.DetectorConfig(**cfg))
    DETj.detect_with_callback(jnp.asarray(x), pat, want.append,
                              DETj.DetectorConfig(**cfg))
    assert [d["position"] for d in got] == [d["position"] for d in want]
    assert [d["position"] for d in got] == sorted(d["position"] for d in got)
    for a, b in zip(got, want):
        assert abs(a["gain"] - b["gain"]) < 1e-3
        assert abs(a["score"] - b["score"]) < 5e-4
    assert [f.name for f in dataclasses.fields(DETt.Detection)] == \
        [f.name for f in dataclasses.fields(DETj.Detection)]


@pytest.mark.parametrize("engine", ENGINES)
def test_g2_det_golden(engine):
    """The reference binary's detection (tests/golden/g2_det*) on every
    engine, with the gates of tests/test_golden_ref2.py:290-310: the
    position exact, position + fraction within 0.01, score, gain and theta
    within 1e-3, SNR within 0.2 dB."""
    import os
    gold = os.path.join(os.path.dirname(__file__), "golden")
    g = lambda n: np.load(os.path.join(gold, n + ".npy"))
    det, _ = DETt.detect_pattern(
        torch.as_tensor(g("g2_det_x")), g("g2_det_motif"),
        DETt.DetectorConfig(threshold=0.4, Ne=1024, engine=engine))
    v = det.valid.numpy()
    assert v.sum() == 1
    i = int(np.argmax(v))
    ref = g("g2_det")    # [pos, pos_frac, score, gain, theta, snr_db]
    pos = float(det.position[i])
    assert pos == ref[0]
    assert abs(pos + float(det.position_frac[i]) - ref[1]) < 0.01
    for k, f in enumerate(("score", "gain", "theta"), start=2):
        assert abs(float(getattr(det, f)[i]) - ref[k]) < 1e-3
    assert abs(float(det.snr_db[i]) - ref[5]) < 0.2
