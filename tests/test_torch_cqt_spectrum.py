"""The port's real-time spectrum analyser (ops.spectrum) and constant-Q
transform (ops.cqt, psd.periodogram_cqt) against the JAX package on the
same numpy inputs, on the CPU, and the reference binary's round-4 sweep
golden and round-6 CQT golden through the port.

Tolerances: spectra and CQT magnitudes within 1e-5 of the JAX output's
peak, in linear power (both sides fp32, other FFT and summation orders;
the dB values of masked bins sit at -300 dB, where a ratio says nothing);
``cqt_stream``'s times and valid masks, and the host-side kernel banks
(copies), exactly; the goldens with the JAX tests' own gates
(tests/test_golden_ref4.py:149-180: 0.01 dB above the floor;
tests/test_golden_ref6.py:26-62: the localisation and profile gates).
One jitted JAX ``cqt_stream`` call serves the file (a module fixture)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.ops import cqt as Qj, spectrum as Sj
from libtsd_tpu_torch.ops import cqt as Qt, psd as Pt, spectrum as St
from libtsd_tpu_torch.utils.convert import rt_spectrum_from_jax
from torch_compare import rel

GOLD = os.path.join(os.path.dirname(__file__), "golden")
TOL = 1e-5


def g(name):
    return np.load(os.path.join(GOLD, name + ".npy"))


def _lin(db):
    return 10.0 ** (np.asarray(db, np.float64) / 10)


# ------------------------------------------------------------ RtSpectrum

@pytest.mark.parametrize("cfg", [
    dict(N=256, navg=4),
    dict(N=256, navg=2, window="hm", mask_hf=4, mask_bf=3),
    dict(N=128, navg=3, nsubs=4, sweep_step=32, mask_hf=8, mask_bf=4),
    dict(N=128, navg=1, nsubs=3, sweep_step=200),   # spans that do not meet
])
@pytest.mark.parametrize("cplx", [False, True])
def test_rt_spectrum_streams_as_jax(cfg, cplx):
    """Three chained steps over 2 channels, the block built through the
    converter, held step by step to JAX's."""
    cfg_j = Sj.SpectrumConfig(**cfg)
    bj = Sj.RtSpectrum.create(cfg_j)
    bt = rt_spectrum_from_jax(bj, device="cpu")
    assert dataclasses.asdict(bt.cfg) == dataclasses.asdict(cfg_j)
    bc = St.RtSpectrum.create(St.SpectrumConfig(**cfg), device="cpu")
    for k in ("win", "mask", "cnt"):
        assert rel(getattr(bc, k), np.asarray(getattr(bj, k))) < 1e-7
    rng = np.random.default_rng(1)
    n = 2 * cfg_j.nsubs * cfg_j.N
    sj, st = bj.init(), bt.init()
    for _ in range(3):
        x = rng.standard_normal((2, n))
        if cplx:
            x = x + 1j * rng.standard_normal((2, n))
        x = x.astype(np.complex64 if cplx else np.float32)
        sj, dj = bj.step(sj, jnp.asarray(x))
        st, dt = bt.step(st, torch.as_tensor(x))
        assert dt.shape == tuple(dj.shape) == (2, cfg_j.Ns)
        assert rel(st, sj) < TOL
        assert rel(_lin(dt.numpy()), _lin(dj)) < TOL


def test_rt_spectrum_rejects_partial_block():
    bt = St.RtSpectrum.create(St.SpectrumConfig(N=64, nsubs=2,
                                                sweep_step=16), device="cpu")
    with pytest.raises(ValueError):
        bt.step(bt.init(), torch.zeros(64))


def test_g4_rt_spectrum_sweep_through_port():
    """The composite sweep against the reference binary, as
    tests/test_golden_ref4.py:149-180 holds JAX's (its known constant
    offset, 10 log10(N nsubs) dB, removed)."""
    sizes = g("g4_spec_sizes")
    Nf, Ns = int(sizes[0]), int(sizes[1])
    cfg = St.SpectrumConfig(N=Nf, navg=1, nsubs=4, sweep_step=128,
                            mask_hf=8, mask_bf=4)
    assert cfg.Ns == Ns
    sp = St.RtSpectrum.create(cfg, device="cpu")
    x = torch.cat([torch.as_tensor(g("g4_spec_x1")),
                   torch.as_tensor(g("g4_spec_x2"))])
    _, db = sp.step(sp.init(), x)
    ref = g("g4_spec_y")
    ours = db.numpy() - 10 * np.log10(cfg.N * cfg.nsubs)
    m = ref > ref.max() - 80
    assert m.sum() > 150
    assert np.abs(ours[m] - ref[m]).max() < 0.01


# ------------------------------------------------------------ dense CQT

def test_cqt_kernels_are_copies():
    a, b = Qj.cqt_kernel(0.01, 0.3, 12), Qt.cqt_kernel(0.01, 0.3, 12)
    for f in ("bank_re", "bank_im", "freqs", "lengths"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert np.array_equal(Qj.cqt_freqs(0.01, 0.3, 24),
                          Qt.cqt_freqs(0.01, 0.3, 24))
    a = Qj.cqt_stream_kernel(0.01, 0.25, 2 ** (1 / 6))
    b = Qt.cqt_stream_kernel(0.01, 0.25, 2 ** (1 / 6))
    for f in dataclasses.fields(a):
        assert np.array_equal(getattr(a, f.name), getattr(b, f.name)), f


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("hop", [256, 100])
def test_cqt_matches_jax(cplx, hop):
    K = Qj.cqt_kernel(0.02, 0.4, 12)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(3000)
    if cplx:
        x = x + 1j * rng.standard_normal(3000)
    x = x.astype(np.complex64 if cplx else np.float32)
    rj = Qj.cqt(jnp.asarray(x), K, hop)
    rt = Qt.cqt(torch.as_tensor(x), Qt.cqt_kernel(0.02, 0.4, 12), hop)
    assert rt.shape == tuple(rj.shape)
    assert rel(rt, rj) < TOL


# ------------------------------------------------------- streaming CQT

@pytest.fixture(scope="module")
def stream_case():
    """The round-6 golden's two-tone input through ONE jitted JAX
    cqt_stream, and the port's on the same input."""
    x = g("g6_cqt_x")
    Kj = Qj.cqt_stream_kernel(0.02, 0.2, 2 ** 0.25, Q=34.0, kprec=0.99,
                              window="hm")
    Kt = Qt.cqt_stream_kernel(0.02, 0.2, 2 ** 0.25, Q=34.0, kprec=0.99,
                              window="hm")
    rj = jax.jit(lambda v: Qj.cqt_stream(v, Kj))(jnp.asarray(x))
    rt = Qt.cqt_stream(torch.as_tensor(x), Kt)
    return x, Kj, Kt, [np.asarray(a) for a in rj], rt


def test_cqt_stream_matches_jax_element_by_element(stream_case):
    _, _, _, (tj, mj, vj), (tt, mt, vt) = stream_case
    assert tt.shape == tj.shape and mt.shape == mj.shape
    assert tt.dtype == torch.int32 and vt.dtype == torch.bool
    assert np.array_equal(tt.numpy(), tj)
    assert np.array_equal(vt.numpy(), vj)
    assert rel(mt, mj) < TOL
    assert not mt.numpy()[~vj].any()          # invalid slots are zeros
    # the host interpolation (a copy) on the same inputs: equal
    Kj, Kt = stream_case[1], stream_case[2]
    for a, b in zip(Qt.cqt_interpolate(tj, mj, vj, Kt, 200),
                    Qj.cqt_interpolate(tj, mj, vj, Kj, 200)):
        assert np.array_equal(a, b)


def test_cqt_stream_phase_schedule_is_the_scans():
    """The host recurrence gives the scan's kphase carry: replay the scan's
    integer update literally over a few blocks of every bin."""
    K = Qt.cqt_stream_kernel(0.01, 0.25, 2 ** (1 / 6))
    N, hop = K.N, K.N // 2
    dt = np.maximum(K.ktime // 2, 1)
    kp = np.full(len(K.ktime), hop)
    got = Qt._stream_phases(K, 9)
    for b in range(9):
        assert np.array_equal(got[b], kp)
        pos = kp[:, None] + np.arange(K.Mmax)[None, :] * dt[:, None]
        nev = np.sum(pos + K.ktime[:, None] <= N, axis=1)
        kp = kp + nev * dt - hop


def test_cqt_stream_rejects_bad_length():
    K = Qt.cqt_stream_kernel(0.02, 0.2, 2 ** 0.25)
    with pytest.raises(ValueError):
        Qt.cqt_stream(torch.zeros(K.N // 2 + 1), K)


def test_periodogram_cqt_matches_jax_interpolation(stream_case):
    """periodogram_cqt at fs 1 is the stream's interpolation at hop 256:
    held to JAX's cqt_interpolate of JAX's stream outputs."""
    x, Kj, _, (tj, mj, vj), _ = stream_case
    gj, fj, Aj = Qj.cqt_interpolate(tj, mj, vj, Kj, 256)
    t, f, A = Pt.periodogram_cqt(torch.as_tensor(x), 1.0, 0.02, 0.2,
                                 2 ** 0.25)
    assert np.array_equal(t, gj) and np.array_equal(f, fj)
    assert A.shape == Aj.shape
    assert rel(A, Aj) < TOL


def test_g6_cqt_behaviour_through_port(stream_case):
    """The port's CQT against the reference binary, with the gates of
    tests/test_golden_ref6.py:26-62."""
    x = stream_case[0]
    dims = g("g6_cqt_dims").astype(int)
    B = g("g6_cqt_A").reshape(dims[0], dims[1])
    _, f, A = Pt.periodogram_cqt(torch.as_tensor(x), 1.0, 0.02, 0.2,
                                 2 ** 0.25)
    assert len(f) == dims[1]
    assert np.abs(f - g("g6_cqt_freqs")).max() < 1e-6
    nr = min(A.shape[0], B.shape[0])
    a, b = A[4:nr - 4], B[4:nr - 4]
    assert np.mean(np.argmax(a, axis=1) == 5) > 0.85
    pa, pb = a.mean(0), b.mean(0)
    assert pa[10] > pa[9] * 1.2 and pa[10] > pa[11] * 1.2
    pa, pb = pa / np.linalg.norm(pa), pb / np.linalg.norm(pb)
    assert float(pa @ pb) > 0.8


def test_periodogram_cqt_pads_and_rejects_complex():
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(5000)
                        .astype(np.float32))
    t, f, A = Pt.periodogram_cqt(x, 8000.0, 200.0, 2000.0, ofs=100.0)
    assert A.shape == (len(t), len(f)) and np.isfinite(A).all()
    assert np.allclose(np.diff(t), 0.01)
    with pytest.raises(ValueError):
        Pt.periodogram_cqt(x.to(torch.complex64), 8000.0, 200.0, 2000.0)
