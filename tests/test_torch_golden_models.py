"""The reference-binary goldens of the modules ported here, read from
tests/golden/ through the port (no JAX call), at the JAX tests' own
tolerances: tests/test_golden_ref2.py (Levinson, LPC),
tests/test_golden_ref3.py (MLS/Barker, Kalman, subspace spectra,
Matzner, Shannon, geometry, date/time), tests/test_golden_ref4.py (LMS
trajectories, dispersive channel, MDL), tests/test_golden_ref5.py (DSSS,
the ECP's deterministic path) and tests/test_golden_ref7.py (WAV).  Each
case cites the JAX test it mirrors.

Also here: no module of the port imports jax or the JAX package."""
import ast
import os
import pathlib

import numpy as np
import pytest
import torch

import torch_compare  # noqa: F401  (thread caps)

GOLD = os.path.join(os.path.dirname(__file__), "golden")
CPU = "cpu"


def g(name):
    return np.load(os.path.join(GOLD, name + ".npy"))


def _gold_path(name):
    p = os.path.join(GOLD, name)
    if not os.path.exists(p):
        pytest.skip(f"golden {name} not generated")
    return p


# ---------------------------------------------------- ref2: LPC/Levinson

def test_levinson_matches_reference():
    """test_golden_ref2.py:260"""
    from libtsd_tpu_torch.models.stats import levinson_real
    r = np.array([1.0, 0.5, 0.2, 0.05, -0.01, 0.003])
    assert np.abs(levinson_real(r) - g("g2_levinson")).max() < 1e-6


def test_lpc_composite_matches_reference():
    """test_golden_ref2.py:266: unbiased xcorr lags 0..7 -> levinson."""
    from libtsd_tpu_torch.models.stats import levinson_real
    from libtsd_tpu_torch.ops.corr import xcorr
    x = torch.as_tensor(g("g2_lpc_x"))
    _, cr = xcorr(x, x, 8)
    r = np.real(cr.numpy()[7:])
    a = levinson_real(r)
    ref = g("g2_lpc_a")
    assert a.shape == ref.shape
    assert np.abs(a - ref).max() < 0.05
    xs = x.numpy().astype(np.float64)

    def perr(c):
        return np.std(np.convolve(xs, c)[8:-8])
    assert perr(a) < 0.06 * np.std(xs)
    assert abs(perr(a) - perr(ref)) < 0.02 * np.std(xs)


# ---------------------------------------------------- ref3

@pytest.mark.parametrize("reglen", [5, 7])
def test_mls_codes_match_reference(reglen):
    """test_golden_ref3.py:45"""
    from libtsd_tpu_torch.models.lfsr import mls_code
    ref = g(f"g3_mls{reglen}")
    ours = mls_code(reglen, device=CPU).numpy().astype(np.float32)
    assert ours.shape == ref.shape and np.array_equal(ours, ref)


@pytest.mark.parametrize("n", [11, 13])
def test_barker_codes_match_reference(n):
    """test_golden_ref3.py:54"""
    from libtsd_tpu_torch.models.lfsr import barker_code
    ours = barker_code(n, device=CPU).numpy()
    assert np.array_equal((ours + 1) / 2, g(f"g3_barker{n}"))


def test_kalman_random_walk_matches_reference():
    """test_golden_ref3.py:64"""
    from libtsd_tpu_torch.models.kalman import LinearSSM, kalman_filter
    ssm = LinearSSM(A=np.eye(1), C=np.eye(1), Q=0.01 * np.eye(1),
                    R=0.5 * np.eye(1))
    y = g("g3_kalman_y")
    xs, _ = kalman_filter(ssm, torch.as_tensor(y[:, None]), x0=np.zeros(1),
                          P0=np.eye(1))
    assert np.abs(xs[:, 0].numpy() - g("g3_kalman_xh")).max() < 1e-5


def test_kalman_steady_gain_matches_reference():
    """test_golden_ref3.py:76"""
    from libtsd_tpu_torch.models.kalman import LinearSSM, kalman_steady_gain
    ssm = LinearSSM(A=np.eye(1), C=np.eye(1), Q=0.01 * np.eye(1),
                    R=0.5 * np.eye(1))
    K = kalman_steady_gain(ssm)
    assert abs(float(K[0, 0]) - float(g("g3_kalman_ssg")[0])) < 1e-5


def test_subspace_spectrum_matches_reference():
    """test_golden_ref3.py:87"""
    from libtsd_tpu_torch.models.stats import subspace_spectrum
    R = torch.as_tensor(g("g3_music_R").reshape(8, 8))
    _, S = subspace_spectrum(R, 2, 512)
    ref = g("g3_music_spectrum")
    S = S.numpy()
    assert np.argmax(S) == np.argmax(ref)
    assert np.abs(S - ref).max() < 0.2


def test_psd_subspace_matches_reference():
    """test_golden_ref3.py:100"""
    from libtsd_tpu_torch.models.stats import psd_subspace
    _, S = psd_subspace(torch.as_tensor(g("g3_psdss_x")), 2, 512, 16)
    ref = g("g3_psdss")
    S = S.numpy()
    assert np.argmax(S) == np.argmax(ref)
    assert np.abs(S - ref).max() < 0.2


def test_matzner_streaming_matches_reference():
    """test_golden_ref3.py:113: NaN positions exact, values to 1e-4."""
    from libtsd_tpu_torch.models.snr import MatznerTracker
    x = torch.as_tensor(g("g3_matzner_x"))
    tr = MatznerTracker(0.1, device=CPU)
    _, (S, N) = tr.step(tr.init(), x)
    S, N = S.numpy(), N.numpy()
    refS, refN = g("g3_matzner_S"), g("g3_matzner_N")
    assert np.array_equal(np.isnan(S), np.isnan(refS))
    assert np.isnan(S[:3]).all() and not np.isnan(S[16:]).any()
    m = ~np.isnan(refS)
    assert np.abs(S[m] - refS[m]).max() < 1e-4
    assert np.abs(N[m] - refN[m]).max() < 1e-4


def test_shannon_capacity_matches_reference():
    """test_golden_ref3.py:155"""
    from libtsd_tpu_torch.models.channel import shannon_capacity
    for snr_lin, r in zip((0.1, 1.0, 10.0, 100.0), g("g3_capacity")):
        assert abs(shannon_capacity(10 * np.log10(snr_lin), 1.0)
                   - float(r)) < 1e-5


def test_cardan_quaternion_roundtrip_matches_reference():
    """test_golden_ref3.py:165"""
    from libtsd_tpu_torch.utils import geometry as geo
    R = geo.cardan_to_rotmat(0.3, -0.5, 1.2, device=CPU)
    ref_R = g("g3_rotmat").reshape(3, 3)
    assert np.abs(R.numpy() - ref_R).max() < 1e-5
    q = geo.rotmat_to_quat(R).numpy()
    ref_q = g("g3_quat")
    if ref_q[0] * q[0] < 0:
        q = -q
    assert np.abs(q - ref_q).max() < 1e-5
    phi, th, psi = geo.quat_to_cardan(torch.as_tensor(q))
    assert np.abs(np.array([float(phi), float(th), float(psi)])
                  - g("g3_cardan_rt")).max() < 1e-5
    p2, t2, s2 = geo.rotmat_to_cardan(torch.as_tensor(ref_R))
    assert np.abs(np.array([float(p2), float(t2), float(s2)])
                  - np.array([0.3, -0.5, 1.2])).max() < 1e-5


def test_datetime_j2000_and_sidereal_match_reference():
    """test_golden_ref3.py:191"""
    from libtsd_tpu_torch.utils.timedate import (gregorian_to_jd, j2000,
                                                 local_sidereal_time,
                                                 sidereal_time)
    ref = g("g3_time")
    jd1 = gregorian_to_jd(2021, 2, 8 + 12 / 24)
    jd2 = gregorian_to_jd(2000, 1, 1 + (18 + 30 / 60 + 15 / 3600) / 24)
    assert abs(j2000(2021, 2, 8 + 12 / 24) - ref[0]) < 1e-6
    assert abs(j2000(2000, 1, 1 + (18 + 30 / 60 + 15 / 3600) / 24)
               - ref[1]) < 1e-6
    assert abs(sidereal_time(jd1) - ref[2]) < 1e-5
    assert abs(sidereal_time(jd2) - ref[3]) < 1e-5
    assert abs(local_sidereal_time(jd1, np.rad2deg(2.3488)) - ref[4]) < 1e-4


# ---------------------------------------------------- ref4

@pytest.mark.parametrize("name,structure,errf,alpha,n2", [
    ("g4_eq_ffe_dec", "ffe", "dec", 0.01, 11),
    ("g4_eq_ffe_cma", "ffe", "cma", 0.002, 11),
    ("g4_eq_dfe_dec", "dfe", "dec", 0.01, 7),
])
def test_equalizer_trajectory_matches_reference(name, structure, errf,
                                                alpha, n2):
    """test_golden_ref4.py:63: ref_mode trajectories within 1e-3."""
    from libtsd_tpu_torch.models import waveform as WF
    from libtsd_tpu_torch.models.equalizer import LmsEqualizer
    wf = WF.wf_qpsk(WF.PulseShape.nrz(), device=CPU)
    eq = LmsEqualizer(wf, structure=structure, errf=errf, K=1, alpha=alpha,
                      N1=11, N2=n2, ref_mode=True)
    _, (y, _, _) = eq.step(eq.init(), torch.as_tensor(g("g4_eq_x")))
    assert np.abs(y.numpy() - g(name)).max() < 1e-3


def _doppler_bw(h, fe, frac=0.9):
    H = np.abs(np.fft.fftshift(np.fft.fft(h - h.mean()))) ** 2
    f = np.fft.fftshift(np.fft.fftfreq(len(h), 1.0 / fe))
    c = np.cumsum(H) / H.sum()
    return (f[np.searchsorted(c, 1 - (1 - frac) / 2)]
            - f[np.searchsorted(c, (1 - frac) / 2)])


def test_dispersive_rayleigh_stats_match_reference():
    """test_golden_ref4.py:110"""
    from libtsd_tpu_torch.models.channel import dispersive_channel
    fd, fe = 50.0, 10000.0
    ref = g("g4_disp_y")
    ours = dispersive_channel(torch.Generator().manual_seed(5),
                              torch.ones(len(ref), dtype=torch.complex64),
                              fd, fe).numpy()
    for h in (ref, ours):
        p2 = np.mean(np.abs(h) ** 2)
        p4 = np.mean(np.abs(h) ** 4)
        assert abs(p4 / p2 ** 2 - 2.0) < 0.45
        bw = _doppler_bw(h, fe)
        assert 0.3 * fd < bw < 2.4 * fd


def test_dispersive_rice_stats_match_reference():
    """test_golden_ref4.py:131"""
    from libtsd_tpu_torch.models.channel import dispersive_channel
    ref = g("g4_disp_rice_y")
    ours = dispersive_channel(torch.Generator().manual_seed(6),
                              torch.ones(len(ref), dtype=torch.complex64),
                              50.0, 10000.0, rice_factor=4.0).numpy()

    def gamma(h):
        p = np.abs(h) ** 2
        return p.var() / p.mean() ** 2
    assert abs(gamma(ours) - (1 + 2 * 4.0) / (1 + 4.0) ** 2) < 0.15
    ray = g("g4_disp_y")
    assert gamma(ref) < 0.75 < gamma(ray) * 1.5


def test_mdl_auto_selection_matches_reference():
    """test_golden_ref4.py:183"""
    from libtsd_tpu_torch.models.stats import mdl_criterion, subspace_spectrum
    R = g("g4_mdl_R").reshape(8, 8)
    ns_ref = int(g("g4_mdl_ns")[0])
    _, ns = mdl_criterion(R)
    assert ns == ns_ref
    _, S = subspace_spectrum(torch.as_tensor(R), ns_ref, 256)
    ref = g("g4_mdl_spectrum")
    S = S.numpy()
    assert np.argmax(S) == np.argmax(ref)
    assert np.abs(S - ref).max() < 0.2


# ---------------------------------------------------- ref5

def test_dsss_matches_reference():
    """test_golden_ref5.py:99"""
    from libtsd_tpu_torch.models.spread import dsss_modulate
    chips = g("g5_dsss_chips")
    y = dsss_modulate(torch.as_tensor(g("g5_dsss_x")), chips,
                      osf_in=int(chips.shape[0]))
    assert np.abs(y.numpy() - g("g5_dsss_y")).max() < 1e-6


def test_ecp_deterministic_path_matches_reference():
    """test_golden_ref5.py:108: Eb/N0 200 dB, sigma ~ 1e-10."""
    from libtsd_tpu_torch.models.channel import (ChannelConfig,
                                                 propagation_channel)
    cfg = ChannelConfig(fe=1.0, fsymb=0.25, fbit=0.25, Eb_N0=200.0,
                        freq_offset=0.01, phase_offset=0.7, clock_delay=0.0)
    y = propagation_channel(torch.Generator().manual_seed(0),
                            torch.as_tensor(g("g5_ecp_x")), cfg)
    assert np.abs(y.numpy() - g("g5_ecp_y")).max() < 1e-4


# ---------------------------------------------------- ref7: WAV

def test_wav_load_reference_files():
    """test_golden_ref7.py:35-64: the reference's float32 mono/stereo and
    PCM16 files load through the port's copy."""
    from libtsd_tpu_torch.utils.wav import wav_load
    x, rate = wav_load(_gold_path("g7_ref_mono_f32.wav"))
    assert rate == 16000 and np.array_equal(x, g("g7_ref_mono"))
    x, rate = wav_load(_gold_path("g7_ref_stereo_f32.wav"))
    assert rate == 22050 and x.shape == (len(g("g7_ref_stereo_l")), 2)
    assert np.array_equal(x[:, 0], g("g7_ref_stereo_l"))
    assert np.array_equal(x[:, 1], g("g7_ref_stereo_r"))
    x, rate = wav_load(_gold_path("g7_ref_mono_i16.wav"))
    assert rate == 8000
    assert np.array_equal(np.round(x * 32768.0), g("g7_ref_mono_i16"))


def test_wav_committed_files_and_readbacks(tmp_path):
    """test_golden_ref7.py:67-87: the committed g7_ours_*.wav are the
    recipe and the reference read them back; the port's writer makes
    files that load as the committed ones do."""
    from libtsd_tpu_torch.utils.wav import wav_load, wav_save
    n = 1024
    i = np.arange(n)
    x16 = (0.8 * np.sin(2 * np.pi * 0.01 * i)).astype(np.float32)
    xf = (0.5 * np.cos(2 * np.pi * 0.017 * i)).astype(np.float32)
    q = np.clip(x16 * 32767.0, -32768, 32767).astype(np.int16)
    assert np.array_equal(g("g7_ours_i16_readback"), q.astype(np.float32))
    assert np.array_equal(g("g7_ours_f32_readback"), xf)
    a, ra = wav_load(_gold_path("g7_ours_i16.wav"))
    b, rb = wav_load(_gold_path("g7_ours_f32.wav"))
    assert ra == 8000 and rb == 16000
    assert np.array_equal(a, q.astype(np.float32) / 32768.0)
    assert np.array_equal(b, xf)
    for x, rate, dt, name in ((x16, 8000, "int16", "g7_ours_i16.wav"),
                              (xf, 16000, "float32", "g7_ours_f32.wav")):
        wav_save(str(tmp_path / "t.wav"), x, rate, dtype=dt)
        back, r = wav_load(str(tmp_path / "t.wav"))
        ref, rr = wav_load(_gold_path(name))
        assert r == rr and np.array_equal(back, ref)


# ---------------------------------------------------- the port stands alone

def test_port_imports_no_jax():
    """No module of libtsd_tpu_torch, nor chip_smoke.py, imports jax,
    flax or the JAX package (read from the source, not by importing)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "libtsd_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 60
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "libtsd_tpu"):
                    bad.append(f"{f.relative_to(root)}: {n}")
    assert bad == []
