"""The port's PRBS and codes (models.lfsr), channel models
(models.channel), SNR estimators (models.snr), spreading (models.spread)
and equalizers (models.equalizer) against the JAX package on the same
numpy inputs, on the CPU.

Tolerances: register sequences, codes, error counts and equalizer
decisions exactly; the host copies (``zfe_design``, ``convolution_matrix``,
capacities) within 1e-6; float32 signals (DSSS, FHSS, TranspoBB, the
channel's deterministic path at Eb/N0 200 dB, the SNR estimators) within
1e-5 of the JAX output's peak, NaN masks equal; the LMS trajectories within
1e-4 (an adaptive loop over float32 sums of another order).  Noise cannot
be matched draw for draw (a torch generator is not a JAX key), so it is
held to its formula by its statistics on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.models import channel as CHj
from libtsd_tpu.models import equalizer as EQj
from libtsd_tpu.models import lfsr as Lj
from libtsd_tpu.models import snr as SNj
from libtsd_tpu.models import spread as SPj
from libtsd_tpu.models import waveform as WFj
from libtsd_tpu_torch.models import channel as CHt
from libtsd_tpu_torch.models import equalizer as EQt
from libtsd_tpu_torch.models import lfsr as Lt
from libtsd_tpu_torch.models import snr as SNt
from libtsd_tpu_torch.models import spread as SPt
from libtsd_tpu_torch.models import waveform as WFt
from libtsd_tpu_torch.utils import convert
from torch_compare import rel

CPU = "cpu"
TOL = 1e-5


def _cn(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------ lfsr

@pytest.mark.parametrize("reglen", [3, 5, 7, 9, 11, 13])
def test_lfsr_and_mls_exact(reglen):
    bt = Lt.lfsr_bits(reglen, 700, seed=5, device=CPU)
    assert bt.device.type == "cpu" and bt.dtype == torch.int8
    assert np.array_equal(bt.numpy(), np.asarray(Lj.lfsr_bits(reglen, 700,
                                                               seed=5)))
    mt = Lt.mls_code(reglen, device=CPU)
    assert np.array_equal(mt.numpy(), np.asarray(Lj.mls_code(reglen)))
    assert mt.shape[0] == (1 << reglen) - 1


def test_barker_codes_exact():
    for n in (2, 3, 4, 5, 7, 11, 13):
        assert np.array_equal(Lt.barker_code(n, device=CPU).numpy(),
                              np.asarray(Lj.barker_code(n)))
    with pytest.raises(ValueError):
        Lt.barker_code(6, device=CPU)


@pytest.mark.parametrize("flips", [[], [20], [20, 50, 51, 300, 499]])
def test_prbs_check_exact(flips):
    bits = np.asarray(Lj.lfsr_bits(9, 500, seed=3)).copy()
    bits[flips] ^= 1
    want = Lj.prbs_check(bits, 9)
    assert Lt.prbs_check(torch.as_tensor(bits), 9) == want
    assert Lt.prbs_check(bits, 9, device=CPU) == want
    assert (Lt.prbs_check(bits[:5], 9, device=CPU)
            == Lj.prbs_check(bits[:5], 9))


# ------------------------------------------------------------ spread

@pytest.mark.parametrize("cplx,osf_in", [(False, 1), (True, 1), (True, 2)])
def test_dsss_modulate_demodulate(cplx, osf_in):
    rng = np.random.default_rng(1)
    x = (_cn(rng, 3, 40) if cplx
         else rng.standard_normal((3, 40)).astype(np.float32))
    chips = np.asarray(Lj.mls_code(4), np.float32) * 2 - 1
    chips = np.concatenate([chips, chips[:1]])          # 16 chips
    yj = np.asarray(SPj.dsss_modulate(jnp.asarray(x), chips, osf_in))
    yt = SPt.dsss_modulate(torch.as_tensor(x), chips, osf_in)
    assert rel(yt, yj) < TOL
    zj = np.asarray(SPj.dsss_demodulate(jnp.asarray(yj), chips, osf_in))
    zt = SPt.dsss_demodulate(yt, torch.as_tensor(chips), osf_in)
    assert rel(zt, zj) < TOL


@pytest.mark.parametrize("n,slot,nf", [(4096, 64, 17), (1 << 16, 512, 1021),
                                       (5000, 100, 46340)])
def test_fhss_exact_phase(n, slot, nf):
    rng = np.random.default_rng(2)
    x = _cn(rng, n)
    hop = rng.integers(-3 * nf, 3 * nf, 13).astype(np.int32)
    yj = np.asarray(SPj.fhss_modulate(jnp.asarray(x), jnp.asarray(hop),
                                      slot, nf))
    yt = SPt.fhss_modulate(torch.as_tensor(x), torch.as_tensor(hop), slot,
                           nf)
    assert yt.shape == yj.shape and rel(yt, yj) < TOL
    # float64 phase of the same hops: exact at any length
    m = (n // slot) * slot
    k = np.arange(m)
    hs = np.repeat(np.asarray(hop, np.int64)[np.arange(m // slot) % 13]
                   % nf, slot)
    lo = np.exp(2j * np.pi * ((hs * k) % nf) / nf)
    assert rel(yt, x[:m] * lo) < TOL


def test_fhss_list_hop_seq():
    """The JAX function raises AttributeError on a list hop_seq (it reads
    hop_seq.shape first, libtsd_tpu/models/spread.py:67-68); the port
    converts the list, so this case is held to JAX's result on the same
    hops as an array."""
    rng = np.random.default_rng(4)
    x = _cn(rng, 2048)
    hop = [3, 1, 4, 1, 5, 9, 2, 6]
    with pytest.raises(AttributeError):
        SPj.fhss_modulate(jnp.asarray(x), hop, 128, 16)
    yj = np.asarray(SPj.fhss_modulate(jnp.asarray(x), np.asarray(hop),
                                      128, 16))
    for h in (hop, tuple(hop), np.asarray(hop)):
        assert rel(SPt.fhss_modulate(torch.as_tensor(x), h, 128, 16),
                   yj) < TOL
    with pytest.raises(ValueError):
        SPt.fhss_modulate(torch.as_tensor(x), hop, 128, 46341)


@pytest.mark.parametrize("fi,real_input", [(0.2, True), (0.3, True),
                                           (0.1, False)])
def test_transpo_bb_streamed(fi, real_input):
    """Three blocks with the state carried, the port built on its own and
    from the JAX block, against the JAX block streamed the same way."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(3 * 1000).astype(np.float32) if real_input
         else _cn(rng, 3 * 1000))
    bj = SPj.TranspoBB.create(SPj.TranspoBBConfig(fi=fi, ntaps=63),
                              real_input=real_input)
    sj = bj.init()
    yj = []
    for b in range(3):
        sj, y = bj.step(sj, jnp.asarray(x[b * 1000:(b + 1) * 1000]))
        yj.append(np.asarray(y))
    yj = np.concatenate(yj)
    for bt in (SPt.TranspoBB.create(SPt.TranspoBBConfig(fi=fi, ntaps=63),
                                    real_input=real_input, device=CPU),
               convert.transpo_bb_from_jax(bj, device=CPU)):
        assert bt.delay == bj.delay
        st = bt.init()
        yt = []
        for b in range(3):
            st, y = bt.step(st, torch.as_tensor(x[b * 1000:(b + 1) * 1000]))
            yt.append(y.numpy())
        assert rel(np.concatenate(yt), yj) < TOL
        assert abs(float(st[0]) - float(sj[0])) < 1e-6


def test_transpo_bb_batched():
    """(C, n) input: the filter state takes the channel axis; each
    channel equals its own run."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 800)).astype(np.float32)
    bt = SPt.TranspoBB.create(SPt.TranspoBBConfig(fi=0.2), device=CPU)
    st = bt.init_for(torch.as_tensor(x))
    st, y = bt.step(st, torch.as_tensor(x))
    for c in range(3):
        _, yc = bt.step(bt.init(), torch.as_tensor(x[c]))
        assert rel(y[c], yc) < 1e-6


# ------------------------------------------------------------ channel

def test_propagation_channel_deterministic_path():
    """Eb/N0 200 dB (sigma ~ 1e-10): the frequency and phase offset and
    the fractional clock delay, on (C, n), against JAX and against float64
    numpy of the same formula."""
    rng = np.random.default_rng(7)
    x = _cn(rng, 3, 3000)
    cfg = dict(fe=1.0, fsymb=0.25, fbit=0.25, Eb_N0=200.0,
               freq_offset=0.01, phase_offset=0.7, clock_delay=0.37)
    yj = np.asarray(CHj.propagation_channel(
        jax.random.PRNGKey(0), jnp.asarray(x), CHj.ChannelConfig(**cfg)))
    yt = CHt.propagation_channel(_gen(0), torch.as_tensor(x),
                                 CHt.ChannelConfig(**cfg))
    assert rel(yt, yj) < TOL
    # float64: the ramp, then the delay of the JAX/port formula (FFT of a
    # 2x zero-padded block times a phase ramp)
    z = x * np.exp(1j * (0.7 + 2 * np.pi * 0.01 * np.arange(3000)))
    n, N = 3000, 6000
    zp = np.zeros((3, N), complex)
    zp[:, n // 2:n // 2 + n] = z
    kf = np.fft.fftfreq(N)
    z64 = np.fft.ifft(np.fft.fft(zp) * np.exp(-2j * np.pi * kf * 0.37))[
        :, n // 2:n // 2 + n]
    assert rel(yt, z64) < 1e-5


def test_awgn_level_and_noise_statistics():
    """The level is the RMS over the whole array (channel.py:43); the
    noise per real dimension has the formula's sigma on both sides."""
    rng = np.random.default_rng(8)
    x = _cn(rng, 4, 1 << 14) * np.array([[0.5], [1.0], [2.0], [1.5]],
                                        np.float32)
    level = np.sqrt(np.mean(np.abs(x) ** 2))
    sigma = level * np.sqrt(0.5 * (4 / 2) / 10 ** (10 / 10))
    yt = CHt.awgn(_gen(1), torch.as_tensor(x), 10.0, osf=4,
                  k_bits=2).numpy()
    yj = np.asarray(CHj.awgn(jax.random.PRNGKey(1), jnp.asarray(x), 10.0,
                             osf=4, k_bits=2))
    for y in (yt, yj):
        e = (y - x).reshape(-1)
        for part in (e.real, e.imag):
            assert abs(part.std() / sigma - 1) < 0.02
        # one sigma for every channel, not one per channel
        per = (y - x).std(axis=-1) / np.sqrt(2) / sigma
        assert np.all(np.abs(per - 1) < 0.04)
    r = rng.standard_normal(1 << 15).astype(np.float32)
    er = CHt.awgn(_gen(2), torch.as_tensor(r), 6.0).numpy() - r
    s_r = np.sqrt(np.mean(r ** 2)) * np.sqrt(0.5 / 10 ** 0.6)
    assert abs(er.std() / s_r - 1) < 0.02 and er.dtype == np.float32


def test_propagation_channel_phase_noise_statistics():
    """Phase noise at -20 dBc/Hz, fe 1: the phase walks with steps of std
    sqrt(10^-2), on both sides."""
    x = np.ones(1 << 14, np.complex64)
    cfg = dict(Eb_N0=200.0, phase_noise_db_hz=-20.0)
    yt = CHt.propagation_channel(_gen(3), torch.as_tensor(x),
                                 CHt.ChannelConfig(**cfg)).numpy()
    yj = np.asarray(CHj.propagation_channel(
        jax.random.PRNGKey(3), jnp.asarray(x), CHj.ChannelConfig(**cfg)))
    for y in (yt, yj):
        dphi = np.angle(y[1:] * np.conj(y[:-1]))
        assert abs(dphi.std() / 0.1 - 1) < 0.03


def test_propagation_channel_random_clock_delay():
    """A negative clock_delay draws an integer delay in [0, fe/fsymb) per
    call: the output is the input shifted by that many samples."""
    rng = np.random.default_rng(9)
    x = _cn(rng, 512)
    cfg = CHt.ChannelConfig(Eb_N0=200.0, clock_delay=-1.0)
    y = CHt.propagation_channel(_gen(4), torch.as_tensor(x), cfg).numpy()
    errs = [np.abs(y[d:] - x[:512 - d]).max() for d in range(4)]
    assert min(errs) < 1e-4


def test_dispersive_channel_statistics():
    """Rayleigh: unit power, E|h|^4/(E|h|^2)^2 = 2; Rice K = 4: the LOS
    share gamma = (1 + 2K)/(1 + K)^2; the fading confined to the Doppler
    band; on both sides, each on its own draws."""
    n, fd, fe = 1 << 15, 50.0, 10000.0
    one = np.ones(n, np.complex64)
    for seed in (0, 1):
        ht = CHt.dispersive_channel(_gen(seed), torch.as_tensor(one), fd,
                                    fe).numpy()
        hj = np.asarray(CHj.dispersive_channel(
            jax.random.PRNGKey(seed), jnp.asarray(one), fd, fe))
        for h in (ht, hj):
            p2 = np.mean(np.abs(h) ** 2)
            assert abs(p2 - 1) < 1e-4
            assert abs(np.mean(np.abs(h) ** 4) / p2 ** 2 - 2) < 0.45
            H = np.abs(np.fft.fft(h)) ** 2
            f = np.abs(np.fft.fftfreq(n, 1 / fe))
            assert H[f > 1.05 * fd].sum() < 1e-3 * H.sum()
        rt = CHt.dispersive_channel(_gen(seed), torch.as_tensor(one), fd,
                                    fe, rice_factor=4.0).numpy()
        p = np.abs(rt) ** 2
        assert abs(p.var() / p.mean() ** 2 - 0.36) < 0.15


def test_doppler_psd_capacity_thermal():
    f = np.linspace(-100, 100, 41)
    assert rel(CHt.doppler_psd(f, 50.0, device=CPU),
               np.asarray(CHj.doppler_psd(jnp.asarray(f), 50.0))) < TOL
    for snr in (-10.0, 0.0, 20.0):
        assert CHt.shannon_capacity(snr, 3.0) == CHj.shannon_capacity(snr,
                                                                      3.0)
    assert CHt.thermal_noise_power(1e6) == CHj.thermal_noise_power(1e6)


# ------------------------------------------------------------ snr

def _qpsk_noisy(rng, shape, sigma):
    sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, shape)))
    return (sym + sigma * _cn(rng, *shape)).astype(np.complex64)


def test_block_snr_estimators():
    rng = np.random.default_rng(10)
    x = _qpsk_noisy(rng, (4, 2000), 0.3)
    for ft, fj in ((SNt.snr_matzner, SNj.snr_matzner),
                   (SNt.snr_bpsk_abs, SNj.snr_bpsk_abs)):
        St, Nt = ft(torch.as_tensor(x))
        Sj, Nj = fj(jnp.asarray(x))
        assert rel(St, np.asarray(Sj)) < TOL and rel(Nt, np.asarray(Nj)) < TOL


@pytest.mark.parametrize("clamp,sigma", [(False, 0.3), (False, 3.0),
                                         (True, 3.0)])
def test_matzner_tracker(clamp, sigma):
    """Two blocks on (C, n) with the state carried: the NaN masks equal
    (warm-up; and, at low SNR, wherever the statistic goes negative:
    snr.py:40-56); where finite, S^2 = 2 e2^2 - e4 and S + N = e2 within
    1e-5 of the peak (S itself is the root of a difference that cancels at
    low SNR, where a last-bit difference in e2 or e4 moves it by ~1e-4)."""
    rng = np.random.default_rng(11)
    x = _qpsk_noisy(rng, (3, 1200), sigma)
    tj = SNj.MatznerTracker(0.1, clamp=clamp)
    tt = SNt.MatznerTracker(0.1, clamp=clamp, device=CPU)
    sj, st = tj.init(), tt.init()
    for b in range(2):
        xb = x[:, b * 600:(b + 1) * 600]
        sj, (Sj, Nj) = tj.step(sj, jnp.asarray(xb))
        st, (S, N) = tt.step(st, torch.as_tensor(xb))
        S, N, Sj, Nj = S.numpy(), N.numpy(), np.asarray(Sj), np.asarray(Nj)
        assert np.array_equal(np.isnan(S), np.isnan(Sj))
        assert np.array_equal(np.isnan(N), np.isnan(Nj))
        m = ~np.isnan(Sj)
        for a, ref in ((S[m] ** 2, Sj[m] ** 2), (S[m] + N[m], Sj[m] + Nj[m])):
            assert np.abs(a - ref).max() < TOL * np.abs(ref).max()
    assert clamp or sigma < 1 or np.isnan(S).any()
    # the JAX state carried into the port continues the JAX stream
    st2 = convert.matzner_state_from_jax(sj, device=CPU)
    xb = x[:, :300]
    _, (S2, _) = tt.step(st2, torch.as_tensor(xb))
    _, (S2j, _) = tj.step(sj, jnp.asarray(xb))
    S2, S2j = S2.numpy(), np.asarray(S2j)
    m = ~np.isnan(S2j)
    assert np.array_equal(np.isnan(S2), ~m)
    assert np.abs(S2[m] ** 2 - S2j[m] ** 2).max() < TOL * (S2j[m] ** 2).max()


# ------------------------------------------------------------ equalizer

def _isi_qpsk(n, seed=12, sigma=0.02):
    rng = np.random.default_rng(seed)
    sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n)))
    h = np.array([1.0, 0.35 - 0.2j, 0.12j])
    y = np.convolve(sym, h)[:n] + sigma * _cn(rng, n)
    return sym, y.astype(np.complex64)


EQ_CASES = [("ffe", "dec", 1, False), ("dfe", "dec", 1, False),
            ("ffe", "cma", 1, False), ("dfe", "cma", 1, False),
            ("ffe", "dec", 2, False),
            ("ffe", "dec", 1, True), ("dfe", "dec", 1, True),
            ("ffe", "cma", 1, True), ("dfe", "cma", 1, True)]


@pytest.mark.parametrize("structure,errf,K,ref_mode", EQ_CASES)
def test_lms_equalizer_against_jax(structure, errf, K, ref_mode):
    """Both the default branch and ref_mode: the same decisions and
    activity flags, the output trajectory and the taps within 1e-4; the
    port built on its own and from the JAX equalizer; a cut carried
    through the converted JAX state."""
    _, x = _isi_qpsk(500)
    alpha = 0.01 if errf == "dec" else 0.002
    kw = dict(structure=structure, errf=errf, K=K, alpha=alpha, N1=11,
              N2=7, ref_mode=ref_mode)
    ej = EQj.LmsEqualizer(wf=WFj.wf_qpsk(WFj.PulseShape.nrz()), **kw)
    sj, (yj, errj, actj) = ej.step(ej.init(), jnp.asarray(x))
    syms = np.asarray(ej.wf.symbols)
    dj = np.argmin(np.abs(np.asarray(yj)[:, None] - syms) ** 2, axis=1)
    et = EQt.LmsEqualizer(WFt.wf_qpsk(WFt.PulseShape.nrz(), device=CPU),
                          **kw)
    for eq in (et, convert.lms_equalizer_from_jax(ej, device=CPU)):
        st, (y, err, act) = eq.step(eq.init(), torch.as_tensor(x))
        dt = np.argmin(np.abs(y.numpy()[:, None] - syms) ** 2, axis=1)
        assert np.array_equal(dt, dj)
        assert np.array_equal(act.numpy(), np.asarray(actj))
        assert np.abs(y.numpy() - np.asarray(yj)).max() < 1e-4
        assert np.abs(err.numpy() - np.asarray(errj)).max() < 1e-4
        for k in sj:
            assert np.abs(st[k].numpy() - np.asarray(sj[k])).max() < 1e-4
    # the JAX state after 300 samples, carried into the port
    s300, _ = ej.step(ej.init(), jnp.asarray(x[:300]))
    st = convert.equalizer_state_from_jax(s300, device=CPU)
    _, (y2, _, _) = et.step(st, torch.as_tensor(x[300:]))
    assert np.abs(y2.numpy() - np.asarray(yj)[300:]).max() < 1e-4


def test_lms_equalizer_converges():
    """DFE DEC on a 3-tap ISI channel: no decision error after the first
    200 symbols (decision delay N1 // 2)."""
    sym, x = _isi_qpsk(1200, seed=13)
    eq = EQt.LmsEqualizer(WFt.wf_qpsk(WFt.PulseShape.nrz(), device=CPU),
                          structure="dfe", alpha=0.01, N1=11, N2=7)
    _, (y, _, _) = eq.step(eq.init(), torch.as_tensor(x))
    syms = eq.wf.symbols.numpy()
    dec = syms[np.argmin(np.abs(y.numpy()[:, None] - syms), axis=1)]
    delay = 11 // 2
    assert np.abs(dec[200 + delay:] - sym[200:1200 - delay]).max() < 1e-6


def test_zfe_and_convolution_matrix():
    h = np.array([1.0, 0.4 - 0.3j, 0.1j])
    assert np.array_equal(EQt.convolution_matrix(h, 9),
                          EQj.convolution_matrix(h, 9))
    gt, gj = EQt.zfe_design(h, 15), EQj.zfe_design(h, 15)
    assert np.abs(gt - gj).max() < 1e-6
    z = np.convolve(h, gt)
    assert np.argmax(np.abs(z)) == (15 + 3 - 1) // 2
