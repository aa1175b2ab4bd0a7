"""Each CUDA kernel of libtsd_tpu_torch against its plain PyTorch version,
on the card (the demodulator kernels #5 and #6 and the frame kernels #9
and #10 with their own gates, at the end of the file).  Every test is
marked ``cuda`` and skips without a GPU.

This file imports no jax, so it runs on a GPU machine without one:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` skips tests/conftest.py, which configures jax.)

Tolerance: 1e-4 relative to the plain version's peak.  Both sides are
fp32; they differ in summation order, and the periodogram and chain
kernels combine partial spectra with atomicAdd in a run-dependent order.
Chain spectra are also held to 1e-3 per bin, with a floor of 1e-6 of the
peak, so that the stopband bins behind the lowpass count.
"""
import numpy as np
import pytest
import torch

from libtsd_tpu_torch.ops import fft as F, psd
from libtsd_tpu_torch.ops.filter_rt import fir_toeplitz_mats
from libtsd_tpu_torch.ops.fir_design import fir_lowpass
from libtsd_tpu_torch.ops.kernels import chain, fft, fir, periodogram

pytestmark = pytest.mark.cuda
TOL = 1e-4
TOL_BIN = 1e-3   # spectra per bin, floor 1e-6 of the peak (bin_err)
TIERS = ["highest", "split", "bf16", "int8", "int16"]


@pytest.fixture
def dev():
    """The card, or a skip: decided at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel vs its plain version)")
    return torch.device("cuda")


def rel(a, b):
    torch.cuda.synchronize()
    a = torch.view_as_real(a) if a.is_complex() else a
    b = torch.view_as_real(b) if b.is_complex() else b
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


def bin_err(a, b, floor=1e-6):
    """Per-bin error of a spectrum, floored at 1e-6 of b's peak, so that the
    stopband bins far below the peak count too."""
    torch.cuda.synchronize()
    a, b = a.double(), b.double()
    return ((a - b).abs() / (b.abs() + floor * b.abs().max())).max().item()


def _G(h, dev):
    return torch.as_tensor(fir_toeplitz_mats(np.asarray(h, np.float64))
                           .astype(np.float32), device=dev)


@pytest.mark.parametrize("K,n", [(256, 100003), (3, 4096), (600, 50000)])
def test_fir_kernel(dev, K, n):
    g = torch.Generator(device=dev).manual_seed(K)
    h = np.random.default_rng(K).standard_normal(K)
    x = torch.randn(n, generator=g, device=dev)
    before = fir.fir_kernel.launches
    y = fir.fir_kernel(h, x)
    assert fir.fir_kernel.launches == before + 1
    assert rel(y, fir.fir_plain(h, x)) < TOL
    z = torch.complex(x, x.flip(0))
    assert rel(fir.fir_kernel_complex(h, z),
               torch.complex(fir.fir_plain(h, z.real),
                             fir.fir_plain(h, z.imag))) < TOL


@pytest.mark.parametrize("C,frames", [(1, 3), (3, 64), (300, 2)])
def test_periodogram_kernel(dev, C, frames):
    g = torch.Generator(device=dev).manual_seed(C)
    y = torch.randn(C, frames * 4096, generator=g, device=dev)
    assert rel(periodogram.periodogram4096_acc(y),
               periodogram.periodogram4096_plain(y)) < TOL


@pytest.mark.parametrize("hist", [False, True])
@pytest.mark.parametrize("fir_passes", [2, 3])
@pytest.mark.parametrize("precision", TIERS)
def test_chain_kernel(dev, precision, fir_passes, hist):
    g = torch.Generator(device=dev).manual_seed(fir_passes)
    G = _G(fir_lowpass(256, 0.2), dev)
    shape = (3, 32 * 4096)
    if precision in ("int8", "int16"):
        lim = 127 if precision == "int8" else 20000
        dt = torch.int8 if precision == "int8" else torch.int16
        x = torch.randint(-lim, lim + 1, shape, generator=g, device=dev,
                          dtype=dt)
        h0 = torch.randint(-lim, lim + 1, (3, 2, 128), generator=g,
                           device=dev, dtype=dt)
    else:
        x = torch.randn(shape, generator=g, device=dev)
        h0 = torch.randn(3, 2, 128, generator=g, device=dev)
    h0 = h0 if hist else None
    k = chain.fir_periodogram4096(x, G, h0, precision, fir_passes)
    p = chain.fir_periodogram4096_plain(x, G, h0, precision, fir_passes)
    assert rel(k, p) < TOL
    assert bin_err(k, p) < TOL_BIN


@pytest.mark.parametrize("K", [1, 31, 300])
def test_chain_kernel_tap_counts(dev, K):
    """Short and long filters (tap padding, D = 2 and 4)."""
    g = torch.Generator(device=dev).manual_seed(K)
    G = _G(np.random.default_rng(K).standard_normal(K), dev)
    x = torch.randn(2, 8 * 4096, generator=g, device=dev)
    assert rel(chain.fir_periodogram4096(x, G),
               chain.fir_periodogram4096_plain(x, G)) < TOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,B", [(256, 37), (512, 8), (2048, 3), (4096, 5),
                                 (8192, 2), (16384, 3)])
def test_fft_kernel(dev, n, B, inverse):
    g = torch.Generator(device=dev).manual_seed(n)
    xr = torch.randn(B, n, generator=g, device=dev)
    xi = torch.randn(B, n, generator=g, device=dev)
    assert rel(torch.stack(fft.fft_pow2(xr, xi, inverse=inverse)),
               torch.stack(fft.fft_pow2_plain(xr, xi, inverse=inverse))) < TOL


def test_fft_engine_auto_and_gradient(dev):
    """ops.fft sends a CUDA power-of-two transform to the kernel, whose
    gradient matches torch.fft's."""
    g = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn(6, 1024, generator=g, device=dev, dtype=torch.complex64)
    before = fft.fft_pow2.launches
    assert rel(F.fft(z), torch.fft.fft(z, norm="ortho")) < TOL
    assert fft.fft_pow2.launches == before + 1
    assert rel(F.ifft(z, axis=0, n=8), torch.fft.ifft(z, n=8, dim=0,
                                                      norm="ortho")) < TOL
    w = torch.arange(1024, device=dev, dtype=torch.float32)
    za = z.clone().requires_grad_(True)
    ga = torch.autograd.grad((F.fft(za).abs() ** 2 * w).sum(), za)[0]
    zb = z.clone().requires_grad_(True)
    gb = torch.autograd.grad(
        (torch.fft.fft(zb, norm="ortho").abs() ** 2 * w).sum(), zb)[0]
    assert rel(ga, gb) < TOL
    _, S = psd.psd_welch(z.real[:2], 256)
    assert torch.isfinite(S).all()


# ------------------------------------------------- #5, #6: demod_sb
# Gates, kernel against its plain version on the same inputs (the JAX
# gates of tests/test_demod_sb.py:174-178 between its Pallas kernel and its
# XLA scan): equal valid masks, max |dsymbol| < 1e-3 on valid symbols, bit
# mismatch share < 1e-4.  Both sides are fp32; they differ in summation
# order and in atan2f against torch.angle, which a decision-feedback loop
# may amplify only where a symbol sits on a decision boundary.

def _qam(dev, M, C, nsym, seed):
    """C channels of one QPSK or QAM-16 stream (RRC 0.25, osf 4) at 8
    fractional delays, with independent noise, made on the card."""
    from libtsd_tpu_torch.models import waveform as W
    from libtsd_tpu_torch.models.bitstream import randbits
    from libtsd_tpu_torch.models.modulator import ModConfig, Modulator
    sh = W.PulseShape.rcs(0.25)
    wf = (W.wf_qam(16, sh, device=dev) if M == 16
          else W.wf_qpsk(sh, device=dev))
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    bits = randbits(g, wf.info.k * nsym)
    x, _ = mod.modulate(bits)
    n = (x.shape[0] // 64) * 64
    xs = torch.stack([F.delay_signal(x, 0.3 + 0.1 * c)[:n]
                      for c in range(8)])
    xs = xs.repeat(C // 8 + 1, 1)[:C]
    w = torch.randn(2, C, n, generator=g, device=dev) * 0.02
    return wf, bits, xs + torch.complex(w[0], w[1])


def _demod_gates(k, p, nbits):
    from libtsd_tpu_torch.models.waveform import symbol_indices_to_bits
    (yk, sk, vk, stk), (yp, sp, vp, stp) = k, p
    torch.cuda.synchronize()
    assert torch.equal(vk, vp)
    assert vk.float().mean() > 0.5
    assert (yk - yp).abs()[vp].max().item() < 1e-3
    bk = symbol_indices_to_bits(sk, nbits)
    bp = symbol_indices_to_bits(sp, nbits)
    assert (bk != bp).float().mean().item() < 1e-4
    assert torch.isfinite(stk).all()


@pytest.mark.parametrize("M,C,S,itrp", [(4, 200, 16, "cspline"),
                                        (16, 77, 16, "cspline"),
                                        (4, 40, 8, "linear"),
                                        (4, 40, 32, "lagrange"),
                                        (4, 40, 16, "sinc")])
def test_demod_sb_kernel(dev, M, C, S, itrp):
    """#5 against its plain version on two consecutive blocks (the second
    one from the kernel's carried state)."""
    from libtsd_tpu_torch.models.demod_sb import (DecisionDemodSB,
                                                  SBDemodConfig, pack_state)
    from libtsd_tpu_torch.ops.kernels import demod_sb as KSB
    wf, _, x = _qam(dev, M, C, 1200, M + S)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=S, itrp=itrp,
                                                  engine="cuda"), device=dev)
    st = dd.init_for(x)
    for xb in (x[:, :2048], x[:, 2048:4000]):
        _, zp = dd.matched_zp(st, xb)
        p = dd.loop_params(xb.shape[-1])
        s8 = pack_state(st)
        before = KSB.demod_sb.launches
        k = KSB.demod_sb(zp, s8, wf.symbols, p)
        assert KSB.demod_sb.launches == before + 1
        _demod_gates(k, KSB.demod_sb_plain(zp, s8, wf.symbols, p),
                     wf.info.k)
        st = dd.step(st, xb)[0]


@pytest.mark.parametrize("M,C", [(4, 200), (16, 77)])
def test_demod_sb_fused_kernel(dev, M, C):
    """#6 against its plain version on two consecutive blocks (carried
    input tail, pointer and power EMA)."""
    from libtsd_tpu_torch.models.demod_sb import (DecisionDemodSB,
                                                  SBDemodConfig, pack_state)
    from libtsd_tpu_torch.ops.kernels import demod_sb as KSB
    wf, _, x = _qam(dev, M, C, 1200, M)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16,
                                                  engine="cuda-fused"),
                                device=dev)
    st = dd.init_for(x)
    for xb in (x[:, :2048], x[:, 2048:4096]):
        p = dd.loop_params(xb.shape[-1])
        args = (xb, st["xtail"], pack_state(st), wf.symbols, dd.h_mf, p,
                dd.rms_ref)
        before = KSB.demod_sb_fused.launches
        k = KSB.demod_sb_fused(*args)
        assert KSB.demod_sb_fused.launches == before + 1
        _demod_gates(k, KSB.demod_sb_fused_plain(*args), wf.info.k)
        st = dd.step(st, xb)[0]


@pytest.mark.parametrize("engine", ["cuda", "cuda-fused"])
def test_qam16_engines_decode_on_card(dev, engine):
    """Both engines decode QAM-16 on the card: tail EVM < 0.2 and zero
    bit errors after warm-up (examples/qam_serving.py's checks)."""
    from libtsd_tpu_torch.models import ber
    from libtsd_tpu_torch.models.demod_sb import DecisionDemodSB, SBDemodConfig
    wf, bits, x = _qam(dev, 16, 24, 2048, 3)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16,
                                                  engine=engine), device=dev)
    _, (_, syms, mask, _) = dd.step(dd.init_for(x), x)
    t = syms[:, syms.shape[1] // 2:]
    d2 = ((t[..., None] - wf.symbols).abs() ** 2).min(-1).values
    evm = torch.sqrt(d2.mean(-1) / (wf.symbols.abs() ** 2).mean())
    assert evm.max().item() < 0.2
    for c in range(0, 24, 7):
        sy = syms[c][mask[c]]
        _, errs, _ = ber.cmp_bits_rot(bits[4 * 600:], sy[600:], wf,
                                      max_lag=64)
        assert errs == 0


def test_demod_kernels_without_build_raise(dev, tmp_path, monkeypatch):
    """No fallback: CUDA tensors with no kernel library (no nvcc) raise
    instead of running the plain versions."""
    from libtsd_tpu_torch.models.demod_sb import (DecisionDemodSB,
                                                  SBDemodConfig, pack_state)
    from libtsd_tpu_torch.ops.kernels import _build, demod_sb as KSB
    wf, _, x = _qam(dev, 4, 8, 300, 1)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16), device=dev)
    st = dd.init_for(x)
    _, zp = dd.matched_zp(st, x)
    p = dd.loop_params(x.shape[-1])
    ddf = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16,
                                                   engine="cuda-fused"),
                                 device=dev)
    stf = ddf.init_for(x)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        KSB.demod_sb(zp, pack_state(st), wf.symbols, p)
    with pytest.raises(RuntimeError, match="nvcc"):
        KSB.demod_sb_fused(x, stf["xtail"], pack_state(stf), wf.symbols,
                           ddf.h_mf, p, ddf.rms_ref)


# ------------------------------------------- #9 ola, #10 detfront
# Gates: #9's output and new state to 1e-5 of the plain version's peak
# (the JAX gate between its Pallas OLA kernel and XLA's FFT path,
# tests/test_pallas.py:148,224); #10's correlation and energy planes to
# 1e-5 of their peak, its raw score to 1e-4 absolute.  Both sides are fp32:
# #9 against torch.fft in another butterfly order, #10 against cuDNN's
# fp32 convolution (TF32 off) in another summation order.

def _cplx(g, dev, *shape):
    return torch.complex(torch.randn(shape, generator=g, device=dev),
                         torch.randn(shape, generator=g, device=dev))


@pytest.mark.parametrize("complex_taps", [False, True])
@pytest.mark.parametrize("K,Nf", [(129, 256), (128, 4096), (1000, 16384)])
def test_ola_kernel(dev, K, Nf, complex_taps):
    """#9 against its plain version on two consecutive blocks at an odd
    channel count, the second from the carried state."""
    from libtsd_tpu_torch.ops.kernels import ola
    rng = np.random.default_rng(K)
    h = rng.standard_normal(K)
    if complex_taps:
        h = h + 1j * rng.standard_normal(K)
    Nf, Ne, V = ola.ola_plan(K, Nf)
    H = ola.freq_response(h, Nf, dev)
    g = torch.Generator(device=dev).manual_seed(K)
    x = _cplx(g, dev, 3, 5 * Ne)
    st = _cplx(g, dev, 3, V)
    st0, ys = st, []
    for xb in (x[:, :2 * Ne], x[:, 2 * Ne:]):
        before = ola.ola_stream.launches
        yk, sk = ola.ola_stream(xb, st, H, K, Nf)
        assert ola.ola_stream.launches == before + 1
        yp, sp = ola.ola_stream_plain(xb, st, H, K, Nf)
        assert rel(yk, yp) < 1e-5
        assert torch.equal(sk, sp)
        st = sk
        ys.append(yk)
    # each window is one block of the kernel: continuation is exact
    assert torch.equal(torch.cat(ys, -1), ola.ola_stream(x, st0, H, K, Nf)[0])


def test_ola_filter_kernel_matches_direct_form(dev):
    """One-shot ``ola_filter`` on the card against the direct-form FIR of
    the same taps (float64 on the host), real and complex taps."""
    from libtsd_tpu_torch.ops.kernels import ola
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 20000))
         + 1j * rng.standard_normal((2, 20000))).astype(np.complex64)
    for h in (rng.standard_normal(97),
              rng.standard_normal(97) + 1j * rng.standard_normal(97)):
        y = ola.ola_filter(torch.as_tensor(x, device=dev), h).cpu().numpy()
        ref = np.stack([np.convolve(r.astype(np.complex128), h)[:20000]
                        for r in x])
        assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("M,n", [(88, 5 * 2048 + 3 * 128), (128, 8192),
                                 (1500, 4096)])
def test_detfront_kernel(dev, M, n):
    """#10 against its plain version on two consecutive blocks at an odd
    channel count (a ragged last tile at M = 88, several tap chunks at
    M = 1500)."""
    from libtsd_tpu_torch.ops.kernels import detfront as DF
    rng = np.random.default_rng(M)
    pat = rng.standard_normal(M) + 1j * rng.standard_normal(M)
    fr = DF.DetFront.create(np.conj(pat[::-1]) / np.linalg.norm(pat),
                            device=dev)
    g = torch.Generator(device=dev).manual_seed(M)
    x = _cplx(g, dev, 3, 2 * n)
    st = fr.init_for(x)
    for xb in (x[:, :n], x[:, n:]):
        before = DF.detfront.launches
        k = DF.detfront(xb, st, fr.taps, M)
        assert DF.detfront.launches == before + 1
        p = DF.detfront_plain(xb, st, fr.taps, M)
        for a, b in zip(k[:3], p[:3]):
            assert rel(a, b) < 1e-5
        assert (k[3] - p[3]).abs().max().item() < 1e-4
        st = fr.step(st, xb)[0]


@pytest.mark.parametrize("engine", ["cuda", "cuda-fused"])
def test_detector_engines_match_torch_engine_on_card(dev, engine):
    """The detector's kernel engines find the "torch" engine's detections
    on the card (the gates of tests/test_detfront.py:36-42)."""
    from libtsd_tpu_torch.models.detector import DetectorConfig, detect_pattern
    rng = np.random.default_rng(11)
    pat = (rng.standard_normal(128)
           + 1j * rng.standard_normal(128)).astype(np.complex64)
    x = (0.05 * (rng.standard_normal((3, 20000))
                 + 1j * rng.standard_normal((3, 20000)))).astype(np.complex64)
    for c in range(3):
        for pos in (1200 + 7 * c, 9000, 15000 - 5 * c):
            x[c, pos:pos + 128] += 0.9 * np.exp(1j * c) * pat
    xd = torch.as_tensor(x, device=dev)
    d1, s1 = detect_pattern(xd, pat, DetectorConfig(threshold=0.5))
    d2, s2 = detect_pattern(xd, pat, DetectorConfig(threshold=0.5,
                                                    engine=engine))
    assert torch.equal(d1.valid, d2.valid) and int(d1.valid.sum()) == 9
    assert torch.equal(d1.position, d2.position)
    assert (s1 - s2).abs().max().item() < 5e-4
    assert (d1.gain - d2.gain).abs().max().item() < 1e-3
    assert (d1.theta - d2.theta).abs().max().item() < 1e-3


def test_frame_kernels_without_build_raise(dev, tmp_path, monkeypatch):
    """No fallback: CUDA tensors with no kernel library (no nvcc) raise
    instead of running the plain versions of #9 and #10."""
    from libtsd_tpu_torch.ops.kernels import _build, detfront as DF, ola
    Nf, Ne, V = ola.ola_plan(64)
    H = ola.freq_response(np.ones(64), Nf, dev)
    x = torch.zeros(2, Ne, dtype=torch.complex64, device=dev)
    fr = DF.DetFront.create(np.ones(64), device=dev)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        ola.ola_stream(x, torch.zeros(2, V, dtype=torch.complex64,
                                      device=dev), H, 64, Nf)
    with pytest.raises(RuntimeError, match="nvcc"):
        fr.step(fr.init_for(x[:, :1024]), x[:, :1024])
