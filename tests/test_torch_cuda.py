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
Chain and periodogram spectra are also held to 1e-3 per bin, with a floor
of 1e-6 of the peak, so that the stopband bins behind the lowpass count.
"""
import numpy as np
import pytest
import torch

from libtsd_tpu_torch.ops import fft as F, psd
from libtsd_tpu_torch.ops.filter_rt import fir_toeplitz_mats
from libtsd_tpu_torch.ops.fir_design import fir_lowpass
from libtsd_tpu_torch.ops.kernels import chain, fft, fir, periodogram, welch

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


def _fir64(h, x):
    """float64 numpy FIR of the fp32 samples, zero initial state."""
    xn = x.double().cpu().numpy()
    return np.convolve(xn, np.asarray(h, np.float64))[:len(xn)]


@pytest.mark.parametrize("K", [3, 256, 600, 5000])
def test_fir_kernel_vs_float64(dev, K):
    """#1 within 1e-5 of the peak of a float64 FIR (the six bf16 products
    of the split and mma.sync's truncating sums): one chunk of taps (3,
    256), two (600) and eleven (5000)."""
    rng = np.random.default_rng(K + 1)
    h = rng.standard_normal(K)
    x = torch.as_tensor(rng.standard_normal(3 * 8192 + 1001)
                        .astype(np.float32), device=dev)
    y = fir.fir_kernel(h, x)
    assert rel(y, torch.as_tensor(_fir64(h, x), device=dev)) < 1e-5
    assert rel(y, fir.fir_plain(h, x)) < TOL


@pytest.mark.parametrize("K", [3, 17, 100, 600, 1000])
@pytest.mark.parametrize("case", ["empty", "one", "K-1", "below a tile",
                                  "ragged", "misaligned"])
def test_fir_kernel_lengths(dev, K, case):
    """Lengths at the edges of #1's tiles (8192 outputs) and windows: 0, 1,
    K - 1 samples, less than one tile, a run not a multiple of the tile, and
    a view 4 bytes off a 16-byte boundary; tap counts not multiples of 16,
    over one and several chunks of 496."""
    n = {"empty": 0, "one": 1, "K-1": max(K - 1, 1), "below a tile": 5000,
         "ragged": 2 * 8192 + 777, "misaligned": 8192 + 5}[case]
    rng = np.random.default_rng(K)
    h = rng.standard_normal(K)
    buf = torch.as_tensor(rng.standard_normal(n + 1).astype(np.float32),
                          device=dev)
    x = buf[1:] if case == "misaligned" else buf[:n]
    y = fir.fir_kernel(h, x)
    assert y.shape == x.shape and y.dtype == torch.float32
    if n:
        assert rel(y, torch.as_tensor(_fir64(h, x), device=dev)) < 1e-5
        assert rel(y, fir.fir_plain(h, x)) < TOL


@pytest.mark.parametrize("lowpass", [False, True])
@pytest.mark.parametrize("C,frames", [(1, 3), (3, 64), (300, 2), (1, 1),
                                      (2, 7), (5, 9), (1, 1024)])
def test_periodogram_kernel(dev, C, frames, lowpass):
    """White or lowpass-filtered input (stopband bins far below the peak);
    frame counts whose runs per block are odd (1, 3, 7, 9: the last frame
    of a run goes alone) and one channel of 2^22."""
    g = torch.Generator(device=dev).manual_seed(C)
    y = torch.randn(C, frames * 4096, generator=g, device=dev)
    if lowpass:
        h = fir_lowpass(256, 0.2)
        y = torch.stack([fir.fir_plain(h, r) for r in y])
    k = periodogram.periodogram4096_acc(y)
    p = periodogram.periodogram4096_plain(y)
    assert rel(k, p) < TOL
    assert bin_err(k, p) < TOL_BIN


def _tier_input(g, dev, precision, shape):
    """Samples of the tier's ingest dtype (int8/int16 ADC ranges, else
    standard normal floats)."""
    if precision in ("int8", "int16"):
        lim = 127 if precision == "int8" else 20000
        dt = torch.int8 if precision == "int8" else torch.int16
        return torch.randint(-lim, lim + 1, shape, generator=g, device=dev,
                             dtype=dt)
    return torch.randn(shape, generator=g, device=dev)


def _wg_tier(precision, fir_passes):
    """The tiers #3 runs on its wgmma body (csrc/chain_wg.cu) at K <=
    chain.K_MAX_WG: one tap plane on the tensor cores (passes 1 and 2)."""
    return precision in ("bf16", "int8") or (
        precision in ("split", "int16") and fir_passes == 2)


# (C, frames): the first runs whole pairs; 7 frames split into runs of 4
# and 3 (the second block's last frame goes alone); one frame (N = 4096);
# one channel of 3 frames (a pair and a lone frame in one block)
CHAIN_SHAPES = [(3, 32), (3, 7), (1, 1), (1, 3)]


@pytest.mark.parametrize("C,frames", CHAIN_SHAPES)
@pytest.mark.parametrize("hist", [False, True])
@pytest.mark.parametrize("fir_passes", [2, 3])
@pytest.mark.parametrize("precision", TIERS)
def test_chain_kernel(dev, precision, fir_passes, hist, C, frames):
    g = torch.Generator(device=dev).manual_seed(fir_passes + frames)
    G = _G(fir_lowpass(256, 0.2), dev)
    x = _tier_input(g, dev, precision, (C, frames * 4096))
    h0 = _tier_input(g, dev, precision, (C, 2, 128)) if hist else None
    before = chain.fir_periodogram4096.launches
    wg = chain.fir_periodogram4096.wg_launches
    k = chain.fir_periodogram4096(x, G, h0, precision, fir_passes)
    assert chain.fir_periodogram4096.launches == before + 1
    assert chain.fir_periodogram4096.wg_launches == wg + _wg_tier(
        precision, fir_passes)
    p = chain.fir_periodogram4096_plain(x, G, h0, precision, fir_passes)
    assert rel(k, p) < TOL
    assert bin_err(k, p) < TOL_BIN


@pytest.mark.parametrize("hist", [False, True])
@pytest.mark.parametrize("fir_passes", [2, 3])
@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("K", [1, 31, 256, 300, 257, 258])
def test_chain_kernel_tap_counts(dev, K, precision, fir_passes, hist):
    """Short and long filters on every tier (D = 1, 2, 3 and 4; E = 1, 3,
    17 and 20 tap blocks of 16; on the wgmma body E = 1, 2, 5 and 5 tap
    blocks of 64, K = 257 its limit), with and without a history (D = 1:
    one unread row).  K = 258, one above the wgmma body's limit, takes
    chain_frames at every tier."""
    g = torch.Generator(device=dev).manual_seed(K)
    G = _G(np.random.default_rng(K).standard_normal(K), dev)
    H = max(G.shape[0] - 1, 1)
    x = _tier_input(g, dev, precision, (2, 8 * 4096))
    h0 = _tier_input(g, dev, precision, (2, H, 128)) if hist else None
    wg = chain.fir_periodogram4096.wg_launches
    k = chain.fir_periodogram4096(x, G, h0, precision, fir_passes)
    assert chain.fir_periodogram4096.wg_launches == wg + (
        _wg_tier(precision, fir_passes) and K <= chain.K_MAX_WG)
    p = chain.fir_periodogram4096_plain(x, G, h0, precision, fir_passes)
    assert rel(k, p) < TOL
    assert bin_err(k, p) < TOL_BIN


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,B", [(256, 37), (512, 8), (2048, 3), (4096, 5),
                                 (8192, 2), (16384, 3), (256, 1), (1024, 7),
                                 (4096, 1), (16384, 1)])
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


# ------------------------------------------ Welch's passes around #4
# The framing is one fp32 product a value, as its plain version: equal
# bit for bit.  The power sum adds in another order than PyTorch's: held
# to 1e-3 dB per bin (~2.3e-4 relative), a sum over 32,766 segments
# included.


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("C,n,N", [(3, 2 * 256 + 1, 256),     # 3 segments
                                   (2, 7 * 2048 + 4, 4096),
                                   (5, 3 * 16384 + 2, 16384),  # 5 segments
                                   (4, 2 ** 26, 4096)])        # welch4's
def test_welch_kernels(dev, cplx, C, n, N):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(C, n, generator=g, device=dev,
                    dtype=torch.complex64 if cplx else torch.float32)
    nseg = max(len(range(0, n - N, N // 2)), 1)
    w = psd._win("hn", N, dev)
    before = (welch.welch_frames.launches, welch.welch_power.launches)
    re, im = welch.welch_frames(x, w, N, nseg)
    assert welch.welch_frames.launches == before[0] + 1
    pr, pi = welch.welch_frames_plain(x, w, N, nseg)
    assert torch.equal(re, pr) and torch.equal(im, pi)
    del x, pr, pi
    yr, yi = fft.fft_pow2(re, im)
    del re, im
    S = welch.welch_power(yr, yi, C, nseg, N)
    assert welch.welch_power.launches == before[1] + 1
    Sp = welch.welch_power_plain(yr, yi, C, nseg, N)
    torch.cuda.synchronize()
    assert S.shape == (C, N) and torch.isfinite(S).all()
    assert (S - Sp).abs().max().item() < 1e-3
    assert torch.equal(welch.welch_power(yr, yi, C, nseg, N), S)


@pytest.mark.parametrize("cplx", [False, True])
def test_psd_welch_takes_the_kernel_route(dev, cplx):
    """psd_welch on a card: each pass launched once a call, leading
    dimensions as channels, two calls bit-identical, and the CPU's
    composed path (torch.fft) within 1e-4 of the peak in linear power."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(2, 3, 9 * 1024 + 5, generator=g, device=dev,
                    dtype=torch.complex64 if cplx else torch.float32)
    wrappers = (welch.welch_frames, fft.fft_pow2, welch.welch_power)
    before = [w.launches for w in wrappers]
    _, S = psd.psd_welch(x, 1024)
    _, S2 = psd.psd_welch(x, 1024)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [2, 2, 2]
    assert S.shape == (2, 3, 1024) and torch.equal(S, S2)
    _, Sc = psd.psd_welch(x.cpu(), 1024)
    assert rel(10 ** (S.double() / 10), 10 ** (Sc.to(dev).double() / 10)) \
        < TOL


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


# #5 against its plain version bit for bit: the window staged into a ring
# by cp.async at either parity of a row's start (an odd row length and a
# base 8 bytes past a 16-byte line; an n that leaves a remainder), and the
# tap table of the windowed sinc (K 15, the 16-tap instance).
@pytest.mark.parametrize("M,C,S,itrp,n,odd", [(16, 77, 16, "cspline", 2048,
                                               False),
                                              (4, 33, 16, "cspline", 2085,
                                               True),
                                              (4, 20, 8, "sinc", 1024, True)])
def test_demod_sb_kernel_bit_identical(dev, M, C, S, itrp, n, odd):
    from libtsd_tpu_torch.models.demod_sb import (DecisionDemodSB,
                                                  SBDemodConfig, pack_state)
    from libtsd_tpu_torch.ops.kernels import demod_sb as KSB
    wf, _, x = _qam(dev, M, C, 2 * n // 4 + 64, 5 * S + C)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=S, itrp=itrp,
                                                  engine="cuda"), device=dev)
    st = dd.init_for(x)
    for blk in range(2):
        xb = x[:, blk * n:(blk + 1) * n]
        _, zp = dd.matched_zp(st, xb)
        if odd:       # odd row length, base 8 bytes past a 16-byte line
            L = zp.shape[1] + 1 - zp.shape[1] % 2
            buf = torch.zeros(C * L + 1, dtype=zp.dtype, device=dev)
            zp2 = buf[1:].view(C, L)
            zp2[:, :zp.shape[1]] = zp
            zp = zp2
            assert zp.data_ptr() % 16 == 8 and zp.is_contiguous()
        p = dd.loop_params(xb.shape[-1])
        s8 = pack_state(st)
        before = KSB.demod_sb.launches
        k = KSB.demod_sb(zp, s8, wf.symbols, p)
        assert KSB.demod_sb.launches == before + 1
        ref = KSB.demod_sb_plain(zp, s8, wf.symbols, p)
        torch.cuda.synchronize()
        for u, v in zip(k, ref):
            assert torch.equal(u, v)
        st = dd.step(st, xb)[0]


# #6 against its plain version, bit for bit (bits, bit flags, y, valid, the
# nine rows and the input tail), over half the symbols valid and the rows
# finite: QPSK and QAM-16; S 8 (four channels a
# warp), 16 and 32 (one a warp); nsb giving tb 8, 2 and 1; the 129-tap
# matched filter; C = 1 and C not a multiple of a block's channels; three
# consecutive blocks, each from the kernel's carried rows and input tail.
@pytest.mark.parametrize("S,n,tb,kmf,C,M", [(16, 2048, 8, 0, 200, 4),
                                            (16, 2048, 8, 0, 77, 16),
                                            (16, 640, 2, 0, 1, 4),
                                            (16, 576, 1, 129, 40, 4),
                                            (8, 2048, 8, 0, 33, 4),
                                            (32, 2048, 8, 0, 9, 16),
                                            (32, 384, 1, 129, 5, 4)])
def test_demod_sb_fused_rings_bit_identical(dev, S, n, tb, kmf, C, M):
    from libtsd_tpu_torch.models.demod_sb import (DecisionDemodSB,
                                                  SBDemodConfig, pack_state)
    from libtsd_tpu_torch.ops.kernels import demod_sb as KSB
    wf, _, x = _qam(dev, M, C, 3 * n // 4 + 64, 11 * S + C)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=S,
                                                  engine="cuda-fused"),
                                device=dev)
    h_mf = dd.h_mf
    if kmf:
        h_mf = torch.as_tensor(np.random.default_rng(kmf).standard_normal(
            kmf).astype(np.float32) / np.sqrt(kmf), device=dev)
    st = dd.init_for(x[:, :n])
    xtail, rows = st["xtail"], pack_state(st)
    p = dd.loop_params(n)
    assert KSB.fused_layout(4, S, p.K, n)["tb"] == tb
    plan = KSB.FusedStep(C, p, wf.symbols, h_mf, dd.rms_ref, wf.info.k, dev)
    for blk in range(3):
        xb = x[:, blk * n:(blk + 1) * n].contiguous()
        before = KSB.demod_sb_fused_step.launches
        got = KSB.demod_sb_fused_step(xb, xtail, rows, plan)
        assert KSB.demod_sb_fused_step.launches == before + 1
        want = KSB.demod_sb_fused_step_plain(xb, xtail, rows, plan)
        torch.cuda.synchronize()
        for u, v in zip(got, want):
            assert u.shape == v.shape and u.dtype == v.dtype
            assert torch.equal(u, v)
        assert got[2].float().mean() > 0.5 and torch.isfinite(got[4]).all()
        rows, xtail = got[4], got[5]


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
        KSB.demod_sb_fused_step(x, stf["xtail"], pack_state(stf),
                                ddf._fused_step(x))


# ------------------------------------------- #6 as DecisionDemodSB.step
# The fused engine's step is one launch of #6 that writes the bits, their
# valid flags, the state rows (pointer re-based) and the carried input
# tail.  It is held bit for bit to a step composed around #6's plain loop
# (demod_sb_fused_plain): symbol_indices_to_bits and repeat_interleave on
# its indices and flags, _unpack and a copy of the input's tail.  A state
# restored from a checkpoint or converted as from JAX is stacked into rows
# at its first step.

def _composed_fused_step(dd, st, xb):
    from libtsd_tpu_torch.models.demod_sb import _unpack, pack_state
    from libtsd_tpu_torch.models.waveform import symbol_indices_to_bits
    from libtsd_tpu_torch.ops.kernels import demod_sb as KSB
    n, k = xb.shape[-1], dd.wf.info.k
    y, sidx, valid, st9 = KSB.demod_sb_fused_plain(
        xb, st["xtail"], pack_state(st), dd.wf.symbols, dd.h_mf,
        dd.loop_params(n), dd.rms_ref)
    xoff = st["xtail"].shape[-1]
    new = dict(_unpack(st9, n), xtail=xb[:, n - xoff:].clone())
    return new, (symbol_indices_to_bits(sidx, k), y, valid,
                 valid.repeat_interleave(k, dim=-1))


def _state_as(form, st, tmp_path):
    """st itself, restored from a checkpoint, or converted by
    demod_state_from_jax from numpy arrays (what a JAX state gives)."""
    if form == "checkpoint":
        from libtsd_tpu_torch.utils.checkpoint import load_state, save_state
        save_state(str(tmp_path / "demod.npz"), st)
        return load_state(str(tmp_path / "demod.npz"), st)
    if form == "converted":
        from libtsd_tpu_torch.utils.convert import demod_state_from_jax
        as_np = {k: (tuple(a.cpu().numpy() for a in v)
                     if isinstance(v, tuple) else v.cpu().numpy())
                 for k, v in st.items()}
        return demod_state_from_jax(as_np, device=st["ptr"].device)
    return st


def _same_state(a, b):
    assert list(a) == list(b)
    for key in a:
        u, v = ((torch.stack(a[key]), torch.stack(b[key])) if key == "lf"
                else (a[key], b[key]))
        assert u.shape == v.shape and u.dtype == v.dtype, key
        assert torch.equal(u, v), key


@pytest.mark.parametrize("form", ["own", "checkpoint", "converted"])
@pytest.mark.parametrize("n", [8192, 1216])
@pytest.mark.parametrize("C", [1, 3, 128, 4096])
def test_fused_step_one_launch_bit_identical(dev, C, n, form, tmp_path):
    """Four consecutive steps after a first one, the state carried (n 1216:
    19 sub-blocks, superframes of 1): bits, bit flags, y, valid, the nine
    state rows and the input tail equal the composed route's."""
    from libtsd_tpu_torch.models.demod_sb import (DecisionDemodSB,
                                                  SBDemodConfig, _viewed_rows)
    from libtsd_tpu_torch.ops.kernels import demod_sb as KSB
    wf, _, x = _qam(dev, 16, C, 5 * n // 4 + 64, C + n)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16,
                                                  engine="cuda-fused"),
                                device=dev)
    st = dd.step(dd.init_for(x[:, :n]), x[:, :n].contiguous())[0]
    st = ref = _state_as(form, st, tmp_path)
    for i in range(1, 5):
        xb = x[:, i * n:(i + 1) * n].contiguous()
        fell_back = i == 1 and form != "own"
        assert (_viewed_rows(st) is None) == fell_back
        launches = KSB.demod_sb_fused_step.launches
        st, out = dd.step(st, xb)
        assert KSB.demod_sb_fused_step.launches == launches + 1
        ref, want = _composed_fused_step(dd, ref, xb)
        torch.cuda.synchronize()
        for u, v in zip(out, want):
            assert u.shape == v.shape and u.dtype == v.dtype
            assert torch.equal(u, v)
        assert out[2].float().mean() > 0.5
        _same_state(st, ref)
        assert _viewed_rows(st) is not None


def test_fused_step_is_one_kernel(dev, tmp_path):
    """A traced step from a state in row layout launches #6 and no other
    kernel, copy or set."""
    import json
    from torch.profiler import ProfilerActivity, profile
    from libtsd_tpu_torch.models.demod_sb import (DecisionDemodSB,
                                                  SBDemodConfig, _viewed_rows)
    n = 8192
    wf, _, x = _qam(dev, 16, 256, 2 * n // 4 + 64, 21)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16,
                                                  engine="cuda-fused"),
                                device=dev)
    x0, x1 = x[:, :n].contiguous(), x[:, n:2 * n].contiguous()
    st = dd.step(dd.init_for(x0), x0)[0]
    torch.cuda.synchronize()
    assert _viewed_rows(st) is not None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dd.step(st, x1)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "step.json"))
    ev = json.loads((tmp_path / "step.json").read_text())["traceEvents"]
    work = [e["name"] for e in ev
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert len(work) == 1 and "demod_sb_fused_kernel" in work[0], work


def test_fused_step_keeps_earlier_results(dev):
    """A step writes fresh tensors: the state and outputs of step k are
    unchanged by step k + 1, and share no memory with its results."""
    from libtsd_tpu_torch.models.demod_sb import (DecisionDemodSB,
                                                  SBDemodConfig)
    n = 2048
    wf, _, x = _qam(dev, 16, 40, 3 * n // 4 + 64, 22)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16,
                                                  engine="cuda-fused"),
                                device=dev)
    st1, out1 = dd.step(dd.init_for(x[:, :n]), x[:, :n])
    flat = lambda st, out: [*st["lf"], *(v for k, v in st.items()  # noqa
                                         if k != "lf"), *out]
    kept = [t.clone() for t in flat(st1, out1)]
    st2, out2 = dd.step(st1, x[:, n:2 * n])
    torch.cuda.synchronize()
    for a, b in zip(flat(st1, out1), kept):
        assert torch.equal(a, b)
    old = {t.untyped_storage().data_ptr() for t in flat(st1, out1)}
    assert not old & {t.untyped_storage().data_ptr()
                      for t in flat(st2, out2)}


# ------------------------------------------- #9 ola, #10 detfront
# Gates: #9's output and new state to 1e-5 of the plain version's peak
# (the JAX gate between its Pallas OLA kernel and XLA's FFT path,
# tests/test_pallas.py:148,224); #10's correlation and energy planes to
# 1e-5 of their peak, its raw score to 1e-4 absolute.  #9 is fp32 against
# torch.fft in another butterfly order; #10 computes the JAX "split" tier
# (bf16 pieces, ~4-5e-6 of the peak on random data,
# tests/test_torch_ola_detfront_design.py) against cuDNN's fp32
# convolution (TF32 off).

def _cplx(g, dev, *shape):
    return torch.complex(torch.randn(shape, generator=g, device=dev),
                         torch.randn(shape, generator=g, device=dev))


@pytest.mark.parametrize("complex_taps", [False, True])
@pytest.mark.parametrize("K,Nf", [(129, 256), (100, 512), (200, 1024),
                                  (300, 2048), (128, 4096), (128, 8192),
                                  (1000, 16384)])
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


def test_detfront_kernel_long_pattern(dev):
    """#10 at M = 5000 (5 chunks of tap blocks, a 4992-sample state)
    against its plain version on two consecutive blocks."""
    from libtsd_tpu_torch.ops.kernels import detfront as DF
    M, n = 5000, 3 * 4096 + 128
    rng = np.random.default_rng(M)
    pat = rng.standard_normal(M) + 1j * rng.standard_normal(M)
    fr = DF.DetFront.create(np.conj(pat[::-1]) / np.linalg.norm(pat),
                            device=dev)
    g = torch.Generator(device=dev).manual_seed(M)
    x = _cplx(g, dev, 2, 2 * n)
    st = fr.init_for(x)
    for xb in (x[:, :n], x[:, n:]):
        k = DF.detfront(xb, st, fr.taps, M)
        p = DF.detfront_plain(xb, st, fr.taps, M)
        for a, b in zip(k[:3], p[:3]):
            assert rel(a, b) < 1e-5
        assert (k[3] - p[3]).abs().max().item() < 1e-4
        st = fr.step(st, xb)[0]


@pytest.mark.parametrize("M", [128, 1500])
def test_detfront_kernel_silent_stretch_is_exact_zero(dev, M):
    """After a zero state, a block whose middle 4096 samples are exact
    zeros: every output whose window lies in the silence is exactly 0 in
    cr, ci, en and the score, as in the plain version; the block is within
    the gates of the plain version everywhere."""
    from libtsd_tpu_torch.ops.kernels import detfront as DF
    rng = np.random.default_rng(M + 1)
    pat = rng.standard_normal(M) + 1j * rng.standard_normal(M)
    fr = DF.DetFront.create(np.conj(pat[::-1]) / np.linalg.norm(pat),
                            device=dev)
    g = torch.Generator(device=dev).manual_seed(M + 1)
    x = _cplx(g, dev, 3, 3 * 4096)
    x[:, 4096:8192] = 0
    st = fr.init_for(x)
    k = DF.detfront(x, st, fr.taps, M)
    p = DF.detfront_plain(x, st, fr.taps, M)
    silent = slice(4096 + M - 1, 8192)
    for a, b in zip(k, p):
        assert torch.count_nonzero(a[:, silent]).item() == 0
        assert torch.count_nonzero(b[:, silent]).item() == 0
    for a, b in zip(k[:3], p[:3]):
        assert rel(a, b) < 1e-5
    assert (k[3] - p[3]).abs().max().item() < 1e-4


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


# ------------------------------------------- #7 iir cascade, #8 fm chain
# Gates: #7 against its plain version to 1e-5 of the peak and against
# float64 scipy sosfilt to 1e-5 of the peak (the JAX gate,
# tests/test_pallas_iir_fm.py:33-34), streaming bit-identical to one call
# (tests/test_pallas_iir_fm.py:37-48); #8 against its plain version and
# against the composed FmReceiver to 1e-5 absolute after the first 4
# outputs (tests/test_pallas_iir_fm.py:101-102).  Both sides fp32; they
# differ in summation order and FMA contraction.

def _butter_sections(order, fc, typ="lp"):
    from libtsd_tpu_torch.ops.iir_design import design_iir, zpk_to_sos
    sos, k = zpk_to_sos(design_iir(order, typ, "butterworth", fc))
    return [(sos[s, :3] * (k if s == 0 else 1.0), sos[s, 3:])
            for s in range(sos.shape[0])], sos, k


@pytest.mark.parametrize("order,C,N,tb", [(4, 3, 128 * 64 * 3, 64),
                                          (2, 5, 128 * 16 * 5, 16),
                                          (8, 2, 128 * 64, 8)])
def test_iir_cascade_kernel(dev, order, C, N, tb):
    """#7 against its plain version and float64 sosfilt, from a random
    carried state and from zeros."""
    import scipy.signal as ss
    from libtsd_tpu_torch.ops.kernels import iir
    secs, sos, k = _butter_sections(order, 0.1)
    casc = iir.IirCascade(secs, device=dev)
    g = torch.Generator(device=dev).manual_seed(order)
    x = torch.randn(C, N, generator=g, device=dev)
    st0 = torch.randn(C, casc.nsec, 8, generator=g, device=dev)
    st0[..., casc.k:] = 0
    for st in (None, st0):
        before = iir.iir_cascade.launches
        yk, sk = casc(x, st, tb=tb)
        assert iir.iir_cascade.launches == before + 1
        yp, sp = iir.iir_cascade_plain(x, casc.T, casc.S, casc.W, casc.M,
                                       st, tb=tb)
        assert rel(yk, yp) < 1e-5
        assert rel(sk, sp) < 1e-5
    sc = sos.copy()
    sc[0, :3] *= k
    ref = ss.sosfilt(sc, x.double().cpu().numpy(), axis=-1)
    y = casc(x, tb=tb)[0].cpu().numpy()
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5


def test_iir_cascade_streaming_bit_identical_on_card(dev):
    """4 calls with the state carried are bit-identical to one call."""
    from libtsd_tpu_torch.ops.kernels import iir
    secs, _, _ = _butter_sections(4, 0.1)
    casc = iir.IirCascade(secs, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(4, 128 * 64 * 8, generator=g, device=dev)
    y1, s1 = casc(x)
    st, ys = None, []
    for xb in x.chunk(4, dim=1):
        yb, st = casc(xb.contiguous(), st)
        ys.append(yb)
    assert torch.equal(torch.cat(ys, 1), y1) and torch.equal(st, s1)


@pytest.mark.parametrize("order,C,N", [(4, 1, 128 * 8), (4, 200, 128 * 72),
                                       (8, 200, 128 * 64 * 2 + 128 * 8)])
def test_iir_cascade_grid_shapes(dev, order, C, N):
    """#7's (channel, chunk) grid at C = 1, C = 200 and order 8 (4
    sections), with a last chunk of 8 frames, against its plain version."""
    from libtsd_tpu_torch.ops.kernels import iir
    secs, _, _ = _butter_sections(order, 0.1)
    casc = iir.IirCascade(secs, device=dev)
    g = torch.Generator(device=dev).manual_seed(C + order)
    x = torch.randn(C, N, generator=g, device=dev)
    yk, sk = casc(x, tb=8)
    yp, sp = iir.iir_cascade_plain(x, casc.T, casc.S, casc.W, casc.M, tb=8)
    assert rel(yk, yp) < 1e-5 and rel(sk, sp) < 1e-5


@pytest.mark.parametrize("C", [1, 3])
def test_iir_cascade_stream_cut_off_chunks_bit_identical(dev, C):
    """Calls of 8, 72 and 432 frames (no chunk size of the grid divides
    them all) with the state carried are bit-identical to one call."""
    from libtsd_tpu_torch.ops.kernels import iir
    secs, _, _ = _butter_sections(4, 0.1)
    casc = iir.IirCascade(secs, device=dev)
    g = torch.Generator(device=dev).manual_seed(8 + C)
    x = torch.randn(C, 128 * 512, generator=g, device=dev)
    y1, s1 = casc(x, tb=8)
    st, ys, f0 = None, [], 0
    for nf in (8, 72, 432):
        yb, st = casc(x[:, f0 * 128:(f0 + nf) * 128].contiguous(), st, tb=8)
        ys.append(yb)
        f0 += nf
    assert torch.equal(torch.cat(ys, 1), y1) and torch.equal(st, s1)


def test_iir_cascade_two_calls_in_flight(dev):
    """Two calls on one stream with no sync between them share the
    workspace; each call's epoch keeps its flags apart."""
    from libtsd_tpu_torch.ops.kernels import iir
    secs, _, _ = _butter_sections(4, 0.1)
    casc = iir.IirCascade(secs, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    xs = [torch.randn(16, 128 * 256, generator=g, device=dev)
          for _ in range(2)]
    torch.cuda.synchronize()
    outs = [casc(x) for x in xs]
    torch.cuda.synchronize()
    for x, (yk, sk) in zip(xs, outs):
        yp, sp = iir.iir_cascade_plain(x, casc.T, casc.S, casc.W, casc.M)
        assert rel(yk, yp) < 1e-5 and rel(sk, sp) < 1e-5


@pytest.mark.parametrize("f0,deemph,C,N", [(0.25, 0.05, 3, 4 * 4096 * 3),
                                           (0.22, 0.05, 2, 4 * 4096 * 2),
                                           (0.1, 0.0, 5, 4 * 4096),
                                           (0.3, 0.3, 2, 4 * 128 * 9)])
def test_fm_chain_kernel(dev, f0, deemph, C, N):
    """#8 against its plain version across several blocks of 1024 outputs
    (the chained de-emphasis carry) and a ragged last block."""
    from libtsd_tpu_torch.ops.kernels import fm
    chain_ = fm.FmChain(f0, 4, 63, 0.1, deemph, device=dev)
    g = torch.Generator(device=dev).manual_seed(C)
    xr = torch.randn(C, N, generator=g, device=dev)
    xi = torch.randn(C, N, generator=g, device=dev)
    tb = next(t for t in (32, 8, 1) if N % (t * 128 * 4) == 0)
    before = fm.fm_chain.launches
    yk = chain_(xr, xi, tb=tb)
    assert fm.fm_chain.launches == before + 1
    yp = fm.fm_chain_plain(xr, xi, chain_.h, R=4, f0=f0, dev=0.1,
                           b0=chain_.b0, c=chain_.c, p=chain_.p, tb=tb)
    torch.cuda.synchronize()
    assert yk.shape == (C, N // 4)
    # random input: |z| near 0 makes a few discriminator outputs fragile,
    # so hold the bulk to 1e-5 and every output to the de-emphasised jump
    d = (yk - yp).abs()
    assert torch.quantile(d.flatten().cpu(), 0.999).item() < 1e-5


# #8's run-time instance (any R, any taps, planes off a 16-byte line)
# against its plain version: R 3, R 4 with 40 taps, R 4 with 63 taps on
# misaligned planes, R 5; the gates of test_fm_chain_kernel.
@pytest.mark.parametrize("R,K,shift", [(3, 63, 0), (4, 40, 0), (4, 63, 1),
                                       (5, 63, 0)])
def test_fm_chain_kernel_generic_instance(dev, R, K, shift):
    from libtsd_tpu_torch.ops.kernels import fm
    chain_ = fm.FmChain(0.23, R, K, 0.1, 0.05, device=dev)
    C, N = 3, R * 4096 * 2 + R * 128 * 8
    g = torch.Generator(device=dev).manual_seed(R + K)
    buf = torch.randn(2, C * N + shift, generator=g, device=dev)
    xr, xi = (b[shift:].view(C, N) for b in buf)
    assert xr.is_contiguous() and (xr.data_ptr() % 16 == 0) == (shift == 0)
    before = fm.fm_chain.launches
    yk = chain_(xr, xi, tb=8)
    assert fm.fm_chain.launches == before + 1
    yp = fm.fm_chain_plain(xr, xi, chain_.h, R=R, f0=0.23, dev=0.1,
                           b0=chain_.b0, c=chain_.c, p=chain_.p, tb=8)
    torch.cuda.synchronize()
    assert yk.shape == (C, N // R)
    d = (yk - yp).abs()
    assert torch.quantile(d.flatten().cpu(), 0.999).item() < 1e-5


@pytest.mark.parametrize("f0", [0.25, 0.22])
def test_fm_chain_matches_fm_receiver_on_card(dev, f0):
    """#8 against the composed FmReceiver on an FM tone within 1e-5 after
    the first 4 outputs (tests/test_pallas_iir_fm.py:79-102)."""
    from libtsd_tpu_torch.models.receivers import FmReceiver, FmReceiverConfig
    from libtsd_tpu_torch.ops.kernels import fm
    cfg = FmReceiverConfig(channel_freq=f0)
    rx = FmReceiver.create(cfg, device=dev)
    N, C = 4 * 32 * 128 * 4, 3
    n = np.arange(N)
    rng = np.random.default_rng(1)
    audio = 0.4 * np.sin(2 * np.pi * 0.002 * n)
    ph = 2 * np.pi * np.cumsum(cfg.deviation / cfg.decim * audio)
    car = np.exp(1j * (2 * np.pi * np.mod(f0 * n, 1.0) + ph))
    x = np.stack([car * np.exp(1j * a) for a in (0.3, 2.0, 4.0)])
    x = (x + 0.001 * (rng.standard_normal((C, N))
                      + 1j * rng.standard_normal((C, N)))).astype(np.complex64)
    xd = torch.as_tensor(x, device=dev)
    _, y_ref = rx.step(rx.init_for(xd), xd)
    fc = fm.FmChain(f0, 4, 63, 0.1, 0.05, device=dev)
    y = fc(xd.real.contiguous(), xd.imag.contiguous())
    assert (y[:, 4:] - y_ref[:, 4:]).abs().max().item() < 1e-5


def test_fm_iir_kernels_without_build_raise(dev, tmp_path, monkeypatch):
    """No fallback: CUDA tensors with no kernel library (no nvcc) raise
    instead of running the plain versions of #7 and #8."""
    from libtsd_tpu_torch.ops.kernels import _build, fm, iir
    casc = iir.IirCascade(_butter_sections(2, 0.1)[0], device=dev)
    chain_ = fm.FmChain(0.25, 4, 63, 0.1, 0.05, device=dev)
    x = torch.zeros(2, 4 * 4096, device=dev)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        casc(x)
    with pytest.raises(RuntimeError, match="nvcc"):
        chain_(x, x)


# ------------------------------------------- #11 chain_halo (parallel)
# Gates: #3's, per shard: 1e-4 of the plain version's peak and 1e-3 per bin
# (floor 1e-6 of the peak); both sides fp32, the kernel's partial spectra
# combined by atomicAdd.  The shards are virtual, all on cuda:0, launched
# in time order on one stream.

def _halo_inputs(g, dev, precision, T, K, with_hist0, C=3, frames=3):
    G = _G(np.random.default_rng(K).standard_normal(K), dev)
    H = max(G.shape[0] - 1, 1)
    shape = (C, T * frames * 4096)
    if precision in ("int8", "int16"):
        lim = 127 if precision == "int8" else 20000
        dt = torch.int8 if precision == "int8" else torch.int16
        x = torch.randint(-lim, lim + 1, shape, generator=g, device=dev,
                          dtype=dt)
        h0 = torch.randint(-lim, lim + 1, (C, H, 128), generator=g,
                           device=dev, dtype=dt)
    else:
        x = torch.randn(shape, generator=g, device=dev)
        h0 = torch.randn(C, H, 128, generator=g, device=dev)
    return G, [c.contiguous() for c in x.chunk(T, dim=1)], \
        (h0 if with_hist0 else None)


@pytest.mark.parametrize("fir_passes", [2, 3])
@pytest.mark.parametrize("with_hist0", [False, True])
@pytest.mark.parametrize("K", [1, 200, 256, 257])     # D = 1, 3, 3, 3
@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("T", [2, 4])
def test_chain_halo_kernel(dev, T, precision, K, with_hist0, fir_passes):
    """Every tier at both pass counts: the tiers with one tap plane (bf16,
    int8; int16 and split at passes 2) at K <= 257 take the wgmma body
    (chain_wg::chain_halo_kernel), the others chain_frames; wg_launches
    grows by T exactly where chain.wg_route says."""
    from libtsd_tpu_torch.ops.kernels import chain_halo
    g = torch.Generator(device=dev).manual_seed(K + T)
    G, xs, h0 = _halo_inputs(g, dev, precision, T, K, with_hist0)
    before = chain_halo.fir_periodogram4096_halo.launches
    wg = chain_halo.fir_periodogram4096_halo.wg_launches
    k = chain_halo.fir_periodogram4096_halo(xs, G, h0, precision, fir_passes)
    assert chain_halo.fir_periodogram4096_halo.launches == before + T
    _, Kt, passes = chain.kernel_taps(G, precision, fir_passes, dev)
    assert chain.wg_route(passes, Kt) == (
        _wg_tier(precision, fir_passes) and K <= chain.K_MAX_WG)
    assert chain_halo.fir_periodogram4096_halo.wg_launches == wg + T * (
        chain.wg_route(passes, Kt))
    p = chain_halo.fir_periodogram4096_halo_plain(xs, G, h0, precision,
                                                  fir_passes)
    for a, b in zip(k, p):
        assert rel(a, b) < TOL
        assert bin_err(a, b) < TOL_BIN


@pytest.mark.parametrize("fir_passes", [2, 3])
@pytest.mark.parametrize("precision", ["highest", "bf16", "int16", "int8"])
def test_chain_halo_reused_and_poisoned_slots(dev, precision, fir_passes):
    """The same HaloBuffers over calls: a second input gives its own
    spectra (no stale flag or slot is read), and slots filled with NaN (an
    integer sentinel) beforehand give finite, correct spectra; on both
    bodies (bf16, int8 and int16/2 take the wgmma body)."""
    from libtsd_tpu_torch.ops.kernels import chain_halo
    g = torch.Generator(device=dev).manual_seed(3)
    T = 4
    bufs = chain_halo.HaloBuffers()
    for call in range(3):
        G, xs, _ = _halo_inputs(g, dev, precision, T, 256, False)
        if call == 2:
            for r in bufs.recv:
                r.fill_(float("nan") if r.is_floating_point() else 77)
        k = chain_halo.fir_periodogram4096_halo(xs, G, None, precision,
                                                fir_passes, bufs=bufs)
        p = chain_halo.fir_periodogram4096_halo_plain(xs, G, None, precision,
                                                      fir_passes)
        assert bufs.epoch == call + 1
        for a, b in zip(k, p):
            assert bool(torch.isfinite(a).all())
            assert rel(a, b) < TOL
            assert bin_err(a, b) < TOL_BIN


def test_chain_halo_mixed_row_and_refit_slots(dev):
    """A row with a CPU shard and a card shard raises, whichever comes
    first (no plain version for the card's shard); one HaloBuffers taken
    from a row of 3 channels to a row of 5 is made anew and stays right."""
    from libtsd_tpu_torch.ops.kernels import chain_halo
    g = torch.Generator(device=dev).manual_seed(9)
    G, xs, _ = _halo_inputs(g, dev, "highest", 2, 256, False)
    for row in ([xs[0].cpu(), xs[1]], [xs[0], xs[1].cpu()]):
        with pytest.raises(ValueError, match="mixes CPU and CUDA"):
            chain_halo.fir_periodogram4096_halo(row, G)
    bufs = chain_halo.HaloBuffers()
    for C in (3, 5, 3):
        G, xs, _ = _halo_inputs(g, dev, "highest", 2, 256, False, C=C)
        k = chain_halo.fir_periodogram4096_halo(xs, G, bufs=bufs)
        p = chain_halo.fir_periodogram4096_halo_plain(xs, G)
        assert bufs.recv[0].shape == (2, C, 256)
        for a, b in zip(k, p):
            assert rel(a, b) < TOL
            assert bin_err(a, b) < TOL_BIN


@pytest.mark.parametrize("halo", ["ppermute", "fused"])
def test_sharded_fused_chain_on_card(dev, halo):
    """Both exchange forms on a (2, 4) mesh of virtual shards of cuda:0
    against the unsharded #3: 1e-5 of the peak (tests/test_parallel.py:96)
    and 1e-3 per bin."""
    from libtsd_tpu_torch.parallel import make_mesh, shard
    from libtsd_tpu_torch.parallel import sharded_fir_periodogram4096
    g = torch.Generator(device=dev).manual_seed(5)
    mesh = make_mesh(chan=2, time=4, devices=[dev] * 8)
    G = _G(fir_lowpass(256, 0.2), dev)
    x = torch.randint(-2048, 2048, (4, 4 * 8 * 4096), generator=g,
                      device=dev, dtype=torch.int16)
    one = chain.fir_periodogram4096(x, G, precision="int16", fir_passes=2)
    for xin in (x, shard(mesh, x)):
        s = sharded_fir_periodogram4096(mesh, xin, G, precision="int16",
                                        halo=halo, fir_passes=2)
        assert rel(s, one) < 1e-5
        assert bin_err(s, one) < TOL_BIN


def test_chain_halo_without_build_raises(dev, tmp_path, monkeypatch):
    """No fallback: CUDA shards with no kernel library (no nvcc) raise
    instead of running #11's plain version."""
    from libtsd_tpu_torch.ops.kernels import _build, chain_halo
    G = _G(fir_lowpass(256, 0.2), dev)
    xs = [torch.zeros(2, 4096, device=dev) for _ in range(2)]
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        chain_halo.fir_periodogram4096_halo(xs, G)


def test_sharded_chain_across_cards(dev):
    """The multi-card paths: #11's peer stores, peer access, the streams'
    event waits and the ppermute form's peer copies, on meshes over every
    visible card (a row across all cards; two rows; two shards a card),
    eight calls in a row on the same slots (each parity slot reused four
    times), new data each call, all queued before the host waits for any,
    then each against the unsharded #3 on one card (1e-5 of the peak,
    1e-3 per bin)."""
    from libtsd_tpu_torch.ops.kernels import chain_halo
    from libtsd_tpu_torch.parallel import (make_mesh, shard,
                                           sharded_fir_periodogram4096)
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards (#11's peer stores)")
    cards = [torch.device("cuda", i) for i in range(n)]
    layouts = [(1, n, cards), (1, 2 * n, [c for c in cards for _ in (0, 1)])]
    if n >= 4:
        layouts.append((2, n // 2, cards))
    g = torch.Generator(device=dev).manual_seed(9)
    G = _G(fir_lowpass(256, 0.2), dev)
    for chan, time, devs in layouts:
        mesh = make_mesh(chan=chan, time=time, devices=devs)
        x = [torch.randint(-2048, 2048, (2 * chan, time * 8 * 4096),
                           generator=g, device=dev, dtype=torch.int16)
             for _ in range(8)]
        xs = [shard(mesh, xc) for xc in x]
        for halo in ("fused", "ppermute"):
            # no host sync between the calls: a call may queue on the
            # cards while the one before it still runs
            outs = [sharded_fir_periodogram4096(mesh, xc, G,
                                                precision="int16", halo=halo,
                                                fir_passes=2) for xc in xs]
            for call, (s, xc) in enumerate(zip(outs, x)):
                one = chain.fir_periodogram4096(xc, G, precision="int16",
                                                fir_passes=2)
                assert s.device == cards[0]
                assert rel(s, one) < 1e-5, (chan, time, halo, call)
                assert bin_err(s, one) < TOL_BIN
        row = xs[-1][0]
        k = chain_halo.fir_periodogram4096_halo(row, G, None, "int16", 2)
        p = chain_halo.fir_periodogram4096_halo_plain(row, G, None, "int16",
                                                      2)
        for a, b in zip(k, p):
            assert a.device == b.device
            assert rel(a, b) < TOL and bin_err(a, b) < TOL_BIN


# -------------------------------- #11 across processes (CUDA IPC slots)

_IPC_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from libtsd_tpu_torch.ops.filter_rt import fir_toeplitz_mats
from libtsd_tpu_torch.ops.fir_design import fir_lowpass
from libtsd_tpu_torch.ops.kernels import chain, chain_halo
from libtsd_tpu_torch.parallel import (launch, make_mesh, shard,
                                       sharded_fir_periodogram4096)

argv = sys.argv
get = lambda k: argv[argv.index(k) + 1]
n, pid, mode = int(get("--nproc")), int(get("--pid")), argv[1]
cards = {"shared": [0], "own": [pid], "pair": [2 * pid, 2 * pid + 1]}[mode]
launch.initialize(get("--coordinator"), n, pid, local_device_ids=cards)
dev = torch.device("cuda", cards[0])
T, k0 = n * len(cards), pid * len(cards)      # the row; this rank's first
mesh = make_mesh(chan=1, time=T)
link = mesh.links[0]
assert link.transport == ("gloo" if mode == "shared" else "nccl"), link
bufs = chain_halo.HaloBuffers(link)


def rel(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


def bin_err(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs() / (b.abs() + 1e-6 * b.abs().max())).max().item()


G = torch.as_tensor(fir_toeplitz_mats(np.asarray(fir_lowpass(256, 0.2),
                                                 np.float64))
                    .astype(np.float32), device=dev)
C, F = 3, 3
for call in range(20):
    # the same input on every rank (one generator, one seed a call);
    # int16/2 then, from call 10, "highest" (the slots made anew)
    prec = "int16" if call < 10 else "highest"
    g = torch.Generator(device=dev).manual_seed(100 + call)
    if prec == "int16":
        x = torch.randint(-20000, 20001, (C, T * F * 4096), generator=g,
                          device=dev, dtype=torch.int16)
    else:
        x = torch.randn(C, T * F * 4096, generator=g, device=dev)
    xs = [c.contiguous() for c in x.chunk(T, dim=1)]
    mine = [xs[k0 + j].to(d) for j, d in enumerate(mesh.devices[0])]
    if call % 5 == 4:             # poison this rank's slots first
        torch.cuda.synchronize()
        for r in bufs.recv:
            r.fill_(float("nan") if r.is_floating_point() else 77)
        torch.cuda.synchronize()
        dist.barrier()
    ks = chain_halo.fir_periodogram4096_halo(mine, G, None, prec, 2,
                                             bufs=bufs)
    ps = chain_halo.fir_periodogram4096_halo_plain(xs, G, None, prec, 2)
    assert bufs.epoch == (call % 10) + 1, (call, bufs.epoch)
    for j, k in enumerate(ks):
        p = ps[k0 + j].to(k.device)
        assert bool(torch.isfinite(k).all()), call
        assert rel(k, p) < 1e-4 and bin_err(k, p) < 1e-3, (call, rel(k, p))
# both forms of the sharded chain on the same row, 8 calls in a row on new
# data each call, queued with no host sync between them (the fused form's
# slots reused 4 times each, ordered by the row's sum alone on NCCL), then
# each against #3 on one card
x = [torch.randint(-2048, 2048, (2, T * 8 * 4096), generator=g, device=dev,
                   dtype=torch.int16) for _ in range(8)]
xs = [launch.ingest_local(mesh, xc[:, launch.host_slice(mesh, "time",
                                                        xc.shape[1])])
      for xc in x]
for halo in ("fused", "ppermute"):
    outs = [sharded_fir_periodogram4096(mesh, xc, G, precision="int16",
                                        halo=halo, fir_passes=2)
            for xc in xs]
    for call, (s, xc) in enumerate(zip(outs, x)):
        one = chain.fir_periodogram4096(xc, G, precision="int16",
                                        fir_passes=2)
        s = s.to(dev)
        assert rel(s, one) < 1e-5 and bin_err(s, one) < 1e-3, (halo, call)
print(f"rank {pid} OK", flush=True)
dist.destroy_process_group()
"""


def _ipc_row(n: int, mode: str) -> None:
    from libtsd_tpu_torch.ops.kernels import _build
    from libtsd_tpu_torch.parallel import launch
    _build.build()              # the workers only load the library
    outs = launch.spawn(["-c", _IPC_WORKER, mode], n, timeout=300)
    for p, out in enumerate(outs):
        assert f"rank {p} OK" in out, out[-2000:]


def test_chain_halo_across_processes_shared_card(dev):
    """#11 with one "time" row across 2 processes on one card (the gloo
    transport: the slot of rank 1 mapped into rank 0 by CUDA IPC, each
    rank started after its left neighbour's kernel): 20 calls on the same
    slots, poisoned every fifth call, int16/2 then "highest" (slots made
    anew), each rank's spectrum against #11's plain version of the row
    (TOL of the peak, TOL_BIN a bin); then both forms of the sharded chain,
    8 calls on new data queued before any check, against #3 (1e-5 of the
    peak)."""
    _ipc_row(2, "shared")


def test_chain_halo_across_processes_one_card_each(dev):
    """As above over 2-4 processes on a card each (the NCCL transport: a
    row barrier on the stream each direct call, the neighbours' kernels
    side by side; the sharded chain's calls ordered by its row sum
    alone)."""
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two or more cards (a process a card)")
    _ipc_row(n, "own")


def test_chain_halo_across_processes_two_cards_each(dev):
    """As above over 2 processes of 2 cards each: a row of 4 shards, the
    push inside each process through a peer pointer and across the
    processes through the IPC mapping on the segment's last card."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (2 processes x 2 cards)")
    _ipc_row(2, "pair")


# ------------------------------------- the spectral, RDS and channelizer
# paths: no kernel of their own; each is held on the card to the same port
# call on CPU copies of its inputs (fp32 on both, other FFT and summation
# orders: TOL of the peak)

def _cpu_pair(dev, shape, seed, cplx=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*shape, generator=g, device=dev)
    if cplx:
        x = torch.complex(x, torch.randn(*shape, generator=g, device=dev))
    return x, x.cpu()


@pytest.mark.parametrize("cfg", [dict(N=4096, navg=4),
                                 dict(N=4096, navg=4, nsubs=8,
                                      sweep_step=2048, mask_hf=16,
                                      mask_bf=8)])
def test_rt_spectrum_on_card_matches_cpu(dev, cfg):
    from libtsd_tpu_torch.ops.spectrum import RtSpectrum, SpectrumConfig
    c = SpectrumConfig(**cfg)
    bc = RtSpectrum.create(c, device=dev)
    bh = RtSpectrum.create(c, device="cpu")
    sc, sh = bc.init(), bh.init()
    for step in range(3):
        x, xh = _cpu_pair(dev, (4, 2 * c.nsubs * c.N), step)
        sc, dc = bc.step(sc, x)
        sh, dh = bh.step(sh, xh)
        assert dc.device.type == "cuda"
        assert rel(sc, sh.to(dev)) < TOL


def test_cqt_stream_on_card_matches_cpu(dev):
    from libtsd_tpu_torch.ops.cqt import cqt_stream, cqt_stream_kernel
    K = cqt_stream_kernel(55 / 8000, 3000 / 8000)
    x, xh = _cpu_pair(dev, (K.N * 6,), 1, cplx=False)
    tc, mc, vc = cqt_stream(x, K)
    th, mh, vh = cqt_stream(xh, K)
    assert mc.device.type == "cuda"
    assert torch.equal(tc.cpu(), th) and torch.equal(vc.cpu(), vh)
    assert rel(mc, mh.to(dev)) < TOL


def test_channelizer_step_on_card_matches_cpu(dev):
    from libtsd_tpu_torch.models.channelizer import Channelizer
    bc = Channelizer.create(256, device=dev)
    bh = Channelizer.create(256, device="cpu")
    sc, sh = bc.init(), bh.init()
    for step in range(3):
        x, xh = _cpu_pair(dev, (256 * 512,), step)
        sc, yc = bc.step(sc, x)
        sh, yh = bh.step(sh, xh)
        assert yc.device.type == "cuda"
        assert rel(yc, yh.to(dev)) < TOL
        assert rel(sc["hist"], sh["hist"].to(dev)) < TOL


def test_rds_baseband_on_card_matches_cpu(dev):
    from libtsd_tpu_torch.models.rds import (rds_baseband, rds_encode_groups,
                                             rds_group_0a, rds_subcarrier)
    from libtsd_tpu_torch.ops.signal import cycles
    fs = 1.024e6 / 7
    bits = rds_encode_groups([rds_group_0a(0xF201, 4, s, "AB")
                              for s in range(4)])
    n = 24576
    mpx = (0.1 * torch.cos(2 * np.pi * cycles(19e3 / fs, n, device=dev))
           + rds_subcarrier(bits, fs, n, device=dev))
    yc = rds_baseband(mpx, fs)
    yh = rds_baseband(mpx.cpu(), fs)
    assert yc.device.type == "cuda"
    assert rel(yc, yh.to(dev)) < TOL


def test_czt_and_xcorr_on_card_match_cpu(dev):
    from libtsd_tpu_torch.ops.corr import xcorr
    x, xh = _cpu_pair(dev, (3, 4096), 2)
    W, z0 = np.exp(-2j * np.pi * 0.0013), np.exp(0.3j)
    assert rel(F.czt(x, 3000, W=W, z0=z0),
               F.czt(xh, 3000, W=W, z0=z0).to(dev)) < TOL
    y, yh = _cpu_pair(dev, (4096,), 3)
    lc, cc = xcorr(x[0], y, 2000)
    lh, ch = xcorr(xh[0], yh, 2000)
    assert torch.equal(lc.cpu(), lh)
    ov = (torch.clamp(4096 - lh.abs(), min=1.0) / 4096).to(dev)
    assert rel(cc * ov, ch.to(dev) * ov) < TOL


# ----------------------------------------------------------------------
# models ported without a kernel: their device paths on CUDA tensors (the
# GF(2) syndromes as float32 matmuls, the tie-stable top-k, eigh, the
# per-sample loops), each against the same call on CPU copies.

def _adsb_blocks(C, n, seed):
    from libtsd_tpu_torch.models.adsb import (_crc_bits_np, adsb_crc,
                                              adsb_waveform)
    rng = np.random.default_rng(seed)
    x = 0.02 * np.abs(rng.standard_normal((C, n))).astype(np.float32)
    want = {}
    for c in range(C):
        for j in range(3):
            bits = rng.integers(0, 2, 112).astype(np.int8)
            bits[:5] = [1, 0, 0, 0, 1]                    # DF17
            bits[88:] = _crc_bits_np(bits[:88])           # CRC-24 parity
            assert adsb_crc(bits).sum() == 0
            p = 1000 + j * 20000 + 37 * c
            wf = adsb_waveform(bits, osf=2)
            x[c, p:p + len(wf)] += 0.8 * wf
            want[(c, p)] = bits
    return x, want


def test_adsb_decode_block_on_card_matches_cpu(dev):
    """(64, 65536) at the default config: the same candidates, bits and
    CRC flags as on the CPU, every frame found with its bits."""
    from libtsd_tpu_torch.models.adsb import AdsbConfig, AdsbDecoder
    x, want = _adsb_blocks(64, 1 << 16, 0)
    dc = AdsbDecoder(AdsbConfig(), device=dev)
    dh = AdsbDecoder(AdsbConfig(), device="cpu")
    gc = dc.decode_block(torch.as_tensor(x, device=dev))
    gh = dh.decode_block(torch.as_tensor(x))
    for f in ("position", "bits", "crc_ok", "valid"):
        assert torch.equal(getattr(gc, f).cpu(), getattr(gh, f)), f
    assert rel(gc.score, gh.score.to(dev)) < 1e-5
    ok = (gc.valid & gc.crc_ok).cpu().numpy()
    pos, bits = gc.position.cpu().numpy(), gc.bits.cpu().numpy()
    got = {(c, int(pos[c, k])): bits[c, k] for c in range(64)
           for k in np.flatnonzero(ok[c])}
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_adsb_topk_ties_on_card(dev):
    """Equal scores everywhere (a flat block): the candidates are the
    lowest positions in order, on the card as on the CPU."""
    from libtsd_tpu_torch.ops.signal import top_k_stable
    v = torch.zeros(4, 100000, device=dev)
    v[:, 5000:5010] = 1.0
    s, i = top_k_stable(v, 16)
    want = list(range(5000, 5010)) + list(range(6))
    assert (i.cpu() == torch.as_tensor(want)).all()
    assert torch.equal(s.cpu(), top_k_stable(v.cpu(), 16)[0])


def test_pocsag_scan_on_card_matches_cpu(dev):
    """The sync scan, BCH syndromes and pair corrections on the card,
    against the CPU, on a page with two bit errors in one codeword."""
    from libtsd_tpu_torch.models import pocsag as P
    bits = P.pocsag_encode(ric=42, function=3, text="CARD BCH TEST").copy()
    base = 576 + 32 + 5 * 32
    bits[base + 3] ^= 1
    bits[base + 19] ^= 1
    z = P.pocsag_waveform(bits, fe=48000.0, debit=1200, fi=3000.0)
    cfg = P.PocsagConfig(fe=48000.0, fi=3000.0, debit=1200)
    dc = P.PocsagDecoder(cfg, device=dev)
    dh = P.PocsagDecoder(cfg, device="cpu")
    d = dc._front(torch.as_tensor(z, device=dev))
    rc, rh = dc._scan(d, 1200), dh._scan(d.cpu(), 1200)
    for f in ("position", "bits", "cw_ok", "valid"):
        assert torch.equal(getattr(rc, f).cpu(), getattr(rh, f)), f
    assert rel(rc.score, rh.score.to(dev)) < 1e-5
    msgs = dc.decode(torch.as_tensor(z, device=dev))
    assert [(m.ric, m.function, m.text) for m in msgs] == \
        [(42, 3, "CARD BCH TEST")]


def test_doa_spectra_on_card_match_cpu(dev):
    from libtsd_tpu_torch.models import doa as D
    from libtsd_tpu_torch.models.stats import psd_subspace
    rng = np.random.default_rng(4)
    k = np.arange(16)
    X = sum(np.outer(np.exp(2j * np.pi * 0.5 * np.cos(np.deg2rad(a)) * k),
                     rng.standard_normal(400) + 1j * rng.standard_normal(400))
            for a in (70.0, 110.0))
    X = X + 0.1 * (rng.standard_normal((16, 400))
                   + 1j * rng.standard_normal((16, 400)))
    R = torch.as_tensor((X @ X.conj().T / 400).astype(np.complex64))
    Rc = R.to(dev)
    pc, sc = D.capon_spectrum(Rc, 0.5, 2048)
    ph, sh = D.capon_spectrum(R, 0.5, 2048)
    assert sc.device.type == "cuda" and rel(sc, sh.to(dev)) < 1e-4
    for f in (D.musicdoa_1d, D.capondoa_1d):
        ac, ah = f(Rc, 0.5, 2, Nf=2048), f(R, 0.5, 2, Nf=2048)
        assert torch.equal(ac.cpu(), ah)
    x = torch.as_tensor(X[0].astype(np.complex64))
    _, mc = psd_subspace(x.to(dev), 2, 512, 16)
    _, mh = psd_subspace(x, 2, 512, 16)
    assert torch.argmax(mc).item() == torch.argmax(mh).item()
    assert rel(10 ** (-mc.double() / 10), 10 ** (-mh.double().to(dev) / 10)
               ) < 1e-4


def test_lms_and_kalman_on_card_match_cpu(dev):
    from libtsd_tpu_torch.models import waveform as WF
    from libtsd_tpu_torch.models.equalizer import LmsEqualizer
    from libtsd_tpu_torch.models.kalman import kalman_filter, ssm_random_walk
    rng = np.random.default_rng(5)
    sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, 600)))
    x = (np.convolve(sym, [1.0, 0.35 - 0.2j, 0.12j])[:600]).astype(
        np.complex64)
    outs = []
    for d in (dev, "cpu"):
        eq = LmsEqualizer(WF.wf_qpsk(WF.PulseShape.nrz(), device=d),
                          structure="dfe", N1=11, N2=7)
        _, (y, _, act) = eq.step(eq.init(), torch.as_tensor(x, device=d))
        outs.append(y.cpu())
    assert (outs[0] - outs[1]).abs().max().item() < 1e-4
    ys = torch.as_tensor(np.cumsum(0.1 * rng.standard_normal(500))
                         + rng.standard_normal(500),
                         dtype=torch.float32)[:, None]
    xc, _ = kalman_filter(ssm_random_walk(), ys.to(dev))
    xh, _ = kalman_filter(ssm_random_walk(), ys)
    assert xc.device.type == "cuda" and rel(xc, xh.to(dev)) < 1e-5


# ------------------------------------------------- the examples on the card

def test_qam_serving_twin_on_card(dev):
    """qam_serving's main at its default 128 channels: engine cuda-fused
    (#6), every channel's tail EVM < 0.2, no bit error."""
    from libtsd_tpu_torch.examples import qam_serving
    r = qam_serving.main(128, dev)
    assert r["engine"] == "cuda-fused" and r["evm_max"] < 0.2
    assert r["bit_errors"] == 0


def test_serving_loop_twin_on_card(dev):
    """serving_loop's main on the fused detector (#10), with its asserts
    (every payload without a bit error, the resume bit-identical); its
    detections those of the "torch" engine at the same Ne: the same stream
    samples and payload bits, scores within 5e-4."""
    from libtsd_tpu_torch.examples import serving_loop
    r = serving_loop.main("cuda-fused", dev)
    assert r["payloads"] == serving_loop.NFRAMES and r["bit_errors"] == 0
    ref = serving_loop.main("torch", dev, r["ne"])
    assert ref["block_len"] == r["block_len"]
    a, b = ref["detections"], r["detections"]
    assert [p for p, _, _ in a] == [p for p, _, _ in b]
    assert all(np.array_equal(x, y) for (_, _, x), (_, _, y) in zip(a, b))
    assert max(abs(x - y) for (_, x, _), (_, y, _) in zip(a, b)) < 5e-4


def test_fm_demo_twin_on_card(dev, tmp_path):
    """fm_demo's main without its report: corr > 0.97 on every station,
    the WAVs written."""
    from libtsd_tpu_torch.examples import fm_demo
    r = fm_demo.main(dev, str(tmp_path), report=False)
    assert min(r["corr"]) > fm_demo.TOL_CORR
    assert all((tmp_path / f"station{i}.wav").exists() for i in range(3))
