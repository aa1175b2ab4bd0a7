"""``psd_welch`` on the FFT kernel's route (``ops.kernels.welch``'s two
passes around #4) against the JAX ``psd_welch``, on the CPU with the route
forced, so that each wrapper runs its plain version; the plain versions
against the composed tensor ops they replace; the wrappers' checks; and
the inputs that keep the composed path.  The kernels themselves are held
to their plain versions on the card (``tests/test_torch_cuda.py``).

Spectra compare in linear power, 1e-5 relative to the peak, as in
``tests/test_torch_fft_psd.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.ops import psd as Pj
from libtsd_tpu_torch.ops import fft as Ft, psd as Pt
from libtsd_tpu_torch.ops.kernels import welch as W
from libtsd_tpu_torch.ops.kernels.fft import fft_pow2_plain
from torch_compare import rel


@pytest.fixture
def kernel_route(monkeypatch):
    """The FFT's route on a card (the wrappers' plain versions here)."""
    monkeypatch.setattr(Ft, "_kernel_eligible", lambda x, axis: True)


def _signal(shape, cplx, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        return (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x.astype(np.float32)


def _lin(db):
    return 10.0 ** (np.asarray(db, np.float64) / 10)


def _route_counts(monkeypatch) -> dict:
    """Count the calls of each wrapper psd_welch makes."""
    calls = {"frames": 0, "power": 0}
    frames, power = W.welch_frames, W.welch_power

    def f(*a):
        calls["frames"] += 1
        return frames(*a)

    def p(*a):
        calls["power"] += 1
        return power(*a)
    monkeypatch.setattr(W, "welch_frames", f)
    monkeypatch.setattr(W, "welch_power", p)
    return calls


@pytest.mark.parametrize("mult", [(1, 0), (2, 0), (2, 1)])   # N, 2N, 2N + 1
@pytest.mark.parametrize("N", [256, 4096])
@pytest.mark.parametrize("cplx", [False, True])
def test_psd_welch_on_the_kernel_route_matches_jax(kernel_route, monkeypatch,
                                                   cplx, N, mult):
    calls = _route_counts(monkeypatch)
    x = _signal((2, 3, mult[0] * N + mult[1]), cplx, N + mult[0])
    ft, St = Pt.psd_welch(torch.as_tensor(x), N)
    fj, Sj = Pj.psd_welch(jnp.asarray(x), N)
    assert calls == {"frames": 1, "power": 1}
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-7)
    assert St.shape == tuple(Sj.shape) == (2, 3, N)
    assert St.dtype == torch.float32
    assert rel(_lin(St.numpy()), _lin(Sj)) < 1e-5


@pytest.mark.parametrize("case", ["float64", "grad"])
def test_other_inputs_keep_the_composed_path(kernel_route, monkeypatch,
                                             case):
    calls = _route_counts(monkeypatch)
    x = torch.as_tensor(_signal((2, 600), False, 3))
    if case == "float64":
        x = x.double()
    else:
        x.requires_grad_(True)
    _, S = Pt.psd_welch(x, 256)
    assert calls == {"frames": 0, "power": 0}
    if case == "grad":
        S.sum().backward()
        assert x.grad is not None and torch.isfinite(x.grad).all()
    _, Sj = Pj.psd_welch(jnp.asarray(x.detach().numpy()), 256)
    assert rel(_lin(S.detach().numpy()), _lin(Sj)) < 1e-5


@pytest.mark.parametrize("cplx", [False, True])
def test_frames_plain_is_the_segments_times_the_window(cplx):
    N, n = 256, 5 * 128 + 3
    nseg = len(range(0, n - N, N // 2))
    x = torch.as_tensor(_signal((3, n), cplx, 6))
    w = Pt._win("hn", N, "cpu")
    re, im = W.welch_frames_plain(x, w, N, nseg)
    want = (Pt._segments(x, N, N // 2, nseg) * w).reshape(-1, N)
    assert re.shape == im.shape == (3 * nseg, N)
    assert torch.equal(torch.complex(re, im) if cplx else re, want)
    if not cplx:
        assert torch.equal(im, torch.zeros_like(im))


def test_power_plain_is_the_composed_reduction():
    C, nseg, N = 3, 5, 256
    g = torch.Generator().manual_seed(7)
    yr, yi = torch.randn(2, C * nseg, N, generator=g)
    got = W.welch_power_plain(yr, yi, C, nseg, N)
    X = torch.complex(yr, yi).reshape(C, nseg, N) * (1.0 / np.sqrt(N))
    S = torch.sum(torch.fft.fftshift(X.abs() ** 2, dim=-1), dim=-2)
    want = 10.0 * torch.log10(S + 1e-30)
    assert got.shape == (C, N)
    assert rel(_lin(got.numpy()), _lin(want.numpy())) < 1e-6


def test_the_three_passes_compose_to_the_periodogram_sum():
    """frames -> #4's plain version -> power, against numpy in float64."""
    N, C, n = 512, 2, 4 * 512
    nseg = len(range(0, n - N, N // 2))
    x = _signal((C, n), True, 8)
    w = Pt._win("hn", N, "cpu")
    re, im = W.welch_frames(torch.as_tensor(x), w, N, nseg)
    got = W.welch_power(*fft_pow2_plain(re, im), C, nseg, N)
    segs = np.stack([x[:, s * N // 2:s * N // 2 + N] for s in range(nseg)])
    P = np.abs(np.fft.fft(segs * w.double().numpy(), axis=-1)) ** 2 / N
    want = np.fft.fftshift(P.sum(0), axes=-1)
    assert rel(_lin(got.numpy()), want) < 1e-5


def test_power_ranges_cover_the_segments_once():
    for C, nseg, N in [(4, 32766, 4096), (1, 1, 256), (3, 7, 16384),
                       (5000, 3, 1024), (2, 1000, 256)]:
        L, P = W.power_ranges(C, nseg, N)
        assert L >= 1 and (P - 1) * L < nseg <= P * L
        assert P <= W.POWER_BLOCKS
    assert W.power_ranges(4, 32766, 4096) == (512, 64)


@pytest.mark.parametrize("bad", [
    {"x": torch.zeros(2, 1024, dtype=torch.float64)},
    {"x": torch.zeros(2, 1024, dtype=torch.int16)},
    {"x": torch.zeros(2048)},
    {"w": torch.zeros(255)},
    {"w": torch.zeros(256, dtype=torch.float64)},
    {"N": 384},
    {"N": 128},
    {"N": 32768, "w": torch.zeros(32768), "x": torch.zeros(2, 65536)},
    {"nseg": 8},
    {"nseg": 0},
])
def test_frames_wrapper_raises(bad):
    args = dict(x=torch.zeros(2, 1024), w=torch.zeros(256), N=256, nseg=7)
    args.update(bad)
    with pytest.raises(ValueError):
        W.welch_frames(args["x"], args["w"], args["N"], args["nseg"])


def test_frames_wrapper_raises_on_a_conjugate_view():
    x = torch.zeros(2, 1024, dtype=torch.complex64).conj()
    with pytest.raises(ValueError, match="conj"):
        W.welch_frames(x, torch.zeros(256), 256, 7)


@pytest.mark.parametrize("bad", [
    {"yr": torch.zeros(14, 257)},
    {"yi": torch.zeros(13, 256)},
    {"yr": torch.zeros(14, 256, dtype=torch.float64)},
    {"N": 300},
    {"C": 0, "yr": torch.zeros(0, 256), "yi": torch.zeros(0, 256)},
])
def test_power_wrapper_raises(bad):
    args = dict(yr=torch.zeros(14, 256), yi=torch.zeros(14, 256), C=2,
                nseg=7, N=256)
    args.update(bad)
    with pytest.raises(ValueError):
        W.welch_power(args["yr"], args["yi"], args["C"], args["nseg"],
                      args["N"])


def test_windows_are_made_once_per_device():
    a = Pt._win("hn", 512, "cpu")
    assert Pt._win("hn", 512, torch.device("cpu")) is a
    assert Pt._win("hm", 512, "cpu") is not a
    from libtsd_tpu_torch.ops.window import window
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(window("hn", 512, sym=False), np.float32))


def test_psd_keeps_no_window_and_the_cache_is_bounded():
    """psd()'s whole-signal windows are not cached (one a signal length
    would pile up); the segment windows keep at most 16."""
    x = torch.as_tensor(_signal((700,), False, 9))
    before = Pt._cached_win.cache_info().currsize
    for n in (300, 301, 517, 700):
        _, S = Pt.psd(x[:n])
        _, Sj = Pj.psd(jnp.asarray(x[:n].numpy()))
        assert rel(_lin(S.numpy()), _lin(Sj)) < 1e-5
    assert Pt._cached_win.cache_info().currsize == before
    for N in range(256, 256 + 40):
        Pt._win("hn", N, "cpu")
    assert Pt._cached_win.cache_info().currsize == 16
