"""The recursive half of the port's filter runtime and kernel #7's plain
version against the JAX package on the CPU, on the same numpy inputs:
ExpSmoother, DcBlocker, Iir (orders 0, 1, 2), IirFrame, iir_filter
(order > 4 through second-order sections), Sos, sos_frame_chain,
filter_signal with (b, a) and ZPK designs, filtfilt, streaming against one
shot, and the fused cascade (``ops.kernels.iir``) against JAX
``IirCascadePallas`` (interpret mode, the file's one Pallas call) and
float64 ``scipy.signal.sosfilt``.

Tolerances and why:

* 1e-5 of the peak between the port and JAX: float32 on both sides, the
  scans in another association order (log-depth doubling here, XLA's
  associative scan there) and the matmuls in another summation order.
* 1e-5 of the peak against float64 sosfilt: the JAX gate of its Pallas
  cascade (tests/test_pallas_iir_fm.py:33-34).
* 1e-5 of the peak between streamed and one-shot runs of the scan-based
  blocks (the carried state enters by another path); bit-identical for
  the per-sample loops and for #7's plain version (its every product is an
  explicit sum in a fixed order, tests/test_pallas_iir_fm.py:37-48).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

from libtsd_tpu.ops import filter_rt as FRj
from libtsd_tpu.ops.iir_design import design_iir, design_lexp, zpk_to_sos
from libtsd_tpu.ops.pallas.iir import IirCascadePallas
from libtsd_tpu_torch.ops import filter_rt as FRt
from libtsd_tpu_torch.ops.kernels import iir as KI
from libtsd_tpu_torch.utils import convert

CPU = "cpu"
TOL = 1e-5


def rel(a, b):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _x(seed, *shape, cplx=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
        return x.astype(np.complex64)
    return x.astype(np.float32)


def _stream(blk, x, cuts):
    """blk over x (last axis) in pieces cut at ``cuts``, state carried."""
    st = blk.init_for(x)
    ys = []
    for a, b in zip((0,) + cuts, cuts + (x.shape[-1],)):
        st, y = blk.step(st, x[..., a:b])
        ys.append(y)
    return st, torch.cat(ys, -1)


def test_exp_smoother_and_dc_blocker():
    x = _x(0, 700)
    for j, t in ((FRj.ExpSmoother.create(0.07),
                  FRt.ExpSmoother.create(0.07, device=CPU)),
                 (FRj.DcBlocker.create(0.01),
                  FRt.DcBlocker.create(0.01, device=CPU))):
        sj, yj = j.step(j.init(), jnp.asarray(x))
        st, yt = t.step(t.init(), torch.as_tensor(x))
        assert rel(yt, yj) < TOL
        _, ys = _stream(t, torch.as_tensor(x), (100, 333))
        assert rel(ys, yt) < TOL


@pytest.mark.parametrize("design", ["gain", "lexp", "butter2", "butter2c"])
def test_iir_orders(design):
    """Iir of order 0 (a gain), 1 (the log-depth scan) and 2 (the
    per-sample loop), real and complex, one shot and streamed."""
    b, a = {"gain": (np.array([0.5]), np.array([2.0])),
            "lexp": design_lexp(0.05)}.get(
        design, design_iir(2, "lp", "butterworth", 0.1).to_ba())
    x = _x(1, 2, 300, cplx=design == "butter2c")
    j = FRj.Iir.create(b, a)
    t = FRt.Iir.create(b, a, device=CPU)
    sj, yj = j.step(j.init_for(jnp.asarray(x)), jnp.asarray(x))
    st, yt = t.step(t.init_for(torch.as_tensor(x)), torch.as_tensor(x))
    assert t.order == len(a) - 1 if design != "gain" else t.order == 0
    assert rel(yt, yj) < TOL
    assert rel(st, sj) < TOL if st.numel() else True
    ss_, ys = _stream(t, torch.as_tensor(x), (37, 200))
    if t.order >= 2:
        assert torch.equal(ys, yt)
    else:
        assert rel(ys, yt) < TOL


@pytest.mark.parametrize("cplx", [False, True])
def test_iir_frame(cplx):
    b, a = design_iir(3, "hp", "butterworth", 0.2).to_ba()
    x = _x(2, 2, 128 * 6, cplx=cplx)
    j = FRj.IirFrame.create(b, a)
    t = FRt.IirFrame.create(b, a, device=CPU)
    sj, yj = j.step(j.init_for(jnp.asarray(x)), jnp.asarray(x))
    st, yt = t.step(t.init_for(torch.as_tensor(x)), torch.as_tensor(x))
    assert rel(yt, yj) < TOL and rel(st, sj) < TOL
    _, ys = _stream(t, torch.as_tensor(x), (128, 512))
    assert rel(ys, yt) < TOL
    tc = convert.iir_frame_from_jax(j, device=CPU)
    assert torch.equal(tc.step(tc.init_for(torch.as_tensor(x)),
                               torch.as_tensor(x))[1], yt)
    with pytest.raises(ValueError, match="128"):
        t.step(t.init(), torch.zeros(100))


@pytest.mark.parametrize("order,typ,proto", [(2, "lp", "butterworth"),
                                             (4, "bp", "cheb1"),
                                             (6, "lp", "ellip"),
                                             (8, "hp", "butterworth")])
def test_iir_filter_and_filter_signal(order, typ, proto):
    """iir_filter (order > 4 factored into sections), filter_signal with a
    (b, a) tuple and with the ZPK design, filtfilt."""
    kw = dict(fcut2=0.2) if typ == "bp" else {}
    zpk = design_iir(order, typ, proto, 0.1 if typ == "bp" else 0.15, **kw)
    b, a = zpk.to_ba()
    x = _x(3, 2, 1000)
    yj = np.asarray(FRj.iir_filter(b, a, jnp.asarray(x)))
    assert rel(FRt.iir_filter(b, a, torch.as_tensor(x)), yj) < TOL
    assert rel(FRt.filter_signal((b, a), torch.as_tensor(x)), yj) < TOL
    assert rel(FRt.filter_signal(zpk, torch.as_tensor(x)),
               FRj.filter_signal(zpk, jnp.asarray(x))) < TOL
    assert rel(FRt.filtfilt((b, a), torch.as_tensor(x)),
               FRj.filtfilt((b, a), jnp.asarray(x))) < TOL


def test_iir_filter_delay_and_fir_filtfilt():
    """Leading zeros of b are a pure delay; filtfilt of FIR taps."""
    x = _x(4, 500)
    b, a = np.array([0.0, 0.0, 0.3, 0.2]), np.array([1.0, -0.5])
    assert rel(FRt.iir_filter(b, a, torch.as_tensor(x)),
               FRj.iir_filter(b, a, jnp.asarray(x))) < TOL
    h = np.hanning(21) / np.hanning(21).sum()
    assert rel(FRt.filtfilt(h, torch.as_tensor(x)),
               FRj.filtfilt(h, jnp.asarray(x))) < TOL


def test_sos_and_sos_frame_chain():
    sos, k = zpk_to_sos(design_iir(6, "lp", "ellip", 0.1))
    x = _x(5, 2, 128 * 4)
    j = FRj.Sos.create(sos, k)
    t = FRt.Sos.create(sos, k, device=CPU)
    sj, yj = j.step(j.init_for(jnp.asarray(x)), jnp.asarray(x))
    st, yt = t.step(t.init_for(torch.as_tensor(x)), torch.as_tensor(x))
    assert rel(yt, yj) < TOL and rel(st, sj) < TOL
    _, ys = _stream(t, torch.as_tensor(x), (77, 300))
    assert torch.equal(ys, yt)
    assert torch.equal(convert.sos_from_jax(j, device=CPU).step(
        st * 0, torch.as_tensor(x))[1], yt)
    cj = FRj.sos_frame_chain(sos, k)
    ct = FRt.sos_frame_chain(sos, k, device=CPU)
    yc = ct.step(ct.init_for(torch.as_tensor(x)), torch.as_tensor(x))[1]
    assert rel(yc, cj.step(cj.init_for(jnp.asarray(x)), jnp.asarray(x))[1]) \
        < TOL
    assert rel(yc, yt) < TOL


# ------------------------------------------------- #7, the fused cascade

def _sections(order, typ, fc):
    sos, k = zpk_to_sos(design_iir(order, typ, "butterworth", fc))
    secs = [(sos[s, :3] * (k if s == 0 else 1.0), sos[s, 3:])
            for s in range(sos.shape[0])]
    sc = sos.copy()
    sc[0, :3] *= k
    return secs, sc


@pytest.fixture(scope="module")
def cascade():
    """The JAX cascade on the first half of x, interpreted (the file's one
    Pallas call), and the port's."""
    secs, sc = _sections(4, "lp", 0.1)
    x = _x(6, 3, 128 * 64)
    cj = IirCascadePallas(secs)
    yj, sj = cj(jnp.asarray(x[:, :128 * 32]), tb=16, interpret=True)
    return dict(secs=secs, sc=sc, x=x, cj=cj, yj=np.asarray(yj),
                sj=np.asarray(sj), ct=KI.IirCascade(secs, device=CPU))


def test_iir_cascade_plain_vs_jax_and_sosfilt(cascade):
    ct, x = cascade["ct"], torch.as_tensor(cascade["x"])
    y, st = ct(x, tb=16)
    half = 128 * 32
    assert rel(y[:, :half], cascade["yj"]) < TOL
    ref = ss.sosfilt(cascade["sc"], cascade["x"].astype(np.float64), axis=-1)
    assert rel(y, ref) < TOL
    assert st.shape == (3, 2, 8) and ct.nsec == 2 and ct.k == 2


def test_iir_cascade_from_jax_carries_the_jax_state(cascade):
    """The JAX state after the first half, carried into the port's
    cascade (built from the JAX operators), continues the one-shot run."""
    ct = convert.iir_cascade_from_jax(cascade["cj"], device=CPU)
    for k in ("T", "S", "W", "M"):
        assert torch.equal(getattr(ct, k), getattr(cascade["ct"], k))
    x = torch.as_tensor(cascade["x"])
    half = 128 * 32
    y, _ = ct(x, tb=16)
    y2, _ = ct(x[:, half:], torch.as_tensor(cascade["sj"].copy()), tb=16)
    assert rel(y2, y[:, half:]) < TOL


def test_iir_cascade_streaming_is_bit_identical():
    """4 calls cut at multiples of tb * 128 with the state carried equal
    one call bit for bit (tests/test_pallas_iir_fm.py:37-48)."""
    secs, _ = _sections(2, "hp", 0.2)
    ct = KI.IirCascade(secs, device=CPU)
    x = torch.as_tensor(_x(7, 2, 128 * 32))
    y, s = ct(x, tb=8)
    st, ys = None, []
    for xb in x.chunk(4, dim=1):
        yb, st = ct(xb, st, tb=8)
        ys.append(yb)
    assert torch.equal(torch.cat(ys, 1), y) and torch.equal(st, s)


def test_iir_cascade_rejects_what_it_does_not_take():
    ct = KI.IirCascade(_sections(2, "lp", 0.1)[0], device=CPU)
    with pytest.raises(TypeError, match="REAL-plane"):
        ct(torch.zeros(1, 1024, dtype=torch.complex64))
    with pytest.raises(ValueError, match="multiple of 8192"):
        ct(torch.zeros(1, 1024))
    with pytest.raises(ValueError, match="order 9"):
        KI.IirCascade([(np.ones(10), np.r_[1.0, np.zeros(9)])], device=CPU)
