"""The port's ``viz`` against the JAX package's ``viz`` on the same numpy
inputs (tensors on the port's side): the same recorded plot operations
(kind, format, label, arrays to 1e-12 of their peak, or to 1e-5 where a
float32 computation sits under them), titles, axis labels and unit
strings; ``cic_analyse``'s metrics equal within 1e-9; the same figures in
a debug report; ``subspace_spectrum(debug=True)`` drawing JAX's MDL
panel.  Then the debug-report twin's main function in this process at a
small size.  No figure is rendered except where a report writes its PNGs
(into pytest's tmp_path).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libtsd_tpu.viz as Vj
from libtsd_tpu.models import stats as Sj
from libtsd_tpu.ops import resample as RSj
from libtsd_tpu.viz import report as report_j
import libtsd_tpu_torch.viz as V
from libtsd_tpu_torch.models import stats as St
from libtsd_tpu_torch.ops import resample as RS
from libtsd_tpu_torch.viz import report as report_t
from torch_compare import rel  # (importing it caps the threads)


def same_ops(a, b, tol=1e-12):
    """Two Figures recorded the same operations, titles and labels."""
    assert (a._title, a._xlabel, a._ylabel, a._xunit, a._yunit) == \
        (b._title, b._xlabel, b._ylabel, b._xunit, b._yunit)
    assert len(a._ops) == len(b._ops)
    for oa, ob in zip(a._ops, b._ops):
        assert (oa[0], oa[3], oa[4]) == (ob[0], ob[3], ob[4])
        for xa, xb in zip(oa[1:3], ob[1:3]):
            assert (xa is None) == (xb is None)
            if xa is not None and not isinstance(xa, (list, tuple)):
                xa, xb = np.asarray(xa), np.asarray(xb)
                assert xa.shape == xb.shape
                if xa.size:
                    assert rel(xa, xb) <= tol


def same_figures(a, b, tol=1e-12):
    assert len(a._subs) == len(b._subs)
    for fa, fb in zip(a._subs, b._subs):
        same_ops(fa, fb, tol)


@pytest.fixture
def sig():
    rng = np.random.default_rng(5)
    return ((rng.standard_normal(512) + 1j * rng.standard_normal(512))
            .astype(np.complex64))


def test_figure_ops_titles_and_units(sig):
    for mod, x in ((Vj, jnp.asarray(sig)), (V, torch.as_tensor(sig))):
        f = mod.Figure("t0")
        f.plot(x, "r-o", label="x").plot(x.real, "g:")
        f.plot(np.arange(512.0), x.imag, "b-")
        f.plot_psd(x, fs=2e3, label="psd").plot_iq(x[:64], "bo")
        f.plot_img(np.outer(np.arange(4.0), np.arange(3.0)))
        f.titles("", ylabel="amplitude").set_units("Hz", "V")
        if mod is Vj:
            fj = f
    same_ops(f, fj, 1e-6)     # the PSD: float32 input, float64 window
    assert f._title == "t0" and f._xlabel == "Frequency"
    vals = [0.0, 1.5e-7, 2.5e-4, 0.012, 3.0, 1500.0, 2.25e6, 4.1e9]
    for unit in ("", "Hz", "V"):
        for v in vals:
            assert V.unit_format(v, unit) == Vj.unit_format(v, unit)
        assert V.si_tick_formatter(vals, unit) == \
            Vj.si_tick_formatter(vals, unit)
        assert V.calc_expo_ndigits_common(vals, unit) == \
            Vj.calc_expo_ndigits_common(vals, unit)


def test_eye_plz_filter_and_ellipse(sig):
    same_ops(V.plot_eye(torch.as_tensor(sig), 4, ntraces=20),
             Vj.plot_eye(jnp.asarray(sig), 4, ntraces=20))
    b, a = [0.2, 0.4, 0.2], [1.0, -0.5, 0.25]
    same_ops(V.plot_plz(torch.tensor(b), a), Vj.plot_plz(b, a))
    h = np.hanning(31)
    same_figures(V.plot_filter(torch.as_tensor(h)), Vj.plot_filter(h))
    same_figures(V.plot_filter(b, a, complete=True, fs=48e3),
                 Vj.plot_filter(b, a, complete=True, fs=48e3))
    P = np.array([[2.0, 0.3], [0.3, 0.5]])
    ft = V.plot_covariance_ellipse(V.Figure(), torch.as_tensor(P),
                                   (1.0, -2.0), nsig=2.0, label="2 sigma")
    fj = Vj.plot_covariance_ellipse(Vj.Figure(), P, (1.0, -2.0), nsig=2.0,
                                    label="2 sigma")
    same_ops(ft, fj)


@pytest.mark.parametrize("N,R,M,comp", [(4, 8, 1, 0), (3, 16, 2, 15),
                                        (5, 32, 1, 31)])
def test_cic_analyse_metrics(N, R, M, comp):
    ft, mt = V.cic_analyse(RS.CicConfig(N=N, R=R, M=M), fe=48e3,
                           comp_ncoefs=comp, bout_bits=20)
    fj, mj = Vj.cic_analyse(RSj.CicConfig(N=N, R=R, M=M), fe=48e3,
                            comp_ncoefs=comp, bout_bits=20)
    assert mt.keys() == mj.keys()
    for k in mt:
        if isinstance(mt[k], float):
            assert abs(mt[k] - mj[k]) <= 1e-9 * max(1.0, abs(mj[k])), k
        else:
            assert np.array_equal(mt[k], mj[k]), k
    same_figures(ft, fj, 1e-9)


def test_debug_report_same_figures(sig, tmp_path):
    """The same signals (complex symbols, real, a mask, a scalar) give the
    same figures in both packages' debug reports, tensors on the port's
    side."""
    sigs = {"sym_out": sig[:128], "x1": sig[:64], "energy": np.abs(sig),
            "mask": np.abs(sig) > 1.0, "has_detection": np.array(True),
            "scalar": np.array(3.0)}
    got = V.debug_figures({k: torch.as_tensor(v) for k, v in sigs.items()})
    want = Vj.debug_figures(sigs)
    assert [t for _, t in got] == [t for _, t in want]
    for (a, _), (b, _) in zip(got, want):
        same_ops(a, b)
    pt = V.debug_report("port", {k: torch.as_tensor(v)
                                 for k, v in sigs.items()},
                        str(tmp_path / "t"))
    pj = Vj.debug_report("jax", sigs, str(tmp_path / "j"))
    assert os.path.exists(pt)
    assert sorted(os.listdir(tmp_path / "t" / "img")) == \
        sorted(os.listdir(tmp_path / "j" / "img"))


def test_subspace_spectrum_debug_draws(tmp_path, monkeypatch):
    """debug=True with the automatic source count draws JAX's eigenvalue
    and MDL panel into the active report; the spectrum is unchanged."""
    rng = np.random.default_rng(8)
    n = np.arange(2048)
    x = (np.exp(2j * np.pi * 0.11 * n) + 0.5 * np.exp(2j * np.pi * -0.23 * n)
         + 0.1 * (rng.standard_normal(2048)
                  + 1j * rng.standard_normal(2048))).astype(np.complex64)
    R = np.array(Sj.covmtx(jnp.asarray(x), 8))
    drawn = {}
    for name, mod in (("torch", report_t), ("jax", report_j)):
        rep = mod.Report(str(tmp_path / name))
        monkeypatch.setattr(rep, "add_figure",
                            lambda fig, title="", name=name:
                            drawn.setdefault(name, []).append((fig, title)))
        monkeypatch.setattr(mod, "_report", rep)
    _, st = St.subspace_spectrum(torch.as_tensor(R), -1, 64, debug=True)
    _, sj = Sj.subspace_spectrum(R, -1, 64, debug=True)
    assert [t for _, t in drawn["torch"]] == [t for _, t in drawn["jax"]] \
        == ["MDL"]
    same_figures(drawn["torch"][0][0], drawn["jax"][0][0], 1e-5)
    assert torch.equal(st, St.subspace_spectrum(torch.as_tensor(R), -1,
                                                64)[1])
    assert rel(st, np.asarray(sj)) < 1e-4


def test_debug_report_twin_runs(tmp_path):
    """``python -m libtsd_tpu_torch.examples.debug_report_demo``'s main,
    on the CPU at a small size: three reports, each with its figures."""
    from libtsd_tpu_torch.examples import debug_report_demo as demo
    paths = demo.main("cpu", str(tmp_path), payload_bits=128, nbits=512,
                      n_fm=1 << 13)
    assert len(paths) == 3
    for p in paths:
        assert os.path.exists(p)
        assert len(os.listdir(os.path.join(os.path.dirname(p), "img"))) > 3


def test_port_imports_without_matplotlib():
    """matplotlib is the optional ``viz`` extra: the package, its entry
    points and the twins import without it; only ``viz`` needs it."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import importlib, pkgutil, libtsd_tpu_torch as P\n"
            "names = [m.name for m in pkgutil.walk_packages(P.__path__, "
            "'libtsd_tpu_torch.') if '.viz' not in m.name]\n"
            "for n in names: importlib.import_module(n)\n"
            "try:\n import libtsd_tpu_torch.viz\nexcept ImportError:\n"
            " print('viz needs matplotlib', len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "viz needs matplotlib" in r.stdout
