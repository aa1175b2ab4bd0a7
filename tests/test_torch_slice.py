"""The port's main path as a whole, at a small size, against the JAX chain
(Pallas interpreted), plus the port's package rules: no jax at import, and
no fallback from a CUDA request to a CPU path.

Tolerances, relative to the peak: 1e-2 against the JAX int16 tier (its DFT
stages round to bf16 on purpose, the gate of tests/test_pallas.py); 1e-5
against a float64 reference with the same bf16-rounded taps, and between
the port's fused, composed and streamed forms (all fp32); there also 1e-3
per bin with a floor of 1e-6 of the peak, for the stopband bins."""
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.ops import filter_rt as FRj
from libtsd_tpu.ops.pallas.chain import fir_periodogram4096 as chain_j
from libtsd_tpu_torch.ops.fir_design import fir_lowpass
from libtsd_tpu_torch.ops.kernels import _build
from libtsd_tpu_torch.ops.kernels.chain import fir_periodogram4096
from libtsd_tpu_torch.ops.kernels.fft import fft_pow2
from libtsd_tpu_torch.ops.kernels.fir import fir_kernel
from libtsd_tpu_torch.ops.kernels.periodogram import periodogram4096_acc
from libtsd_tpu_torch.utils.convert import fir_from_jax

ROOT = Path(__file__).resolve().parents[1]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def bin_err(a, b, floor=1e-6):
    """Per-bin error, floored at 1e-6 of b's peak (see test_torch_kernels)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / (np.abs(b) + floor * np.max(np.abs(b))))


def test_main_path_small_matches_jax_chain():
    """fir_lowpass -> Fir converted from the JAX Fir -> fused int16 chain,
    fir_passes=2, against the JAX chain interpreted; then the composed
    (Fir.step -> periodogram) and two-half streamed forms agree with the
    fused one."""
    h = fir_lowpass(256, 0.2)
    fir = fir_from_jax(FRj.Fir.create(h), device="cpu")
    G = fir.G
    D = G.shape[0]
    C, N = 2, 2 * 65536
    x = np.random.default_rng(5).integers(-2048, 2048, size=(C, N)) \
        .astype(np.int16)
    xt = torch.as_tensor(x)
    s2 = fir_periodogram4096(xt, G, precision="int16", fir_passes=2).numpy()
    sj = np.asarray(chain_j(jnp.asarray(x), jnp.asarray(G.numpy()),
                            interpret=True, precision="int16", fir_passes=2))
    assert s2.shape == sj.shape == (C, 4096) and np.isfinite(s2).all()
    assert rel(s2, sj) < 1e-2
    hb = torch.as_tensor(h, dtype=torch.float32).to(torch.bfloat16).double()
    y64 = np.stack([np.convolve(r, hb.numpy())[:N] for r in x.astype(float)])
    ref = (np.abs(np.fft.fft(y64.reshape(C, -1, 4096), axis=-1)) ** 2).sum(1)
    assert rel(s2, ref) < 1e-5
    assert bin_err(s2, ref) < 1e-3

    s3 = fir_periodogram4096(xt, G, precision="int16", fir_passes=3)
    composed = periodogram4096_acc(fir.step(fir.init_for(xt), xt)[1])
    assert rel(composed.numpy(), s3.numpy()) < 1e-5
    assert bin_err(composed.numpy(), s3.numpy()) < 1e-3
    half = N // 2
    hist0 = xt[:, half - (D - 1) * 128:half].reshape(C, D - 1, 128)
    streamed = (fir_periodogram4096(xt[:, :half], G, precision="int16")
                + fir_periodogram4096(xt[:, half:], G, hist0=hist0,
                                      precision="int16"))
    assert rel(streamed.numpy(), s3.numpy()) < 1e-5
    assert bin_err(streamed.numpy(), s3.numpy()) < 1e-3


def test_port_imports_no_jax():
    code = ("import sys, libtsd_tpu_torch, libtsd_tpu_torch.ops, "
            "libtsd_tpu_torch.models, libtsd_tpu_torch.utils.convert, "
            "libtsd_tpu_torch.io, libtsd_tpu_torch.utils.checkpoint, "
            "libtsd_tpu_torch.utils.monitor, libtsd_tpu_torch.utils.log; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'libtsd_tpu')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|libtsd_tpu)\b",
                     re.M)
    for p in (ROOT / "libtsd_tpu_torch").rglob("*.py"):
        assert not pat.search(p.read_text()), p
    assert not pat.search((ROOT / "chip_smoke.py").read_text())


def test_wrappers_refuse_a_device_without_a_kernel_path(monkeypatch):
    """A tensor that is neither on the CPU nor on CUDA gets no path at all
    (no silent CPU fallback); asking for CUDA where there is none raises;
    a wrapper routed to its kernel raises where it cannot launch it instead
    of handing the call to its plain version."""
    x = torch.empty(4096, device="meta")
    with pytest.raises(ValueError, match="device"):
        fir_kernel(np.ones(3), x)
    with pytest.raises(ValueError, match="device"):
        periodogram4096_acc(x.reshape(1, -1))
    with pytest.raises(ValueError, match="device"):
        fft_pow2(x.reshape(16, 256), x.reshape(16, 256))
    with pytest.raises(ValueError, match="device"):
        fir_periodogram4096(x.reshape(1, -1), torch.zeros(2, 128, 128))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            fir_kernel(np.ones(3), torch.zeros(4096, device="cuda"))
        with pytest.raises((RuntimeError, AssertionError)):
            fir_periodogram4096(torch.zeros(1, 4096, dtype=torch.int16,
                                            device="cuda"),
                                torch.zeros(2, 128, 128), precision="int16")
    monkeypatch.setattr(_build, "use_plain", lambda t: False)
    calls = [
        lambda: fir_kernel(np.ones(3), torch.zeros(4096)),
        lambda: periodogram4096_acc(torch.zeros(1, 4096)),
        lambda: fft_pow2(torch.zeros(16, 256), torch.zeros(16, 256)),
        lambda: fir_periodogram4096(torch.zeros(1, 4096, dtype=torch.int16),
                                    torch.zeros(2, 128, 128),
                                    precision="int16"),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="expected CUDA"):
            call()


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A missing nvcc raises instead of leaving CUDA tensors a slower path;
    the library name carries the sources' hash."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.library_path().parent == tmp_path
    assert _build._digest() in _build.library_path().name
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
