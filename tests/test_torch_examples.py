"""The port's twins of the examples (``libtsd_tpu_torch/examples``) run
clean, on the CPU, each in its own process (slow tier, as
tests/test_examples.py runs the JAX package's): the multi-process demo
(4 gloo processes, both layouts and halo forms, every checksum against
#3 in the launcher), the scaling bench at small sizes over 1, 2 and 4
processes, the debug-report demo writing its three reports, and the
seven demos with their own gates (the BER sweep on two Eb/N0 points of
2048 bits; fm_demo's and ber_sweep's reports and WAVs written)."""
import json
import os
import subprocess
import sys

import pytest

from torch_compare import THREAD_ENV  # (importing it caps the threads)

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, tmp_path, timeout=600):
    env = {**os.environ, **THREAD_ENV, "MPLBACKEND": "Agg",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}
    r = subprocess.run([sys.executable, "-m", *args], env=env,
                       cwd=str(tmp_path), timeout=timeout,
                       capture_output=True, text=True)
    assert r.returncode == 0, (args, r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout


def test_multihost_twin(tmp_path):
    out = _run(["libtsd_tpu_torch.examples.multihost_demo", "--device",
                "cpu", "--nproc", "4"], tmp_path)
    assert "MULTIHOST OK" in out


def test_scaling_twin(tmp_path):
    path = tmp_path / "scaling.json"
    _run(["libtsd_tpu_torch.examples.scaling_bench", "--device", "cpu",
          "--counts", "1,2,4", "--n-fir", "16384", "--n-metric", "8192",
          "--c-metric", "4", "--json", str(path)], tmp_path)
    res = json.loads(path.read_text())
    assert [r["nproc"] for r in res["rows"]] == [1, 2, 4]
    assert [r["transport"] for r in res["rows"]] == ["none", "gloo", "gloo"]
    for r in res["rows"]:
        assert set(r["efficiency"]) == {"fir", "fused", "ppermute"}


def test_debug_report_twin(tmp_path):
    out = _run(["libtsd_tpu_torch.examples.debug_report_demo", "--device",
                "cpu", "--out", str(tmp_path / "rep")], tmp_path)
    assert "1 frame(s) decoded" in out
    for name in ("frame_rx", "demod", "fm_stereo"):
        assert (tmp_path / "rep" / name / "index.html").exists()


# each twin with its arguments and the line its run must print
TWINS = {
    "qam_serving": ([], "QAM serving demo OK"),
    "serving_loop": ([], "serving loop: 12 frames detected"),
    "iq_stream_demo": ([], "OK"),
    "protocols_demo": ([], "PS name:   'TSD TPU!'"),
    "doa_demo": ([], "OK: smoothing restored"),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_demo_twin(name, tmp_path):
    args, line = TWINS[name]
    out = _run([f"libtsd_tpu_torch.examples.{name}", "--device", "cpu",
                *args], tmp_path)
    assert any(l.strip().startswith(line) for l in out.splitlines()), \
        out[-2000:]


def test_fm_demo_twin_report(tmp_path):
    rep = tmp_path / "fm"
    out = _run(["libtsd_tpu_torch.examples.fm_demo", "--device", "cpu",
                "--report", str(rep)], tmp_path)
    assert f"report: {rep / 'index.html'}" in out
    for f in ("index.html", "station0.wav", "station1.wav", "station2.wav"):
        assert (rep / f).exists(), f


def test_ber_sweep_twin_report(tmp_path):
    rep = tmp_path / "ber"
    out = _run(["libtsd_tpu_torch.examples.ber_sweep", "--device", "cpu",
                "--nbits", "2048", "--snrs", "4,8", "--report", str(rep)],
               tmp_path)
    rows = [l.split() for l in out.splitlines()
            if l.split() and l.split()[0] in ("BPSK", "QPSK", "pi4-QPSK",
                                              "8PSK", "QAM16", "4FSK")]
    assert len(rows) == 12 and (rep / "index.html").exists()
