"""The port's twins of the examples (``libtsd_tpu_torch/examples``) run
clean, on the CPU, each in its own process (slow tier, as
tests/test_examples.py runs the JAX package's): the multi-process demo
(4 gloo processes, both layouts and halo forms, every checksum against
#3 in the launcher), the scaling bench at small sizes over 1, 2 and 4
processes, and the debug-report demo writing its three reports."""
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
