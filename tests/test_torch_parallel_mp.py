"""The port's parallel layer across processes: "time" rows that cross
processes, against the JAX package on the same numpy inputs.

One set of 2 gloo workers (``tests/torch_mp_worker.py``, started once for
the module through ``parallel.launch.spawn`` with a 120 s deadline) runs
four mesh layouts over CPU shards: a row of 4 across both workers (2
shards each), chan 2 x time 2 (a row each), one shard a worker (a row of
2), and chan 3 x time 2 over 3 shards a worker (each holds parts of two
rows).  The test holds what the workers wrote:

* ``host_slice``/``ingest_local``: JAX's slices, each shard its block;
* ``sharded_chain`` [Fir, IirFrame] and ``sharded_fm_receiver`` against
  JAX's jitted sharded functions, on conftest's 8 virtual CPU devices over
  a mesh of the same shape, to tests/test_torch_parallel.py's tolerances
  (1e-4 absolute; the FM receiver 2e-3); the OlaFft stage (#9's plain
  version) against JAX's jitted ``fir_filter``, 1e-5 of the peak;
* both halo forms of the metric chain (the plain route: #3 and #11's plain
  versions over gloo) against the port's single-process grid result,
  1e-5 of the peak and the checksum to 1e-5 relative, and against a
  float64 numpy spectrum, 1e-4 of the peak.  No interpreted Pallas call.
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.models import receivers as RXj
from libtsd_tpu.ops import filter_rt as FRj
from libtsd_tpu.ops import fir_design as FDj
from libtsd_tpu.ops import iir_design as IDj
from libtsd_tpu.parallel import channel_sharding
from libtsd_tpu.parallel import make_mesh as make_mesh_j
from libtsd_tpu.parallel import sharded_chain as sharded_chain_j
from libtsd_tpu.parallel import sharded_fm_receiver as sharded_fm_j
from libtsd_tpu.utils.testing import check_max_error
from libtsd_tpu_torch.ops import filter_rt as FR
from libtsd_tpu_torch.ops import fir_design as FD
from libtsd_tpu_torch.parallel import (launch, make_mesh,
                                       sharded_fir_periodogram4096)
from torch_compare import THREAD_ENV, rel  # (importing it caps the threads)
import torch_mp_worker as W

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{layout: {key: array}} merged over both workers, and the JAX
    references, computed here while the workers run."""
    out = str(tmp_path_factory.mktemp("mp"))
    err = []

    def go():
        try:
            launch.spawn([os.path.join(HERE, "torch_mp_worker.py"), out], 2,
                         timeout=120, env=THREAD_ENV)
        except RuntimeError as e:        # raised again in the test thread
            err.append(e)
    th = threading.Thread(target=go)
    th.start()
    try:
        x = W.inputs()
        ref = _jax_refs(x)
    finally:
        th.join()
    if err:
        raise err[0]
    got = {}
    for name in W.LAYOUTS:
        got[name] = [dict(np.load(os.path.join(out, f"{name}_{p}.npz")))
                     for p in range(2)]
    return x, got, ref


def _jax_refs(x: dict) -> dict:
    """JAX's jitted fir_filter of the OlaFft input, and its jitted
    sharded_chain and sharded_fm_receiver on a mesh of each layout's
    shape."""
    h = x["ola_h"]
    ref = {"ola": np.asarray(jax.jit(lambda v: FRj.fir_filter(h, v))(
        jnp.asarray(x["ola"])))}
    b, a = IDj.design_iir(W.IIR[0], "lp", "butt", W.IIR[1]).to_ba()
    stages = [(FRj.Fir.create(FDj.fir_lowpass(*W.FIR)), W.FIR[0] - 1),
              (FRj.IirFrame.create(b, a), 0)]
    fm = RXj.FmReceiver.create(RXj.FmReceiverConfig(**W.FM))
    for _, chan, time in set(W.LAYOUTS.values()):
        mj = make_mesh_j(chan=chan, time=time)

        def put(v):
            return jax.device_put(jnp.asarray(v), channel_sharding(mj))
        ref["chain", chan, time] = np.asarray(jax.jit(
            lambda v: sharded_chain_j(mj, stages, v))(put(x["chain"])))
        ref["fm", chan, time] = np.asarray(jax.jit(
            lambda v: sharded_fm_j(mj, fm, v))(put(x["fm"])))
    return ref


def assemble(parts: list, key: str, chan: int, time: int,
             shape: tuple) -> np.ndarray:
    """The global (C, N) array from the workers' (row, t) pieces; each
    piece must come from exactly one worker."""
    full = None
    seen = set()
    c, n = shape[0] // chan, None
    for p in parts:
        for k, v in p.items():
            name, *pos = k.split("/")
            if name != key:
                continue
            r, t = map(int, pos)
            assert (r, t) not in seen, (key, r, t)
            seen.add((r, t))
            if full is None:
                n = v.shape[-1]
                full = np.zeros((shape[0], n * time), v.dtype)
            full[r * c:(r + 1) * c, t * n:(t + 1) * n] = v
    assert seen == {(r, t) for r in range(chan) for t in range(time)}, key
    return full


@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_host_slice_and_ingest_local(runs, layout):
    """JAX's host_slice: each worker's contiguous block along each axis;
    every shard ingest_local placed is its global block; gather refuses a
    worker that holds parts of rows of unequal span."""
    _, got, _ = runs
    n_local, chan, time = W.LAYOUTS[layout]
    C, N = W.C, W.inputs()["chain"].shape[1]
    for pid, p in enumerate(got[layout]):
        g = np.arange(pid * n_local, (pid + 1) * n_local)
        g = g[g < chan * time]
        rows, ts = g // time, g % time
        want = [rows.min() * C // chan, (rows.max() + 1) * C // chan,
                ts.min() * N // time, (ts.max() + 1) * N // time]
        assert p["host_slice"].tolist() == want, (layout, pid)
        assert bool(p["ingest_ok"])
        assert bool(p["gather_raises"]) == (layout == "parts")


@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_sharded_chain_stages_match_jax(runs, layout):
    """[Fir, IirFrame] against JAX's jitted sharded_chain on a mesh of the
    same shape (1e-4, tests/test_parallel.py:55,241); the OlaFft stage
    against JAX's fir_filter (1e-5 of the peak, :223)."""
    x, got, ref = runs
    _, chan, time = W.LAYOUTS[layout]
    y = assemble(got[layout], "chain", chan, time, x["chain"].shape)
    check_max_error(y, ref["chain", chan, time], 1e-4)
    y = assemble(got[layout], "ola", chan, time, x["ola"].shape)
    assert rel(y, ref["ola"]) < 1e-5


@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_sharded_fm_receiver_matches_jax(runs, layout):
    """The NCO base from each shard's global t, both halos and the
    de-emphasis' end states across processes: against JAX's jitted
    sharded_fm_receiver (2e-3, tests/test_parallel.py:315)."""
    x, got, ref = runs
    _, chan, time = W.LAYOUTS[layout]
    y = assemble(got[layout], "fm", chan, time, x["fm"].shape)
    assert y.shape == (W.C, x["fm"].shape[1] // W.FM["decim"])
    assert np.abs(y - ref["fm", chan, time]).max() < 2e-3
    assert np.abs(y).max() > 0.1


def _spectrum64(h, x):
    """Float64 numpy FIR then the sum of |FFT-4096|^2 over frames."""
    y = np.stack([np.convolve(r, h)[:x.shape[1]]
                  for r in x.astype(np.float64)])
    return (np.abs(np.fft.fft(y.reshape(x.shape[0], -1, 4096))) ** 2).sum(1)


@pytest.mark.parametrize("halo", ["fused", "ppermute"])
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_metric_chain_across_processes(runs, layout, halo):
    """Both halo forms on the plain route: every rank of a row holds the
    row's spectrum, equal to the single-process grid result of the same
    mesh shape (1e-5 of the peak, checksum 1e-5 relative) and to float64
    numpy (1e-4 of the peak)."""
    x, got, _ = runs
    _, chan, time = W.LAYOUTS[layout]
    h = FD.fir_lowpass(W.K_METRIC, W.FC_METRIC)
    G = torch.as_tensor(FR.fir_toeplitz_mats(np.asarray(h, np.float64))
                        .astype(np.float32))
    one = sharded_fir_periodogram4096(
        make_mesh(chan=chan, time=time, devices=["cpu"] * chan * time),
        torch.as_tensor(x["metric"]), G, precision="highest",
        halo=halo).numpy()
    c = W.C // chan
    seen = set()
    for p in got[layout]:
        for k, v in p.items():
            if k.split("/")[0] != f"spec_{halo}":
                continue
            r = int(k.split("/")[1])
            seen.add(r)
            want = one[r * c:(r + 1) * c]
            assert rel(v, want) < 1e-5, (layout, halo, r)
            assert abs(v.astype(np.float64).sum() / want.astype(
                np.float64).sum() - 1) < 1e-5
    assert seen == set(range(chan))
    assert rel(one, _spectrum64(h, x["metric"])) < 1e-4
