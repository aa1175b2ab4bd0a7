"""Multi-process scale-out on the port: the sharded fused FIR + periodogram
chain across N processes joined by ``parallel.launch``.  The twin of
``examples/multihost_demo.py``.

Two layouts, each in both halo forms ("fused": kernel #11, its receive
slots mapped between the processes by CUDA IPC; "ppermute": the tails
sent point to point, then kernel #3):

* the JAX demo's: processes on "chan" (each owns a block of channels),
  LOCAL_SHARDS shards of its card on "time": nothing crosses processes in
  steady state;
* one "time" row across every process (LOCAL_SHARDS shards each): the
  halo goes between processes and the sum over "time" is an all-reduce
  over the row.

Each process ingests ONLY its own block (``host_slice``/``ingest_local``).
The launcher holds every rank's checksum against kernel #3 on the whole
signal in its own process, to 1e-5 relative, and prints ``MULTIHOST OK``.

    python -m libtsd_tpu_torch.examples.multihost_demo [--nproc 2]
        [--device cpu]

On the card each process takes its own card where there are as many, else
all share cuda:0 (the rows' transport is then gloo: NCCL refuses two
processes on one card); ``--device cpu`` runs CPU shards over gloo.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

LOCAL_SHARDS = 2         # shards a process (virtual shards of its card)
N_SHARD = 65536          # samples a shard
TAPS = 128
LAYOUTS = ("hosts_on_chan", "row_across")


def gen_channel(c: int, n: int) -> np.ndarray:
    return np.random.default_rng(1000 + c).standard_normal(n).astype(
        np.float32)


def _taps(device) -> torch.Tensor:
    from ..ops import fir_design as FD
    from ..ops.filter_rt import fir_toeplitz_mats
    h = FD.fir_lowpass(TAPS, 0.2)
    return torch.as_tensor(fir_toeplitz_mats(np.asarray(h, np.float64))
                           .astype(np.float32), device=device)


def _shape(layout: str, nproc: int) -> tuple:
    """(C, N) of the global signal: 2 channels a process; LOCAL_SHARDS
    shards of N_SHARD samples a row (a row of every process's shards when
    it runs across them)."""
    rows = 1 if layout == "hosts_on_chan" else nproc
    return 2 * nproc, LOCAL_SHARDS * N_SHARD * rows


def _mesh(layout: str, nproc: int, shards: list):
    from ..parallel import make_mesh
    if layout == "hosts_on_chan":
        return make_mesh(chan=nproc, time=LOCAL_SHARDS, devices=shards)
    return make_mesh(chan=1, time=LOCAL_SHARDS * nproc, devices=shards)


def worker(coordinator: str, nproc: int, pid: int, device: str) -> None:
    import torch.distributed as dist
    from ..parallel import launch, sharded_fir_periodogram4096
    if device == "cpu":
        dev = torch.device("cpu")
        launch.initialize(coordinator, nproc, pid)
    else:
        card = pid if torch.cuda.device_count() >= nproc else 0
        dev = torch.device("cuda", card)
        launch.initialize(coordinator, nproc, pid, local_device_ids=[card])
    G = _taps(dev)
    for layout in LAYOUTS:
        mesh = _mesh(layout, nproc, [dev] * LOCAL_SHARDS)
        C, N = _shape(layout, nproc)
        rows = launch.host_slice(mesh, "chan", C)
        ts = launch.host_slice(mesh, "time", N)
        # this process keeps ONLY its block of the signal
        local = np.stack([gen_channel(c, N)[ts]
                          for c in range(rows.start, rows.stop)])
        x = launch.ingest_local(mesh, local)
        for halo in ("fused", "ppermute"):
            acc = sharded_fir_periodogram4096(mesh, x, G,
                                              precision="highest", halo=halo)
            total = acc.double().sum()
            if layout == "hosts_on_chan":    # each process its own rows
                dist.all_reduce(total)
            transport = (mesh.links[0].transport if mesh.links[0]
                         else "none")
            print(f"proc {pid}: {layout} {halo} rows {rows.start}:"
                  f"{rows.stop} samples {ts.start}:{ts.stop} transport "
                  f"{transport} CHECKSUM {total.item():.12e}", flush=True)
    dist.destroy_process_group()


def launcher(nproc: int, device: str, timeout: float = 600) -> None:
    from ..ops.kernels import _build
    from ..ops.kernels.chain import fir_periodogram4096
    from ..parallel import launch
    if device == "cuda":
        _build.build()          # once, before the workers load it
    outs = launch.spawn(["-m", "libtsd_tpu_torch.examples.multihost_demo",
                         "--worker", "--device", device], nproc, timeout)
    dev = torch.device(device if device == "cpu" else "cuda")
    G = _taps(dev)
    for layout in LAYOUTS:
        # the whole signal's spectrum: the all-reduced sum of the ranks'
        # rows, or the row's, which every rank of the row holds
        C, N = _shape(layout, nproc)
        x = torch.as_tensor(np.stack([gen_channel(c, N) for c in range(C)]),
                            device=dev)
        ref = fir_periodogram4096(x, G).double().sum().item()
        for p, out in enumerate(outs):
            for halo in ("fused", "ppermute"):
                line = next(ln for ln in out.splitlines()
                            if f"{layout} {halo} " in ln)
                print(line)
                v = float(line.split("CHECKSUM")[1])
                rel = abs(v - ref) / abs(ref)
                if rel >= 1e-5:
                    raise SystemExit(f"rank {p} {layout} {halo}: checksum "
                                     f"{v} against {ref} (rel {rel:.2e})")
    print(f"MULTIHOST OK: {nproc} processes x {LOCAL_SHARDS} shards on "
          f"{device}, both layouts and halo forms, every checksum matches "
          f"#3 on the whole signal ({dev})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    if a.worker:
        worker(a.coordinator, a.nproc, a.pid, a.device)
    else:
        launcher(a.nproc, a.device)


if __name__ == "__main__":
    main(sys.argv[1:])
