"""Weak-scaling efficiency of the port's "time" axis across processes (the
"scaling eff. at N hosts" of BASELINE.json's metric).  The twin of
``examples/scaling_bench.py``.

One process a card, one time shard a process: a "time" row across 1, 2
and 4 processes (``parallel.launch``), the work per process constant, so
ideal weak scaling keeps the time of a call flat; efficiency(n) =
t(1) / t(n).  Two chains are timed:

* the JAX bench's, for parity: C 4 channels, N_FIR samples a shard, a
  256-tap ``Fir`` through ``sharded_chain`` (its 255-sample halo point to
  point between the processes), then the sum of y^2 over the row;
* BASELINE's metric chain, ``sharded_fir_periodogram4096`` at the main
  path's width: 256 channels of int16, tier int16/2 (the headline), N_METRIC
  samples a shard, in both halo forms ("fused": kernel #11 with its receive
  slots mapped between the processes by CUDA IPC; "ppermute": the tails
  sent point to point, then kernel #3), the spectra summed over the row.

Each rank times ITERS calls with CUDA events after a barrier of every
rank; a round's time is the slowest rank's, and the bench reports the
best of ROUNDS rounds.  It prints a table and, with ``--json``, writes the
rows with the card's name and power limit (``nvidia-smi``).

    python -m libtsd_tpu_torch.examples.scaling_bench [--json PATH]
        [--device cpu] [--counts 1,2,4] [--n-fir N] [--n-metric N]
        [--c-metric C]

On the card it runs the counts that have a card each (4 cards: 1, 2, 4);
``--device cpu`` runs CPU processes over gloo (small sizes, for a check).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

C_FIR, TAPS = 4, 256
N_FIR = 1 << 23              # samples a shard, the JAX bench's
C_METRIC = 256               # the main path's width
N_METRIC = 1 << 22           # samples a shard
ITERS, ROUNDS = 5, 3
FORMS = ("fused", "ppermute")


def _card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def worker(a) -> None:
    import torch.distributed as dist
    from ..ops import fir_design as FD
    from ..ops import kernels
    from ..ops.filter_rt import Fir, fir_toeplitz_mats
    from ..parallel import (launch, make_mesh, sharded_chain,
                            sharded_fir_periodogram4096)
    n, pid = a.nproc, a.pid
    if a.device == "cpu":
        dev = torch.device("cpu")
        launch.initialize(a.coordinator, n, pid)
    else:
        dev = torch.device("cuda", pid)
        launch.initialize(a.coordinator, n, pid, local_device_ids=[pid])
    mesh = make_mesh(chan=1, time=n, devices=[dev])
    link = mesh.links[0]
    h = FD.fir_lowpass(TAPS, 0.2)
    fir = Fir.create(h, device=dev)
    G = torch.as_tensor(fir_toeplitz_mats(np.asarray(h, np.float64))
                        .astype(np.float32), device=dev)
    g = torch.Generator(device=dev).manual_seed(1000 + pid)
    xf = [[torch.randn(C_FIR, a.n_fir, generator=g, device=dev)]]
    xm = [[torch.randint(-2048, 2048, (a.c_metric, a.n_metric), generator=g,
                         device=dev, dtype=torch.int16)]]

    def fir_chain():
        y = sharded_chain(mesh, [(fir, TAPS - 1)], xf)[0][0]
        total = (y * y).sum()
        if link is not None:
            dist.all_reduce(total, group=link.group)
        return total

    calls = {"fir": fir_chain}
    for form in FORMS:
        calls[form] = (lambda form=form: sharded_fir_periodogram4096(
            mesh, xm, G, precision="int16", halo=form, fir_passes=2))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    kernels.reset_launches()
    for fn in calls.values():        # warm-up (and the kernels' first use)
        fn()
    sync()
    counts = kernels.launches()
    ms = {}
    for name, fn in calls.items():
        best = float("inf")
        for _ in range(ROUNDS):
            sync()
            dist.barrier()
            if dev.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(ITERS):
                    fn()
                e1.record()
                sync()
                t = e0.elapsed_time(e1) / ITERS
            else:
                t0 = time.perf_counter()
                for _ in range(ITERS):
                    fn()
                t = (time.perf_counter() - t0) / ITERS * 1e3
            every = [None] * n
            dist.all_gather_object(every, t)
            best = min(best, max(every))
        ms[name] = best
    if pid == 0:
        print("RESULT " + json.dumps({
            "nproc": n, "ms": ms,
            "transport": link.transport if link else "none",
            "launches": {k: counts[k] for k in
                         ("fir_periodogram4096_halo", "fir_periodogram4096")}
        }), flush=True)
    dist.destroy_process_group()


def run_sweep(counts, device: str, args: list, json_path=None) -> dict:
    from ..ops.kernels import _build
    from ..parallel import launch
    if device == "cuda":
        _build.build()          # once, before the workers load it
    rows = []
    for n in counts:
        outs = launch.spawn(["-m", "libtsd_tpu_torch.examples.scaling_bench",
                             "--worker", "--device", device, *args], n,
                            timeout=600)
        res = next(json.loads(ln[7:]) for ln in outs[0].splitlines()
                   if ln.startswith("RESULT "))
        if device == "cuda" and min(res["launches"].values()) == 0:
            raise RuntimeError(f"{n} processes: a kernel did not launch "
                               f"({res['launches']})")
        rows.append(res)
    base = rows[0]["ms"]
    names = list(base)
    print(f"{'procs':>6}" + "".join(f"{k + ' ms':>16}{k + ' eff':>16}"
                                    for k in names) + f"{'transport':>11}")
    for r in rows:
        r["efficiency"] = {k: base[k] / r["ms"][k] for k in names}
        print(f"{r['nproc']:>6}" + "".join(
            f"{r['ms'][k]:>16.4f}{r['efficiency'][k]:>16.4f}"
            for k in names) + f"{r['transport']:>11}")
    result = {
        "metric": "weak-scaling efficiency t(1)/t(n), one process a card "
                  "and one time shard a process; the slowest rank's time "
                  f"of a call, CUDA events, best of {ROUNDS} rounds of "
                  f"{ITERS} calls",
        "device": device, "rows": rows, "args": args}
    if device == "cuda":
        result["card"] = _card_line()
        result["torch"] = torch.__version__
        print(f"card: {result['card']}")
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {json_path}")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--counts", default="1,2,4")
    ap.add_argument("--n-fir", type=int, default=N_FIR)
    ap.add_argument("--n-metric", type=int, default=N_METRIC)
    ap.add_argument("--c-metric", type=int, default=C_METRIC)
    ap.add_argument("--json", default=None)
    a = ap.parse_args(argv)
    if a.worker:
        worker(a)
        return
    have = (torch.cuda.device_count() if a.device == "cuda"
            else os.cpu_count() or 1)
    if a.device == "cuda" and have == 0:
        raise SystemExit("scaling_bench: no CUDA device (--device cpu "
                         "runs CPU processes)")
    counts = [c for c in map(int, a.counts.split(",")) if c <= have]
    run_sweep(counts, a.device, ["--n-fir", str(a.n_fir), "--n-metric",
                                 str(a.n_metric), "--c-metric",
                                 str(a.c_metric)], a.json)


if __name__ == "__main__":
    main(sys.argv[1:])
