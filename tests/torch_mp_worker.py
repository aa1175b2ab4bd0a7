"""One worker of ``tests/test_torch_parallel_mp.py``: the port's parallel
layer in a gloo process group of CPU processes, over the mesh layouts of
:data:`LAYOUTS`.  Imports no jax.

    python tests/torch_mp_worker.py OUTDIR --coordinator A --nproc 2 --pid P

(as ``parallel.launch.spawn`` starts it).  Each worker builds every
layout's mesh over its own CPU shards, ingests its block of the global
inputs of :func:`inputs` (made from seeds with numpy, the same arrays the
test gives JAX), runs the sharded calls and writes each local result, by
global (row, time shard), into ``OUTDIR/<layout>_<rank>.npz``.
"""
import os
import sys

import numpy as np

# (CPU shards a worker, chan, time): a row across both workers; each
# worker its own row; one shard a worker; a worker holding parts of
# several rows
LAYOUTS = {"row4": (2, 1, 4), "grid22": (2, 2, 2), "one": (1, 1, 2),
           "parts": (3, 3, 2)}
C = 6                          # channels: rows of 6, 3 or 2
FIR = (33, 0.2)                # the Fir stage, then an IirFrame
IIR = (2, 0.1)                 # order-2 Butterworth lowpass
OLA_NE = 256                   # OlaFft(Ne=256) rounds Ne up to 384
FM = dict(channel_freq=0.22, decim=4, deemph_fc=0.05)
K_METRIC, FC_METRIC = 200, 0.15


def inputs() -> dict:
    """The global inputs, made from seeds: real (C, 4096) for the Fir +
    IirFrame chain, complex (C, 3072) for the OlaFft stage and its 129
    taps, an FM IF (C, 8192) of two tones per channel, and (C, 32768)
    for the metric chain."""
    rng = np.random.default_rng(31)
    x_ola = (rng.standard_normal((C, 3072))
             + 1j * rng.standard_normal((C, 3072))).astype(np.complex64)
    k = np.arange(8192)
    audio = np.stack([0.7 * np.sin(2 * np.pi * (0.004 + 0.0005 * c) * k)
                      for c in range(C)])
    dev = 0.1           # FmReceiverConfig.deviation, at the decimated rate
    ph = 2 * np.pi * (np.mod(FM["channel_freq"] * k, 1.0)
                      + dev / FM["decim"] * np.cumsum(audio, axis=1))
    return {"chain": rng.standard_normal((C, 4096)).astype(np.float32),
            "ola": x_ola,
            "ola_h": rng.standard_normal(129).astype(np.float32),
            "fm": np.exp(1j * ph).astype(np.complex64),
            "metric": rng.standard_normal((C, 32768)).astype(np.float32)}


def _put(out: dict, name: str, mesh, grid) -> None:
    for r, t0, row in zip(mesh.rows, mesh.tstart, grid):
        for k, p in enumerate(row):
            out[f"{name}/{r}/{t0 + k}"] = p.numpy()


def run_layout(name: str, x: dict) -> dict:
    import torch
    from libtsd_tpu_torch.models.receivers import (FmReceiver,
                                                   FmReceiverConfig)
    from libtsd_tpu_torch.ops import filter_rt as FR
    from libtsd_tpu_torch.ops import fir_design as FD
    from libtsd_tpu_torch.ops import iir_design as ID
    from libtsd_tpu_torch.parallel import (gather, launch, make_mesh,
                                           sharded_chain,
                                           sharded_fir_periodogram4096,
                                           sharded_fm_receiver)
    n_local, chan, time = LAYOUTS[name]
    mesh = make_mesh(chan=chan, time=time, devices=["cpu"] * n_local)
    out = {}

    def local(a):
        rs = launch.host_slice(mesh, "chan", a.shape[0])
        ts = launch.host_slice(mesh, "time", a.shape[1])
        return launch.ingest_local(mesh, a[rs, ts]), (rs, ts)

    grid, (rs, ts) = local(x["chain"])
    out["host_slice"] = np.array([rs.start, rs.stop, ts.start, ts.stop])
    # every placed shard is its global block of the input
    c, n = C // chan, x["chain"].shape[1] // time
    ok = all(np.array_equal(p.numpy(), x["chain"][r * c:(r + 1) * c,
                                                  t * n:(t + 1) * n])
             for r, t0, row in zip(mesh.rows, mesh.tstart, grid)
             for t, p in enumerate(row, start=t0))
    out["ingest_ok"] = np.array(ok)
    try:
        gather(mesh, grid)
        out["gather_raises"] = np.array(False)
    except ValueError:
        out["gather_raises"] = np.array(True)
    b, a = ID.design_iir(IIR[0], "lp", "butt", IIR[1]).to_ba()
    stages = [(FR.Fir.create(FD.fir_lowpass(*FIR), device="cpu"),
               FIR[0] - 1), (FR.IirFrame.create(b, a, device="cpu"), 0)]
    _put(out, "chain", mesh, sharded_chain(mesh, stages, grid))
    ola = FR.OlaFft.create(x["ola_h"], Ne=OLA_NE, engine="cuda",
                           device="cpu")
    _put(out, "ola", mesh, sharded_chain(mesh, [(ola, ola.V)],
                                         local(x["ola"])[0]))
    fm = FmReceiver.create(FmReceiverConfig(**FM), device="cpu")
    _put(out, "fm", mesh, sharded_fm_receiver(mesh, fm, local(x["fm"])[0]))
    G = torch.as_tensor(FR.fir_toeplitz_mats(np.asarray(
        FD.fir_lowpass(K_METRIC, FC_METRIC), np.float64)).astype(np.float32))
    xm = local(x["metric"])[0]
    for halo in ("fused", "ppermute"):
        acc = sharded_fir_periodogram4096(mesh, xm, G, precision="highest",
                                          halo=halo)
        for i, r in enumerate(mesh.rows):
            out[f"spec_{halo}/{r}"] = acc[i * (C // chan):
                                          (i + 1) * (C // chan)].numpy()
    return out


def main() -> None:
    outdir = sys.argv[1]
    argv = sys.argv
    coord = argv[argv.index("--coordinator") + 1]
    nproc = int(argv[argv.index("--nproc") + 1])
    pid = int(argv[argv.index("--pid") + 1])
    import torch_compare  # noqa: F401  (caps the threads)
    import torch.distributed as dist
    from libtsd_tpu_torch.parallel import launch
    launch.initialize(coord, nproc, pid)
    x = inputs()
    for name in LAYOUTS:
        np.savez(os.path.join(outdir, f"{name}_{pid}.npz"),
                 **run_layout(name, x))
    # leave the group before exit: a gloo group still open while the
    # interpreter shuts down can abort the process
    dist.destroy_process_group()
    print(f"worker {pid}: {len(LAYOUTS)} layouts", flush=True)


if __name__ == "__main__":
    main()
