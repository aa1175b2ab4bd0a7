"""Path ``row``: the spectral chain sharded along time over a row of
cards, ``libtsd_tpu_torch.parallel.chain.sharded_fir_periodogram4096``.

One process a card (``harness.spawn_row``), each a shard of every row
record: C channels of N samples a card, a ring of R blocks a card.  A step
is one sharded call on every rank at once: each shard's FIR takes its left
neighbour's input tail as history (kernel #11 stores it into the
neighbour's receive slot, mapped by CUDA IPC, with ``halo="fused"``), and
the row's spectra are summed by the port's all-reduce.  Rank 0 copies the
row's (C, 4096) spectra into pinned host memory.  The row's first shard
starts from zero history: each step's row is an independent record.

The ranks stop together: every 16 steps rank 0's decision is broadcast,
and read 16 steps later (``agree``).
The check, on rank 0: the data of every rank made again from the seed,
and the reference's chain over the whole row record (zero history, then
each shard with its left neighbour's tail), against the spectra rank 0
received.
"""
from __future__ import annotations

import torch

from portbench import signals
from portbench.spans import span

# the faults ``Path(fault=...)`` plants in the timed path, each of which
# must make a run not correct (the benchmark's tests plant each one)
FAULTS = ("no_exchange", "altered")
# the traffic keys a tiny run on the CPU overrides (the benchmark's tests):
# CPU shards over gloo, so the halo goes point to point ("ppermute");
# "fused" maps kernel #11's slots by CUDA IPC, on cards only
TINY = {"channels": 4, "block": 4096 * 4, "halo": "ppermute"}


def _gen(seed: int, rank: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(8 * seed + rank)


class Path:
    def __init__(self, cell, seed: int, device, mark, control=False,
                 fault=None, row=None):
        import torch.distributed as dist
        t, c = cell.traffic, cell.config
        self.t, self.seed, self.device = t, seed, device
        self.C, self.N, self.R = t["channels"], t["block"], t["ring"]
        self.samples_per_step = self.C * self.N
        self.limits = t["limits"]
        self.precision, self.passes = c["precision"], c["fir_passes"]
        if control:
            self.precision = c["control_precision"]
        self.halo = t["halo"]
        self.fault, self.rank, self.nproc = fault, row.rank, row.nproc
        self.ring = signals.adc_ring(_gen(seed, row.rank, device), self.R,
                                     self.C, self.N, t["signal"], device)
        self.taps = signals.lowpass(c["taps"], c["cutoff"])
        mark("data")
        from libtsd_tpu_torch.ops.filter_rt import fir_toeplitz_mats
        from libtsd_tpu_torch.ops.kernels.chain import fir_periodogram4096
        from libtsd_tpu_torch.parallel import (launch, make_mesh,
                                               sharded_fir_periodogram4096)
        launch.initialize(row.coordinator, row.nproc, row.rank,
                          local_device_ids=([device.index]
                                            if device.type == "cuda"
                                            else None))
        self.mesh = make_mesh(chan=1, time=row.nproc, devices=[device])
        self.dist = dist
        self.fn = sharded_fir_periodogram4096
        self.plain_fn = fir_periodogram4096
        self.G = fir_toeplitz_mats(torch.as_tensor(
            self.taps, dtype=torch.float32, device=device))
        self.host = torch.empty((self.C, 4096), dtype=torch.float32,
                                pin_memory=device.type == "cuda")
        self.kept = {}
        self.sent = None   # agree's broadcast in flight
        mark("program")

    def warm(self):
        for i in range(2):
            self.step(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.dist.barrier()

    def step(self, i: int):
        x = self.ring[i % self.R]
        with span("parallel.sharded_fir_periodogram4096"):
            if self.fault == "no_exchange":
                # the halo left out: every shard from zero history
                out = self.plain_fn(x, self.G, None, self.precision,
                                    self.passes)
                self.dist.all_reduce(out, group=self.mesh.links[0].group)
            else:
                out = self.fn(self.mesh, [[x]], self.G, self.precision,
                              self.halo, self.passes)
        if self.rank == 0:
            if self.fault == "altered":
                out[0, 1] += out[0].max()
            with span("consumer.copy_to_host"):
                self.host.copy_(out, non_blocking=True)

    def agree(self, stop: bool) -> bool:
        """Rank 0's ``stop`` of the call before, the same on every rank.
        Each call sends rank 0's decision without waiting for it and reads
        the one sent 16 steps back, long since arrived, so no rank's step
        waits on another rank's host here; the window runs on 16 steps
        past rank 0's decision, and every step of it counts."""
        flag = torch.tensor([int(stop)])
        sent = (flag, self.dist.broadcast(flag, src=0, async_op=True))
        prev, self.sent = self.sent, sent
        if prev is None:
            return False
        prev[1].wait()
        if not prev[0].item():
            return False
        sent[1].wait()   # nothing left in flight once the ranks stop
        return True

    def keep(self, i: int, slot: int):
        if self.rank == 0:
            self.kept[slot] = (i, self.host.clone())

    def release(self):
        """Free the program's state on every rank: kernel #11's slots
        (unmapped behind a row barrier), then the process group."""
        for bufs in self.mesh.halo_buffers.values():
            bufs.release()
        self.dist.barrier()
        self.dist.destroy_process_group()
        self.ring = self.G = self.mesh = None

    def check(self) -> list:
        if self.rank != 0:
            return []
        from portbench.reference import chain, row
        want = {i: 0.0 for i, _ in self.kept.values()}
        prev = None
        for r in range(self.nproc):
            ring = signals.adc_ring(_gen(self.seed, r, self.device), self.R,
                                    self.C, self.N, self.t["signal"],
                                    self.device)
            for i in want:
                k = i % self.R
                want[i] = row.add_shard(want[i], ring[k],
                                        None if prev is None else prev[k],
                                        self.taps)
            prev = ring
        worst = max(chain.worst_bin_rel(got, want[i])
                    for i, got in self.kept.values())
        return [("spec_bin_rel", worst, self.limits["spec_bin_rel"])]
