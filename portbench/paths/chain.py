"""Path ``chain``: the spectral monitor's headline step, kernel #3.

A step hands block i % R of the int16 ring to
``libtsd_tpu_torch.ops.kernels.chain.fir_periodogram4096`` with the FIR
history carried from the block before it (its last (D - 1) 128 samples,
as a streaming caller keeps them), and copies the (C, 4096) spectra into a
pinned host buffer, where a monitor's display or logger reads them.
"""
from __future__ import annotations

import torch

from portbench import signals
from portbench.spans import span

# the faults ``Path(fault=...)`` plants in the timed path, each of which
# must make a run not correct (the benchmark's tests plant each one)
FAULTS = ("half_batch", "altered")
# the traffic keys a tiny run on the CPU overrides (the benchmark's tests)
TINY = {"channels": 4, "block": 4096 * 4, "ring": 3}


class Path:
    def __init__(self, cell, seed: int, device, mark, control=False,
                 fault=None, row=None):
        t, c = cell.traffic, cell.config
        self.C, self.N, self.R = t["channels"], t["block"], t["ring"]
        self.samples_per_step = self.C * self.N
        self.precision, self.passes = c["precision"], c["fir_passes"]
        # the control: the program's own next tier down (int16 samples
        # rounded to bfloat16, one pass)
        if control:
            self.precision, self.passes = c["control_precision"], 2
        self.fault = fault
        self.limits = t["limits"]
        self.device = device
        gen = torch.Generator(device=device).manual_seed(seed)
        self.taps = signals.lowpass(c["taps"], c["cutoff"])
        self.ring = signals.adc_ring(gen, self.R, self.C, self.N,
                                     t["signal"], device)
        mark("data")
        from libtsd_tpu_torch.ops.filter_rt import fir_toeplitz_mats
        from libtsd_tpu_torch.ops.kernels.chain import fir_periodogram4096
        self.fn = fir_periodogram4096
        self.G = fir_toeplitz_mats(torch.as_tensor(
            self.taps, dtype=torch.float32, device=device))
        self.H = (self.G.shape[0] - 1) * 128
        self.host = torch.empty((self.C, 4096), dtype=torch.float32,
                                pin_memory=device.type == "cuda")
        self.kept = {}
        mark("program")

    def _hist(self, i: int) -> torch.Tensor:
        prev = self.ring[(i - 1) % self.R]
        return prev[:, self.N - self.H:].reshape(self.C, -1, 128)

    def warm(self):
        for i in range(2):
            self.step(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, i: int):
        x = self.ring[i % self.R]
        with span("kernels.fir_periodogram4096"):
            out = self.fn(x, self.G, self._hist(i), self.precision,
                          self.passes)
        if self.fault == "half_batch":
            out[self.C // 2:] = out[:self.C - self.C // 2]
        elif self.fault == "altered":
            out[0, 1] += out[0].max()
        with span("consumer.copy_to_host"):
            self.host.copy_(out, non_blocking=True)

    def keep(self, i: int, slot: int):
        self.kept[slot] = (i, self.host.clone())

    def release(self):
        self.G = None

    def check(self) -> list:
        from portbench.reference import chain as ref
        worst = 0.0
        for i, got in self.kept.values():
            k = i % self.R
            want = ref.spectra(self.ring[k], self.ring[(k - 1) % self.R],
                               self.taps, round_taps=True)
            worst = max(worst, ref.worst_bin_rel(got, want))
        return [("spec_bin_rel", worst, self.limits["spec_bin_rel"])]
