"""Path ``welch``: the spectral monitor's display, ``ops.psd.psd_welch``.

A step hands block i % R of the float32 ring (C channels of N samples) to
``libtsd_tpu_torch.ops.psd.psd_welch(x, nfft, window)`` and copies the
(C, nfft) PSD in dB into a pinned host buffer, where the display reads
it.  Welch's segments do not cross blocks, so no state is carried.
"""
from __future__ import annotations

import torch

from portbench import signals
from portbench.spans import span

# the faults ``Path(fault=...)`` plants in the timed path, each of which
# must make a run not correct (the benchmark's tests plant each one)
FAULTS = ("half_batch", "altered")
# the traffic keys a tiny run on the CPU overrides (the benchmark's tests)
TINY = {"channels": 2, "block": 4096 * 8}


class Path:
    def __init__(self, cell, seed: int, device, mark, control=False,
                 fault=None, row=None):
        t, c = cell.traffic, cell.config
        self.C, self.N, self.R = t["channels"], t["block"], t["ring"]
        self.nfft = c["welch_nfft"]
        self.window = c["welch_window"]
        self.samples_per_step = self.C * self.N
        self.limits = t["limits"]
        self.control, self.fault, self.device = control, fault, device
        gen = torch.Generator(device=device).manual_seed(seed)
        self.ring = signals.tone_ring(gen, self.R, self.C, self.N,
                                      t["signal"], device)
        mark("data")
        from libtsd_tpu_torch.ops.psd import psd_welch
        self.fn = psd_welch
        self.host = torch.empty((self.C, self.nfft), dtype=torch.float32,
                                pin_memory=device.type == "cuda")
        self.kept = {}
        mark("program")

    def warm(self):
        for i in range(2):
            self.step(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, i: int):
        x = self.ring[i % self.R]
        if self.control:
            from portbench.reference import welch as ref
            out = ref.psd_db(x, self.nfft, lower=True).to(torch.float32)
        else:
            with span("ops.psd.psd_welch"):
                _, out = self.fn(x, self.nfft, self.window)
        if self.fault == "half_batch":
            out[self.C // 2:] = out[:self.C - self.C // 2]
        elif self.fault == "altered":
            out[0, 1] += 1.0
        with span("consumer.copy_to_host"):
            self.host.copy_(out, non_blocking=True)

    def keep(self, i: int, slot: int):
        self.kept[slot] = (i, self.host.clone())

    def release(self):
        self.fn = None

    def check(self) -> list:
        from portbench.reference import welch as ref
        worst = 0.0
        for i, got in self.kept.values():
            want = ref.psd_db(self.ring[i % self.R], self.nfft)
            worst = max(worst, float((got.to(want.device, torch.float64)
                                      - want).abs().max()))
        return [("psd_db_gap", worst, self.limits["psd_db_gap"])]
