"""Path ``qam``: the QAM-16 bank, ``models.demod_sb.DecisionDemodSB.step``
on the ``"cuda-fused"`` engine (kernel #6).

A step hands block (stream position) % R of the complex64 ring, C
channels of nsym osf samples, to ``DecisionDemodSB.step`` with the state
the step before returned (loops, AGC power EMA, input tail).  The
symbols, decisions, bits and valid flags stay on the card, where an
on-card decoder reads them.

The check: the stream's first step against the reference from its own
initial state, and a sample of the window's steps against the reference
started from the state the program carried into that step (the reference
cannot replay thousands of steps in a run's time; the carried state is
checked at the start, and each sampled step's outgoing state is compared
too).
"""
from __future__ import annotations

import torch

from portbench import signals
from portbench.spans import span

# the faults ``Path(fault=...)`` plants in the timed path, each of which
# must make a run not correct (the benchmark's tests plant each one)
FAULTS = ("stale_state", "half_batch", "altered")
# the traffic keys a tiny run on the CPU overrides (the benchmark's tests)
TINY = {"channels": 8, "nsym": 512, "ring": 3}


def _rows(state) -> tuple:
    """The program's carried state as (9, C) rows and the input tail."""
    lf0, lf1, lf2 = state["lf"]
    rows = torch.stack([state["ptr"], state["theta"], state["gain"], lf0,
                        lf1, lf2, state["yprev_ri"][..., 0],
                        state["yprev_ri"][..., 1], state["p_ema"]])
    return rows.to(torch.float32), state["xtail"]


class Path:
    def __init__(self, cell, seed: int, device, mark, control=False,
                 fault=None, row=None):
        t, c = cell.traffic, cell.config
        self.cfg = c
        self.C, self.R = t["channels"], t["ring"]
        self.n = t["nsym"] * c["osf"]
        self.samples_per_step = self.C * self.n
        self.limits = t["limits"]
        self.control, self.fault, self.device = control, fault, device
        gen = torch.Generator(device=device).manual_seed(seed)
        self.ring = signals.qam_ring(gen, self.R, self.C, t["nsym"],
                                     t["signal"], device)
        mark("data")
        from libtsd_tpu_torch.models import waveform as WF
        from libtsd_tpu_torch.models.demod_sb import (DecisionDemodSB,
                                                      SBDemodConfig)
        wf = WF.wf_qam(16, WF.PulseShape.rcs(c["beta"]), device=device)
        # on the CPU (tests) the same engine runs kernel #6's plain version
        self.dd = DecisionDemodSB.create(wf, SBDemodConfig(
            osf=c["osf"], S=c["S"], tc=c["tc"], BL=c["BL"], eta=c["eta"],
            agc_tc=c["agc_tc"], itrp=c["itrp"], engine=c["engine"]),
            device=device)
        self.state = self.dd.init_for(self.ring[0])
        if control:
            from portbench.reference.qam import Reference
            self.ref = Reference(c, self.n, device, lower=True)
            self.ref_state = _rows(self.state)
        self.pos = 0
        self.kept = {}
        self.start = None
        mark("program")

    def warm(self):
        self.step(0)
        self.start = self.last
        self.step(1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, i: int):
        x = self.ring[self.pos % self.R]
        if self.control:
            before = self.ref_state
            y, sidx, valid, rows, xtail = self.ref.step(x, *before)
            self.ref_state = (rows, xtail)
            out = (y, sidx, valid, rows)
        else:
            before = self.state
            with span("models.demod_sb.step"):
                st, (bits, y, valid, bvalid) = self.dd.step(self.state, x)
            if self.fault == "stale_state":
                st = before
            self.state = st
            out = (y, bits, valid, st)
        if self.fault == "altered":
            y[0, 7] = y[0, 7] + 1.0
        elif self.fault == "half_batch":
            y[self.C // 2:] = y[:self.C - self.C // 2]
        self.last = (self.pos, before, out)
        self.pos += 1

    def keep(self, i: int, slot: int):
        self.kept[slot] = self.last

    def release(self):
        self.state = None

    def check(self) -> list:
        from portbench.reference.qam import Reference, initial_state
        ref = Reference(self.cfg, self.n, self.device)
        sym_gap = state_gap = 0.0
        mism = total = 0
        runs = [(self.start, True)] + [(k, False) for k in
                                        self.kept.values()]
        for (pos, before, out), fresh in runs:
            if fresh:
                rows, xtail = initial_state(self.C, ref.p, self.device)
            else:
                rows, xtail = before if self.control else _rows(before)
            ry, rsidx, rvalid, rrows, _ = ref.step(
                self.ring[pos % self.R], rows, xtail)
            y, valid = out[0], out[2]
            dsym = out[1] if self.control else _indices(out[1])
            both = valid & rvalid
            total += int(rvalid.sum())
            mism += int((valid != rvalid).sum()) + int(
                (both & (dsym != rsidx)).sum())
            gap = (y - ry).abs()
            sym_gap = max(sym_gap, float(gap[both].max()) / ref.rms_ref
                          if both.any() else float("inf"))
            prow = out[3] if self.control else _rows(out[3])[0]
            state_gap = max(state_gap, _state_gap(prow, rrows))
        return [("dec_mismatch", mism / max(total, 1),
                 self.limits["dec_mismatch"]),
                ("sym_gap", sym_gap, self.limits["sym_gap"]),
                ("state_gap", state_gap, self.limits["state_gap"])]


def _indices(bits: torch.Tensor) -> torch.Tensor:
    """The program's decisions from the bits it returned (4 a symbol,
    least significant first)."""
    b = bits.reshape(bits.shape[0], -1, 4).to(torch.int32)
    return (b << torch.arange(4, device=b.device, dtype=torch.int32)).sum(
        -1, dtype=torch.int32)


def _state_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest gap of a state row, relative to that row's largest value
    in the reference (pointer, phases, gains, errors, power)."""
    g = (got.to(torch.float64) - want.to(torch.float64)).abs().amax(1)
    s = want.to(torch.float64).abs().amax(1).clamp(min=1e-6)
    return float((g / s).max())
