"""(chan, time)-sharded FM receiver chain, the recursive de-emphasis
included.

Ported from ``libtsd_tpu/parallel/fm.py``.  Every stage of
``FmReceiver.step`` time-shards:

  1. NCO channel mix: stateless given the GLOBAL sample offset; shard t's
     wrapped-cycle base (f n_local t) mod 1, t its global time index
     (``Mesh.tstart`` on), is formed on the host in float64, so the
     float32 ramp never sees a large argument, and the ramp within the
     shard is ``signal.cycles``;
  2. channel-select FIR + decimate (``FirDecim``): its state IS the last
     Kp R input samples, so the tail halo seeds it exactly;
  3. quadrature discriminator: a 1-sample halo;
  4. de-emphasis IIR: ``IirFrame`` + the cross-shard state composition of
     ``halo.iir_time_sharded``.

The halos and the de-emphasis' end states cross processes where a row does
(``halo.halo_exchange_left``, ``halo.iir_time_sharded``).  The output
matches the unsharded ``FmReceiver.step`` from zero state up to float32
reassociation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import complex_dtype
from ..models.demod import quadrature_discriminator
from ..ops.filter_rt import IirFrame
from ..ops.signal import cycles
from .halo import (_grid, _on, _result, halo_exchange_left,
                   iir_time_sharded)
from .mesh import Mesh, on_device

__all__ = ["sharded_fm_receiver"]


def sharded_fm_receiver(mesh: Mesh, fm, x):
    """One-shot (zero initial state) FM receive over a (chan, time)-sharded
    IF signal x (C, N) complex, global or the grid from ``mesh.shard``;
    returns the (C, N / decim) audio in the same form.  ``fm`` is a
    ``models.receivers.FmReceiver``."""
    cfg = fm.cfg
    R = cfg.decim
    f = float(cfg.channel_freq)
    dev = float(cfg.deviation)
    # de-emphasis as a frame-parallel IIR for the cross-shard state
    # composition; the same b/a as the unsharded Iir stage
    b = fm.deemph.b.detach().cpu().double().numpy()
    a = fm.deemph.a.detach().cpu().double().numpy()
    has_deemph = not (len(b) == 1 and len(a) == 1)
    deemph = (IirFrame.create(b, a, device=fm.deemph.b.device)
              if has_deemph else None)
    hist = fm.chan_filt.P.shape[0] * R          # FirDecim carried samples
    grid, was_global = _grid(mesh, x)
    n_local = grid[0][0].shape[-1]
    # exact per-shard phase base: (f n_local t) mod 1 in host float64
    base_step = float(np.mod(np.float64(f) * n_local, 1.0))
    out = []
    for row, t0, link in zip(grid, mesh.tstart, mesh.links):
        xb = []
        for t, xs in enumerate(row, start=t0):
            base = np.float32(np.mod(base_step * t, 1.0))
            cyc = torch.remainder(base + cycles(f, n_local, device=xs.device),
                                  1.0)
            xb.append(xs.to(complex_dtype)
                      * torch.exp(-2j * np.pi * cyc).to(complex_dtype))
        xd = []
        for h, xs in zip(halo_exchange_left(xb, hist, link), xb):
            with on_device(xs.device):
                xd.append(_on(fm.chan_filt, xs.device).step(h, xs)[1])
        audio = [quadrature_discriminator(v, p) / (2 * np.pi * dev)
                 for v, p in zip(xd, halo_exchange_left(xd, 1, link))]
        if has_deemph:
            audio = iir_time_sharded(deemph, audio, link)
        out.append(audio)
    return _result(mesh, out, was_global)
