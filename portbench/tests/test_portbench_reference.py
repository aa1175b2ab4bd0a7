"""Each reference at a tiny size against the port's plain route on the CPU
(the references themselves import nothing of the port; these tests do, to
hold the two side by side)."""
from __future__ import annotations

import numpy as np
import torch

from portbench import signals
from portbench.reference import chain as rchain
from portbench.reference import qam as rqam
from portbench.reference import welch as rwelch


def test_chain_reference_matches_the_plain_route():
    from libtsd_tpu_torch.ops.filter_rt import fir_toeplitz_mats
    from libtsd_tpu_torch.ops.kernels.chain import fir_periodogram4096_plain
    g = torch.Generator().manual_seed(3)
    sig = {"noise_std": 2000.0, "tone_amp": 8000.0, "tone_band": [0.01, 0.19]}
    ring = signals.adc_ring(g, 2, 3, 4096 * 3, sig, "cpu")
    taps = signals.lowpass(256, 0.2)
    G = fir_toeplitz_mats(torch.as_tensor(taps, dtype=torch.float32))
    hist = ring[0][:, -256:].reshape(3, 2, 128)
    got = fir_periodogram4096_plain(ring[1], G, hist, "int16", 2)
    want = rchain.spectra(ring[1], ring[0], taps, round_taps=True)
    assert rchain.worst_bin_rel(got, want) < 5e-3
    # the history matters: without it the first frame differs
    cold = fir_periodogram4096_plain(ring[1], G, None, "int16", 2)
    assert rchain.worst_bin_rel(cold, want) > 1e-2


def test_chain_reference_fir_is_the_direct_convolution():
    g = torch.Generator().manual_seed(4)
    x = torch.randint(-3000, 3000, (2, 4096 * 2), generator=g,
                      dtype=torch.int16)
    prev = torch.randint(-3000, 3000, (2, 4096 * 2), generator=g,
                         dtype=torch.int16)
    h = np.random.default_rng(1).standard_normal(37)
    xe = np.concatenate([prev.numpy()[:, -36:], x.numpy()], 1).astype(float)
    y = np.stack([np.convolve(r, h)[36:36 + x.shape[1]] for r in xe])
    P = (np.abs(np.fft.fft(y.reshape(2, -1, 4096), axis=-1)) ** 2).sum(1)
    got = rchain.spectra(x, prev, h, round_taps=False).numpy()
    assert np.abs(got - P).max() / P.max() < 1e-12


def test_welch_reference_matches_the_port():
    from libtsd_tpu_torch.ops.psd import psd_welch
    g = torch.Generator().manual_seed(5)
    sig = {"noise_std": 1e-4, "tone_amps": [1.0, 0.1, 0.01],
           "tone_band": [0.01, 0.45]}
    x = signals.tone_ring(g, 1, 2, 4096 * 6, sig, "cpu")[0]
    _, got = psd_welch(x, 4096, "hn")
    want = rwelch.psd_db(x, 4096)
    assert float((got.double() - want).abs().max()) < 0.5
    assert float((got.double() - want).abs().median()) < 1e-3


def test_qam_reference_matches_the_port_step_by_step():
    from libtsd_tpu_torch.models import waveform as WF
    from libtsd_tpu_torch.models.demod_sb import (DecisionDemodSB,
                                                  SBDemodConfig)
    import json
    from portbench.harness import PB
    cfg = json.loads((PB / "configs" / "qam16_bank.json").read_text())
    g = torch.Generator().manual_seed(6)
    q = {"osf": 4, "beta": 0.25, "noise_std": 0.03,
         "delays": [0.3, 0.301, 0.302]}
    ring = signals.qam_ring(g, 3, 5, 512, q, "cpu")
    wf = WF.wf_qam(16, WF.PulseShape.rcs(0.25), device="cpu")
    dd = DecisionDemodSB.create(wf, SBDemodConfig(
        osf=4, S=16, tc=32.0, BL=0.005, eta=1.0, agc_tc=10.0,
        itrp="cspline", engine="cuda-fused"), device="cpu")
    assert np.allclose(dd.h_mf.numpy(), rqam.matched_taps(0.25, 4),
                       atol=1e-7)
    ref = rqam.Reference(cfg, 2048, "cpu")
    st = dd.init_for(ring[0])
    rows, xtail = rqam.initial_state(5, ref.p, "cpu")
    for k in range(4):
        x = ring[k % 3]
        st, (bits, y, valid, _) = dd.step(st, x)
        ry, rsidx, rvalid, rows, xtail = ref.step(x, rows, xtail)
        assert torch.equal(valid, rvalid)
        assert float((y - ry).abs().max()) < 1e-5
        assert torch.equal(st["ptr"], rows[0]) and torch.equal(
            st["xtail"], xtail)
