#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json] [--profile DIR]

Builds the port's CUDA kernels from ``libtsd_tpu_torch/csrc`` into
``build/libtsd_tpu_torch/`` and drives two paths at full size:

* the spectral main path (256 channels x 2^22 int16 samples: 256-tap
  lowpass FIR -> 4096-point periodogram, fused, composed and streamed, plus
  a Welch PSD), with kernels #1-#4 each checked against its plain PyTorch
  version;
* the QAM-16 receive path: 4096 channels made on the card by the port's
  modulator (RRC 0.25, osf 4, 8 fractional delays, independent noise),
  demodulated by ``DecisionDemodSB`` over 8 steps of 8192 samples with
  the ``"cuda"`` engine (kernel #5) and the ``"cuda-fused"`` engine
  (kernel #6); tail EVM on every channel, bit errors after warm-up on
  sampled channels, each kernel against its plain version.

Every kernel is timed beside its plain version (CUDA events, median of 5
after a warm-up), beside the least time the card could take for the same
work and, where one PyTorch call computes the same function, that call's
time.  Each path runs with the launch counts set to 0 just before it and
read just after; a kernel of a path that was not launched fails the run.
Any failure raises and exits non-zero.  Without a CUDA device it exits 1
and prints no result.  ``--profile DIR`` adds ``torch.profiler`` windows
over the fused and composed main path and over one step of each QAM
engine (device busy time, idle share, top kernels; chrome traces into
DIR).

Output, in order: versions and the card (``nvidia-smi`` name, power
limit), build time, one line per check with its tolerance, timings, launch
counts, a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

C_MAIN, N_MAIN = 256, 1 << 22      # the main path's working set
C_CHECK = 16                       # channels of the kernel-vs-plain checks
NFFT = 4096
TOL_F32 = 1e-4                     # fp32 results, relative to the peak
TOL_TIER = 1e-2                    # across tiers that round taps or x to bf16
# Spectra are also held bin by bin: |a-b| / (|b| + FLOOR * peak).  Behind
# the 256-tap lowpass most bins lie orders of magnitude below the peak, so
# the peak-relative error alone cannot see a wrong stopband.  fp32 against
# float64 gives ~2e-5 per bin there (CPU tests); zeroing a bin gives ~1.
FLOOR = 1e-6
TOL_BIN = 1e-3

# the QAM-16 receive path (examples/qam_serving.py at full width)
C_QAM, N_QAM, STEPS_QAM = 4096, 8192, 8
QAM_BASES = 8          # base streams, fractional delays 0.3 + 0.1 b
QAM_NOISE = 0.02       # noise std per real dimension
WARMUP_SYM = 600       # symbols before the bit-error count starts
TOL_EVM = 0.2          # tail EVM, every channel (qam_serving.py:75)
# kernel vs plain, the JAX gates of tests/test_demod_sb.py:174-178
TOL_SYM = 1e-3         # max |dsymbol| on valid symbols
TOL_BITS = 1e-4        # bit mismatch share

# the card's published peaks (NVIDIA's H100 SXM data sheet): HBM bytes/s and
# fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12

KERNELS = {   # wrapper name -> (source, the Pallas call it replaces)
    "fir": ("libtsd_tpu_torch/csrc/fir.cu",
            "libtsd_tpu/ops/pallas/fir.py:82"),
    "periodogram4096": ("libtsd_tpu_torch/csrc/periodogram.cu",
                        "libtsd_tpu/ops/pallas/periodogram.py:143"),
    "fir_periodogram4096": ("libtsd_tpu_torch/csrc/chain.cu",
                            "libtsd_tpu/ops/pallas/chain.py:337"),
    "fft_pow2": ("libtsd_tpu_torch/csrc/fft.cu",
                 "libtsd_tpu/ops/pallas/fft.py:152"),
    "demod_sb": ("libtsd_tpu_torch/csrc/demod_sb.cu",
                 "libtsd_tpu/ops/pallas/demod_sb.py:338"),
    "demod_sb_fused": ("libtsd_tpu_torch/csrc/demod_sb.cu",
                       "libtsd_tpu/ops/pallas/demod_sb.py:561"),
}
PATH_KERNELS = {"main": ("fir", "periodogram4096", "fir_periodogram4096",
                         "fft_pow2"),
                "qam": ("demod_sb", "demod_sb_fused")}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``flops``:
    (ms, "bytes" or "operations")."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def fft_flops(n: int) -> float:
    """5 n log2 n, the usual count of a complex radix-2 FFT."""
    return 5.0 * n * np.log2(n)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a-b| / max |b|, max |a-b|), in float64."""
    a, b = a.double(), b.double()
    d = (a - b).abs().max().item()
    return d / b.abs().max().item(), d


def bin_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a-b| / (|b| + FLOOR * max |b|), in float64: per-bin error."""
    a, b = a.double(), b.double()
    return ((a - b).abs() / (b.abs() + FLOOR * b.abs().max())).max().item()


def check(name: str, a: torch.Tensor, b: torch.Tensor, tol: float,
          per_bin: bool = False) -> float:
    """Hold a against b: peak-relative error below tol and, for spectra of
    one tier (per_bin), the per-bin error below TOL_BIN.  Returns the max
    absolute error."""
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError(f"{name}: non-finite values")
    if a.shape != b.shape:
        raise AssertionError(f"{name}: shape {tuple(a.shape)} != "
                             f"{tuple(b.shape)}")
    r, d = rel_err(a, b)
    line = f"check {name}: rel_err={r:.3e} max_abs_err={d:.6e} tol={tol:g}"
    ok = r < tol
    if per_bin:
        rb = bin_err(a, b)
        line += f" bin_err={rb:.3e} tol_bin={TOL_BIN:g} floor={FLOOR:g}"
        ok = ok and rb < TOL_BIN
    print(f"{line} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: out of tolerance")
    return d


def time_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` CUDA-event timings of one call, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return float(np.median(ts))


def device_info() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"nvcc {ver}")
    print(card)
    return card


def kernel_checks(h, G, gen, dev) -> dict:
    """Phase 3: every kernel against its plain version, on the card."""
    from libtsd_tpu_torch.ops.kernels import chain, fft, fir, periodogram
    err = {}
    x = torch.randn(N_MAIN, generator=gen, device=dev)
    err["fir"] = check("#1 fir 1-D N=2^22 K=256 vs plain",
                       fir.fir_kernel(h, x), fir.fir_plain(h, x), TOL_F32)
    y = torch.randn(C_CHECK, N_MAIN, generator=gen, device=dev)
    err["periodogram4096"] = max(
        check(f"#2 periodogram4096 C={C_CHECK} {p} vs plain",
              periodogram.periodogram4096_acc(y, p),
              periodogram.periodogram4096_plain(y, p), TOL_F32, per_bin=True)
        for p in ("highest", "split"))
    xi16 = torch.randint(-2048, 2048, (C_CHECK, N_MAIN), generator=gen,
                         device=dev, dtype=torch.int16)
    xi8 = torch.randint(-127, 128, (C_CHECK, N_MAIN), generator=gen,
                        device=dev, dtype=torch.int8)
    xf = torch.randn(C_CHECK, N_MAIN, generator=gen, device=dev) * 1000
    inputs = {"highest": xf, "split": xf, "bf16": xf, "int8": xi8,
              "int16": xi16}
    errs = []
    for prec, xin in inputs.items():
        for passes in (2, 3):
            errs.append(check(
                f"#3 fir_periodogram4096 C={C_CHECK} {prec} "
                f"fir_passes={passes} vs plain",
                chain.fir_periodogram4096(xin, G, precision=prec,
                                          fir_passes=passes),
                chain.fir_periodogram4096_plain(xin, G, precision=prec,
                                                fir_passes=passes), TOL_F32,
                per_bin=True))
    # the repo's own reference: float64 numpy FIR + FFT on a small input,
    # same bf16-rounded taps as fir_passes=2
    xs = xi16[:2, :2 * 65536]
    hb = torch.as_tensor(h, dtype=torch.float32).to(torch.bfloat16).double()
    xn = xs.double().cpu().numpy()
    yn = np.stack([np.convolve(r, hb.numpy())[:xn.shape[1]] for r in xn])
    ref = (np.abs(np.fft.fft(yn.reshape(2, -1, NFFT), axis=-1)) ** 2).sum(1)
    check("#3 int16 fir_passes=2 vs float64 numpy (C=2, N=2^17)",
          chain.fir_periodogram4096(xs, G, precision="int16", fir_passes=2),
          torch.as_tensor(ref, device=dev), TOL_F32, per_bin=True)
    err["fir_periodogram4096"] = max(errs)
    errs = []
    for n in (256, 4096, 16384):
        zr = torch.randn(N_MAIN // n, n, generator=gen, device=dev)
        zi = torch.randn(N_MAIN // n, n, generator=gen, device=dev)
        for inv in (False, True):
            k = torch.complex(*fft.fft_pow2(zr, zi, inverse=inv))
            p = torch.complex(*fft.fft_pow2_plain(zr, zi, inverse=inv))
            errs.append(check(f"#4 fft_pow2 n={n} B={N_MAIN // n} "
                              f"inverse={inv} vs plain",
                              torch.view_as_real(k), torch.view_as_real(p),
                              TOL_F32))
    z = torch.complex(zr[:8], zi[:8]).requires_grad_(True)
    wgt = torch.arange(z.shape[-1], device=dev, dtype=torch.float32)
    gk = torch.autograd.grad(
        (fft.FftPow2.apply(z, False).abs() ** 2 * wgt).sum(), z)[0]
    gp = torch.autograd.grad((torch.fft.fft(z).abs() ** 2 * wgt).sum(), z)[0]
    check("#4 FftPow2 gradient vs torch.fft (n=16384)",
          torch.view_as_real(gk), torch.view_as_real(gp), TOL_F32)
    err["fft_pow2"] = max(errs)
    return err


def main_path(h, gen, dev) -> dict:
    """Phase 4: the port's main path at full size, as a user drives it."""
    from libtsd_tpu_torch.ops import psd
    from libtsd_tpu_torch.ops.filter_rt import Fir
    from libtsd_tpu_torch.ops.kernels.chain import fir_periodogram4096
    from libtsd_tpu_torch.ops.kernels.fir import fir_kernel
    from libtsd_tpu_torch.ops.kernels.periodogram import periodogram4096_acc

    fir = Fir.create(h, device=dev)
    G = fir.G
    D = G.shape[0]
    x = torch.randint(-2048, 2048, (C_MAIN, N_MAIN), generator=gen,
                      device=dev, dtype=torch.int16)
    x8 = torch.randint(-127, 128, (C_MAIN, N_MAIN), generator=gen,
                       device=dev, dtype=torch.int8)
    out = {"x": x, "x8": x8, "G": G, "fir": fir}
    # fused metric kernel, every tier
    s = {}
    s["int16/2"] = fir_periodogram4096(x, G, precision="int16", fir_passes=2)
    s["int16/3"] = fir_periodogram4096(x, G, precision="int16", fir_passes=3)
    s["split"] = fir_periodogram4096(x.float(), G, precision="split")
    s["highest"] = fir_periodogram4096(x.float(), G, precision="highest")
    s["bf16"] = fir_periodogram4096(x.float(), G, precision="bf16")
    s["int8"] = fir_periodogram4096(x8, G, precision="int8")
    s["int8_ref"] = fir_periodogram4096(x8.float(), G, precision="split",
                                        fir_passes=2)
    # composed: the streaming Fir block, then the periodogram kernel
    y = fir.step(fir.init_for(x), x)[1]
    s["composed"] = periodogram4096_acc(y)
    # composed through the 1-D FIR kernel, a few channels
    s["fir1d"] = torch.cat([periodogram4096_acc(fir_kernel(h, x[c])[None])
                            for c in range(4)])
    # streamed in two halves, carrying the last (D-1)*128 input samples
    half = N_MAIN // 2
    hist0 = x[:, half - (D - 1) * 128:half].reshape(C_MAIN, D - 1, 128)
    s["half1"] = fir_periodogram4096(x[:, :half], G, precision="int16",
                                     fir_passes=3)
    s["half2"] = fir_periodogram4096(x[:, half:], G, hist0=hist0,
                                     precision="int16", fir_passes=3)
    s["streamed"] = s["half1"] + s["half2"]
    out["hist0"] = hist0
    # display spectra: Welch over the filtered signal of a few channels
    _, s["welch_db"] = psd.psd_welch(y[:4], NFFT)
    out["y"] = y
    out["spectra"] = s
    torch.cuda.synchronize()
    return out


def main_path_checks(mp) -> dict:
    """Phase 4's checks: every fused tier and the composed path against
    their plain versions on the same full-size tensors, then the fused,
    composed and streamed forms against each other.  Returns the largest
    absolute error of each kernel against its plain version."""
    from libtsd_tpu_torch.ops.kernels.chain import fir_periodogram4096_plain
    from libtsd_tpu_torch.ops.kernels.periodogram import periodogram4096_plain
    s, x, x8, G = mp["spectra"], mp["x"], mp["x8"], mp["G"]
    ref = s["int16/3"]
    for k, v in s.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"main path {k}: non-finite values")
    if ref.shape != (C_MAIN, NFFT):
        raise AssertionError(f"fused spectrum shape {tuple(ref.shape)}")
    err = {"fir_periodogram4096": 0.0}
    tiers = {"int16/2": (x, "int16", 2), "int16/3": (x, "int16", 3),
             "split": (x.float(), "split", 3),
             "highest": (x.float(), "highest", 3),
             "bf16": (x.float(), "bf16", 3), "int8": (x8, "int8", 3),
             "int8_ref": (x8.float(), "split", 2)}
    for k, (xin, prec, passes) in tiers.items():
        d = check(f"main fused {k} (#3) vs plain, {C_MAIN} x 2^22", s[k],
                  fir_periodogram4096_plain(xin, G, precision=prec,
                                            fir_passes=passes),
                  TOL_F32, per_bin=True)
        err["fir_periodogram4096"] = max(err["fir_periodogram4096"], d)
        torch.cuda.empty_cache()
    half = N_MAIN // 2
    d = check("main streamed 2nd half with hist0 (#3) vs plain", s["half2"],
              fir_periodogram4096_plain(x[:, half:], G, hist0=mp["hist0"],
                                        precision="int16", fir_passes=3),
              TOL_F32, per_bin=True)
    err["fir_periodogram4096"] = max(err["fir_periodogram4096"], d)
    err["periodogram4096"] = check(
        "main composed: #2 on Fir.step's output vs plain", s["composed"],
        periodogram4096_plain(mp["y"]), TOL_F32, per_bin=True)
    torch.cuda.empty_cache()
    check("main fused int16/2 vs int16/3", s["int16/2"], ref, TOL_TIER)
    check("main fused split vs int16/3", s["split"], ref, TOL_F32,
          per_bin=True)
    check("main fused highest vs int16/3", s["highest"], ref, TOL_F32,
          per_bin=True)
    check("main fused bf16 vs int16/3", s["bf16"], ref, TOL_TIER)
    check("main fused int8 vs split/2 of the same samples", s["int8"],
          s["int8_ref"], TOL_F32, per_bin=True)
    check("main composed (Fir.step -> #2) vs fused", s["composed"], ref,
          TOL_F32, per_bin=True)
    check("main composed (#1 -> #2, 4 ch) vs fused", s["fir1d"], ref[:4],
          TOL_F32, per_bin=True)
    check("main streamed (2 halves, hist0) vs fused", s["streamed"], ref,
          TOL_F32, per_bin=True)
    # Welch via the FFT kernel against torch.fft on the same segments
    from libtsd_tpu_torch.ops.window import window
    y4 = mp["y"][:4]
    w = torch.as_tensor(window("hn", NFFT, sym=False), dtype=torch.float32,
                        device=y4.device)
    starts = range(0, y4.shape[-1] - NFFT, NFFT // 2)
    S = sum(torch.fft.fftshift(
        torch.fft.fft(y4[:, i:i + NFFT] * w).abs() ** 2 / NFFT, dim=-1)
        for i in starts)
    check("main psd_welch (#4) vs torch.fft, linear power",
          10 ** (s["welch_db"].double() / 10), S, TOL_F32)
    return err


def timings(h, mp, dev) -> dict:
    """Phase 5: each kernel beside its plain version, CUDA events, median
    of 5 after a warm-up, at the main path's shapes."""
    from libtsd_tpu_torch.ops.kernels import chain, fft, fir, periodogram
    x, x8, G, y = mp["x"], mp["x8"], mp["G"], mp["y"]
    xf = x.float()
    t = {}
    tiers = [("int16", 2, x), ("int16", 3, x), ("split", 3, xf),
             ("highest", 3, xf), ("bf16", 3, xf), ("int8", 2, x8)]
    for prec, passes, xin in tiers:
        k = time_ms(lambda: chain.fir_periodogram4096(
            xin, G, precision=prec, fir_passes=passes))
        torch.cuda.empty_cache()
        p = time_ms(lambda: chain.fir_periodogram4096_plain(
            xin, G, precision=prec, fir_passes=passes))
        torch.cuda.empty_cache()
        t[f"fir_periodogram4096 {prec}/{passes}"] = (k, p, C_MAIN * N_MAIN)
    del xf
    t["periodogram4096"] = (
        time_ms(lambda: periodogram.periodogram4096_acc(y)),
        time_ms(lambda: periodogram.periodogram4096_plain(y)),
        C_MAIN * N_MAIN)
    torch.cuda.empty_cache()
    x1 = y[0].contiguous()
    t["fir"] = (time_ms(lambda: fir.fir_kernel(h, x1)),
                time_ms(lambda: fir.fir_plain(h, x1)), N_MAIN)
    # the Welch call's planes: 4 channels x (2^22 / 2048 - 1) segments
    nseg = len(range(0, N_MAIN - NFFT, NFFT // 2))
    zr = torch.randn(4 * nseg, NFFT, device=dev)
    zi = torch.randn(4 * nseg, NFFT, device=dev)
    t["fft_pow2"] = (time_ms(lambda: fft.fft_pow2(zr, zi)),
                     time_ms(lambda: fft.fft_pow2_plain(zr, zi)),
                     zr.numel())
    for name, (k, p, n) in t.items():
        print(f"time {name}: kernel {k:.4f} ms ({n / k / 1e3:.1f} Msamples/s)"
              f" plain {p:.4f} ms ({n / p / 1e3:.1f} Msamples/s)")
    return t


def main_bounds_and_library(h, mp, dev) -> dict:
    """Each main-path kernel's bound at the shapes timed above, and the
    time of the one PyTorch call that computes the same transform:
    ``F.conv1d`` for #1 (cuDNN TF32 off, so fp32 as the kernel),
    ``torch.fft.rfft`` of the same 4096-sample frames for #2 (the
    transform only, without |X|^2 and the sum over frames), ``torch.fft.fft``
    for #4; #3 has none.  Flops: 2 per tap and sample for a FIR, 5 n log2 n
    per complex n-point FFT, 4 per bin for |X|^2 and the accumulation."""
    import torch.nn.functional as F
    y = mp["y"]
    K, frames = len(h), C_MAIN * N_MAIN // NFFT
    spec = frames * (fft_flops(NFFT) + 4 * NFFT)
    nseg = len(range(0, N_MAIN - NFFT, NFFT // 2))
    out = {
        "fir": bound(8 * N_MAIN + 4 * K, 2 * K * N_MAIN),
        "periodogram4096": bound(4 * C_MAIN * N_MAIN + 4 * C_MAIN * NFFT,
                                 spec),
        "fir_periodogram4096": bound(
            2 * C_MAIN * N_MAIN + 4 * C_MAIN * NFFT + 4 * K,
            2 * K * C_MAIN * N_MAIN + spec),
        "fft_pow2": bound(16 * 4 * nseg * NFFT,
                          4 * nseg * fft_flops(NFFT)),
    }
    x1 = y[0].contiguous()[None, None]
    w = torch.as_tensor(np.asarray(h, np.float32)[::-1].copy(),
                        device=dev)[None, None]
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib = {"fir": time_ms(lambda: F.conv1d(x1, w, padding=K - 1))}
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    lib["periodogram4096"] = time_ms(
        lambda: torch.fft.rfft(y.view(C_MAIN, -1, NFFT)))
    torch.cuda.empty_cache()
    z = torch.randn(4 * nseg, NFFT, device=dev, dtype=torch.complex64)
    lib["fft_pow2"] = time_ms(lambda: torch.fft.fft(z))
    lib["fir_periodogram4096"] = None
    for name, (bms, by) in out.items():
        lt = lib[name]
        print(f"bound {name}: {bms:.4f} ms by {by}; library call "
              + ("none" if lt is None else f"{lt:.4f} ms"))
    return {k: (v[0], v[1], lib[k]) for k, v in out.items()}


# ------------------------------------------------------- QAM-16 receive


def qam_signal(gen, dev):
    """C_QAM channels of STEPS_QAM * N_QAM samples, made on the card: one
    QAM-16 stream from the port's modulator (RRC 0.25, osf 4), delayed by
    QAM_BASES fractional delays, channel c carrying delay c % QAM_BASES,
    plus independent noise (examples/qam_serving.py:45-56)."""
    from libtsd_tpu_torch.models import waveform as W
    from libtsd_tpu_torch.models.bitstream import randbits
    from libtsd_tpu_torch.models.modulator import ModConfig, Modulator
    from libtsd_tpu_torch.ops.fft import delay_signal
    wf = W.wf_qam(16, W.PulseShape.rcs(0.25), device=dev)
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0), device=dev)
    total = STEPS_QAM * N_QAM
    bits = randbits(gen, 4 * (total // 4 + 64))
    x, _ = mod.modulate(bits)
    base = torch.stack([delay_signal(x, 0.3 + 0.1 * b)[:total]
                        for b in range(QAM_BASES)])
    xs = base.repeat(C_QAM // QAM_BASES, 1)
    w = torch.randn(2, C_QAM, total, generator=gen, device=dev) * QAM_NOISE
    xs = xs + torch.complex(w[0], w[1])
    torch.cuda.synchronize()
    return wf, bits, xs


def qam_path(wf, x, dev) -> dict:
    """The QAM path as a user drives it: DecisionDemodSB.create, init_for,
    STEPS_QAM steps of N_QAM samples with the state carried, on each
    engine.  Keeps the symbols, masks and the state before each step."""
    from libtsd_tpu_torch.models.demod_sb import DecisionDemodSB, SBDemodConfig
    out = {}
    for eng in ("cuda", "cuda-fused"):
        dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16,
                                                      engine=eng),
                                    device=dev)
        st = dd.init_for(x[:, :N_QAM])
        states, syms, valid = [], [], []
        for k in range(STEPS_QAM):
            states.append(st)
            st, (_, y, v, _) = dd.step(st, x[:, k * N_QAM:(k + 1) * N_QAM])
            syms.append(y)
            valid.append(v)
        out[eng] = dict(dd=dd, states=states, syms=torch.cat(syms, 1),
                        valid=torch.cat(valid, 1))
    torch.cuda.synchronize()
    return out


def _kernel_args(eng, dd, st, xb):
    """Kernel #5's or #6's inputs for one step, as the engine builds them."""
    from libtsd_tpu_torch.models.demod_sb import pack_state
    from libtsd_tpu_torch.ops.kernels import demod_sb as KSB
    p = dd.loop_params(xb.shape[-1])
    if eng == "cuda":
        _, zp = dd.matched_zp(st, xb)
        return (KSB.demod_sb, KSB.demod_sb_plain,
                (zp, pack_state(st), dd.wf.symbols, p))
    return (KSB.demod_sb_fused, KSB.demod_sb_fused_plain,
            (xb.contiguous(), st["xtail"], pack_state(st), dd.wf.symbols,
             dd.h_mf, p, dd.rms_ref))


def qam_checks(wf, bits, x, qp) -> dict:
    """The QAM path's checks on each engine: tail EVM < TOL_EVM on every
    channel; zero bit errors after WARMUP_SYM symbols on sampled channels
    (cmp_bits_rot resolves the 90-degree ambiguity of the blind loop);
    each kernel against its plain version on the same full-width inputs
    (the first step and one from the middle).  Returns the largest
    |dsymbol| per kernel."""
    from libtsd_tpu_torch.models import ber
    from libtsd_tpu_torch.models.waveform import symbol_indices_to_bits
    err = {}
    sym = wf.symbols
    for eng, r in qp.items():
        syms, valid = r["syms"], r["valid"]
        if syms.shape != (C_QAM, STEPS_QAM * N_QAM // 4):
            raise AssertionError(f"qam {eng}: symbols {tuple(syms.shape)}")
        if not torch.isfinite(torch.view_as_real(syms)).all():
            raise AssertionError(f"qam {eng}: non-finite symbols")
        tail = slice(syms.shape[1] - N_QAM // 4, None)     # the last step
        t, v = syms[:, tail], valid[:, tail]
        d2 = ((t[..., None] - sym).abs() ** 2).min(-1).values
        nv = v.sum(1)
        evm = torch.sqrt((d2 * v).sum(1) / nv.clamp(min=1)
                         / (sym.abs() ** 2).mean())
        ok = bool((nv > 0).all()) and evm.max().item() < TOL_EVM
        print(f"check qam {eng}: tail EVM mean {evm.mean().item():.4f} max "
              f"{evm.max().item():.4f} over {C_QAM} channels, tol {TOL_EVM}"
              f", valid share {valid.float().mean().item():.4f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"qam {eng}: tail EVM")
        nerr, nbits = 0, 0
        for i in range(16):
            c = (i * (C_QAM // 16) + i % QAM_BASES) % C_QAM
            sy = syms[c][valid[c]]
            _, e, lag = ber.cmp_bits_rot(bits[4 * WARMUP_SYM:],
                                         sy[WARMUP_SYM:], wf, max_lag=64)
            nerr += e
            nbits += 4 * (len(sy) - WARMUP_SYM)
        print(f"check qam {eng}: {nerr} bit errors in {nbits} bits after "
              f"{WARMUP_SYM} warm-up symbols, 16 channels over all "
              f"{QAM_BASES} delays {'ok' if nerr == 0 else 'FAIL'}")
        if nerr:
            raise AssertionError(f"qam {eng}: bit errors")
        name = "demod_sb" if eng == "cuda" else "demod_sb_fused"
        err[name] = 0.0
        for k in (0, STEPS_QAM // 2):
            kf, pf, args = _kernel_args(eng, r["dd"], r["states"][k],
                                        x[:, k * N_QAM:(k + 1) * N_QAM])
            yk, sk, vk, stk = kf(*args)
            yp, sp, vp, stp = pf(*args)
            same = torch.equal(vk, vp)
            dy = (yk - yp).abs()
            dmax = dy[vp].max().item() if vp.any() else 0.0
            mism = (symbol_indices_to_bits(sk, 4)
                    != symbol_indices_to_bits(sp, 4)).float().mean().item()
            dst = (stk - stp).abs().max().item()
            ok = same and dmax < TOL_SYM and mism < TOL_BITS
            print(f"check qam {name} (#{5 if eng == 'cuda' else 6}) vs plain,"
                  f" {C_QAM} x {N_QAM} step {k}: valid masks equal {same}, "
                  f"max|dsym| {dmax:.3e} tol {TOL_SYM:g}, bit mismatch "
                  f"{mism:.3e} tol {TOL_BITS:g}, max|dstate| {dst:.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} vs plain")
            err[name] = max(err[name], dy.max().item())
            del args
            torch.cuda.empty_cache()
    return err


def qam_timings(x, qp) -> dict:
    """Each engine's step, each kernel alone and its plain version (CUDA
    events, median of 5 after a warm-up) on the first block, and each
    kernel's bound.  Flops per symbol: 8 K for the two K-tap windows, 5 M
    for the decisions, ~60 for rotation, TED, phase and AGC errors and
    the lane sums; the fused kernel adds 4 Kmf + 3 per input sample for
    the matched filter and its power.  Bytes: the kernel's inputs once
    and 13 per symbol out (y 8, sidx 4, valid 1)."""
    out = {}
    xb = x[:, :N_QAM]
    for eng, r in qp.items():
        dd, st = r["dd"], r["states"][0]
        kf, pf, args = _kernel_args(eng, dd, st, xb)
        ms_step = time_ms(lambda: dd.step(st, xb))
        ms_k = time_ms(lambda: kf(*args))
        ms_p = time_ms(lambda: pf(*args))
        p = args[-1] if eng == "cuda" else args[5]
        nsym = C_QAM * p.nsb * p.S
        M, C = dd.wf.symbols.shape[0], C_QAM
        out_b = 13 * nsym + 2 * 36 * C + 8 * M
        loop_f = nsym * (8 * p.K + 5 * M + 60)
        if eng == "cuda":
            nb = 8 * args[0].numel() + out_b
            nf = loop_f
            name = "demod_sb"
        else:
            kmf = dd.h_mf.shape[0]
            nb = 8 * (xb.numel() + args[1].numel()) + 4 * kmf + out_b
            nf = loop_f + C * N_QAM * (4 * kmf + 3)
            name = "demod_sb_fused"
        bms, by = bound(nb, nf)
        rate = C_QAM * N_QAM / ms_step / 1e3
        print(f"time qam {eng}: step {ms_step:.4f} ms ({rate:.1f} "
              f"Msamples/s aggregate, {C_QAM} x {N_QAM}); kernel {name} "
              f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {bms:.4f} ms by "
              f"{by}; library call none")
        out[name] = (ms_k, ms_p, bms, by, None, ms_step, rate)
        del args
        torch.cuda.empty_cache()
    return out


def profile(mp, out_dir: str) -> None:
    """Optional phase: torch.profiler over 5 back-to-back calls of the
    fused int16/2 chain and of the composed path (Fir.step -> #2), after a
    warm-up, at the main path's shapes.  Prints, per window, the device's
    busy time (union of kernel, copy and fill intervals), its idle share of
    the span from the first to the last device interval, and the kernels
    that take most of the busy time."""
    from libtsd_tpu_torch.ops.kernels.chain import fir_periodogram4096
    from libtsd_tpu_torch.ops.kernels.periodogram import periodogram4096_acc
    x, G, fir = mp["x"], mp["G"], mp["fir"]
    profile_windows({
        "fused_int16_2": lambda: fir_periodogram4096(
            x, G, precision="int16", fir_passes=2),
        "composed": lambda: periodogram4096_acc(
            fir.step(fir.init_for(x), x)[1]),
    }, out_dir)


def profile_windows(windows: dict, out_dir: str, calls: int = 5) -> None:
    """torch.profiler over ``calls`` back-to-back calls of each window
    after a warm-up; prints device busy time, idle share and top kernels."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    os.makedirs(out_dir, exist_ok=True)
    for name, fn in windows.items():
        fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        path = os.path.join(out_dir, f"trace_{name}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            ev = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if not ev:
            raise AssertionError(f"profile {name}: no device activity traced")
        busy, end, by_name = 0.0, -1.0, {}
        for e in sorted(ev, key=lambda e: e["ts"]):
            t0, t1 = e["ts"], e["ts"] + e["dur"]
            busy += max(0.0, t1 - max(t0, end))
            end = max(end, t1)
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        span = end - min(e["ts"] for e in ev)
        print(f"profile {name}: {calls} calls, device busy "
              f"{busy / 1e3:.3f} ms of "
              f"{span / 1e3:.3f} ms span, idle {100 * (1 - busy / span):.2f} %"
              f" ({path})")
        for n, d in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"profile {name}:   {d / 1e3:9.3f} ms "
                  f"{100 * d / busy:5.1f} %  {n[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the fused and composed main path "
                         "and one step of each QAM engine; chrome traces go "
                         "into DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from libtsd_tpu_torch.ops import kernels
    from libtsd_tpu_torch.ops.fir_design import fir_lowpass
    from libtsd_tpu_torch.ops.filter_rt import fir_toeplitz_mats
    from libtsd_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda", 0)
    card = device_info()
    t0 = time.perf_counter()
    path = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({path.name})")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    h = fir_lowpass(256, 0.2)
    G = torch.as_tensor(fir_toeplitz_mats(np.asarray(h, np.float64))
                        .astype(np.float32), device=dev)
    errs = kernel_checks(h, G, gen, dev)
    torch.cuda.empty_cache()

    kernels.reset_launches()
    mp = main_path(h, gen, dev)
    launches = {k: v for k, v in kernels.launches().items()
                if k in PATH_KERNELS["main"]}
    for k, d in main_path_checks(mp).items():
        errs[k] = max(errs[k], d)
    t = timings(h, mp, dev)
    extra = main_bounds_and_library(h, mp, dev)
    if args.profile:
        profile(mp, args.profile)
    del mp
    torch.cuda.empty_cache()

    # the QAM-16 receive path (kernels #5 and #6)
    wf, bits, xq = qam_signal(gen, dev)
    kernels.reset_launches()
    qp = qam_path(wf, xq, dev)
    launches.update({k: v for k, v in kernels.launches().items()
                     if k in PATH_KERNELS["qam"]})
    errs.update(qam_checks(wf, bits, xq, qp))
    tq = qam_timings(xq, qp)
    if args.profile:
        xb = xq[:, :N_QAM]
        profile_windows({
            f"qam_{eng}": (lambda r=r: r["dd"].step(r["states"][0], xb))
            for eng, r in qp.items()}, args.profile, calls=3)

    print("launches (each path): " + json.dumps(launches))
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"a path launched no {missing}")
    headline = {"fir_periodogram4096": "fir_periodogram4096 int16/2"}
    rows = []
    for name, (src, rep) in KERNELS.items():
        if name in tq:
            k, p, bms, by, lib, _, _ = tq[name]
        else:
            k, p, _ = t[headline.get(name, name)]
            bms, by, lib = extra[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": k, "plain_ms": p,
                     "bound_ms": bms, "bound_by": by, "library_ms": lib})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": rows, "max_abs_err": errs,
                       "timings_ms": {n: {"kernel": k, "plain": p,
                                          "samples": s}
                                      for n, (k, p, s) in t.items()},
                       "qam_step": {n: {"step_ms": v[5],
                                        "msamples_per_s": v[6]}
                                    for n, v in tq.items()}},
                      f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
