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
  sampled channels, each kernel against its plain version;
* the frame receiver: 64 channels of QPSK frames (RRC 0.25, osf 4, a
  64-bit header, distinct 256-bit payloads, one frame every 8,000 samples
  so that frames straddle block edges) made on the card by the port's
  ``Transmitter``, received by ``Receiver`` over 4 blocks with the state
  carried, on the ``"cuda"`` engine (kernel #9, overlap-save correlation)
  and the ``"cuda-fused"`` engine (kernel #10, fused detector front end):
  every frame found once at its position with 0 bit errors, every
  detection against the normalised correlation recomputed from the
  stream, both engines' detections those of the ``"torch"`` engine, each
  kernel against its plain version; then ``StreamReceiver``
  (chunked pushes, checkpoint/restore) and ``StreamRunner`` over the
  ``"cuda"`` OLA engine on channel 0.

Every kernel is timed beside its plain version (CUDA events, median of 5
after a warm-up), beside the least time the card could take for the same
work and, where one PyTorch call computes the same function, that call's
time.  Each path runs with the launch counts set to 0 just before it and
read just after; a kernel of a path that was not launched fails the run.
Any failure raises and exits non-zero.  Without a CUDA device it exits 1
and prints no result.  ``--profile DIR`` adds ``torch.profiler`` windows
over the fused and composed main path and over one step of each QAM
engine and of each frame-receiver engine (device busy time, idle share,
top kernels; chrome traces into DIR).

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

# the frame receiver (benchmarks/tpu_frame_bench.py:28-35,142-143 at C = 64)
C_FRM, BLOCKS_FRM = 64, 4
N_FRM = {"cuda": 33 * 3968, "cuda-fused": 131072}  # block: multiples of Ne
THRESHOLD_FRM = 0.5    # the detector's threshold
SPACING_FRM = 8000     # one frame every SPACING_FRM samples
PAYLOAD_FRM = 256      # payload bits per frame
FRM_NOISE = 0.02       # noise std per real dimension (tpu_frame_bench.py:48)
CHUNK_FRM = 10007      # StreamReceiver / StreamRunner push size
# kernel vs plain: #9 max |dy| / max |y| (the JAX gate, tests/test_pallas.py:
# 148,224); #10 cr/ci/en to TOL_PLANE of their peak, score max |d| TOL_SCORE
TOL_OLA = 1e-5
TOL_PLANE = 1e-5
TOL_SCORE = 1e-4
# every detection against the normalised correlation recomputed in float64
# from the stream at its position: the score gate of tests/test_detfront.py:
# 36-42, and a local maximum within that slack
TOL_DET = 5e-4

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
    "ola": ("libtsd_tpu_torch/csrc/ola.cu",
            "libtsd_tpu/ops/pallas/ola.py:220"),
    "detfront": ("libtsd_tpu_torch/csrc/detfront.cu",
                 "libtsd_tpu/ops/pallas/detfront.py:132"),
}
PATH_KERNELS = {"main": ("fir", "periodogram4096", "fir_periodogram4096",
                         "fft_pow2"),
                "qam": ("demod_sb", "demod_sb_fused"),
                "frame": ("ola", "detfront")}


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


# ------------------------------------------------------- frame receiver


def frame_signal(gen, dev) -> dict:
    """C_FRM channels of BLOCKS_FRM * 131072 samples, made on the card:
    frames of the port's Transmitter (QPSK, RRC 0.25, fe 4, fsymb 1, a
    seeded 64-bit header, a distinct random payload per frame) every
    SPACING_FRM samples from a per-channel start, times a per-channel gain
    in [0.8, 1.2] and carrier phase, plus noise FRM_NOISE per dimension.
    Only frames that end well before the shorter ("cuda") stream's end are
    inserted, so that both engines see every one of them complete."""
    from libtsd_tpu_torch.models import waveform as W
    from libtsd_tpu_torch.models.bitstream import randbits
    from libtsd_tpu_torch.models.frame import FrameFormat, Transmitter
    from libtsd_tpu_torch.models.modulator import ModConfig
    wf = W.wf_qpsk(W.PulseShape.rcs(0.25), device=dev)
    hdr = tuple(int(b) for b in randbits(gen, 64).tolist())
    fmt = FrameFormat(modulation=ModConfig(wf=wf, fe=4.0, fsymb=1.0),
                      header_bits=hdr, payload_bits=PAYLOAD_FRM)
    tx = Transmitter.create(fmt, device=dev)
    total = BLOCKS_FRM * max(N_FRM.values())
    last = BLOCKS_FRM * min(N_FRM.values()) - 3000
    start = 100 + (torch.arange(C_FRM, device=dev) * 997) % SPACING_FRM
    nfr = (last - 100 - SPACING_FRM) // SPACING_FRM + 1
    pos = start[:, None] + SPACING_FRM * torch.arange(nfr, device=dev)
    bits = randbits(gen, C_FRM * nfr * PAYLOAD_FRM).reshape(
        C_FRM, nfr, PAYLOAD_FRM)
    frames = tx.transmit(bits.reshape(-1, PAYLOAD_FRM)).reshape(
        C_FRM, nfr, -1)
    L = frames.shape[-1]
    gain = 0.8 + 0.4 * torch.rand(C_FRM, generator=gen, device=dev)
    phase = 2 * np.pi * torch.rand(C_FRM, generator=gen, device=dev)
    rot = (gain * torch.exp(1j * phase)).to(torch.complex64)
    w = torch.randn(2, C_FRM, total, generator=gen, device=dev) * FRM_NOISE
    x = torch.complex(w[0], w[1])
    rows = torch.arange(C_FRM, device=dev)[:, None]
    for k in range(nfr):
        cols = pos[:, k, None] + torch.arange(L, device=dev)
        x[rows, cols] += rot[:, None] * frames[:, k]
    torch.cuda.synchronize()
    print(f"frame signal: {C_FRM} x {total} samples, {nfr} frames a channel "
          f"of {L} samples, spacing {SPACING_FRM}, frame bits "
          f"{64 + PAYLOAD_FRM}")
    return dict(fmt=fmt, x=x, pos=pos, bits=bits, L=L)


def frame_receivers(fmt, dev) -> dict:
    from libtsd_tpu_torch.models.detector import DetectorConfig
    from libtsd_tpu_torch.models.frame import Receiver
    return {eng: Receiver.create(
        fmt, DetectorConfig(threshold=THRESHOLD_FRM, max_peaks=17,
                            engine=eng),
        pll_stride=8, device=dev) for eng in ("torch", "cuda", "cuda-fused")}


def frame_block(eng: str, rx) -> int:
    """The block length of an engine: N_FRM, or for "torch" the most whole
    hops of its own Ne in N_FRM["cuda-fused"]."""
    return N_FRM.get(eng, N_FRM["cuda-fused"] // rx.det.Ne * rx.det.Ne)


def frame_path(rxs, x) -> dict:
    """The frame receiver as a user drives it: Receiver.step over
    BLOCKS_FRM blocks of C_FRM channels with the state carried, on each
    engine (the "torch" engine launches neither kernel: its detections are
    the reference of the kernel engines'); keeps the state before each
    block and each block's frames."""
    out = {}
    for eng, rx in rxs.items():
        n = frame_block(eng, rx)
        st = rx.init_for(x[:, :n])
        states, frames = [], []
        for b in range(BLOCKS_FRM):
            states.append(st)
            st, fr = rx.step(st, x[:, b * n:(b + 1) * n])
            frames.append(fr)
        out[eng] = dict(rx=rx, states=states, frames=frames, n=n)
    torch.cuda.synchronize()
    return out


def _found(rx, frames, n) -> list:
    """Per channel, the valid frames of every block as (stream position of
    the header, payload bits, detection score) in time order, on the
    host."""
    from libtsd_tpu_torch.models.frame import _pull_tree
    res = [[] for _ in range(C_FRM)]
    for b, fr in enumerate(frames):
        h = _pull_tree(fr)
        for c, i in zip(*np.nonzero(h.valid)):
            res[c].append((int(h.detection.position[c, i]) + b * n,
                           h.bits[c, i], float(h.detection.score[c, i])))
    return [sorted(r, key=lambda t: t[0]) for r in res]


def _direct_scores(x, taps, got) -> tuple[float, float, int]:
    """Every detection's score against the normalised correlation
    |sum_j taps[M-1-j] x[q+j]| / sqrt(sum_j |x[q+j]|^2) recomputed in
    float64 from the stream at its start q and at q -+ 1, apart from the
    detector's code.  Returns (max |score - direct|, the largest amount by
    which a neighbour's direct score beats the detection's, and how many
    direct scores lie at or under the threshold's gate)."""
    M = taps.shape[0]
    w = taps.flip(0).to(torch.complex128)
    ch = torch.tensor([c for c in range(C_FRM) for _ in got[c]],
                      device=x.device)
    q = torch.tensor([g[0] for c in range(C_FRM) for g in got[c]],
                     device=x.device)
    sc = torch.tensor([g[2] for c in range(C_FRM) for g in got[c]],
                      device=x.device, dtype=torch.float64)
    s = []
    for o in (-1, 0, 1):
        idx = (q + o)[:, None] + torch.arange(M, device=x.device)
        win = x[ch[:, None], idx.clamp(0, x.shape[-1] - 1)].to(
            torch.complex128)
        s.append(((win * w).sum(-1).abs()
                  / (win.abs() ** 2).sum(-1).sqrt()).clamp(max=1.0))
    d = (sc - s[1]).abs().max().item()
    beat = (torch.maximum(s[0], s[2]) - s[1]).max().item()
    return d, beat, int((s[1] <= THRESHOLD_FRM - TOL_DET).sum())


def frame_checks(sig, fp):
    """Every inserted frame found exactly once on every channel, at its
    position (+-1 sample) with 0 payload bit errors, on each engine; every
    detection, those inside a frame but off its header included, a local
    maximum over the threshold of the normalised correlation recomputed
    from the stream; the kernel engines' detections (positions, bits)
    those of the "torch" engine; each kernel against its plain version on
    the step's own inputs (blocks 0 and 2, full width).  Returns the
    largest absolute error of each kernel against its plain version, and
    each engine's frames per channel."""
    from libtsd_tpu_torch.ops.kernels import detfront as DF, ola
    pos = sig["pos"].cpu().numpy()
    bits = sig["bits"].cpu().numpy()
    found = {}
    for eng, r in fp.items():
        rx = r["rx"]
        d = int(round(rx.mod_delay))     # the header starts d samples in
        got = _found(rx, r["frames"], r["n"])
        missed = extra = stray = berr = nbits = 0
        for c in range(C_FRM):
            p = np.array([g[0] for g in got[c]], np.int64)
            want = pos[c] + d
            near = np.abs(p[:, None] - want[None, :]) <= 1
            # a detection near no header: inside a frame it is a sidelobe
            # of the header on that frame's random payload; outside every
            # frame it is a detection in noise
            far = p[~near.any(1)]
            inside = ((far[:, None] >= pos[c][None, :])
                      & (far[:, None] < pos[c][None, :] + sig["L"])).any(1)
            extra += len(far)
            stray += int((~inside).sum())
            for k in range(len(want)):
                j = np.nonzero(near[:, k])[0]
                if len(j) != 1:
                    missed += 1
                    continue
                berr += int((got[c][j[0]][1] != bits[c, k]).sum())
                nbits += bits.shape[-1]
        taps = fp["cuda-fused"]["rx"].det.corr.taps[:rx.det.M]
        dsc, beat, low = _direct_scores(sig["x"], taps, got)
        ok = (missed == 0 and stray == 0 and berr == 0 and dsc < TOL_DET
              and beat < TOL_DET and low == 0)
        print(f"check frame {eng}: {C_FRM * pos.shape[1]} frames inserted, "
              f"{missed} not found once at +-1 sample, {berr} bit errors in "
              f"{nbits} payload bits; {extra} more detections, all inside "
              f"frames (header sidelobes on random payloads), {stray} "
              f"outside; every detection vs the float64 normalised "
              f"correlation at its position: max|dscore| {dsc:.3e}, a "
              f"neighbour above it by {beat:.3e} at most, tol {TOL_DET:g}, "
              f"{low} at or under the threshold; {BLOCKS_FRM} blocks of "
              f"{r['n']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"frame {eng}: frames or bits")
        found[eng] = got
    a = found["torch"]
    for eng in ("cuda", "cuda-fused"):
        b = found[eng]
        same = all(len(a[c]) == len(b[c]) and all(
            pa == pb and np.array_equal(ba, bb)
            for (pa, ba, _), (pb, bb, _) in zip(a[c], b[c]))
            for c in range(C_FRM))
        print(f"check frame {eng} vs torch: the same detections (positions, "
              f"bits) on every channel, {sum(map(len, b))} and "
              f"{sum(map(len, a))} {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"frame engine {eng} disagrees with torch")
    x = sig["x"]
    err = {"ola": 0.0, "detfront": 0.0}
    for b in (0, 2):
        r = fp["cuda"]
        n, corr = r["n"], r["rx"].det.corr
        xb = x[:, b * n:(b + 1) * n]
        st = r["states"][b]["det"]["corr"]
        yk, _ = ola.ola_stream(xb, st, corr.H, corr.M, corr.Nf)
        yp, _ = ola.ola_stream_plain(xb, st, corr.H, corr.M, corr.Nf)
        err["ola"] = max(err["ola"], check(
            f"frame ola (#9) vs plain, {C_FRM} x {n} block {b}",
            torch.view_as_real(yk), torch.view_as_real(yp), TOL_OLA))
        r = fp["cuda-fused"]
        n, fr = r["n"], r["rx"].det.corr
        xb = x[:, b * n:(b + 1) * n]
        st = r["states"][b]["det"]["corr"]
        k = DF.detfront(xb, st, fr.taps, fr.M)
        p = DF.detfront_plain(xb, st, fr.taps, fr.M)
        for name, a_, b_ in zip(("cr", "ci", "en"), k, p):
            err["detfront"] = max(err["detfront"], check(
                f"frame detfront (#10) {name} vs plain, {C_FRM} x {n} "
                f"block {b}", a_, b_, TOL_PLANE))
        ds = (k[3] - p[3]).abs().max().item()
        ok = bool(torch.isfinite(k[3]).all()) and ds < TOL_SCORE
        print(f"check frame detfront (#10) score vs plain, block {b}: "
              f"max_abs_err={ds:.6e} tol={TOL_SCORE:g} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("detfront score vs plain")
        err["detfront"] = max(err["detfront"], ds)
        del k, p, yk, yp
        torch.cuda.empty_cache()
    return err, found


def frame_serving(sig, rxs, found_ch0, tmp: str) -> None:
    """StreamReceiver on channel 0 ("cuda-fused") fed CHUNK_FRM-sample
    pushes, then flush: it gives channel 0's frames; a checkpoint halfway,
    restored into a fresh StreamReceiver, gives the rest bit-identically.
    StreamRunner over OlaFft(engine="cuda") on the same stream equals
    one-shot filtering."""
    from libtsd_tpu_torch.io.runner import StreamRunner
    from libtsd_tpu_torch.models.frame import StreamReceiver
    from libtsd_tpu_torch.ops.filter_rt import OlaFft
    from libtsd_tpu_torch.ops.kernels import ola
    rx = rxs["cuda-fused"]
    n_stream = BLOCKS_FRM * N_FRM["cuda-fused"]
    x0 = sig["x"][0, :n_stream].cpu().numpy()

    def key(frames):
        return [(int(f.detection.position), f.bits.tobytes(),
                 float(f.EbN0_db)) for f in frames]

    ref = StreamReceiver(rx, block_len=N_FRM["cuda-fused"])
    for off in range(0, n_stream, CHUNK_FRM):
        ref.push(x0[off:off + CHUNK_FRM])
    ref.flush()
    got = []
    a = StreamReceiver(rx, block_len=N_FRM["cuda-fused"], callback=got.append)
    cut = (n_stream // 2 // CHUNK_FRM) * CHUNK_FRM
    for off in range(0, cut, CHUNK_FRM):
        a.push(x0[off:off + CHUNK_FRM])
    ck = os.path.join(tmp, "stream_receiver.npz")
    a.checkpoint(ck)
    b = StreamReceiver(rx, block_len=N_FRM["cuda-fused"], callback=got.append)
    b.restore(ck)
    for off in range(cut, n_stream, CHUNK_FRM):
        b.push(x0[off:off + CHUNK_FRM])
    b.flush()
    want_bits = [g[1].tobytes() for g in found_ch0]
    ok1 = [f.bits.tobytes() for f in ref.frames] == want_bits
    ok2 = key(got) == key(ref.frames)
    print(f"check frame StreamReceiver ch 0, pushes of {CHUNK_FRM}: "
          f"{len(ref.frames)} frames, the receiver's {len(found_ch0)} "
          f"{'ok' if ok1 else 'FAIL'}; checkpoint at {cut} + restore: "
          f"{len(got)} frames bit-identical {'ok' if ok2 else 'FAIL'}")
    if not (ok1 and ok2):
        raise AssertionError("StreamReceiver")
    # the detector's correlation taps (conj of the reversed header)
    h = rx.det.corr.taps[:rx.det.M].cpu().numpy()
    blk = OlaFft.create(h, engine="cuda", device=sig["x"].device)
    run = StreamRunner(blk, block_len=8 * blk.Ne)
    y = run.run([x0[off:off + CHUNK_FRM]
                 for off in range(0, n_stream, CHUNK_FRM)], flush=True)
    x0d = sig["x"][0, :n_stream]
    one = ola.ola_filter(x0d, h).cpu().numpy()
    plain = ola.ola_filter(x0d.cpu(), h).numpy()
    y = y[:n_stream]
    r1 = np.abs(y - one).max() / np.abs(one).max()
    r2 = np.abs(y - plain).max() / np.abs(plain).max()
    ok = r1 < TOL_OLA and r2 < TOL_OLA
    print(f"check frame StreamRunner(OlaFft cuda) ch 0, pushes of "
          f"{CHUNK_FRM}: vs one-shot ola_filter rel_err={r1:.3e} (bit-equal "
          f"{np.array_equal(y, one)}), vs its plain version rel_err="
          f"{r2:.3e}, tol={TOL_OLA:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("StreamRunner over OlaFft")


def frame_timings(sig, rxs, fp):
    """One Receiver.step at C_FRM on each engine, each kernel alone and its
    plain version on block 0 (CUDA events, median of 5 after a warm-up),
    and each kernel's bound.  #9: 16 bytes a sample (x in, y out) plus the
    state and H; per window two Nf-point FFTs (5 Nf log2 Nf each) and the
    product (6 Nf).  #10: 8 bytes a sample in and 16 out (four planes)
    plus the state and taps; its least work computes the correlation as #9
    does, by overlap-save at the detector's own plan (Nf, Ne of ola_plan(M)),
    and the window energy as a running sum: (10 Nf log2 Nf + 6 Nf) / Ne
    flop a sample, 3 for |x|^2, 2 for the running sum and 6 for the
    score."""
    from libtsd_tpu_torch.models.frame import MonitoredReceiver
    from libtsd_tpu_torch.ops.kernels import detfront as DF, ola
    x = sig["x"]
    out, steps = {}, {}
    for eng, rx in rxs.items():
        n = frame_block(eng, rx)
        xb = x[:, :n]
        st = rx.init_for(xb)
        ms = time_ms(lambda: rx.step(st, xb))
        steps[eng] = (ms, C_FRM * n / ms / 1e3, n)
        # the receiver's own stage monitors (host clock, each stage ends in
        # a device synchronisation): detection front end vs extraction
        mr = MonitoredReceiver(rx)
        for _ in range(4):
            mr.step(st, xb)
        stats = mr.moniteurs()
        print(f"time frame step {eng}: {ms:.4f} ms ({C_FRM * n / ms / 1e3:.1f}"
              f" Msamples/s aggregate, {C_FRM} x {n}); stages (host clock, "
              f"mean of 4 synchronised steps): front end "
              f"{1e3 * stats['recepteur/ola'].mean_s:.3f} ms, extraction "
              f"{1e3 * stats['recepteur/demod'].mean_s:.3f} ms")
    r = fp["cuda"]
    n, corr = r["n"], r["rx"].det.corr
    xb, st = x[:, :n].contiguous(), r["states"][0]["det"]["corr"]
    args = (xb, st, corr.H, corr.M, corr.Nf)
    ms_k = time_ms(lambda: ola.ola_stream(*args))
    ms_p = time_ms(lambda: ola.ola_stream_plain(*args))
    nwin = C_FRM * n // corr.Ne
    bms, by = bound(16 * C_FRM * n + 8 * st.numel() + 8 * corr.Nf,
                    nwin * (2 * fft_flops(corr.Nf) + 6 * corr.Nf))
    out["ola"] = (ms_k, ms_p, bms, by, None)
    print(f"time frame ola (#9): kernel {ms_k:.4f} ms, plain (cuFFT route) "
          f"{ms_p:.4f} ms, bound {bms:.4f} ms by {by}; library call none")
    r = fp["cuda-fused"]
    n, fr = r["n"], r["rx"].det.corr
    xb, st = x[:, :n].contiguous(), r["states"][0]["det"]["corr"]
    ms_k = time_ms(lambda: DF.detfront(xb, st, fr.taps, fr.M))
    ms_p = time_ms(lambda: DF.detfront_plain(xb, st, fr.taps, fr.M))
    nf, ne, _ = ola.ola_plan(fr.M)
    bms, by = bound(24 * C_FRM * n + 8 * st.numel() + 8 * fr.taps.numel(),
                    C_FRM * n * ((2 * fft_flops(nf) + 6 * nf) / ne + 11))
    out["detfront"] = (ms_k, ms_p, bms, by, None)
    print(f"time frame detfront (#10): kernel {ms_k:.4f} ms, plain "
          f"{ms_p:.4f} ms, bound {bms:.4f} ms by {by}; library call none")
    return out, steps


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
                         "and one step of each QAM and frame-receiver "
                         "engine; chrome traces go into DIR")
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

    del xq, qp
    torch.cuda.empty_cache()

    # the frame receiver (kernels #9 and #10)
    sig = frame_signal(gen, dev)
    rxs = frame_receivers(sig["fmt"], dev)
    kernels.reset_launches()
    fp = frame_path(rxs, sig["x"])
    launches.update({k: v for k, v in kernels.launches().items()
                     if k in PATH_KERNELS["frame"]})
    ferr, found = frame_checks(sig, fp)
    errs.update(ferr)
    tmp = _build.BUILD_DIR.parent / "chip_smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    frame_serving(sig, rxs, found["cuda-fused"][0], str(tmp))
    tf, fsteps = frame_timings(sig, rxs, fp)
    tq.update(tf)
    if args.profile:
        windows = {}
        for eng, rx in rxs.items():
            n = fsteps[eng][2]
            windows[f"frame_{eng}"] = (
                lambda rx=rx, xb=sig["x"][:, :n]: rx.step(rx.init_for(xb),
                                                          xb))
        profile_windows(windows, args.profile, calls=1)

    print("launches (each path): " + json.dumps(launches))
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"a path launched no {missing}")
    headline = {"fir_periodogram4096": "fir_periodogram4096 int16/2"}
    rows = []
    for name, (src, rep) in KERNELS.items():
        if name in tq:
            k, p, bms, by, lib = tq[name][:5]
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
                                    for n, v in tq.items() if len(v) > 5},
                       "frame_step": {e: {"step_ms": v[0],
                                          "msamples_per_s": v[1],
                                          "channels": C_FRM, "n": v[2]}
                                      for e, v in fsteps.items()}},
                      f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
