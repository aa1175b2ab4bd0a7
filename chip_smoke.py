#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json] [--profile DIR]

Builds the port's four CUDA kernels from ``libtsd_tpu_torch/csrc`` into
``build/libtsd_tpu_torch/``, checks each kernel against its plain PyTorch
version on the card, drives the main path at full size (256 channels x
2^22 int16 samples: 256-tap lowpass FIR -> 4096-point periodogram, fused,
composed and streamed, plus a Welch PSD), times every kernel beside its
plain version with CUDA events, and checks that the main path launched
every kernel.  Any failure raises and exits non-zero.  Without a CUDA
device it exits 1 and prints no result.  ``--profile DIR`` adds a
``torch.profiler`` window over the fused and the composed main path
(device busy time, idle share, top kernels; chrome traces into DIR).

Output, in order: versions and the card (``nvidia-smi`` name, power
limit), build time, one line per check with its tolerance, timings in
Msamples/s, launch counts, a ``{"kernels": [...]}`` JSON line, and as the
last line ``{"ok": true, "device": {...}}``.
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

KERNELS = {   # wrapper name -> (source, the Pallas call it replaces)
    "fir": ("libtsd_tpu_torch/csrc/fir.cu",
            "libtsd_tpu/ops/pallas/fir.py:82"),
    "periodogram4096": ("libtsd_tpu_torch/csrc/periodogram.cu",
                        "libtsd_tpu/ops/pallas/periodogram.py:143"),
    "fir_periodogram4096": ("libtsd_tpu_torch/csrc/chain.cu",
                            "libtsd_tpu/ops/pallas/chain.py:337"),
    "fft_pow2": ("libtsd_tpu_torch/csrc/fft.cu",
                 "libtsd_tpu/ops/pallas/fft.py:152"),
}


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


def profile(mp, out_dir: str) -> None:
    """Optional phase: torch.profiler over 5 back-to-back calls of the
    fused int16/2 chain and of the composed path (Fir.step -> #2), after a
    warm-up, at the main path's shapes.  Prints, per window, the device's
    busy time (union of kernel, copy and fill intervals), its idle share of
    the span from the first to the last device interval, and the kernels
    that take most of the busy time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from libtsd_tpu_torch.ops.kernels.chain import fir_periodogram4096
    from libtsd_tpu_torch.ops.kernels.periodogram import periodogram4096_acc
    x, G, fir = mp["x"], mp["G"], mp["fir"]
    windows = {
        "fused_int16_2": lambda: fir_periodogram4096(
            x, G, precision="int16", fir_passes=2),
        "composed": lambda: periodogram4096_acc(
            fir.step(fir.init_for(x), x)[1]),
    }
    os.makedirs(out_dir, exist_ok=True)
    for name, fn in windows.items():
        fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
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
        print(f"profile {name}: 5 calls, device busy {busy / 1e3:.3f} ms of "
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
                    help="also profile the fused and composed main path; "
                         "chrome traces go into DIR")
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
    launches = kernels.launches()
    for k, d in main_path_checks(mp).items():
        errs[k] = max(errs[k], d)
    t = timings(h, mp, dev)
    if args.profile:
        profile(mp, args.profile)
    print("launches (main path): " + json.dumps(launches))
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    headline = {"fir_periodogram4096": "fir_periodogram4096 int16/2"}
    rows = []
    for name, (src, rep) in KERNELS.items():
        k, p, _ = t[headline.get(name, name)]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": k, "plain_ms": p})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": rows, "max_abs_err": errs,
                       "timings_ms": {n: {"kernel": k, "plain": p,
                                          "samples": s}
                                      for n, (k, p, s) in t.items()}},
                      f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
