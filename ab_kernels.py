#!/usr/bin/env python3
"""Time kernels #1-#11 of other trees of the port against this tree's.

    python3 ab_kernels.py [--stages] [--only GROUPS] DIR [DIR ...]

Each DIR holds another tree's ``libtsd_tpu_torch/`` (for example
``git archive <commit> libtsd_tpu_torch | tar -x -C DIR``), which is built
by its own ``_build`` from its own ``csrc/`` into DIR/build/.  For each DIR
in turn, at the paths' shapes: #5 and #6 on the first 8192-sample block
of the QAM path (4096 channels, QAM-16, osf 4, S 16; through each tree's
own wrapper, the two trees' results bit for bit alike and this tree's
bit for bit its plain version's), #7 on 64 x 2^18 float32 samples (an
order-4 Butterworth lowpass as 2 sections; alike bit for bit, 1e-5 of the
peak against plain), #8 on the FM path's 256 x 2^18 complex samples (R 4,
63 taps; the two trees within 1e-5 of each other and each within 1e-5 of
this tree's plain version, max |error|), #3 on 256 x 2^22 samples at every tier (int16/2 and
/3; split/2, /3 and "highest" on the int16 samples as float32; bf16 on
them as bfloat16; int8 on int8 samples), #11 on the int16 samples cut
into 2 rows of 4 time shards (8 virtual shards of the card, int16/2; each
row's launches in time order, one call the 8 launches), #2 on a random
256 x 2^22 float32 input and on its first channel, #4 on 8188 x 4096
planes (the main path's Welch call), #9 and #10 at the frame receiver's
shapes through each tree's own wrapper (#9 on 64 x 130,944 complex
samples, 33 windows of Nf 4096 at 128 complex taps, and at Nf 8192 and
16384 on 16 and 8 windows; #10 on 64 x 131,072 at M = 128; each held to
this tree's plain version: #9 1e-5 of the peak, #10's planes 1e-5 of
their peak and its score 1e-4 absolute), #1 on 2^22 float32 samples at
K = 256 (the main path's lowpass), 3 and 600 (random taps), each tree's
C entry called as its own signature says, then at K = 256 through each
tree's wrapper (both held to this tree's plain version, 1e-4 of the
peak, and this tree to a float64 FIR, 1e-5), and the SASS of #3, #10
and #11 (their sources compiled alone, ``cuobjdump -sass``) compared
kernel by kernel, line for line.  --only takes a comma list of the
groups "sb" (#5, #6), "iir" (#7), "fm" (#8), "chain" (#3, #11), "fft"
(#2, #4), "frame" (#9, #10) and "fir" (#1); all by default.  Each pair
is timed other, this, this, other with ``chip_smoke.time_ms``; #2-#4 and #11
are held to this tree's plain version (1e-4 of the peak; the spectra also
1e-3 per bin).  --stages also builds this tree's kernels with
-DCHAIN_FIR_ONLY (the fused chain without its FFT stage, into
build/fir_only/: chain_body.cuh's and chain_wg.cu's bodies alike) and
times #3 whole and FIR-only in turns at every tier, each on the body it
takes (the wgmma body at passes 1-2): the split of the fused call
between its window-and-FIR and its FFT stages.  Needs one CUDA card;
prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import importlib.util
import os
import re
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
NFFT = 4096
GROUPS = ("fft", "chain", "sb", "iir", "fm",    # --only: kernels #2/#4,
          "frame", "fir")                        # #3/#11, #5/#6, #7, #8,
                                                 # #9/#10, #1
FIR_TAPS = (256, 3, 600)                         # #1's tap counts


def _first_port_taps(G, precision, passes):
    """The fused kernels' taps as the first port's wrapper made them: G's
    taps, trailing zeros dropped, bf16-rounded where the tier asks for it,
    zero-padded to kp (``fir.pad_taps``)."""
    from libtsd_tpu_torch.ops.kernels import chain, fir
    taps = chain.taps_from_G(G)
    nz = torch.nonzero(taps)
    taps = taps[:int(nz[-1, 0]) + 1 if nz.numel() else 1]
    if chain._round_taps(precision, passes):
        taps = taps.to(torch.bfloat16).to(torch.float32)
    return fir.pad_taps(taps)


def chain_callers(ob, olib, dev):
    """The other tree's #3 and #11 called as its own ``SIGNATURES`` say:
    the first port's forms (fp32 FIR, taps padded to kp, frames per block
    from its ``_build``; #3: x, hist, taps, out, dtype, N, C, kp, hist_len,
    hist_stride, frames per block, stream) or this tree's (taps from
    ``chain.kernel_taps``, the twiddle table, the pass count).  #11 runs a
    row of time shards with its own receive slots and flags, launched in
    time order, as ``chain_halo`` does on one card."""
    from libtsd_tpu_torch.ops.kernels import _build, chain, fft
    first = len(ob.SIGNATURES["fir_periodogram4096"]) == 12
    # #11's flag wait limit (wait_ns, 10 s), where the tree's entry has it
    wait = ((10 * 10**9,) if len(ob.SIGNATURES["fir_periodogram4096_halo"])
            == 20 else ())
    stream = _build.stream_ptr(dev)
    tw = _build.ptr(fft.twiddles(12, dev))
    null = ctypes.c_void_p(None)

    def taps(G, precision, passes):
        if first:
            tp, kp = _first_port_taps(G, precision, passes)
            return tp, kp, None
        return chain.kernel_taps(G, precision, passes, dev)

    def one(x, G, precision, passes):
        C, N = x.shape
        tp, K, p = taps(G, precision, passes)
        out = torch.zeros(C, NFFT, device=dev)
        code = chain._DTYPE_CODE[x.dtype]
        hs = max(G.shape[0] - 1, 1) * 128
        args = ((_build.ptr(tp), _build.ptr(out), code, N, C, K, 0, hs,
                 ob.frames_per_block(C, N // NFFT, dev)) if first else
                (_build.ptr(tp), tw, _build.ptr(out), code, p, N, C, K, 0,
                 hs))
        _build.check(olib.fir_periodogram4096(_build.ptr(x), _build.ptr(x),
                                              *args, stream), "other #3")
        return out

    slots = {}

    def row(xs, G, precision, passes, key):
        C, N = xs[0].shape
        T, D = len(xs), G.shape[0]
        P = (D - 1) * 128
        if key not in slots:
            slots[key] = [torch.zeros(T, 2, C, P, dtype=xs[0].dtype,
                                      device=dev),
                          torch.zeros(T, 2, C, dtype=torch.int32,
                                      device=dev), 0]
        recv, flags, epoch = slots[key]
        epoch += 1
        slots[key][2] = epoch
        s = epoch & 1
        tp, K, p = taps(G, precision, passes)
        code = chain._DTYPE_CODE[xs[0].dtype]
        outs = []
        for t, x in enumerate(xs):
            out = torch.zeros(C, NFFT, device=dev)
            left = ((_build.ptr(recv[t, s]), _build.ptr(flags[t, s]))
                    if t > 0 else (null, null))
            right = ((_build.ptr(recv[t + 1, s]),
                      _build.ptr(flags[t + 1, s])) if t + 1 < T
                     else (null, null))
            head = (_build.ptr(x), _build.ptr(x), *left, *right,
                    _build.ptr(tp))
            tail = ((_build.ptr(out), code, N, C, K, P, 0, max(P, 128),
                     epoch, ob.frames_per_block(C, N // NFFT, dev))
                    if first else
                    (tw, _build.ptr(out), code, p, N, C, K, P, 0,
                     max(P, 128), *wait, epoch))
            _build.check(olib.fir_periodogram4096_halo(*head, *tail, stream),
                         "other #11")
            outs.append(out)
        return outs

    return one, row


TIERS = (("int16", 2), ("int16", 3), ("split", 2), ("split", 3),
         ("highest", 3), ("bf16", 2), ("int8", 2))


def tier_inputs(x: torch.Tensor, dev: torch.device) -> dict:
    """Each tier's samples in its ingest dtype, made when asked: the int16
    samples x as they are, as float32 or as bfloat16; int8 samples of
    their own."""
    x8 = torch.randint(-127, 128, x.shape, device=dev, dtype=torch.int8,
                       generator=torch.Generator(device=dev).manual_seed(1))
    return {"int16": lambda: x, "int8": lambda: x8,
            "bf16": lambda: x.to(torch.bfloat16),
            "split": lambda: x.float(), "highest": lambda: x.float()}


def ab_chain(ob, olib, other: str, x: torch.Tensor, G: torch.Tensor,
             dev: torch.device) -> dict:
    """#3 (every tier, on samples of its ingest dtype) and #11 (2 x 4
    virtual shards, int16/2) of the other tree against this tree's, in
    turns."""
    import chip_smoke as cs
    from libtsd_tpu_torch.ops.kernels import chain, chain_halo
    one, row = chain_callers(ob, olib, dev)
    rows = [[c.contiguous() for c in x[r * 128:(r + 1) * 128].chunk(4, 1)]
            for r in range(2)]
    bufs = [chain_halo.HaloBuffers() for _ in rows]

    def halo_this():
        return [o for r, b in zip(rows, bufs) for o in
                chain_halo.fir_periodogram4096_halo(r, G, None, "int16", 2,
                                                    bufs=b)]

    def halo_other():
        return [o for i, r in enumerate(rows) for o in
                row(r, G, "int16", 2, i)]

    res = {}
    ingest = tier_inputs(x, dev)
    for prec, passes in TIERS:
        xin = ingest[prec]()
        name = f"fir_periodogram4096 {prec}/{passes} 256x2^22"
        ref = chain.fir_periodogram4096_plain(xin, G, precision=prec,
                                              fir_passes=passes)
        oth = lambda: one(xin, G, prec, passes)              # noqa: E731
        this = lambda: chain.fir_periodogram4096(            # noqa: E731
            xin, G, precision=prec, fir_passes=passes)
        cs.check(f"ab {name} other tree vs plain", oth(), ref, cs.TOL_F32,
                 per_bin=True)
        cs.check(f"ab {name} this tree vs plain", this(), ref, cs.TOL_F32,
                 per_bin=True)
        del ref
        res[name] = turns(name, other, oth, this)
        del xin
        torch.cuda.empty_cache()
    name = "fir_periodogram4096_halo int16/2 2x4 shards"
    refs = [o for r in rows
            for o in chain_halo.fir_periodogram4096_halo_plain(
                r, G, None, "int16", 2)]
    for who, fn in (("other tree", halo_other), ("this tree", halo_this)):
        for i, (a, b) in enumerate(zip(fn(), refs)):
            cs.check(f"ab {name} {who} shard {i} vs plain", a, b, cs.TOL_F32,
                     per_bin=True)
    del refs
    res[name] = turns(name, other, halo_other, halo_this)
    return res


def turns(name: str, other: str, oth, this) -> dict:
    import chip_smoke as cs
    ts = [cs.time_ms(f) for f in (oth, this, this, oth)]
    print(f"ab {name} [{other}]: other {ts[0]:.4f} ms, this "
          f"{ts[1]:.4f} ms, this {ts[2]:.4f} ms, other {ts[3]:.4f} ms; "
          f"this / other {(ts[1] + ts[2]) / (ts[0] + ts[3]):.3f}")
    torch.cuda.empty_cache()
    return {"other_ms": [ts[0], ts[3]], "this_ms": [ts[1], ts[2]]}


def load_build(path: str, name: str, flags=(), build_dir=None):
    """A fresh instance of the ``_build`` module at ``path`` (another
    tree's, or this tree's with extra nvcc flags into its own build
    directory), and its loaded library."""
    spec = importlib.util.spec_from_file_location(name, path)
    ob = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ob)
    ob.NVCC_FLAGS = ob.NVCC_FLAGS + list(flags)
    if build_dir is not None:
        ob.BUILD_DIR = build_dir
    t0 = time.perf_counter()
    olib = ob.lib()
    print(f"ab: built {name} in {time.perf_counter() - t0:.1f} s")
    return ob, olib


def stages(x: torch.Tensor, G: torch.Tensor, dev: torch.device) -> dict:
    """#3 whole against its FIR-only build (no FFT stage), in turns, at
    every tier."""
    from libtsd_tpu_torch.ops.kernels import _build, chain
    fb, flib = load_build(_build.__file__, "fir_only_build",
                          ["-DCHAIN_FIR_ONLY"],
                          _build.BUILD_DIR.parent / "fir_only")
    one, _ = chain_callers(fb, flib, dev)
    res = {}
    ingest = tier_inputs(x, dev)
    for prec, passes in TIERS:
        xin = ingest[prec]()
        name = f"fir_periodogram4096 {prec}/{passes} 256x2^22"
        res[name] = turns(f"{name} FIR-only (other) vs whole (this)",
                          "fir_only", lambda: one(xin, G, prec, passes),
                          lambda: chain.fir_periodogram4096(
                              xin, G, precision=prec, fir_passes=passes))
        del xin
        torch.cuda.empty_cache()
    return res


def ab_tree(other: str, y: torch.Tensor, x: torch.Tensor, G: torch.Tensor,
            dev: torch.device, only=GROUPS, inp=None) -> dict:
    """The groups in ``only`` of the tree at ``other`` against this tree's,
    in turns.  The other tree's C entry points are called as its own
    ``SIGNATURES`` say: #2 and #4 without a twiddle table (#2: y, out, C,
    N, frames per block, stream; #4: xr, xi, yr, yi, B, log2 n, inverse,
    stream), or with one after the output pointers, as this tree's, which
    then gets this tree's table; #3 and #11 as ``chain_callers`` says;
    #5-#10 through the other tree's own wrappers (``other_wrapper``)."""
    import chip_smoke as cs
    from libtsd_tpu_torch.ops.kernels import _build, fft, periodogram
    ob, olib = load_build(os.path.join(other, "libtsd_tpu_torch", "ops",
                                       "kernels", "_build.py"), other)
    stream = _build.stream_ptr(dev)
    tw = _build.ptr(fft.twiddles(12, dev))
    pg_tw = ob.SIGNATURES["periodogram4096_f32"][2] is ob.P
    fft_tw = len(ob.SIGNATURES["fft_pow2_f32"]) == 9

    def other_pg(x):
        out = torch.zeros(x.shape[0], cs.NFFT, device=dev)
        C, N = x.shape
        args = ((tw, C, N) if pg_tw else
                (C, N, ob.frames_per_block(C, N // cs.NFFT, dev)))
        _build.check(olib.periodogram4096_f32(
            _build.ptr(x), _build.ptr(out), *args, stream), "other #2")
        return out

    def other_fft(xr, xi):
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        args = (tw,) if fft_tw else ()
        _build.check(olib.fft_pow2_f32(
            _build.ptr(xr), _build.ptr(xi), _build.ptr(yr), _build.ptr(yi),
            *args, xr.shape[0], 12, 0, stream), "other #4")
        return yr, yi

    res = {}
    if only & {"sb", "iir"}:
        res.update(ab_sb_iir(ob, other, inp, only))
    if "fm" in only:
        res.update(ab_fm(ob, other, inp))
    if "frame" in only:
        res.update(ab_frame(ob, other, inp))
    if "chain" in only:
        res.update(ab_chain(ob, olib, other, x, G, dev))
    if "fir" in only:
        res.update(ab_fir(ob, olib, other, inp, dev))
        if not sass_same(other):
            FAILED.append(f"{other}: #3/#10/#11 SASS differs (time them)")
    if "fft" not in only:
        return res
    nseg = len(range(0, cs.N_MAIN - cs.NFFT, cs.NFFT // 2))
    zr = torch.randn(4 * nseg, cs.NFFT, device=dev)
    zi = torch.randn(4 * nseg, cs.NFFT, device=dev)
    y1 = y[:1]
    cases = {
        "periodogram4096 256x2^22": (
            lambda: other_pg(y), lambda: periodogram.periodogram4096_acc(y),
            lambda: periodogram.periodogram4096_plain(y)),
        "periodogram4096 1x2^22": (
            lambda: other_pg(y1), lambda: periodogram.periodogram4096_acc(y1),
            lambda: periodogram.periodogram4096_plain(y1)),
        "fft_pow2 8188x4096": (
            lambda: other_fft(zr, zi), lambda: fft.fft_pow2(zr, zi),
            lambda: fft.fft_pow2_plain(zr, zi)),
    }

    def cat(r):
        return torch.stack(r) if isinstance(r, tuple) else r

    for name, (oth, this, plain) in cases.items():
        ref = cat(plain())
        cs.check(f"ab {name} other tree vs plain", cat(oth()), ref,
                 cs.TOL_F32)
        cs.check(f"ab {name} this tree vs plain", cat(this()), ref,
                 cs.TOL_F32)
        del ref
        res[name] = turns(name, other, oth, this)
    return res


def other_wrapper(ob, other: str, name: str):
    """The other tree's wrapper module ``ops/kernels/<name>.py``, run with
    the other tree's ``_build`` (its library, its C signatures) and this
    tree's modules around it."""
    path = os.path.join(other, "libtsd_tpu_torch", "ops", "kernels",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"libtsd_tpu_torch.ops.kernels._ab_{name}_{len(_OTHERS)}", path)
    m = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = m
    spec.loader.exec_module(m)
    m._build = ob
    _OTHERS.append(m)
    return m


_OTHERS: list = []
FAILED: list = []      # checks that failed without stopping the timings


def sb_iir_inputs(dev: torch.device) -> dict:
    """#5's and #6's arguments for the first block of the QAM path (4096 x
    8192, QAM-16, osf 4, S 16, as ``chip_smoke.py`` drives it), and #7's
    cascade and input (64 x 2^18 float32, an order-4 Butterworth lowpass
    as 2 sections)."""
    import chip_smoke as cs
    from libtsd_tpu_torch.models.demod_sb import DecisionDemodSB, SBDemodConfig
    gen = torch.Generator(device=dev).manual_seed(3)
    wf, _, xq = cs.qam_signal(gen, dev)
    xb = xq[:, :cs.N_QAM].contiguous()
    del xq
    args = {}
    for eng in ("cuda", "cuda-fused"):
        dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16,
                                                      engine=eng), device=dev)
        args[eng] = cs._kernel_args(eng, dd, dd.init_for(xb), xb)[2]
    ip = cs.iir_phase(gen, dev)
    return dict(sb=args["cuda"], fused=args["cuda-fused"], casc=ip["casc"],
                x=ip["x"])


def ab_sb_iir(ob, other: str, inp: dict, only=GROUPS) -> dict:
    """#6 (4096 x 8192), #5 beside it and #7 (64 x 2^18, 2 sections) of the
    other tree against this tree's, in turns, through each tree's own
    wrapper.  The two trees' results must agree bit for bit (#5 and #6 are
    bit-identical to their plain versions; #7 is held to 1e-5 of the peak
    against its plain version, and each tree's #7 differs from the other
    only by exact zero terms); each is also held to its plain version."""
    import chip_smoke as cs
    from libtsd_tpu_torch.ops.kernels import demod_sb as KSB, iir
    osb, oiir = other_wrapper(ob, other, "demod_sb"), other_wrapper(
        ob, other, "iir")
    casc, x = inp["casc"], inp["x"]
    ops = (casc.T, casc.S, casc.W, casc.M)
    cases = {}
    if "sb" in only:
        *step, plan = inp["fused"]     # each tree's #6 with its own plan
        oplan = osb.FusedStep(plan.C, plan.p, plan.sym, plan.h_mf,
                              plan.rms_ref, plan.k, plan.device)
        cases = {
            "demod_sb_fused 4096x8192": (
                lambda: osb.demod_sb_fused_step(*step, oplan),
                lambda: KSB.demod_sb_fused_step(*step, plan),
                lambda: KSB.demod_sb_fused_step_plain(*step, plan)),
            "demod_sb 4096x8192": (
                lambda: osb.demod_sb(*inp["sb"]),
                lambda: KSB.demod_sb(*inp["sb"]),
                lambda: KSB.demod_sb_plain(*inp["sb"]))}
    if "iir" in only:
        cases["iir_cascade 64x2^18 2 sections"] = (
            lambda: oiir.iir_cascade(x, *ops),
            lambda: iir.iir_cascade(x, *ops),
            lambda: iir.iir_cascade_plain(x, *ops))
    res = {}
    for name, (oth, this, plain) in cases.items():
        a, b, ref = oth(), this(), plain()
        same = all(torch.equal(u, v) for u, v in zip(a, b))
        print(f"check ab {name}: other and this tree bit-identical {same} "
              f"{'ok' if same else 'FAIL'}")
        if not same:
            FAILED.append(f"{other}: {name}: trees differ")
        if name.startswith("iir"):
            cs.check(f"ab {name} this tree vs plain", b[0], ref[0], cs.TOL_IIR)
        else:
            for u, v in zip(b, ref):
                if not torch.equal(u, v):
                    raise AssertionError(f"ab {name}: not plain's bits")
            print(f"check ab {name}: this tree bit-identical to plain ok")
        del a, b, ref
        res[name] = turns(name, other, oth, this)
    return res


def fm_inputs(dev: torch.device) -> dict:
    """#8's planes and chain for the FM path (``chip_smoke.py``'s working
    set: 256 x 2^18 FM tones at channel_freq 0.25, R 4, 63 taps)."""
    import chip_smoke as cs
    from libtsd_tpu_torch.models.receivers import FmReceiverConfig
    from libtsd_tpu_torch.ops.kernels.fm import FmChain
    gen = torch.Generator(device=dev).manual_seed(4)
    cfg = FmReceiverConfig(channel_freq=0.25)
    x, _ = cs.fm_signal(gen, dev, cs.C_FM, cfg.channel_freq)
    fc = FmChain(cfg.channel_freq, cfg.decim, cfg.chan_taps, cfg.deviation,
                 cfg.deemph_fc, device=dev)
    return dict(xr=x.real.contiguous(), xi=x.imag.contiguous(), fc=fc)


def ab_fm(ob, other: str, inp: dict) -> dict:
    """#8 of the other tree against this tree's, in turns, through each
    tree's own wrapper: each within TOL_FM (max |error|) of this tree's
    plain version and of the other tree's result."""
    import chip_smoke as cs
    from libtsd_tpu_torch.ops.kernels import fm
    ofm = other_wrapper(ob, other, "fm")
    fc, xr, xi = inp["fc"], inp["xr"], inp["xi"]
    kw = dict(R=fc.R, f0=fc.f0, dev=fc.dev, b0=fc.b0, c=fc.c, p=fc.p,
              tb=cs.TB_FM)
    name = "fm_chain 256x2^18 R 4 63 taps"
    oth = lambda: ofm.fm_chain(xr, xi, fc.h, **kw)          # noqa: E731
    this = lambda: fm.fm_chain(xr, xi, fc.h, **kw)          # noqa: E731
    a, b, ref = oth(), this(), fm.fm_chain_plain(xr, xi, fc.h, **kw)
    for who, u, v in (("other tree vs plain", a, ref),
                      ("this tree vs plain", b, ref),
                      ("this tree vs other tree", b, a)):
        d = (u - v).abs().max().item()
        ok = d < cs.TOL_FM
        print(f"check ab {name} {who}: max_abs_err={d:.3e} tol "
              f"{cs.TOL_FM:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILED.append(f"{other}: {name}: {who}")
    del a, b, ref
    return {name: turns(name, other, oth, this)}


def frame_inputs(dev: torch.device) -> dict:
    """#9's and #10's arguments at the frame receiver's shapes (random
    complex samples, seeded): #9 at Nf 4096 (33 windows of Ne 3968, the
    "cuda" engine's block), 8192 and 16384 (16 and 8 windows), 64
    channels, 128 complex taps, a random state; #10 on 64 x 131,072 (the
    "cuda-fused" engine's block) with 128 unit-norm complex taps after a
    random state."""
    import chip_smoke as cs
    from libtsd_tpu_torch.ops.kernels import detfront as DF, ola
    gen = torch.Generator(device=dev).manual_seed(5)
    rng = np.random.default_rng(5)

    def cplx(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device=dev),
                             torch.randn(shape, generator=gen, device=dev))

    K = 128
    h = rng.standard_normal(K) + 1j * rng.standard_normal(K)
    h /= np.linalg.norm(h)
    out = {"ola": {}}
    for nf, hops in ((4096, 33), (8192, 16), (16384, 8)):
        Nf, Ne, V = ola.ola_plan(K, nf)
        out["ola"][Nf] = (cplx(cs.C_FRM, hops * Ne), cplx(cs.C_FRM, V),
                          ola.freq_response(h, Nf, dev), K, Nf)
    fr = DF.DetFront.create(h, device=dev)
    out["detfront"] = (cplx(cs.C_FRM, cs.N_FRM["cuda-fused"]),
                       cplx(cs.C_FRM, fr.V), fr.taps, fr.M)
    return out


def ab_frame(ob, other: str, inp: dict) -> dict:
    """#9 (Nf 4096, 8192, 16384) and #10 of the other tree against this
    tree's, in turns, through each tree's own wrapper; each tree's results
    held to this tree's plain version (#9 1e-5 of the peak; #10's planes
    1e-5 of their peak, its score 1e-4 absolute)."""
    import chip_smoke as cs
    from libtsd_tpu_torch.ops.kernels import detfront as DF, ola
    ola_o, df_o = (other_wrapper(ob, other, "ola"),
                   other_wrapper(ob, other, "detfront"))
    res = {}
    for Nf, args in inp["ola"].items():
        name = f"ola {cs.C_FRM}x{args[0].shape[1]} Nf {Nf}"
        ref = torch.view_as_real(ola.ola_stream_plain(*args)[0])
        oth = lambda a=args: ola_o.ola_stream(*a)[0]          # noqa: E731
        this = lambda a=args: ola.ola_stream(*a)[0]           # noqa: E731
        for who, fn in (("other tree", oth), ("this tree", this)):
            cs.check(f"ab {name} {who} vs plain", torch.view_as_real(fn()),
                     ref, cs.TOL_OLA)
        del ref
        res[name] = turns(name, other, oth, this)
    args = inp["detfront"]
    name = f"detfront {cs.C_FRM}x{args[0].shape[1]} M {args[3]}"
    ref = DF.detfront_plain(*args)
    oth = lambda: df_o.detfront(*args)                        # noqa: E731
    this = lambda: DF.detfront(*args)                         # noqa: E731
    for who, fn in (("other tree", oth), ("this tree", this)):
        got = fn()
        for plane, a, b in zip(("cr", "ci", "en"), got, ref):
            cs.check(f"ab {name} {who} {plane} vs plain", a, b, cs.TOL_PLANE)
        d = (got[3] - ref[3]).abs().max().item()
        ok = d < cs.TOL_SCORE
        print(f"check ab {name} {who} score vs plain: max_abs_err={d:.3e} "
              f"tol {cs.TOL_SCORE:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILED.append(f"{other}: {name}: {who} score")
        del got
    del ref
    res[name] = turns(name, other, oth, this)
    return res


def fir_inputs(dev: torch.device) -> dict:
    """#1's input (2^22 float32 samples, seeded) and taps: the main path's
    256-tap lowpass and random taps at K = 3 and 600."""
    from libtsd_tpu_torch.ops.fir_design import fir_lowpass
    gen = torch.Generator(device=dev).manual_seed(6)
    rng = np.random.default_rng(6)
    taps = {K: (np.asarray(fir_lowpass(256, 0.2)) if K == 256
                else rng.standard_normal(K)) for K in FIR_TAPS}
    return {"x": torch.randn(1 << 22, generator=gen, device=dev),
            "fir_taps": taps}


def fir_caller(ob, olib, dev: torch.device):
    """A tree's C entry of #1, called as its own ``SIGNATURES`` say: the
    first port's (taps zero-padded to kp, a multiple of 256, and the
    shared-memory bytes of its window) or this tree's (the K taps)."""
    from libtsd_tpu_torch.ops.kernels import _build, fir
    first = len(ob.SIGNATURES["fir_f32"]) == 7
    stream = _build.stream_ptr(dev)

    def call(h, x):
        t = torch.as_tensor(np.asarray(h, np.float32), device=dev)
        y = torch.empty_like(x)
        if first:
            t, kp = fir.pad_taps(t)
            args = (kp, (2 * kp - 1 + 4096) * 4)
        else:
            args = (t.numel(),)
        return lambda: (_build.check(olib.fir_f32(
            _build.ptr(x), _build.ptr(t), _build.ptr(y), x.numel(), *args,
            stream), "fir_f32"), y)[1]
    return call


def ab_fir(ob, olib, other: str, inp: dict, dev: torch.device) -> dict:
    """#1 of the other tree against this tree's, in turns, at 2^22 samples
    and K = 256, 3 and 600: the C entries alone (launches back to back),
    and at K = 256 each tree's wrapper as a caller has it.  Both held to
    this tree's plain version (1e-4 of the peak) and this tree to a float64
    FIR (1e-5 of the peak)."""
    import chip_smoke as cs
    from libtsd_tpu_torch.ops.kernels import _build, fir
    x = inp["x"]
    oth_call = fir_caller(ob, olib, dev)
    this_call = fir_caller(_build, _build.lib(), dev)
    res = {}
    for K, h in inp["fir_taps"].items():
        name = f"fir 2^22 K {K}"
        oth, this = oth_call(h, x), this_call(h, x)
        ref = fir.fir_plain(h, x)
        cs.check(f"ab {name} other tree vs plain", oth(), ref, cs.TOL_F32)
        cs.check(f"ab {name} this tree vs plain", this(), ref, cs.TOL_F32)
        r64 = torch.as_tensor(np.convolve(x.double().cpu().numpy(),
                                          np.asarray(h, np.float64))
                              [:x.numel()], device=dev)
        cs.check(f"ab {name} this tree vs float64", this(), r64, 1e-5)
        del ref, r64
        res[name] = turns(name, other, oth, this)
    ofir = other_wrapper(ob, other, "fir")
    h = inp["fir_taps"][256]
    name = "fir 2^22 K 256 through the wrappers"
    res[name] = turns(name, other, lambda: ofir.fir_kernel(h, x),
                      lambda: fir.fir_kernel(h, x))
    return res


SASS_SOURCES = ("chain.cu", "chain_wg.cu", "chain_halo.cu", "detfront.cu")


def _sass_functions(lines: list) -> dict:
    """{mangled kernel name: its SASS lines} of ``cuobjdump -sass``."""
    funcs, cur = {}, None
    for ln in lines:
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(ln)
    return funcs


def sass_same(other: str) -> bool:
    """#3's, #11's and #10's SASS (``cuobjdump -sass`` of each source
    compiled alone with this tree's flags) in the other tree and in this
    one, kernel by kernel: True when every kernel both trees have is equal
    line for line (they include chain_body.cuh, whose helpers #1 uses);
    kernels only one tree has are listed."""
    import difflib
    import subprocess
    import tempfile
    from libtsd_tpu_torch.ops.kernels import _build
    nvcc = _build._nvcc()
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                       "-fPIC")]
    same = True
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        for src in SASS_SOURCES:
            funcs = []
            for k, root in enumerate((other, os.path.dirname(
                    os.path.abspath(__file__)))):
                path = os.path.join(root, "libtsd_tpu_torch", "csrc", src)
                if not os.path.exists(path):
                    funcs.append({})
                    continue
                cub = os.path.join(tmp, f"{k}_{src}.cubin")
                subprocess.run([nvcc, *flags, "-cubin", "-o", cub, path],
                               check=True)
                out = subprocess.run([tool, "-sass", cub], check=True,
                                     capture_output=True, text=True).stdout
                # anonymous namespaces are named from the file's path
                funcs.append(_sass_functions(
                    [re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N_", ln)
                     for ln in out.splitlines()
                     if "code for" not in ln and ".cubin" not in ln]))
            for name in sorted(set(funcs[0]) | set(funcs[1])):
                if name not in funcs[0] or name not in funcs[1]:
                    where = "this" if name in funcs[1] else "the other"
                    print(f"check ab sass {src} {name} [{other}]: only in "
                          f"{where} tree")
                    continue
                # instructions without their addresses (and the padding
                # their width sets) and with the cubin's label numbers
                # blanked, so that one inserted instruction or kernel does
                # not shift every line after it
                a, b = ([" ".join(re.sub(r"\.L_x_\d+", ".L_x", re.sub(
                    r"/\*[0-9a-f]{4,}\*/", "", ln)).split())
                         for ln in f[name]] for f in funcs)
                ops = difflib.SequenceMatcher(None, a, b,
                                              autojunk=False).get_opcodes()
                changed = [(a[i1:i2], b[j1:j2]) for tag, i1, i2, j1, j2
                           in ops if tag != "equal"]
                diff = sum(max(len(u), len(v)) for u, v in changed)
                n = sum("/*" in ln for ln in b)
                print(f"check ab sass {src} {name} [{other}]: {n} "
                      f"lines, {diff} differ "
                      f"{'ok' if diff == 0 else 'DIFFERS'}")
                for u, v in changed[:3]:
                    print(f"  other: {' | '.join(u[:3])}\n"
                          f"  this:  {' | '.join(v[:3])}")
                same = same and diff == 0
    return same


def main() -> int:
    argv = sys.argv[1:]
    only = set(GROUPS)
    if "--only" in argv:
        i = argv.index("--only")
        only = set(argv[i + 1].split(","))
        del argv[i:i + 2]
        if not only <= set(GROUPS):
            print(f"--only takes a comma list of {GROUPS}", file=sys.stderr)
            return 1
    args = [a for a in argv if a != "--stages"]
    if not (args or "--stages" in argv) or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 1
    import chip_smoke as cs
    from libtsd_tpu_torch.ops.filter_rt import fir_toeplitz_mats
    from libtsd_tpu_torch.ops.fir_design import fir_lowpass
    from libtsd_tpu_torch.ops.kernels import _build
    dev = torch.device("cuda", 0)
    cs.device_info()
    _build.build()
    gen = torch.Generator(device=dev).manual_seed(0)
    y = x = None
    if only & {"fft", "chain"} or "--stages" in argv:
        y = torch.randn(cs.C_MAIN, cs.N_MAIN, generator=gen, device=dev)
        x = torch.randint(-2048, 2048, (cs.C_MAIN, cs.N_MAIN), generator=gen,
                          device=dev, dtype=torch.int16)
    G = torch.as_tensor(fir_toeplitz_mats(np.asarray(fir_lowpass(256, 0.2),
                                                     np.float64))
                        .astype(np.float32), device=dev)
    inp = sb_iir_inputs(dev) if only & {"sb", "iir"} else {}
    if "fm" in only:
        inp.update(fm_inputs(dev))
    if "frame" in only:
        inp.update(frame_inputs(dev))
    if "fir" in only:
        inp.update(fir_inputs(dev))
    for d in args:
        ab_tree(d, y, x, G, dev, only, inp)
    if "--stages" in argv:
        stages(x, G, dev)
    for f in FAILED:
        print(f"FAIL {f}")
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
