#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json] [--profile DIR]

Builds the port's CUDA kernels from ``libtsd_tpu_torch/csrc`` into
``build/libtsd_tpu_torch/`` and drives two paths at full size:

* the spectral main path (256 channels x 2^22 int16 samples: 256-tap
  lowpass FIR -> 4096-point periodogram, fused, composed and streamed, plus
  a Welch PSD), with kernels #1-#4 and Welch's two passes around #4
  (framing, power sum) each checked against its plain PyTorch version;
* the QAM-16 receive path: 4096 channels made on the card by the port's
  modulator (RRC 0.25, osf 4, 8 fractional delays, independent noise),
  demodulated by ``DecisionDemodSB`` over 8 steps of 8192 samples with
  the ``"cuda"`` engine (kernel #5) and the ``"cuda-fused"`` engine
  (kernel #6, one launch a step); tail EVM on every channel, bit errors
  after warm-up on sampled channels, each kernel against its plain
  version, #6 on every output of its step too at ``qam_serving``'s 4096
  and 128 channels;
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
  ``"cuda"`` OLA engine on channel 0;
* the FM broadcast receiver (BASELINE config 4, ``FmReceiverConfig()``
  defaults) at 256 channels x 2^18 complex samples, each an FM tone of its
  own frequency plus noise: the composed ``FmReceiver.step`` and the fused
  chain ``FmChain`` (kernel #8), #8 against its plain version and against
  the composed chain, the composed chain streamed against one shot, every
  channel's tone recovered; again at channel_freq 0.22 on 32 channels;
* the IIR cascade (kernel #7): an order-4 Butterworth lowpass as 2
  sections over 64 x 2^18 samples, against its plain version and float64
  ``scipy.signal.sosfilt``, 4 calls with the state carried bit-identical
  to one call;
* the parallel layer on a (chan 2, time 4) mesh of 8 virtual shards of
  the card: the main path's working set through
  ``sharded_fir_periodogram4096`` in both halo forms (``"fused"``: kernel
  #11, the halo pushed inside the kernel; ``"ppermute"``: tail copies,
  then #3), #11's partial spectra against its plain version, both forms
  against the unsharded #3, a second input on the same receive slots and
  slots poisoned beforehand; ``sharded_chain`` (overlap-save ``OlaFft``,
  kernel #9, then an ``IirFrame``) at 64 channels and the sharded FM
  receiver at 256 x 2^18, each against its unsharded run;
* the parallel layer across processes (``multiprocess_phase``): 4
  workers started through ``parallel.launch`` (each its own card where
  there are 4, else all on cuda:0), one "time" row across them and chan 2
  x time 2: the main path's working set through
  ``sharded_fir_periodogram4096`` in both halo forms (#11's receive slots
  mapped between the processes by CUDA IPC; a poisoned slot), the
  sharded chain and the sharded FM receiver, each rank's results against
  this process's unsharded runs, each rank's launches of #11, #3 and #9;
* the QAM-16 modem (``Qam16Modem``, ``__graft_entry__.entry()``) in both
  ``rx_mode``s: the entry workload, then 2,000 symbols delayed by 1.3
  samples against the BER and EVM gates of tests/test_receivers.py;
* BASELINE config 3, the rational resampler: 64 channels x 327,680
  complex64 samples made on the card, ``RationalResampler`` (48 k -> 44.1
  k, 147/160) then the 256-tap ``Fir``, 8 chained steps (no kernel: the
  hot path is one fp32 contraction); two steps of channels 0-3 against
  float64 numpy from the sinc formula and the same taps, ``resample`` on
  the reference's cfg3 golden, input Msamples/s and ms a step;
* paths with no kernel, each with the launch counts zeroed and printed:
  the spectral layer, the channelizer and RDS (``spectral_phase``,
  ``channelizer_phase``, ``rds_phase``), the protocol decoders (an ADS-B
  monitor of 64 receivers, POCSAG at three bauds: ``protocols_phase``),
  the impaired link in front of a BER sweep (``link_phase``) and the
  estimators (DOA, MUSIC, Kalman, EKF, IMU: ``estimation_phase``);
* the port's examples (``examples_phase``): each twin in
  ``libtsd_tpu_torch/examples`` called through its ``main`` on the card
  with its own gates: ``qam_serving`` at 4096 and 128 channels (#6),
  ``serving_loop`` on the three detector engines (#9, #10; their
  detections held to the plain engine's at the same granularity),
  ``fm_demo`` (#4 in its Welch PSD, held to the CPU route on the same
  band), ``iq_stream_demo``, ``protocols_demo``,
  ``doa_demo`` and ``ber_sweep`` cut to one Eb/N0 a waveform; its counts
  zeroed before it, and #4, #6, #9 and #10 each launched at least once.

Every kernel is timed beside its plain version (CUDA events, median of 5
runs after a warm-up, a run being as many back-to-back calls as fill 2 ms,
at most 50), beside the least time the card could take for the same
work (its share of that bound is printed beside it; #2 also at one
channel) and, where one PyTorch call computes the same function, that
call's time (Welch's two passes on the ``spectral.welch4`` cell's block).
Each path runs with the launch counts set to 0 just before it and read
just after; a kernel of a path that was not launched fails the run.  Any
failure raises and exits non-zero.  Without a CUDA device it exits 1 and
prints no result.  ``--profile DIR`` adds ``torch.profiler`` windows over
the fused and composed main path, the main path's ``psd_welch`` (#4 and
the two passes) and one step of each QAM engine, of each frame-receiver
engine, of both sharded chain forms and of the config-3 chain (device
busy time, idle share, top kernels; chrome traces into DIR).

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
PG_ONE = "periodogram4096 1x2^22"  # #2 timed at one channel beside C_MAIN
TOL_F32 = 1e-4                     # fp32 results, relative to the peak
TOL_FIR64 = 1e-5                   # #1 against a float64 FIR, of the peak
TOL_TIER = 1e-2                    # across tiers that round taps or x to bf16
# Spectra are also held bin by bin: |a-b| / (|b| + FLOOR * peak).  Behind
# the 256-tap lowpass most bins lie orders of magnitude below the peak, so
# the peak-relative error alone cannot see a wrong stopband.  fp32 against
# float64 gives ~2e-5 per bin there (CPU tests); zeroing a bin gives ~1.
FLOOR = 1e-6
TOL_BIN = 1e-3
# Welch's passes: the framing rounds as its plain version (equal bit for
# bit); the power sum adds in another order than PyTorch's, held in dB
TOL_WELCH_DB = 1e-3
WELCH4 = (4, 1 << 26)              # the spectral.welch4 cell's block

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

# the FM broadcast receiver, BASELINE config 4 at the serving block of
# benchmarks/tpu_fm_bench.py:3-6: FmReceiverConfig() defaults (f0 0.25, R 4,
# 63 taps, deviation 0.1, de-emphasis 0.05), C x N complex64 samples
C_FM, N_FM = 256, 1 << 18
C_FM22 = 32            # the second pass at channel_freq = 0.22
TB_FM = 32             # the fused chain's tb
FM_NOISE = 0.01        # noise std per real dimension
FM_SKIP = 4            # outputs before the fused-vs-composed comparison
# #8 vs plain and vs composed (tests/test_pallas_iir_fm.py:102); composed in
# 4 blocks vs one shot (tests/test_receivers.py:86)
TOL_FM, TOL_FM_STREAM = 1e-5, 1e-3
TOL_TONE = 0.003       # recovered tone frequency (tests/test_receivers.py:66)
# the IIR cascade at benchmarks/tpu_iir_bench.py:42,56-62: order-4
# Butterworth lowpass at 0.1 as 2 sections, C x N float32
C_IIR, N_IIR = 64, 1 << 18
# vs plain, and vs float64 sosfilt (tests/test_pallas_iir_fm.py:34)
TOL_IIR = 1e-5
# the QAM-16 modem: the entry() workload of __graft_entry__.py, then the
# gates of tests/test_receivers.py:89-102
NSYM_ENTRY, NSYM_GATE = 512, 2000
TOL_MODEM_BER, TOL_MODEM_EVM = 0.01, 0.15

# BASELINE config 3 at benchmarks/tpu_resample_bench.py:30-58,70-72's
# largest 64-channel shape: 48 k -> 44.1 k (147/160), then the 256-tap
# lowpass, STEPS_RS chained steps over one block of C_RS x N_RS complex64
C_RS, N_RS, STEPS_RS = 64, 160 * 2048, 8
RATIO_RS = 44100 / 48000
NC_RS, NPH_RS = 15, 256  # the default interpolator's taps and phases
TOL_RS = 1e-5          # vs float64 numpy from the sinc formula, of the peak
TOL_GOLDEN_RS = 5e-3   # cfg3 golden (tests/test_golden_ref.py:82-93)

# the spectral layer (no kernel): RtSpectrum at C_SP x N_SP complex64 a
# step, STEPS_SP chained steps, plain and as a sweep; czt; xcorr; the
# constant-Q periodogram of T_AUDIO s of real audio at FS_AUDIO
C_SP, N_SP, STEPS_SP = 64, 1 << 18, 8
NFFT_SP, NAVG_SP = 4096, 4
NSUBS_SP, SWEEP_SP = 8, 2048
N_CZT = 1 << 16        # czt: n = m
N_XC = 1 << 20         # xcorr: two signals of N_XC samples
BINS_REF = 256         # czt bins and xcorr lags held to float64 direct sums
FS_AUDIO, T_AUDIO = 48000.0, 30.0
FMIN_CQT, FMAX_CQT = 55.0, 14000.0
TOL_SP = 1e-4          # fp32 spectra, czt, xcorr vs float64, of the peak
TOL_CQT = 1e-4         # periodogram_cqt on the card vs the CPU, of the peak

# the RDS decoder (tests/test_rds.py:135-150 at full length): T_RDS s of
# broadcast FM IF at FE_RDS, stereo tones plus 0A groups (an 8-character
# PS name) and 2A groups (a 64-character radiotext); 4 s carry the 20
# groups twice over, and the pilot PLL's per-sample loop takes ~30 s of
# the card's time for each second of IF
FE_RDS, T_RDS = 1.024e6, 4.0
PS_RDS = "TSD GPU!"
RT_RDS = "LIBTSD PORT: RDS DECODED ON THE CARD, 4 S OF FM IF AT 1.024 MHZ"
N_RDS_CPU = 1 << 20    # rds_baseband on the card vs the CPU on this prefix
N_RDS_PROF = 1 << 16   # the profile window's prefix (a per-sample PLL loop)
TOL_RDS = 1e-4         # rds_baseband card vs CPU, of the peak

# the channelizer at benchmarks/tpu_channelizer_bench.py:101-107's widest
# shapes: M 256 (K 8) over STEPS_CH chained steps of N_CH complex64, the
# WOLA pair at C_WOLA x N_WOLA, M 256
M_CH, N_CH, STEPS_CH = 256, 1 << 22, 8
C_WOLA, N_WOLA = 64, 1 << 16
TOL_CH = 1e-5          # vs float64 numpy polyphase-FFT, of the peak
# round trips (tests/test_advanced.py:302-345): a channel-centre tone and
# broadband noise through dechannelize(channelize()), rms relative; the
# WOLA pair, rms relative
TOL_DECH_TONE, TOL_DECH_BROAD, TOL_WOLA = 0.01, 0.35, 6e-4

# the protocol decoders (examples/protocols_demo.py at monitoring width):
# an ADS-B monitor of C_ADSB receivers at 2 MS/s, AdsbConfig() defaults
# (fe 2e6, Ne 65,536, threshold 0.55, max_frames 8), BLOCKS_ADSB blocks a
# receiver; magnitude noise ADSB_NOISE |N(0, 1)|, DF17 squitters at
# ADSB_AMP, at most ADSB_PER_BLOCK a block, each wholly inside its block
C_ADSB, BLOCKS_ADSB = 64, 16
ADSB_NOISE, ADSB_AMP, ADSB_PER_BLOCK = 0.02, 0.8, 4
ADSB_PUBLISHED = ("8D4840D6202CC371C32CE0576098",   # ident KLM1023
                  "8D40621D58C382D690C8AC2863A7",   # position, even
                  "8D40621D58C386435CC412692AD6")   # position, odd
CPR_FIX = (52.2572, 3.91937)   # the published pair's position
TOL_CPR = 2e-3                 # degrees (tests/test_protocols.py:296)
# POCSAG: fe 48 kHz, fi 3 kHz, IF AWGN POC_NOISE per real dimension
# (examples/protocols_demo.py:69-76); one T_POC s transmission of pages
# at each baud
FE_POC, FI_POC, POC_NOISE, T_POC = 48000.0, 3000.0, 0.25, 20.0
# and K_GAP pages at 1200 baud as separate transmissions (each with its
# preamble), GAP_POC s of carrier off between them
K_GAP, GAP_POC = 8, 0.5

# the impaired link in front of a BER sweep, at the QAM phase's working
# set: C_LINK x N_LINK complex64 QAM-16 (osf 4) from the port's modulator
C_LINK, N_LINK = 4096, 8192
EBN0_CLEAN, EBN0_NOISY = 200.0, 12.0
PN_DB_HZ = -30.0               # phase noise of the noisy pass, dBc/Hz
TOL_ECP = 1e-5                 # the deterministic path vs float64, of peak
TOL_NOISE_VAR = 0.01           # measured noise variance vs the formula's
N_FADE, FD_FADE, RICE_K = 1 << 22, 0.01, 4.0
TOL_FADE = 0.02                # Rayleigh power, Rice LOS share
N_FHSS, SLOT_FHSS, NF_FHSS = 1 << 23, 1024, 46337
TOL_FHSS = 1e-6                # phase vs float64's exact phase, in cycles
TOL_MATZNER = 1e-4             # vs a float64 numpy recursion, of the peak
N_LMS = 4096                   # QPSK symbols through a 3-tap ISI channel
LMS_SKIP = 1000                # decision errors counted after this symbol
TOL_LMS = 1e-3                 # card vs CPU (tests/test_golden_ref4.py:92)

# the estimators: examples/doa_demo.py at its own size, MUSIC over 2^16
# samples, Kalman / EKF / IMU loops
M_DOA, D_DOA, L_DOA, T_DOA, NF_DOA = 16, 0.5, 10, 400, 2048
DOA_DEG = (70.0, 110.0)
TOL_DOA_DEG = 1.0              # doa_demo.py:81
TOL_DOA_SPEC = 1e-4            # card vs CPU, of the peak
N_PSDSS, M_PSDSS = 1 << 16, 16
N_KALMAN, N_EKF, N_IMU = 4096, 1000, 800
TOL_KALMAN = 1e-4              # vs float64 numpy, of the peak
TOL_EKF_STEP = 1e-4            # one step from the card's state, CPU vs card
TOL_IMU = 1e-4                 # card vs CPU, of the peak
# tail attitude error of every draw: test_advanced.py:64's bound, set for
# a model with 10x less gyro noise; this one reads ~0.002-0.004 (PERF.md)
TOL_IMU_TRACK = 0.05
K_IMU = 8                      # IMU draws, filtered at once (torch.func.vmap)

# the parallel layer: a (chan, time) mesh of virtual shards of one card
MESH_CHAN, MESH_TIME = 2, 4
C_PAR = 64             # sharded_chain's channels; 16 hops of #9 per shard
HOPS_PAR = 16
# sharded vs unsharded (tests/test_parallel.py:96,223); the IIR chain and
# the FM receiver absolute, the FM after FM_PAR_SKIP outputs (:241,365-366)
TOL_SHARD, TOL_SHARD_IIR, TOL_SHARD_FM = 1e-5, 1e-4, 1e-4
FM_PAR_SKIP = 16
SENTINEL_I16 = 32767   # poisons an int16 receive slot
# rows of the mesh across processes: MP_RANKS workers, each its own card
# when there are as many, else all on cuda:0; (chan, time) layouts
MP_RANKS = 4
MP_LAYOUTS = ((1, MP_RANKS), (2, MP_RANKS // 2))
MP_KERNELS = ("fir_periodogram4096_halo", "fir_periodogram4096", "ola")
MP_TIMEOUT = 420       # seconds, for the whole fleet
MP_ROUNDS = 3
# the examples: qam_serving at BASELINE config 5's serving width and at
# its default; serving_loop on every detector engine; ber_sweep at
# NBITS_BER bits and one Eb/N0 a waveform (its per-sample clock-recovery
# loop is a Python loop of device operations): the blind-chain points of
# tests/test_ber_sweep.py (BLIND, :98-110), measured < factor x theory +
# BER_FLOOR; 4-FSK printed ungated, as the reference bench records it
C_QAM_SERVE = (4096, 128)
DET_ENGINES = ("torch", "cuda", "cuda-fused")
NBITS_BER = 12000
BER_GATED = {"QPSK": (4.0, 3.0), "BPSK": (6.0, 5.0), "pi4-QPSK": (8.0, 4.0),
             "8PSK": (8.0, 4.0), "QAM16": (8.0, 3.0)}
BER_UNGATED = {"4FSK": 10.0}
BER_FLOOR = 6e-4

# the card's published peaks (NVIDIA's H100 SXM data sheet): HBM bytes/s,
# fp32 FLOP/s outside the tensor cores, dense bf16 FLOP/s on them
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
PEAK_TENSOR = 989e12

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
    "iir_cascade": ("libtsd_tpu_torch/csrc/iir.cu",
                    "libtsd_tpu/ops/pallas/iir.py:147"),
    "fm_chain": ("libtsd_tpu_torch/csrc/fm.cu",
                 "libtsd_tpu/ops/pallas/fm.py:289"),
    "fir_periodogram4096_halo": ("libtsd_tpu_torch/csrc/chain_halo.cu",
                                 "libtsd_tpu/ops/pallas/chain.py:362"),
    # no Pallas call: the XLA glue around #4 in the JAX psd_welch
    "welch_frames": ("libtsd_tpu_torch/csrc/welch.cu",
                     "libtsd_tpu/ops/psd.py:48 (framing, window)"),
    "welch_power": ("libtsd_tpu_torch/csrc/welch.cu",
                    "libtsd_tpu/ops/psd.py:48 (|X|^2, sum, fftshift, dB)"),
}
PATH_KERNELS = {"main": ("fir", "periodogram4096", "fir_periodogram4096",
                         "fft_pow2", "welch_frames", "welch_power"),
                "qam": ("demod_sb", "demod_sb_fused"),
                "frame": ("ola", "detfront"),
                "fm": ("fm_chain",),
                "iir": ("iir_cascade",),
                "parallel": ("fir_periodogram4096_halo",),
                "examples": ("fft_pow2", "demod_sb_fused", "ola", "detfront",
                             "welch_frames", "welch_power")}
# kernels the parallel path runs under the mesh whose counts stay those of
# their own paths: each must still launch there
PARALLEL_ALSO = ("fir_periodogram4096", "ola")


def bound(nbytes: float, flops: float,
          tensor_flops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once), does ``flops`` in
    fp32 and ``tensor_flops`` as bf16 products on the tensor cores (the
    units run side by side, so the largest of the three times): (ms,
    "bytes" or "operations")."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    tf = max(tf, tensor_flops / PEAK_TENSOR * 1e3)
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


def check_abs(name: str, a: torch.Tensor, b: torch.Tensor,
              atol: float) -> float:
    """Hold a against b: largest |a-b| below atol, or, with atol 0, equal
    bit for bit.  Returns the max absolute error."""
    if a.shape != b.shape or not torch.isfinite(a).all():
        raise AssertionError(f"{name}: shape {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}, or non-finite values")
    d = (a.double() - b.double()).abs().max().item()
    ok = torch.equal(a, b) if atol == 0 else d < atol
    print(f"check {name}: max_abs_err={d:.6e} "
          + ("bit-equal" if atol == 0 else f"tol={atol:g}")
          + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: out of tolerance")
    return d


def time_ms(fn, reps: int = 5, min_ms: float = 2.0) -> float:
    """Median over ``reps`` CUDA-event timings, after a warm-up, of a run of
    back-to-back calls divided by its count.  The run is long enough (>=
    ``min_ms`` by a first timed call, at most 50 calls) that the host's
    work for the next call overlaps the device's for this one, so that a
    short kernel's time is not its wrapper's."""
    fn()
    torch.cuda.synchronize()

    def run(n: int) -> float:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    inner = int(min(50, max(1, np.ceil(min_ms / run(1)))))
    return float(np.median([run(inner) for _ in range(reps)]))


def registers(pattern: str) -> str:
    """The registers and spill stores ``nvcc -Xptxas -v`` reported for the
    kernels whose mangled names contain ``pattern`` (the build's log)."""
    from libtsd_tpu_torch.ops.kernels import _build
    found = [v for k, v in _build.ptxas_registers().items() if pattern in k]
    if not found:
        return f"registers of {pattern}: not recorded"
    return "; ".join(f"{pattern}: {r} registers, {sp} bytes of spill stores"
                     " (ptxas -v)" for r, sp in found)


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
    # the repo's own reference: a float64 FIR of the same samples, at one
    # chunk of taps (3, the main path's 256) and two (600)
    xn = x.double().cpu().numpy()
    rng = np.random.default_rng(1)
    for K, hk in ((256, h), (3, rng.standard_normal(3)),
                  (600, rng.standard_normal(600))):
        y = fir.fir_kernel(hk, x)
        if K != 256:
            check(f"#1 fir 1-D N=2^22 K={K} vs plain", y,
                  fir.fir_plain(hk, x), TOL_F32)
        check(f"#1 fir 1-D N=2^22 K={K} vs float64 numpy", y,
              torch.as_tensor(np.convolve(xn, np.asarray(hk, np.float64))
                              [:N_MAIN], device=dev), TOL_FIR64)
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
    err.update(welch_checks(gen, dev))
    return err


def welch_checks(gen, dev) -> dict:
    """Welch's two passes around #4 against their plain versions, real and
    complex input, at the main path's Welch block (4 x 2^22) and at the
    ``spectral.welch4`` cell's (4 x 2^26): the framing bit for bit, the
    power sum within TOL_WELCH_DB dB and bit-identical on a second call."""
    from libtsd_tpu_torch.ops import psd
    from libtsd_tpu_torch.ops.kernels import fft, welch
    err = {"welch_frames": 0.0, "welch_power": 0.0}
    w = psd._win("hn", NFFT, dev)
    for C, n in ((4, N_MAIN), WELCH4):
        nseg = len(range(0, n - NFFT, NFFT // 2))
        for dt in (torch.float32, torch.complex64):
            x = torch.randn(C, n, generator=gen, device=dev, dtype=dt)
            what = f"{C} x 2^{n.bit_length() - 1} {str(dt)[6:]}"
            re, im = welch.welch_frames(x, w, NFFT, nseg)
            for k, (a, b) in enumerate(zip(
                    (re, im), welch.welch_frames_plain(x, w, NFFT, nseg))):
                err["welch_frames"] = max(err["welch_frames"], check_abs(
                    f"welch_frames {what} {('re', 'im')[k]} plane vs plain",
                    a, b, 0))
            del x
            torch.cuda.empty_cache()
            yr, yi = fft.fft_pow2(re, im)
            del re, im
            S = welch.welch_power(yr, yi, C, nseg, NFFT)
            err["welch_power"] = max(err["welch_power"], check_abs(
                f"welch_power {what} vs plain, dB", S,
                welch.welch_power_plain(yr, yi, C, nseg, NFFT),
                TOL_WELCH_DB))
            check_abs(f"welch_power {what}: a second call", S,
                      welch.welch_power(yr, yi, C, nseg, NFFT), 0)
            del yr, yi
            torch.cuda.empty_cache()
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
    y1 = y[:1]
    t[PG_ONE] = (time_ms(lambda: periodogram.periodogram4096_acc(y1)),
                 time_ms(lambda: periodogram.periodogram4096_plain(y1)),
                 N_MAIN)
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


def welch_timings(dev) -> dict:
    """Welch's two passes beside their plain versions on the
    ``spectral.welch4`` cell's block (4 x 2^26 float32), and their bounds:
    the framing reads the input once and writes two float32 planes of C
    nseg N values; the power pass reads the planes once and writes C N
    values.  Returns {name: (kernel ms, plain ms, bound ms, bound by,
    library ms: none)}."""
    from libtsd_tpu_torch.ops import psd
    from libtsd_tpu_torch.ops.kernels import fft, welch
    C, n = WELCH4
    x = torch.randn(C, n, generator=torch.Generator(device=dev).manual_seed(19),
                    device=dev)
    nseg = len(range(0, n - NFFT, NFFT // 2))
    rows = C * nseg
    w = psd._win("hn", NFFT, dev)
    re, im = welch.welch_frames(x, w, NFFT, nseg)
    t = {"welch_frames": (
        time_ms(lambda: welch.welch_frames(x, w, NFFT, nseg)),
        time_ms(lambda: welch.welch_frames_plain(x, w, NFFT, nseg)),
        *bound(4 * C * (nseg + 1) * (NFFT // 2) + 8 * rows * NFFT,
               rows * NFFT), None)}
    del x
    yr, yi = fft.fft_pow2(re, im)
    del re, im
    torch.cuda.empty_cache()
    t["welch_power"] = (
        time_ms(lambda: welch.welch_power(yr, yi, C, nseg, NFFT)),
        time_ms(lambda: welch.welch_power_plain(yr, yi, C, nseg, NFFT)),
        *bound(8 * rows * NFFT + 4 * C * NFFT, 4 * rows * NFFT), None)
    del yr, yi
    torch.cuda.empty_cache()
    for name, (k, p, bms, by, _) in t.items():
        print(f"time {name} ({C} x 2^{n.bit_length() - 1}): kernel {k:.4f} "
              f"ms, plain {p:.4f} ms, bound {bms:.4f} ms by {by}")
    return t


def main_bounds_and_library(h, mp, dev) -> dict:
    """Each main-path kernel's bound at the shapes timed above, and the
    time of the one PyTorch call that computes the same transform:
    ``F.conv1d`` for #1 (cuDNN TF32 off, so fp32 as the kernel),
    ``torch.fft.rfft`` of the same 4096-sample frames for #2 (the
    transform only, without |X|^2 and the sum over frames; also at one
    channel), ``torch.fft.fft`` for #4; #3 has none.  Flops: 2 per tap and
    sample for a FIR, 5 n log2 n per complex n-point FFT, 4 per bin for
    |X|^2 and the accumulation.  #3's headline tier, int16/2, does its FIR
    as two bf16 passes on the tensor cores (its bound: the direct form's
    useful products); "highest" does it in fp32 (printed beside it).  #1
    does its FIR as six bf16 products on the tensor cores (x and h split
    in three bf16 parts, every xi hj with i + j <= 4)."""
    import torch.nn.functional as F
    y = mp["y"]
    K, frames = len(h), C_MAIN * N_MAIN // NFFT
    spec = frames * (fft_flops(NFFT) + 4 * NFFT)
    nseg = len(range(0, N_MAIN - NFFT, NFFT // 2))
    out = {
        # #1: six bf16 products (x and h split in three) on the tensor
        # cores; on the FMA pipes only the split's two subtractions and
        # the sum of the two accumulator sets, 3 flop a sample
        "fir": bound(8 * N_MAIN + 4 * K, 3 * N_MAIN, 6 * 2 * K * N_MAIN),
        "periodogram4096": bound(4 * C_MAIN * N_MAIN + 4 * C_MAIN * NFFT,
                                 spec),
        PG_ONE: bound(4 * N_MAIN + 4 * NFFT, spec / C_MAIN),
        "fir_periodogram4096": bound(
            2 * C_MAIN * N_MAIN + 4 * C_MAIN * NFFT + 4 * K, spec,
            2 * 2 * K * C_MAIN * N_MAIN),
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
    lib[PG_ONE] = time_ms(lambda: torch.fft.rfft(y[:1].view(1, -1, NFFT)))
    torch.cuda.empty_cache()
    z = torch.randn(4 * nseg, NFFT, device=dev, dtype=torch.complex64)
    lib["fft_pow2"] = time_ms(lambda: torch.fft.fft(z))
    lib["fir_periodogram4096"] = None
    hb, hby = bound(4 * C_MAIN * N_MAIN + 4 * C_MAIN * NFFT + 4 * K,
                    2 * K * C_MAIN * N_MAIN + spec)
    print(f"bound fir_periodogram4096 highest (fp32 FIR): {hb:.4f} ms by "
          f"{hby}")
    # #3's wgmma body (csrc/chain_wg.cu) as it stands: 64-phase Toeplitz
    # blocks, E = 5 at K = 256, 640 tensor flops a sample and pass
    from libtsd_tpu_torch.ops.kernels import chain
    E = (K + 62) // 64 + 1
    wb, wby = bound(2 * C_MAIN * N_MAIN + 4 * C_MAIN * NFFT + 4 * K, spec,
                    2 * 2 * 64 * E * C_MAIN * N_MAIN)
    print(f"bound fir_periodogram4096 int16/2 on the wgmma body (K <= "
          f"{chain.K_MAX_WG}; {2 * 64 * E} tensor flops a sample and pass): "
          f"{wb:.4f} ms by {wby}")
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
    """Kernel #5's or #6's inputs for one step, as the engine builds them
    (#6's with a step plan of its own)."""
    from libtsd_tpu_torch.models.demod_sb import pack_state
    from libtsd_tpu_torch.ops.kernels import demod_sb as KSB
    p = dd.loop_params(xb.shape[-1])
    if eng == "cuda":
        _, zp = dd.matched_zp(st, xb)
        return (KSB.demod_sb, KSB.demod_sb_plain,
                (zp, pack_state(st), dd.wf.symbols, p))
    xb = xb.contiguous()
    return (KSB.demod_sb_fused_step, KSB.demod_sb_fused_step_plain,
            (xb, st["xtail"], pack_state(st),
             KSB.FusedStep(xb.shape[0], p, dd.wf.symbols, dd.h_mf,
                           dd.rms_ref, dd.wf.info.k, xb.device)))


def _checked(eng, out):
    """(y, bits, valid, state rows) of #5's or #6's results."""
    from libtsd_tpu_torch.models.waveform import symbol_indices_to_bits
    if eng == "cuda":
        y, sidx, valid, st = out
        return y, symbol_indices_to_bits(sidx, 4), valid, st
    bits, y, valid, _, rows, _ = out
    return y, bits, valid, rows


def qam_checks(wf, bits, x, qp) -> dict:
    """The QAM path's checks on each engine: tail EVM < TOL_EVM on every
    channel; zero bit errors after WARMUP_SYM symbols on sampled channels
    (cmp_bits_rot resolves the 90-degree ambiguity of the blind loop);
    each kernel against its plain version on the same full-width inputs
    (the first step and one from the middle).  Returns the largest
    |dsymbol| per kernel."""
    from libtsd_tpu_torch.models import ber
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
            yk, bk, vk, stk = _checked(eng, kf(*args))
            yp, bp, vp, stp = _checked(eng, pf(*args))
            same = torch.equal(vk, vp)
            dy = (yk - yp).abs()
            dmax = dy[vp].max().item() if vp.any() else 0.0
            mism = (bk != bp).float().mean().item()
            dst = (stk - stp).abs().max().item()
            # #5 and #6 round every operation as their plain versions do:
            # the symbols and the state agree bit for bit
            ok = (same and dmax < TOL_SYM and mism < TOL_BITS and dmax == 0
                  and dst == 0)
            print(f"check qam {name} (#{5 if eng == 'cuda' else 6}) vs plain,"
                  f" {C_QAM} x {N_QAM} step {k}: valid masks equal {same}, "
                  f"max|dsym| {dmax:.3e} tol {TOL_SYM:g}, bit mismatch "
                  f"{mism:.3e} tol {TOL_BITS:g}, max|dstate| {dst:.3e} (both "
                  f"must be 0) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} vs plain")
            err[name] = max(err[name], dy.max().item())
            del args
            torch.cuda.empty_cache()
    return err


def qam_step_checks(x, qp) -> None:
    """The fused engine's step route (#6, one launch)
    against its plain version on the same inputs, bit for bit: bits, bit
    flags, y, valid, the nine state rows (pointer re-based) and the input
    tail, at qam_serving's channel counts C_QAM_SERVE, from the state the
    path carried into its middle step; and the path's steps all on that
    route (each from a state in #6's row layout)."""
    from libtsd_tpu_torch.models.demod_sb import _viewed_rows, pack_state
    from libtsd_tpu_torch.ops.kernels import demod_sb as KSB
    r = qp["cuda-fused"]
    dd, k = r["dd"], STEPS_QAM // 2
    st = r["states"][k]
    xb = x[:, k * N_QAM:(k + 1) * N_QAM]
    names = ("bits", "bit flags", "y", "valid", "state rows", "xtail")
    for C in C_QAM_SERVE:
        xc = xb[:C].contiguous()
        args = (xc, st["xtail"][:C].contiguous(),
                pack_state(st)[:, :C].contiguous(),
                KSB.FusedStep(C, dd.loop_params(N_QAM), dd.wf.symbols,
                              dd.h_mf, dd.rms_ref, dd.wf.info.k, xc.device))
        got = KSB.demod_sb_fused_step(*args)
        want = KSB.demod_sb_fused_step_plain(*args)
        torch.cuda.synchronize()
        same = [u.dtype == v.dtype and torch.equal(u, v)
                for u, v in zip(got, want)]
        print(f"check qam demod_sb_fused_step (#6) vs "
              f"plain, {C} x {N_QAM} step {k}: "
              + ", ".join(f"{nm} equal {ok}" for nm, ok in zip(names, same))
              + f" {'ok' if all(same) else 'FAIL'}")
        if not all(same):
            raise AssertionError("demod_sb_fused_step vs plain")
        del args, got, want
    rows = sum(_viewed_rows(s) is not None for s in r["states"])
    ok = len(r["states"]) == STEPS_QAM and rows == STEPS_QAM
    print(f"check qam cuda-fused route: {rows} of {STEPS_QAM} steps from a "
          f"state in row layout (one launch), {len(r['states']) - rows} "
          f"stacked {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("qam cuda-fused: a step off the one-launch route")


def qam_timings(x, qp) -> dict:
    """Each engine's step, each kernel alone and its plain version (CUDA
    events, median of 5 after a warm-up) on the first block, and each
    kernel's bound.  Flops per symbol: 8 K for the two K-tap windows, 5 M
    for the decisions, ~60 for rotation, TED, phase and AGC errors and
    the lane sums; the fused kernel adds 4 Kmf + 3 per input sample for
    the matched filter and its power.  Bytes: the kernel's inputs once
    and per symbol out #5's 13 (y 8, sidx 4, valid 1), #6's 17 (y 8,
    valid 1, the 4 bits and their 4 flags) and its input tail."""
    out = {}
    xb = x[:, :N_QAM]
    for eng, r in qp.items():
        dd, st = r["dd"], r["states"][0]
        kf, pf, args = _kernel_args(eng, dd, st, xb)
        ms_step = time_ms(lambda: dd.step(st, xb))
        ms_k = time_ms(lambda: kf(*args))
        ms_p = time_ms(lambda: pf(*args))
        p = args[-1] if eng == "cuda" else args[3].p
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
            nb = (16 * args[1].numel() + 8 * xb.numel() + 4 * kmf + out_b
                  + 4 * nsym)
            nf = loop_f + C * N_QAM * (4 * kmf + 3)
            name = "demod_sb_fused"
        bms, by = bound(nb, nf)
        rate = C_QAM * N_QAM / ms_step / 1e3
        print(f"time qam {eng}: step {ms_step:.4f} ms ({rate:.1f} "
              f"Msamples/s aggregate, {C_QAM} x {N_QAM}); kernel {name} "
              f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {bms:.4f} ms by "
              f"{by} ({100 * bms / ms_k:.1f} % of the bound); library call "
              f"none")
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
    each kernel's bound, its share of the bound and its registers (the
    build's ``-Xptxas -v`` report).  #9: 16 bytes a sample (x in, y out)
    plus the state and H; per window two Nf-point FFTs (5 Nf log2 Nf each)
    and the product (6 Nf).  #10: 8 bytes a sample in and 16 out (four planes)
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
          f"{ms_p:.4f} ms, bound {bms:.4f} ms by {by} ({100 * bms / ms_k:.1f}"
          f" % of the bound); library call none; "
          f"{registers(f'ola_kernelILi{corr.Nf.bit_length() - 1}E')}")
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
          f"{ms_p:.4f} ms, bound {bms:.4f} ms by {by} ({100 * bms / ms_k:.1f}"
          f" % of the bound); library call none; "
          f"{registers('detfront_kernel')}")
    return out, steps


# ------------------------------------------------------- FM receiver


def fm_signal(gen, dev, C: int, f0: float):
    """C channels of N_FM samples made on the card: channel c carries a
    tone of its own frequency fa_c = 0.002 + 0.016 c / C (cycles per audio
    sample), amplitude 0.5, FM-modulated at the receiver's deviation (0.1
    at the decimated rate) on the carrier f0 with a random phase, plus
    noise FM_NOISE per dimension; the phase is summed in float64 cycles.
    Returns (x complex64 (C, N_FM), fa)."""
    from libtsd_tpu_torch.models.receivers import FmReceiverConfig
    cfg = FmReceiverConfig(channel_freq=f0)
    R = cfg.decim
    fa = 0.002 + 0.016 * torch.arange(C, device=dev,
                                      dtype=torch.float64) / C
    n = torch.arange(N_FM, device=dev, dtype=torch.float64)
    audio = 0.5 * torch.sin(2 * np.pi * (fa[:, None] / R) * n)
    ph0 = torch.rand(C, 1, generator=gen, device=dev, dtype=torch.float64)
    cyc = torch.remainder(f0 * n + ph0 + (cfg.deviation / R)
                          * torch.cumsum(audio, 1), 1.0)
    del audio
    x = torch.polar(torch.ones((), device=dev),
                    (2 * np.pi * cyc).to(torch.float32))
    del cyc
    w = torch.randn(2, C, N_FM, generator=gen, device=dev) * FM_NOISE
    x = x + torch.complex(w[0], w[1])
    torch.cuda.synchronize()
    return x, fa


def fm_path(x, f0: float, dev) -> dict:
    """The FM chain as a user drives it: FmReceiver.step over the whole
    block (composed: NCO mix, FirDecim, discriminator, Iir), then the fused
    chain FmChain (kernel #8) on the same samples' planes."""
    from libtsd_tpu_torch.models.receivers import FmReceiver, FmReceiverConfig
    from libtsd_tpu_torch.ops.kernels.fm import FmChain
    cfg = FmReceiverConfig(channel_freq=f0)
    rx = FmReceiver.create(cfg, device=dev)
    fc = FmChain(cfg.channel_freq, cfg.decim, cfg.chan_taps, cfg.deviation,
                 cfg.deemph_fc, device=dev)
    _, comp = rx.step(rx.init_for(x), x)
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    fused = fc(xr, xi, tb=TB_FM)
    torch.cuda.synchronize()
    return dict(rx=rx, fc=fc, xr=xr, xi=xi, comp=comp, fused=fused, f0=f0)


def _fm_plain(fp):
    from libtsd_tpu_torch.ops.kernels.fm import fm_chain_plain
    fc = fp["fc"]
    return fm_chain_plain(fp["xr"], fp["xi"], fc.h, R=fc.R, f0=fc.f0,
                          dev=fc.dev, b0=fc.b0, c=fc.c, p=fc.p, tb=TB_FM)


def fm_checks(fp, x, fa, label: str) -> float:
    """#8 against its plain version on the same full-width planes; #8
    against the composed FmReceiver after FM_SKIP outputs; the composed
    chain streamed in 4 blocks against one shot; every channel's recovered
    tone at its own frequency.  Returns #8's max |error| vs plain."""
    C = x.shape[0]
    fused, comp = fp["fused"], fp["comp"]
    if fused.shape != (C, N_FM // 4) or comp.shape != fused.shape:
        raise AssertionError(f"fm {label}: shapes {tuple(fused.shape)}, "
                             f"{tuple(comp.shape)}")
    if not (torch.isfinite(fused).all() and torch.isfinite(comp).all()):
        raise AssertionError(f"fm {label}: non-finite audio")
    plain = _fm_plain(fp)
    dp = (fused - plain).abs().max().item()
    dc = (fused[:, FM_SKIP:] - comp[:, FM_SKIP:]).abs().max().item()
    ok = dp < TOL_FM and dc < TOL_FM
    print(f"check fm {label} {C} x {N_FM}: fm_chain (#8) vs plain max_abs_err="
          f"{dp:.3e}, vs composed FmReceiver after {FM_SKIP} outputs "
          f"max_abs_err={dc:.3e} (first {FM_SKIP}: "
          f"{(fused[:, :FM_SKIP] - comp[:, :FM_SKIP]).abs().max().item():.3e})"
          f", tol {TOL_FM:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fm {label}: #8 vs plain or composed")
    del plain
    rx = fp["rx"]
    st, ys = rx.init_for(x), []
    for xb in x.chunk(4, dim=1):
        st, yb = rx.step(st, xb)
        ys.append(yb)
    ds = (torch.cat(ys, 1) - comp).abs().max().item()
    ok = ds < TOL_FM_STREAM
    print(f"check fm {label}: composed FmReceiver in 4 blocks vs one shot "
          f"max_abs_err={ds:.3e} tol {TOL_FM_STREAM:g} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fm {label}: streamed vs one shot")
    seg = fused[:, 1024:].double()
    win = torch.hann_window(seg.shape[1], periodic=False, device=seg.device,
                            dtype=torch.float64)
    peak = torch.fft.rfft(seg * win).abs().argmax(1).double() / seg.shape[1]
    df = (peak - fa).abs().max().item()
    ok = df < TOL_TONE
    print(f"check fm {label}: every channel's tone recovered at its own "
          f"frequency, max |f_peak - f_tone| {df:.3e} cycles/sample "
          f"(tones {fa[0].item():.5f}..{fa[-1].item():.5f}, bin "
          f"{1 / seg.shape[1]:.2e}) tol {TOL_TONE:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fm {label}: tone")
    return dp


def fm_timings(fp):
    """The composed FmReceiver step and the fused chain (#8) beside its
    plain version (CUDA events, median of 5 after a warm-up), and #8's
    bound: 8 bytes read per input sample, 4 written per output, the taps;
    its least work per input sample: the mix (6 flop and a sincos, counted
    as 2), the polyphase FIR (K / R taps in re and im, 4 K / R flop), and
    per output the discriminator (6 and an atan2, counted as 1), the
    scaling (1) and the de-emphasis (4)."""
    fc, rx, xr, xi = fp["fc"], fp["rx"], fp["xr"], fp["xi"]
    C, N = xr.shape
    K, R = fc.h.shape[0], fc.R
    x = torch.complex(xr, xi)
    ms_step = time_ms(lambda: rx.step(rx.init_for(x), x))
    del x
    torch.cuda.empty_cache()
    ms_k = time_ms(lambda: fc(xr, xi, tb=TB_FM))
    ms_p = time_ms(lambda: _fm_plain(fp))
    torch.cuda.empty_cache()
    bms, by = bound(8 * C * N + 4 * C * N // R + 4 * K,
                    C * N * (8 + 4 * K / R) + C * N // R * 12)
    print(f"time fm: composed FmReceiver.step {ms_step:.4f} ms "
          f"({C * N / ms_step / 1e3:.1f} Msamples/s in, {C} x {N}); "
          f"fm_chain (#8) kernel {ms_k:.4f} ms ({C * N / ms_k / 1e3:.1f} "
          f"Msamples/s), plain {ms_p:.4f} ms, bound {bms:.4f} ms by {by} "
          f"({100 * bms / ms_k:.1f} % of the bound); library call none")
    return {"fm_chain": (ms_k, ms_p, bms, by, None)}, ms_step


# ------------------------------------------------------- IIR cascade


def iir_phase(gen, dev) -> dict:
    """Kernel #7 as ``benchmarks/tpu_iir_bench.py`` drives its Pallas
    counterpart: an order-4 Butterworth lowpass at 0.1 as 2 sections over
    C_IIR x N_IIR float32, one call, then 4 calls with the state
    carried."""
    from libtsd_tpu_torch.ops.iir_design import design_iir, zpk_to_sos
    from libtsd_tpu_torch.ops.kernels.iir import IirCascade
    sos, k = zpk_to_sos(design_iir(4, "lp", "butterworth", 0.1))
    secs = [(sos[s, :3] * (k if s == 0 else 1.0), sos[s, 3:])
            for s in range(sos.shape[0])]
    casc = IirCascade(secs, device=dev)
    x = torch.randn(C_IIR, N_IIR, generator=gen, device=dev)
    y, st = casc(x)
    sc, ys = None, []
    for xb in x.chunk(4, dim=1):
        yb, sc = casc(xb.contiguous(), sc)
        ys.append(yb)
    torch.cuda.synchronize()
    sos_sc = sos.copy()
    sos_sc[0, :3] *= k
    return dict(casc=casc, x=x, y=y, st=st, ys=torch.cat(ys, 1), sts=sc,
                sos=sos_sc)


def iir_checks(ip) -> float:
    """#7 against its plain version and float64 sosfilt (1e-5 of the
    peak), and its 4-call stream bit-identical to one call.  Returns #7's
    max |error| vs plain."""
    import scipy.signal as ss
    from libtsd_tpu_torch.ops.kernels.iir import iir_cascade_plain
    casc, x, y = ip["casc"], ip["x"], ip["y"]
    if not torch.isfinite(y).all():
        raise AssertionError("iir: non-finite output")
    yp, sp = iir_cascade_plain(x, casc.T, casc.S, casc.W, casc.M)
    d = check(f"iir_cascade (#7) vs plain, {C_IIR} x {N_IIR}, 2 sections",
              y, yp, TOL_IIR)
    check("iir_cascade (#7) final state vs plain", ip["st"], sp, TOL_IIR)
    ref = ss.sosfilt(ip["sos"], x.double().cpu().numpy(), axis=-1)
    check("iir_cascade (#7) vs float64 scipy sosfilt", y,
          torch.as_tensor(ref, device=y.device), TOL_IIR)
    same = torch.equal(ip["ys"], y) and torch.equal(ip["sts"], ip["st"])
    print(f"check iir_cascade (#7): 4 calls with the state carried vs one "
          f"call bit-identical {same} {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("iir: streaming not bit-identical")
    return d


def iir_timings(ip) -> dict:
    """#7 beside its plain version (CUDA events, median of 5 after a
    warm-up), and its bound: x read and y written once (8 bytes a sample),
    the state in and out; the least work is the direct-form recursion, 9
    flop a sample and section."""
    from libtsd_tpu_torch.ops.kernels.iir import iir_cascade_plain
    casc, x = ip["casc"], ip["x"]
    ms_k = time_ms(lambda: casc(x))
    ms_p = time_ms(lambda: iir_cascade_plain(x, casc.T, casc.S, casc.W,
                                             casc.M))
    torch.cuda.empty_cache()
    bms, by = bound(8 * x.numel() + 2 * 4 * C_IIR * casc.nsec * 8,
                    9 * casc.nsec * x.numel())
    print(f"time iir_cascade (#7): kernel {ms_k:.4f} ms "
          f"({x.numel() / ms_k / 1e3:.1f} Msamples/s), plain {ms_p:.4f} ms, "
          f"bound {bms:.4f} ms by {by}; library call none")
    return {"iir_cascade": (ms_k, ms_p, bms, by, None)}


# ------------------------------------------------------- QAM-16 modem


def modem_phase(seed: int, dev) -> dict:
    """Qam16Modem in both rx_modes: the entry() workload of
    __graft_entry__.py (512 symbols from numpy's default_rng(0), transmit
    then receive), then
    NSYM_GATE symbols delayed by 1.3 samples held to the gates of
    tests/test_receivers.py:89-102 (BER < 0.01 after 400 symbols, tail
    EVM < 0.15).  Runs no kernel."""
    from libtsd_tpu_torch.models.ber import cmp_bits
    from libtsd_tpu_torch.models.receivers import Qam16Modem
    from libtsd_tpu_torch.ops.fft import delay_signal
    out = {}
    for mode in ("composed", "fused"):
        modem = Qam16Modem.create(osf=4, rx_mode=mode, device=dev)
        bits = torch.as_tensor(np.random.default_rng(0).integers(
            0, 2, 4 * NSYM_ENTRY), dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        rb, syms, mask, ev = modem.receive(modem.transmit(bits))
        torch.cuda.synchronize()
        t_entry = time.perf_counter() - t0
        if not (torch.isfinite(torch.view_as_real(syms)).all()
                and bool(torch.isfinite(ev))):
            raise AssertionError(f"modem {mode}: non-finite entry output")
        be = cmp_bits(bits, rb[mask.repeat_interleave(4)], max_lag=64)[0]
        b2 = torch.as_tensor(np.random.default_rng(seed + 1).integers(
            0, 2, 4 * NSYM_GATE), dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        rb2, syms2, mask2, ev2 = modem.receive(
            delay_signal(modem.transmit(b2), 1.3))
        torch.cuda.synchronize()
        t_gate = time.perf_counter() - t0
        rbv = rb2[mask2.repeat_interleave(4)]
        ber, nerr, _ = cmp_bits(b2[4 * 400:], rbv[4 * 400:], max_lag=64)
        ok = ber < TOL_MODEM_BER and float(ev2) < TOL_MODEM_EVM
        print(f"check modem {mode}: entry() {NSYM_ENTRY} symbols EVM "
              f"{float(ev):.4f} BER {be:.2e} ({t_entry:.2f} s); "
              f"{NSYM_GATE} symbols delayed 1.3: BER {ber:.2e} ({nerr} "
              f"errors) tol {TOL_MODEM_BER:g}, tail EVM {float(ev2):.4f} tol "
              f"{TOL_MODEM_EVM:g} ({t_gate:.2f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"modem {mode}: gates")
        out[mode] = dict(entry_s=t_entry, gate_s=t_gate, evm=float(ev2),
                         ber=ber)
    return out


# ------------------------------------------------------- parallel layer


def parallel_setup(h, gen, dev) -> dict:
    """The parallel path's inputs, made on the card: the mesh of
    MESH_CHAN x MESH_TIME virtual shards of ``dev``; the main path's
    working set (C_MAIN x N_MAIN int16) and its grid of local shards (the
    deployment form: each shard's samples already on its device); the
    sharded chain's blocks (the 129-tap lowpass at 0.2 through the
    overlap-save OlaFft, engine "cuda" = #9, then an order-2 Butterworth
    lowpass at 0.1 as IirFrame) and its input, C_PAR complex channels of
    HOPS_PAR hops of #9 per shard; the FM receiver (FmReceiverConfig())
    and C_FM x N_FM tones as in the FM phase."""
    from libtsd_tpu_torch.models.receivers import FmReceiver, FmReceiverConfig
    from libtsd_tpu_torch.ops.filter_rt import Fir, IirFrame, OlaFft
    from libtsd_tpu_torch.ops.fir_design import fir_lowpass
    from libtsd_tpu_torch.ops.iir_design import design_iir
    from libtsd_tpu_torch.parallel import make_mesh, shard
    mesh = make_mesh(chan=MESH_CHAN, time=MESH_TIME,
                     devices=[dev] * (MESH_CHAN * MESH_TIME))
    x = torch.randint(-2048, 2048, (C_MAIN, N_MAIN), generator=gen,
                      device=dev, dtype=torch.int16)
    ola = OlaFft.create(fir_lowpass(129, 0.2), engine="cuda", device=dev)
    b, a = design_iir(2, "lp", "butt", 0.1).to_ba()
    n_par = MESH_TIME * HOPS_PAR * ola.Ne
    w = torch.randn(2, C_PAR, n_par, generator=gen, device=dev)
    xfm, fa = fm_signal(gen, dev, C_FM, 0.25)
    torch.cuda.synchronize()
    return dict(mesh=mesh, G=Fir.create(h, device=dev).G, x=x,
                xs=shard(mesh, x), ola=ola,
                iir=IirFrame.create(b, a, device=dev),
                xc=torch.complex(w[0], w[1]),
                fm=FmReceiver.create(FmReceiverConfig(), device=dev),
                xfm=xfm)


def parallel_path(ps) -> dict:
    """The parallel layer as a user drives it: the sharded fused chain on
    the pre-sharded grid in both halo forms (headline tier int16,
    fir_passes=2), the sharded chain [(OlaFft, V), (IirFrame, 0)] and the
    sharded FM receiver on global tensors (cut and put back by the
    calls)."""
    from libtsd_tpu_torch.parallel import (sharded_chain,
                                           sharded_fir_periodogram4096,
                                           sharded_fm_receiver)
    mesh, G, xs = ps["mesh"], ps["G"], ps["xs"]
    out = {form: sharded_fir_periodogram4096(mesh, xs, G, precision="int16",
                                             halo=form, fir_passes=2)
           for form in ("fused", "ppermute")}
    out["chain"] = sharded_chain(mesh, [(ps["ola"], ps["ola"].V),
                                        (ps["iir"], 0)], ps["xc"])
    out["fm"] = sharded_fm_receiver(mesh, ps["fm"], ps["xfm"])
    torch.cuda.synchronize()
    return out


def _halo_rows(ps, plain: bool = False) -> list:
    """#11 on the row's own receive slots (or its plain version) over each
    chan row of the grid: the 8 partial spectra."""
    from libtsd_tpu_torch.ops.kernels import chain_halo as KH
    out = []
    for i, row in enumerate(ps["xs"]):
        out += (KH.fir_periodogram4096_halo_plain(row, ps["G"], None,
                                                  "int16", 2) if plain
                else KH.fir_periodogram4096_halo(
                    row, ps["G"], None, "int16", 2,
                    bufs=ps["mesh"].halo_buffers[i]))
    return out


def parallel_checks(ps, pp, gen) -> float:
    """#11's 8 partial spectra against its plain version; both halo forms
    against the unsharded #3; a second input on the same receive slots;
    slots poisoned first (int16: a sentinel; bf16, 16 channels: NaN); the
    sharded OLA stage and chain and the sharded FM receiver against their
    unsharded runs.  Returns #11's max |error| vs plain."""
    from libtsd_tpu_torch.ops.kernels.chain import fir_periodogram4096
    from libtsd_tpu_torch.parallel import (make_mesh, shard, sharded_chain,
                                           sharded_fir_periodogram4096)
    mesh, G, x = ps["mesh"], ps["G"], ps["x"]
    err = 0.0
    kparts = _halo_rows(ps)
    pparts = _halo_rows(ps, plain=True)
    for j, (a, b) in enumerate(zip(kparts, pparts)):
        err = max(err, check(
            f"parallel #11 shard ({j // MESH_TIME}, {j % MESH_TIME}) vs "
            f"plain, {C_MAIN // MESH_CHAN} x {N_MAIN // MESH_TIME} int16/2",
            a, b, TOL_F32, per_bin=True))
    del kparts, pparts
    one = fir_periodogram4096(x, G, precision="int16", fir_passes=2)
    for form in ("fused", "ppermute"):
        check(f"parallel sharded {form} vs unsharded #3, {C_MAIN} x {N_MAIN} on "
              f"{MESH_CHAN} x {MESH_TIME} shards", pp[form], one, TOL_SHARD,
              per_bin=True)

    def sharded(xin, prec="int16", passes=2):
        return sharded_fir_periodogram4096(mesh, xin, G, precision=prec,
                                           halo="fused", fir_passes=passes)


    x2 = torch.randint(-2048, 2048, x.shape, generator=gen, device=x.device,
                       dtype=torch.int16)
    check("parallel fused, a second input on the same slots, vs unsharded "
          "#3", sharded(shard(mesh, x2)),
          fir_periodogram4096(x2, G, precision="int16", fir_passes=2),
          TOL_SHARD, per_bin=True)
    del x2
    for i in range(MESH_CHAN):
        for r in mesh.halo_buffers[i].recv:
            r.fill_(SENTINEL_I16)
    check(f"parallel fused, slots filled with {SENTINEL_I16} first, vs "
          f"unsharded #3", sharded(ps["xs"]), one, TOL_SHARD, per_bin=True)
    # bf16 on a mesh of its own (its own slots), poisoned with NaN
    mesh = make_mesh(chan=MESH_CHAN, time=MESH_TIME,
                     devices=[x.device] * (MESH_CHAN * MESH_TIME))
    xb = x[:16].float()
    sharded(shard(mesh, xb), "bf16", 3)          # makes the bf16 slots
    for i in range(MESH_CHAN):
        for r in mesh.halo_buffers[i].recv:
            r.fill_(float("nan"))
    check("parallel fused bf16 (16 ch), slots filled with NaN first, vs "
          "unsharded #3", sharded(shard(mesh, xb), "bf16", 3),
          fir_periodogram4096(xb, G, precision="bf16"), TOL_SHARD,
          per_bin=True)
    mesh = ps["mesh"]
    del xb, one
    torch.cuda.empty_cache()
    ola, iir, xc = ps["ola"], ps["iir"], ps["xc"]
    y1 = ola.step(ola.init_for(xc), xc)[1]
    check(f"parallel sharded_chain OLA stage (#9) vs unsharded, {C_PAR} x "
          f"{xc.shape[1]} complex", torch.view_as_real(
              sharded_chain(mesh, [(ola, ola.V)], xc)),
          torch.view_as_real(y1), TOL_SHARD)
    ref = iir.step(iir.init_for(y1), y1)[1]
    d = (pp["chain"] - ref).abs().max().item()
    ok = bool(torch.isfinite(torch.view_as_real(pp["chain"])).all()) and \
        d < TOL_SHARD_IIR
    print(f"check parallel sharded_chain [OlaFft #9, IirFrame] vs unsharded:"
          f" max_abs_err={d:.6e} tol={TOL_SHARD_IIR:g} (peak "
          f"{ref.abs().max().item():.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("sharded_chain vs unsharded")
    fm, xfm = ps["fm"], ps["xfm"]
    comp = fm.step(fm.init_for(xfm), xfm)[1]
    ys = pp["fm"]
    d = (ys[:, FM_PAR_SKIP:] - comp[:, FM_PAR_SKIP:]).abs().max().item()
    ok = (ys.shape == comp.shape == (C_FM, N_FM // 4)
          and bool(torch.isfinite(ys).all()) and d < TOL_SHARD_FM)
    print(f"check parallel sharded_fm_receiver vs FmReceiver.step, {C_FM} x "
          f"{N_FM}: max_abs_err={d:.6e} after {FM_PAR_SKIP} outputs "
          f"(first {FM_PAR_SKIP}: "
          f"{(ys[:, :FM_PAR_SKIP] - comp[:, :FM_PAR_SKIP]).abs().max().item():.3e})"
          f" tol={TOL_SHARD_FM:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("sharded FM receiver vs unsharded")
    return err


def parallel_timings(ps) -> tuple[dict, dict]:
    """#11 over the 8 shards (one mesh call's launches) beside its plain
    version, the whole sharded call in both forms and the unsharded #3;
    the sharded and unsharded FM step.  #11's bound: #3's at the full
    working set (int16/2: 2 K flop a sample and pass for the FIR on the
    tensor cores, 5 n log2 n + 4 n per frame), plus the pushed tails, each
    read and written once, and the 8 partial spectra written."""
    from libtsd_tpu_torch.ops.kernels.chain import fir_periodogram4096
    from libtsd_tpu_torch.parallel import (sharded_fir_periodogram4096,
                                           sharded_fm_receiver)
    mesh, G, x, xs = ps["mesh"], ps["G"], ps["x"], ps["xs"]
    K = 256
    ms_k = time_ms(lambda: _halo_rows(ps))
    ms_p = time_ms(lambda: _halo_rows(ps, plain=True))
    torch.cuda.empty_cache()
    forms = {f: time_ms(lambda f=f: sharded_fir_periodogram4096(
        mesh, xs, G, precision="int16", halo=f, fir_passes=2))
        for f in ("fused", "ppermute")}
    ms_one = time_ms(lambda: fir_periodogram4096(x, G, precision="int16",
                                                 fir_passes=2))
    P = (G.shape[0] - 1) * 128
    shards = MESH_CHAN * MESH_TIME
    frames = C_MAIN * N_MAIN // NFFT
    bms, by = bound(2 * C_MAIN * N_MAIN + 4 * C_MAIN * NFFT * MESH_TIME
                    + 2 * 2 * C_MAIN * P * (MESH_TIME - 1) + 4 * K,
                    frames * (fft_flops(NFFT) + 4 * NFFT),
                    2 * 2 * K * C_MAIN * N_MAIN)
    fm, xfm = ps["fm"], ps["xfm"]
    fm_sh = time_ms(lambda: sharded_fm_receiver(mesh, fm, xfm), reps=3)
    fm_un = time_ms(lambda: fm.step(fm.init_for(xfm), xfm), reps=3)
    print(f"time parallel #11 fir_periodogram4096_halo: {shards} shards "
          f"{ms_k:.4f} ms ({ms_k / shards:.4f} ms a shard, "
          f"{C_MAIN * N_MAIN / ms_k / 1e3:.1f} Msamples/s), plain "
          f"{ms_p:.4f} ms, bound {bms:.4f} ms by {by}; library call none")
    print(f"time parallel sharded_fir_periodogram4096 int16/2 on "
          f"{MESH_CHAN} x {MESH_TIME}: fused {forms['fused']:.4f} ms, "
          f"ppermute {forms['ppermute']:.4f} ms; unsharded #3 "
          f"{ms_one:.4f} ms")
    print(f"time parallel FM: sharded_fm_receiver {fm_sh:.4f} ms, unsharded "
          f"FmReceiver.step {fm_un:.4f} ms ({C_FM} x {N_FM})")
    extra = {"halo_call_ms": ms_k, "halo_shard_ms": ms_k / shards,
             "plain_ms": ms_p, "fused_ms": forms["fused"],
             "ppermute_ms": forms["ppermute"], "unsharded_ms": ms_one,
             "fm_sharded_ms": fm_sh, "fm_unsharded_ms": fm_un}
    return {"fir_periodogram4096_halo": (ms_k, ms_p, bms, by, None)}, extra


def _events_ms(fn, runs: int = 3) -> float:
    """Median over ``runs`` of one call of fn, CUDA events, after the
    caller's own first run."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


# ------------------------------------------- multiprocess: rows across ranks


def mp_inputs(seed: int, dev) -> dict:
    """The multiprocess phase's global inputs, made on ``dev`` from the
    seed in the same order in the parent and in every worker: the main
    path's working set (C_MAIN x N_MAIN int16) and its G, the sharded
    chain's blocks and input (as ``parallel_setup``), the FM receiver and
    its C_FM x N_FM tones."""
    from libtsd_tpu_torch.models.receivers import FmReceiver, FmReceiverConfig
    from libtsd_tpu_torch.ops.filter_rt import (IirFrame, OlaFft,
                                                fir_toeplitz_mats)
    from libtsd_tpu_torch.ops.fir_design import fir_lowpass
    from libtsd_tpu_torch.ops.iir_design import design_iir
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    h = fir_lowpass(256, 0.2)
    x = torch.randint(-2048, 2048, (C_MAIN, N_MAIN), generator=gen,
                      device=dev, dtype=torch.int16)
    ola = OlaFft.create(fir_lowpass(129, 0.2), engine="cuda", device=dev)
    b, a = design_iir(2, "lp", "butt", 0.1).to_ba()
    w = torch.randn(2, C_PAR, MESH_TIME * HOPS_PAR * ola.Ne, generator=gen,
                    device=dev)
    xfm, _ = fm_signal(gen, dev, C_FM, 0.25)
    G = torch.as_tensor(fir_toeplitz_mats(np.asarray(h, np.float64))
                        .astype(np.float32), device=dev)
    return dict(G=G, x=x, ola=ola, iir=IirFrame.create(b, a, device=dev),
                xc=torch.complex(w[0], w[1]), xfm=xfm,
                fm=FmReceiver.create(FmReceiverConfig(), device=dev))


def _mp_time(fn) -> float:
    """Best of MP_ROUNDS of one call, CUDA events, each after a barrier of
    every rank (the caller's first call warmed up)."""
    import torch.distributed as dist
    best = float("inf")
    for _ in range(MP_ROUNDS):
        torch.cuda.synchronize()
        dist.barrier()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best


def mp_worker(argv: list) -> int:
    """One rank of the multiprocess phase (``launch.spawn`` starts it with
    --coordinator/--nproc/--pid): its own card when there are as many
    cards as ranks, else cuda:0, shared.  It loads the parent's build
    (never builds), runs each layout of MP_LAYOUTS through the port's entry
    points with the launch counts zeroed first, saves its results for the
    parent and prints one ``mp {...}`` line a layout."""
    import torch.distributed as dist
    from libtsd_tpu_torch.ops import kernels
    from libtsd_tpu_torch.ops.kernels import _build
    from libtsd_tpu_torch.ops.kernels import chain_halo as KH
    from libtsd_tpu_torch.parallel import (launch, make_mesh, sharded_chain,
                                           sharded_fir_periodogram4096,
                                           sharded_fm_receiver)
    get = lambda k: argv[argv.index(k) + 1]          # noqa: E731
    nproc, pid = int(get("--nproc")), int(get("--pid"))
    out = get("--mp-out")
    card = pid if torch.cuda.device_count() >= nproc else 0
    if not _build.library_path().exists():
        raise RuntimeError("the parent builds the kernels before the workers")
    launch.initialize(get("--coordinator"), nproc, pid,
                      local_device_ids=[card])
    dev = torch.device("cuda", card)
    inp = mp_inputs(int(get("--seed")), dev)
    G, ola, iir, fm = inp["G"], inp["ola"], inp["iir"], inp["fm"]
    for chan, time_ in MP_LAYOUTS:
        mesh = make_mesh(chan=chan, time=time_)
        link = mesh.links[0]

        def mine(a):
            rs = launch.host_slice(mesh, "chan", a.shape[0])
            ts = launch.host_slice(mesh, "time", a.shape[1])
            return launch.ingest_local(mesh, a[rs, ts])
        xs, xc, xf = mine(inp["x"]), mine(inp["xc"]), mine(inp["xfm"])
        torch.cuda.synchronize()
        dist.barrier()
        kernels.reset_launches()
        res = {f: sharded_fir_periodogram4096(mesh, xs, G, precision="int16",
                                              halo=f, fir_passes=2)
               for f in ("fused", "ppermute")}
        res["chain"] = sharded_chain(mesh, [(ola, ola.V), (iir, 0)], xc)
        res["fm"] = sharded_fm_receiver(mesh, fm, xf)
        torch.cuda.synchronize()
        counts = kernels.launches()
        for r in mesh.halo_buffers[0].recv:
            r.fill_(SENTINEL_I16)
        torch.cuda.synchronize()
        dist.barrier()        # no rank pushes before every slot is filled
        res["fused_poisoned"] = sharded_fir_periodogram4096(
            mesh, xs, G, precision="int16", halo="fused", fir_passes=2)
        ms = {f: _mp_time(lambda f=f: sharded_fir_periodogram4096(
            mesh, xs, G, precision="int16", halo=f, fir_passes=2))
            for f in ("fused", "ppermute")}
        bufs = mesh.halo_buffers[0]
        devs = [x.device for x in xs[0]]

        def order():
            KH._order_before(bufs, devs, 0)
            KH._order_after(bufs, devs, 0)
        order()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(20):
            order()
        torch.cuda.synchronize()
        ms["order"] = (time.perf_counter() - t0) / 20 * 1e3
        grid = {k: {(r, t0_ + j): p.cpu() for r, t0_, row in
                    zip(mesh.rows, mesh.tstart, res[k]) for j, p in
                    enumerate(row)} for k in ("chain", "fm")}
        torch.save({"rows": mesh.rows, **grid,
                    **{k: res[k].cpu() for k in ("fused", "ppermute",
                                                  "fused_poisoned")}},
                   os.path.join(out, f"{chan}x{time_}_{pid}.pt"))
        print("mp " + json.dumps({
            "rank": pid, "layout": f"{chan}x{time_}", "card": card,
            "transport": link.transport if link else "none",
            "launches": {k: counts[k] for k in MP_KERNELS}, "ms": ms}),
            flush=True)
        del xs, xc, xf, res, mesh
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return 0


def multiprocess_phase(seed: int, dev) -> dict:
    """Rows of the mesh across MP_RANKS processes (``parallel.launch``):
    one "time" row across the ranks, then chan 2 x time 2.  The parent
    has built the kernels; it makes the same inputs, computes the
    references on one card (#3 on the whole signal, the unsharded OlaFft
    + IirFrame chain and FmReceiver.step) and the single-controller time
    of both forms on a (1, MP_RANKS) mesh over the ranks' cards, then spawns
    the ranks (one deadline for all, MP_TIMEOUT s) and holds each rank's
    results to the references: the spectra to TOL_SHARD of the peak and
    TOL_BIN a bin (a slot poisoned with SENTINEL_I16 first too), the
    chain and the FM receiver as the parallel phase holds them.  Each
    rank's launch counts of #11, #3 and #9 must be non-zero.  Returns the
    max errors (#11: the fused form, #3: the ppermute form) and the
    times."""
    from libtsd_tpu_torch.ops.kernels import _build
    from libtsd_tpu_torch.ops.kernels.chain import fir_periodogram4096
    from libtsd_tpu_torch.parallel import (launch, make_mesh, shard,
                                           sharded_fir_periodogram4096)
    inp = mp_inputs(seed, dev)
    G, x, ola, iir, fm = (inp[k] for k in ("G", "x", "ola", "iir", "fm"))
    one = fir_periodogram4096(x, G, precision="int16", fir_passes=2)
    xc, xfm = inp["xc"], inp["xfm"]
    chain_ref = ola.step(ola.init_for(xc), xc)[1]
    chain_ref = iir.step(iir.init_for(chain_ref), chain_ref)[1]
    fm_ref = fm.step(fm.init_for(xfm), xfm)[1]
    # one process over the ranks' cards (the same shards, pre-sharded)
    own = torch.cuda.device_count() >= MP_RANKS
    mesh1 = make_mesh(chan=1, time=MP_RANKS, devices=[
        torch.device("cuda", i if own else 0) for i in range(MP_RANKS)])
    xs1 = shard(mesh1, x)
    single = {f: time_ms(lambda f=f: sharded_fir_periodogram4096(
        mesh1, xs1, G, precision="int16", halo=f, fir_passes=2), reps=3)
        for f in ("fused", "ppermute")}
    del mesh1, xs1, inp
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = _build.BUILD_DIR.parent / "chip_smoke" / "mp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    logs = launch.spawn([os.path.abspath(__file__), "--mp-worker", "--seed",
                         str(seed), "--mp-out", str(out)], MP_RANKS,
                        timeout=MP_TIMEOUT)
    print(f"multiprocess: {MP_RANKS} ranks, "
          f"{time.perf_counter() - t0:.1f} s")
    lines = [json.loads(ln[3:]) for log in logs for ln in log.splitlines()
             if ln.startswith("mp {")]
    for log in logs:
        for ln in log.splitlines():
            if ln.startswith(("mp {", "mesh:")):
                print(f"multiprocess {ln}")
    err = {"fir_periodogram4096_halo": 0.0, "fir_periodogram4096": 0.0}
    for ln in lines:
        if any(ln["launches"][k] == 0 for k in MP_KERNELS):
            raise AssertionError(f"multiprocess rank {ln['rank']} layout "
                                 f"{ln['layout']}: launches {ln['launches']}")
    for chan, time_ in MP_LAYOUTS:
        lay = f"{chan}x{time_}"
        got = [torch.load(out / f"{lay}_{p}.pt") for p in range(MP_RANKS)]
        c = C_MAIN // chan
        want = torch.cat([one[r * c:(r + 1) * c] for g in got
                          for r in g["rows"]])
        for form, key in (("fused", "fir_periodogram4096_halo"),
                          ("fused_poisoned", "fir_periodogram4096_halo"),
                          ("ppermute", "fir_periodogram4096")):
            a = torch.cat([g[form] for g in got]).to(dev)
            err[key] = max(err[key], check(
                f"multiprocess {lay} {form} (every rank's rows) vs #3 on the "
                f"whole {C_MAIN} x {N_MAIN} int16/2", a, want, TOL_SHARD,
                per_bin=True))
        for key, ref, tol, skip in (("chain", chain_ref, TOL_SHARD_IIR, 0),
                                    ("fm", fm_ref, TOL_SHARD_FM,
                                     FM_PAR_SKIP)):
            cr, nr = ref.shape[0] // chan, ref.shape[1] // time_
            full = torch.full_like(ref, float("nan"))
            for g in got:
                for (r, t), p in g[key].items():
                    full[r * cr:(r + 1) * cr, t * nr:(t + 1) * nr] = p.to(dev)
            d = (full[:, skip:] - ref[:, skip:]).abs().max().item()
            ok = bool(torch.isfinite(full).all()) and d < tol
            print(f"check multiprocess {lay} {key} vs one process: "
                  f"max_abs_err={d:.6e} after {skip} outputs tol={tol:g} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"multiprocess {lay} {key}")
    worst = {f"{ln['layout']} {k}": max(m["ms"][k] for m in lines
                                        if m["layout"] == ln["layout"])
             for ln in lines for k in ln["ms"]}
    print(f"time multiprocess (slowest rank, best of {MP_ROUNDS}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in worst.items())
          + f"; one process driving the same {MP_RANKS} shards of "
          f"{'a card each' if own else 'one card'}: fused "
          f"{single['fused']:.4f} ms, ppermute {single['ppermute']:.4f} ms")
    shutil.rmtree(out, ignore_errors=True)
    return {"err": err, "ranks": lines, "slowest_ms": worst,
            "single_process_ms": single,
            "transport": sorted({ln["transport"] for ln in lines})}


def sinc_taps64(nc: int, fcut: float, tau: float) -> np.ndarray:
    """Windowed-sinc fractional-delay taps at offset tau, float64, written
    here from the reference's formula (itrp.cc:24-39: the Hann window
    shifted by tau, the taps scaled to a unit sum) so that the config-3
    check holds the resampler's one-cycle matrix, not a copy of it."""
    k = np.arange(nc) - nc // 2 - tau
    h = 2 * fcut * np.sinc(2 * fcut * k) * (0.5 + 0.5 * np.cos(
        k * (2 * np.pi / nc)))
    return h / h.sum()


def resample_phase(gen, dev, card: str, prof_dir=None) -> dict:
    """BASELINE config 3 as a user drives it: ``RationalResampler.create``
    (147/160) and ``Fir.create`` (256-tap lowpass), STEPS_RS chained steps
    of both over one block of C_RS x N_RS complex64 samples made on the
    card (benchmarks/tpu_resample_bench.py steps one block so).  Checks:
    steps 0 and 1 of channels 0-3 against float64 numpy from the sinc
    formula and the same FIR taps (step 1 carries both states), within
    TOL_RS of the peak; ``resample`` of the reference's cfg3 input on the
    card against its output within TOL_GOLDEN_RS (the golden test's trim
    and bound).  Prints input Msamples/s and ms a step (CUDA events over
    the chained steps, after a warm-up run)."""
    from libtsd_tpu_torch.ops.filter_rt import Fir
    from libtsd_tpu_torch.ops.fir_design import fir_lowpass
    from libtsd_tpu_torch.ops.resample import RationalResampler, resample
    rr = RationalResampler.create(RATIO_RS, device=dev)
    h = fir_lowpass(256, 0.2, "hn")
    fir = Fir.create(h, device=dev)
    w = torch.randn(2, C_RS, N_RS, generator=gen, device=dev)
    x = torch.complex(w[0], w[1])
    del w
    nout = N_RS * rr.p // rr.q

    def run(steps):
        srr, sf = rr.init_for(x), fir.init_for(x[..., :nout])
        ys = []
        for _ in range(steps):
            srr, y = rr.step(srr, x)
            sf, y = fir.step(sf, y)
            ys.append(y)
        return ys

    ys = run(STEPS_RS)
    torch.cuda.synchronize()
    if not all(y.shape == (C_RS, nout) and bool(torch.isfinite(
            torch.view_as_real(y)).all()) for y in ys):
        raise AssertionError("config 3: output shape or non-finite values")
    # float64 reference of channels 0-3 over two blocks, built without the
    # program's A: output j of the stream after K zeros reads the K samples
    # from ip_j + 1 on, ip_j = j q // p, with the taps of the phase nearest
    # tau_j = (j q mod p) / p of NPH_RS + 1
    K = NC_RS
    fcut = min(0.4, 0.5 * min(1.0, rr.p / rr.q))
    lut = np.stack([sinc_taps64(K, fcut, k / NPH_RS)
                    for k in range(NPH_RS + 1)])
    j = np.arange(2 * nout)
    ip = j * rr.q // rr.p
    ph = np.rint(((j * rr.q) % rr.p) / rr.p * NPH_RS).astype(np.int64)
    xs = np.tile(x[:4].cpu().numpy().astype(np.complex128), 2)
    xx = np.concatenate([np.zeros((4, K)), xs], axis=1)
    r64 = sum(lut[ph, i] * xx[:, ip + 1 + i] for i in range(K))
    ref = np.stack([np.convolve(v, h)[:r64.shape[1]] for v in r64])
    got = torch.cat([ys[0][:4], ys[1][:4]], dim=1)
    err = check("config3 RationalResampler 147/160 -> Fir 256 taps, steps "
                "0-1, channels 0-3 vs float64 numpy (sinc taps, same FIR)",
                torch.view_as_real(got),
                torch.view_as_real(torch.as_tensor(ref, device=dev)), TOL_RS)
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "golden")
    yg = resample(torch.as_tensor(np.load(os.path.join(gold, "cfg3_x.npy")),
                                  device=dev), RATIO_RS)
    yr = np.load(os.path.join(gold, "cfg3_y.npy"))
    dg = float(np.abs(yg.cpu().numpy()[50:-50] - yr[50:-50]).max())
    ok = yg.shape == yr.shape and dg < TOL_GOLDEN_RS
    print(f"check config3 resample(cfg3_x, 44100/48000) on the card vs the "
          f"reference's cfg3_y: {tuple(yg.shape)} samples, max_abs_err="
          f"{dg:.3e} (50 trimmed at each end) tol={TOL_GOLDEN_RS:g} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("config 3 golden")
    del ys
    ms = _events_ms(lambda: run(STEPS_RS)) / STEPS_RS
    rate = C_RS * N_RS / ms / 1e3
    print(f"time config3 step (RationalResampler + Fir 256, {C_RS} x {N_RS} "
          f"complex64): {ms:.4f} ms a step, {rate:.1f} input Msamples/s "
          f"(median of 3 runs of {STEPS_RS} chained steps; {card})")
    if prof_dir:
        srr, sf = rr.init_for(x), fir.init_for(x[..., :nout])
        profile_windows({"config3_step": lambda: fir.step(
            sf, rr.step(srr, x)[1])}, prof_dir, calls=3)
    return {"ms_per_step": ms, "msamples_per_s": rate, "max_abs_err": err,
            "golden_err": dg, "channels": C_RS, "n": N_RS}


def _hann64(n: int) -> np.ndarray:
    """The periodic Hann window in float64, 0.5 - 0.5 cos(2 pi k / n)."""
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def _rt_spectrum64(blocks, N: int, navg: int, nsubs: int = 1,
                   step: int = 0) -> np.ndarray:
    """The averaged power of RtSpectrum after the given blocks, in float64
    from its formula: a unit-energy Hann window, |FFT|^2 averaged over a
    block's frames (of each capture in a sweep), fftshifted, / N; a sweep
    adds capture i at offset i step and divides by the hits per bin."""
    w = _hann64(N)
    w = w * np.sqrt(N / np.sum(w * w))
    Ns = N + (nsubs - 1) * step
    hits = np.zeros(Ns)
    for i in range(nsubs):
        hits[i * step:i * step + N] += 1
    avg = np.zeros((blocks[0].shape[0], Ns))
    for x in blocks:
        C, n = x.shape
        X = np.fft.fft(x.reshape(C, n // (nsubs * N), nsubs, N) * w, axis=-1)
        Psub = np.fft.fftshift(np.mean(np.abs(X) ** 2, axis=1), axes=-1)
        P = np.zeros((C, Ns))
        for i in range(nsubs):
            P[:, i * step:i * step + N] += Psub[:, i]
        P = P / (np.maximum(hits, 1.0) * N)
        avg = (1 - 1.0 / navg) * avg + P / navg
    return avg


def spectral_phase(gen, dev, card: str, prof_dir=None) -> dict:
    """The spectral layer as a user drives it: ``RtSpectrum`` (N NFFT_SP,
    navg NAVG_SP) over STEPS_SP chained steps of C_SP x N_SP complex64, then
    the sweep form (nsubs NSUBS_SP, sweep_step SWEEP_SP) on the same blocks;
    ``czt`` at n = m = N_CZT on a zoomed spiral contour; ``xcorr`` of two
    N_XC-sample signals; ``periodogram_cqt`` of T_AUDIO s of real audio at
    FS_AUDIO (fmin FMIN_CQT, fmax FMAX_CQT, the default gamma and ofs).
    Checks: both spectra of channels 0-3 after steps 0, 1 and the last
    against float64 numpy from the formula (``_rt_spectrum64``); czt at
    BINS_REF bins and xcorr at BINS_REF lags against float64 direct sums;
    periodogram_cqt against the same call on a CPU copy.  No kernel."""
    from libtsd_tpu_torch.ops import fft as F
    from libtsd_tpu_torch.ops.corr import xcorr
    from libtsd_tpu_torch.ops.psd import periodogram_cqt
    from libtsd_tpu_torch.ops.spectrum import RtSpectrum, SpectrumConfig
    out = {}
    blocks = [torch.complex(*torch.randn(2, C_SP, N_SP, generator=gen,
                                         device=dev))
              for _ in range(STEPS_SP)]
    forms = {"plain": (SpectrumConfig(N=NFFT_SP, navg=NAVG_SP), 1, 0),
             "sweep": (SpectrumConfig(N=NFFT_SP, navg=NAVG_SP,
                                      nsubs=NSUBS_SP, sweep_step=SWEEP_SP),
                       NSUBS_SP, SWEEP_SP)}
    host = [b[:4].cpu().numpy().astype(np.complex128) for b in blocks]
    for form, (cfg, nsubs, step) in forms.items():
        sp = RtSpectrum.create(cfg, device=dev)

        def run(sp=sp):
            st = sp.init()
            states = []
            for b in blocks:
                st, db = sp.step(st, b)
                states.append(st)
            return states, db

        states, db = run()
        torch.cuda.synchronize()
        if db.shape != (C_SP, cfg.Ns) or not bool(torch.isfinite(db).all()):
            raise AssertionError(f"RtSpectrum {form}: shape or non-finite")
        for k in (0, 1, STEPS_SP - 1):
            ref = _rt_spectrum64(host[:k + 1], NFFT_SP, NAVG_SP, nsubs, step)
            out[f"rt_{form}_err"] = check(
                f"spectral RtSpectrum {form} (N {NFFT_SP}, navg {NAVG_SP}, "
                f"nsubs {nsubs}, sweep_step {step}), step {k}, channels "
                f"0-3 vs float64 numpy", states[k][:4],
                torch.as_tensor(ref, device=dev), TOL_SP)
        run()
        ms = _events_ms(run) / STEPS_SP
        rate = C_SP * N_SP / ms / 1e3
        print(f"time spectral RtSpectrum {form} step ({C_SP} x {N_SP} "
              f"complex64): {ms:.4f} ms a step, {rate:.1f} input "
              f"Msamples/s (median of 3 runs of {STEPS_SP} chained steps; "
              f"{card})")
        out[f"rt_{form}"] = {"ms_per_step": ms, "msamples_per_s": rate}
        if prof_dir and form == "plain":
            profile_windows({"rt_spectrum_step": lambda sp=sp: sp.step(
                sp.init(), blocks[0])}, prof_dir, calls=3)
    del blocks

    # czt on a spiral contour: z0 e^{0.3i}, W = e^{-2 pi i 2^-18} (a
    # quarter-band zoom); X[k] = sum_n x[n] z0^-n W^(n k)
    x = torch.complex(*torch.randn(2, N_CZT, generator=gen, device=dev))
    W, z0 = np.exp(-2j * np.pi / (4 * N_CZT)), np.exp(0.3j)
    X = F.czt(x, N_CZT, W=W, z0=z0)
    ks = np.linspace(0, N_CZT - 1, BINS_REF).astype(np.int64)
    xn = x.cpu().numpy().astype(np.complex128)
    nn = np.arange(N_CZT, dtype=np.int64)
    xz = xn * np.exp(-0.3j * nn)
    ref = np.array([np.sum(xz * np.exp(-2j * np.pi * ((nn * k) % (4 * N_CZT))
                                       / (4 * N_CZT))) for k in ks])
    out["czt_err"] = check(
        f"spectral czt n = m = {N_CZT} (z0 e^0.3i, W e^(-2 pi i/{4 * N_CZT}))"
        f" at {BINS_REF} bins vs the float64 direct sum",
        torch.view_as_real(X[torch.as_tensor(ks, device=dev)]),
        torch.view_as_real(torch.as_tensor(ref, device=dev)), TOL_SP)
    ms = time_ms(lambda: F.czt(x, N_CZT, W=W, z0=z0))
    print(f"time spectral czt n = m = {N_CZT} complex64: {ms:.4f} ms, "
          f"{N_CZT / ms / 1e3:.1f} input Msamples/s ({card})")
    out["czt"] = {"ms": ms, "msamples_per_s": N_CZT / ms / 1e3}

    # xcorr of x and a delayed, noisy copy
    xa = torch.complex(*torch.randn(2, N_XC, generator=gen, device=dev))
    ya = 0.5 * torch.roll(xa, 12345) + 0.1 * torch.complex(
        *torch.randn(2, N_XC, generator=gen, device=dev))
    lags, c = xcorr(xa, ya)
    if c.shape != (2 * N_XC - 1,):
        raise AssertionError(f"xcorr shape {tuple(c.shape)}")
    # lags with at least half the signals overlapping, and the peak's
    lk = np.unique(np.r_[np.linspace(-N_XC // 2, N_XC // 2,
                                     BINS_REF).astype(np.int64), -12345])
    xh = xa.cpu().numpy().astype(np.complex128)
    yh = ya.cpu().numpy().astype(np.complex128)

    def lag64(k):        # sum_n x[n] conj(y[n + k]) / overlap
        if k >= 0:
            return np.sum(xh[:N_XC - k] * np.conj(yh[k:])) / (N_XC - k)
        return np.sum(xh[-k:] * np.conj(yh[:N_XC + k])) / (N_XC + k)
    ref = np.array([lag64(int(k)) for k in lk])
    got = c[torch.as_tensor(lk + N_XC - 1, device=dev)]
    out["xcorr_err"] = check(
        f"spectral xcorr of two {N_XC}-sample signals at {len(lk)} lags "
        "(overlap >= 1/2, and the peak) vs float64 direct sums",
        torch.view_as_real(got),
        torch.view_as_real(torch.as_tensor(ref, device=dev)), TOL_SP)
    ms = time_ms(lambda: xcorr(xa, ya))
    print(f"time spectral xcorr 2 x {N_XC} complex64: {ms:.4f} ms, "
          f"{2 * N_XC / ms / 1e3:.1f} input Msamples/s ({card})")
    out["xcorr"] = {"ms": ms, "msamples_per_s": 2 * N_XC / ms / 1e3}
    del x, X, xa, ya, c

    # periodogram_cqt of audio: three tones, a chirp and noise
    n = int(FS_AUDIO * T_AUDIO)
    t = torch.arange(n, device=dev, dtype=torch.float64) / FS_AUDIO
    audio = (0.5 * torch.sin(2 * np.pi * 440.0 * t)
             + 0.3 * torch.sin(2 * np.pi * 2093.0 * t)
             + 0.2 * torch.sin(2 * np.pi * 7040.0 * t)
             + 0.1 * torch.sin(2 * np.pi * (100.0 + 200.0 * t) * t)
             ).float() + 0.01 * torch.randn(n, generator=gen, device=dev)
    del t
    t0 = time.perf_counter()
    tg, fr, A = periodogram_cqt(audio, FS_AUDIO, FMIN_CQT, FMAX_CQT)
    torch.cuda.synchronize()
    s_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    tgh, frh, Ah = periodogram_cqt(audio.cpu(), FS_AUDIO, FMIN_CQT, FMAX_CQT)
    s_cpu = time.perf_counter() - t0
    if not (np.array_equal(tg, tgh) and np.array_equal(fr, frh)
            and np.isfinite(A).all()):
        raise AssertionError("periodogram_cqt: grids or non-finite values")
    out["cqt_err"] = check(
        f"spectral periodogram_cqt {T_AUDIO:g} s at {FS_AUDIO:g} Hz "
        f"({n} samples, {FMIN_CQT:g}-{FMAX_CQT:g} Hz, {A.shape[1]} bins x "
        f"{A.shape[0]} frames) on the card vs the CPU",
        torch.as_tensor(A), torch.as_tensor(Ah), TOL_CQT)
    a4 = int(np.argmin(np.abs(fr - 440.0)))
    if int(np.argmax(A[A.shape[0] // 2])) not in (a4 - 1, a4, a4 + 1):
        raise AssertionError("periodogram_cqt: the 440 Hz tone is not the "
                             "strongest bin")
    t0 = time.perf_counter()           # a second, warm run
    periodogram_cqt(audio, FS_AUDIO, FMIN_CQT, FMAX_CQT)
    ms = 1e3 * min(s_card, time.perf_counter() - t0)
    print(f"time spectral periodogram_cqt {n} samples: {ms:.1f} ms on the "
          f"card (host clock, device work and the host interpolation; "
          f"{n / ms / 1e3:.2f} input Msamples/s; the CPU took "
          f"{1e3 * s_cpu:.0f} ms; {card})")
    out["periodogram_cqt"] = {"ms": ms, "msamples_per_s": n / ms / 1e3,
                              "cpu_ms": 1e3 * s_cpu}
    return out


def rds_phase(dev, card: str, prof_dir=None) -> dict:
    """RDS as a user decodes it: T_RDS s of broadcast FM IF at FE_RDS made
    on the card (stereo tones 440 / 1000 Hz, the pilot, 0A groups carrying
    PS_RDS and 2A groups carrying RT_RDS, repeated; no noise, so nothing is
    drawn from the seed), ``rds_decode`` on the card.  Checks: the decoded
    groups are the transmitted sequence, each with no uncorrected block,
    all but the first (block sync) and the last (cut by the filters'
    delay) of the complete groups on air; the PS name and radiotext read
    back; ``rds_baseband`` of the first N_RDS_CPU IF
    samples on the card against the same call on a CPU copy.  No kernel."""
    from libtsd_tpu_torch.models import rds as R
    from libtsd_tpu_torch.models.analog import (_fm_broadcast_front,
                                                fm_broadcast_multiplex)
    from libtsd_tpu_torch.ops.signal import cycles
    pi, pty = 0xB0C1, 10
    groups = [R.rds_group_0a(pi, pty, s, PS_RDS[2 * s:2 * s + 2])
              for s in range(4)]
    groups += [R.rds_group_2a(pi, pty, a, RT_RDS[4 * a:4 * a + 4])
               for a in range(16)]
    n = int(FE_RDS * T_RDS)
    nbits = int(T_RDS * R._BITRATE)
    reps = -(-nbits // (104 * len(groups)))
    bits = R.rds_encode_groups(groups * reps)
    on_air = nbits // 104                    # complete groups in the signal
    t0 = time.perf_counter()
    al = 0.3 * torch.sin(2 * np.pi * cycles(440.0 / FE_RDS, n, device=dev))
    ar = 0.3 * torch.sin(2 * np.pi * cycles(1000.0 / FE_RDS, n, device=dev))
    x = fm_broadcast_multiplex(al, ar, FE_RDS,
                               rds=R.rds_subcarrier(bits, FE_RDS, n,
                                                    device=dev))
    del al, ar
    torch.cuda.synchronize()
    s_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = R.rds_decode(x, FE_RDS)
    s_dec = time.perf_counter() - t0
    # the decoded groups follow the transmitted sequence: group i is
    # groups[(j0 + i) % len(groups)], j0 from the first clean group
    first = next((i for i, g in enumerate(got) if max(g.errors) == 0), None)
    j0 = None if first is None else next(
        (j - first for j in range(len(groups))
         if got[first].blocks == tuple(groups[j])), None)
    clean = [j0 is not None and min(g.errors) >= 0
             and g.blocks == tuple(groups[(j0 + i) % len(groups)])
             for i, g in enumerate(got)]
    n_ok = clean.index(False) if False in clean else len(clean)
    good = n_ok >= max(len(got) - 1, on_air - 2)
    ps, rt = R.rds_station_name(got), R.rds_radiotext(got)
    print(f"check rds {T_RDS:g} s of FM IF at {FE_RDS / 1e6:g} MHz ({n} "
          f"complex64): {len(got)} groups decoded, the first {n_ok} the "
          f"transmitted sequence with no uncorrected block, of {on_air} "
          f"complete groups on air (tol: all decoded but the last, and at "
          f"least {on_air - 2}: block sync may take the first group, the "
          f"filters' delay the last), "
          f"{sum(e > 0 for g in got for e in g.errors)} blocks corrected, "
          f"PS {ps!r}, radiotext {rt!r} {'ok' if good else 'FAIL'}")
    if not good or ps != PS_RDS or rt != RT_RDS.rstrip():
        raise AssertionError("rds: groups or strings not recovered")
    # rds_baseband on the card vs the CPU, on the first N_RDS_CPU samples
    a3, fech2, _ = _fm_broadcast_front(x[:N_RDS_CPU], FE_RDS)
    yc = R.rds_baseband(a3, fech2)
    yh = R.rds_baseband(a3.cpu(), fech2)
    err = check(f"rds rds_baseband of the first {N_RDS_CPU} IF samples "
                f"({a3.shape[-1]} at {fech2:.1f} Hz) on the card vs the "
                "CPU", yc, yh.to(dev), TOL_RDS)
    ms = 1e3 * s_dec
    print(f"time rds rds_decode {n} complex64 IF samples: {ms:.0f} ms "
          f"(host clock, one run: front end, pilot PLL, baseband on the "
          f"card, decode on the host), {n / ms / 1e3:.2f} input "
          f"Msamples/s; making the IF took {1e3 * s_make:.0f} ms ({card})")
    if prof_dir:
        a3p, f2p, _ = _fm_broadcast_front(x[:N_RDS_PROF], FE_RDS)
        profile_windows({"rds_baseband": lambda: R.rds_baseband(a3p, f2p)},
                        prof_dir, calls=1)
    return {"groups": len(got), "in_sequence": n_ok, "on_air": on_air,
            "decode_ms": ms, "msamples_per_s": n / ms / 1e3,
            "baseband_err": err}


def _channelize64(x: np.ndarray, h: np.ndarray, M: int,
                  chans) -> np.ndarray:
    """Channels ``chans`` of the polyphase-FFT bank in float64 numpy, from
    its definition: y[m, c] = sum_p e^{2 pi i c p / M} sum_j h[j M + p]
    x[(m - j) M - p], x zero before the stream."""
    K = len(h) // M
    m = len(x) // M
    xp = np.concatenate([np.zeros(M * (K + 1), complex), x])
    mm, pp = np.arange(m)[:, None], np.arange(M)[None, :]
    v = np.zeros((m, M), complex)
    for j in range(K):
        v += h[j * M + pp] * xp[(mm - j) * M - pp + M * (K + 1)]
    E = np.exp(2j * np.pi * np.outer(np.arange(M), chans) / M)
    return v @ E


def channelizer_phase(gen, dev, card: str, prof_dir=None) -> dict:
    """The channelizer as a user streams it: ``Channelizer.create(M_CH)``
    (K 8) over STEPS_CH chained steps of N_CH complex64; one-shot
    ``channelize``/``dechannelize`` round trips; the WOLA pair at C_WOLA x
    N_WOLA.  Checks: channels 0-3 of steps 0-1 against float64 numpy
    (``_channelize64``, the prototype from the design function), two
    half-steps against one step, the round trips within the bounds of
    tests/test_advanced.py.  No kernel."""
    from libtsd_tpu_torch.models.channelizer import (
        Channelizer, channelize, dechannelize, wola_analysis,
        wola_synthesis)
    from libtsd_tpu_torch.ops.fir_design import fir_lowpass
    out = {}
    bank = Channelizer.create(M_CH, device=dev)
    blocks = [torch.complex(*torch.randn(2, N_CH, generator=gen, device=dev))
              for _ in range(STEPS_CH)]

    def run():
        st = bank.init()
        ys = []
        for b in blocks:
            st, y = bank.step(st, b)
            ys.append(y)
        return ys

    ys = run()
    torch.cuda.synchronize()
    if not all(y.shape == (N_CH // M_CH, M_CH) and bool(torch.isfinite(
            torch.view_as_real(y)).all()) for y in ys):
        raise AssertionError("channelizer: output shape or non-finite")
    h = fir_lowpass(M_CH * 8, 0.5 / M_CH, "hn") * M_CH
    xs = torch.cat(blocks[:2]).cpu().numpy().astype(np.complex128)
    ref = _channelize64(xs, np.asarray(h, np.float64), M_CH, [0, 1, 2, 3])
    got = torch.cat([ys[0][:, :4], ys[1][:, :4]])
    out["err"] = check(
        f"channelizer M {M_CH} K 8, steps 0-1 ({N_CH} complex64 each), "
        "channels 0-3 vs float64 numpy polyphase-FFT",
        torch.view_as_real(got),
        torch.view_as_real(torch.as_tensor(ref, device=dev)), TOL_CH)
    st = bank.init()
    st, ya = bank.step(st, blocks[0][:N_CH // 2])
    st, yb = bank.step(st, blocks[0][N_CH // 2:])
    check("channelizer two half-steps vs one step",
          torch.view_as_real(torch.cat([ya, yb])),
          torch.view_as_real(ys[0]), TOL_CH)
    del ys, ya, yb
    run()
    ms = _events_ms(run) / STEPS_CH
    rate = N_CH / ms / 1e3
    print(f"time channelizer step (M {M_CH}, K 8, {N_CH} complex64): "
          f"{ms:.4f} ms a step, {rate:.1f} input Msamples/s (median of 3 "
          f"runs of {STEPS_CH} chained steps; {card})")
    out["step"] = {"ms_per_step": ms, "msamples_per_s": rate}
    if prof_dir:
        profile_windows({"channelizer_step": lambda: bank.step(
            bank.init(), blocks[0])}, prof_dir, calls=3)
    # the critically sampled round trip (tests/test_advanced.py:302-323)
    n, d = N_CH, 8 * M_CH
    m = slice(2 * d, n - 3 * d)
    tone = torch.exp(2j * np.pi * (3 / M_CH) * torch.arange(
        n, device=dev, dtype=torch.float64)).to(torch.complex64)
    for name, v, bound in (("channel-centre tone", tone, TOL_DECH_TONE),
                           ("broadband noise", blocks[1], TOL_DECH_BROAD)):
        back = dechannelize(channelize(v, M_CH, bank=bank), M_CH, bank=bank)
        e = (v[:n - d][m] - back[d:][m]).abs().pow(2).mean()
        err = float(torch.sqrt(e / v[:n - d][m].abs().pow(2).mean()))
        print(f"check channelizer dechannelize(channelize()) {name}, M "
              f"{M_CH}: rms_rel_err={err:.3e} tol={bound:g} "
              f"{'ok' if err < bound else 'FAIL'}")
        if not err < bound:
            raise AssertionError("channelizer round trip")
    del blocks, tone
    # the WOLA pair (tests/test_advanced.py:326-345)
    xw = torch.complex(*torch.randn(2, C_WOLA, N_WOLA, generator=gen,
                                    device=dev))
    ch = wola_analysis(xw, M_CH)
    xr = wola_synthesis(ch, M_CH)
    L = min(xr.shape[-1], N_WOLA)
    e0 = 16 * M_CH
    a, b = xw[:, e0:L - e0], xr[:, e0:L - e0]
    err = float(torch.sqrt((a - b).abs().pow(2).mean()
                           / a.abs().pow(2).mean()))
    print(f"check channelizer WOLA round trip C {C_WOLA} M {M_CH} n "
          f"{N_WOLA}: rms_rel_err={err:.3e} tol={TOL_WOLA:g} "
          f"{'ok' if err < TOL_WOLA else 'FAIL'}")
    if not err < TOL_WOLA:
        raise AssertionError("WOLA round trip")
    ms = time_ms(lambda: wola_synthesis(wola_analysis(xw, M_CH), M_CH))
    print(f"time channelizer WOLA round trip C {C_WOLA} M {M_CH} n "
          f"{N_WOLA}: {ms:.4f} ms, {C_WOLA * N_WOLA / ms / 1e3:.1f} "
          f"aggregate input Msamples/s ({card})")
    out["wola"] = {"ms": ms, "msamples_per_s": C_WOLA * N_WOLA / ms / 1e3,
                   "err": err}
    return out


def _hexbits(h: str) -> np.ndarray:
    v = int(h, 16)
    n = 4 * len(h)
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.int8)


def adsb_frames(rng, Ne: int, frame_len: int) -> dict:
    """The squitters on air, {(receiver, block): [(start in block, 112
    bits), ...]}: at most ADSB_PER_BLOCK a block, each in its own quarter
    block and wholly inside it; the published frames first in receiver
    0's block 0, random DF17 payloads with their CRC-24 elsewhere (the
    host encoders, as in the JAX package)."""
    from libtsd_tpu_torch.models.adsb import _crc_bits_np
    q = Ne // ADSB_PER_BLOCK
    out = {}
    for c in range(C_ADSB):
        for b in range(BLOCKS_ADSB):
            first = (c, b) == (0, 0)
            k = (ADSB_PER_BLOCK if first
                 else int(rng.integers(0, ADSB_PER_BLOCK + 1)))
            fr = []
            for j, slot in enumerate(sorted(rng.choice(ADSB_PER_BLOCK, k,
                                                       replace=False))):
                p = int(slot) * q + int(rng.integers(0, q - frame_len - 64))
                if first and j < len(ADSB_PUBLISHED):
                    bits = _hexbits(ADSB_PUBLISHED[j])
                else:
                    bits = rng.integers(0, 2, 112).astype(np.int8)
                    bits[:5] = (1, 0, 0, 0, 1)             # DF17
                    bits[88:] = _crc_bits_np(bits[:88])    # CRC-24 parity
                fr.append((p, bits))
            out[(c, b)] = fr
    return out


def pocsag_transmission(baud: int, seconds: float, rng):
    """One POCSAG transmission of `seconds` carrying pages to several RICs,
    alphanumeric and numeric (a 576-bit preamble, then batches back to back:
    each address codeword in its RIC's frame, its message codewords after
    it, an idle word between pages), as a paging transmitter sends its
    queue.  Returns (bits, [(ric, function, text)], batches)."""
    from libtsd_tpu_torch.models import pocsag as P
    texts = ["CALL DISPATCH 555-0117", "UNIT 12 RESPOND TO STATION 4",
             "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG 0123456789", "OK"]
    nums = ["5551234", "911", "0123 456-789"]
    nb = (int(seconds * baud) - 576) // 544
    cws, pages, i = [], [], 0
    while True:
        ric = int(rng.integers(8, 1 << 21))
        num = i % 3 == 2
        text = nums[i % 3] if num else texts[i % 4]
        fn = int(rng.integers(0, 3)) if num else 3
        one = P.pocsag_encode(ric, fn, text, numeric=num, npreamble=0)
        words = [int("".join(map(str, w)), 2)
                 for w in one[32:].reshape(-1, 32)]
        first = 2 * (ric & 7)
        add = []
        while ((len(cws) + len(add)) % 16) // 2 != (ric & 7):
            add.append(P.IDLE)
        add += [words[first]] + [w for w in words[first + 1:] if w >> 31]
        add.append(P.IDLE)
        if len(cws) + len(add) > 16 * nb:
            break
        cws += add
        pages.append((ric, fn, text))
        i += 1
    cws += [P.IDLE] * (16 * nb - len(cws))
    out = [np.tile([1, 0], 288).astype(np.int8)]
    for b in range(nb):
        out.append(P._word_bits(P.FSC))
        out += [P._word_bits(w) for w in cws[16 * b:16 * (b + 1)]]
    return np.concatenate(out), pages, nb


def pocsag_gapped(baud: int, rng):
    """K_GAP pages as separate transmissions (a preamble each), GAP_POC s
    of carrier off after each, as an occasional pager hears them.  Returns
    (IF samples at FE_POC, [(ric, function, text)], batches)."""
    from libtsd_tpu_torch.models import pocsag as P
    texts = ["CALL DISPATCH 555-0117", "UNIT 12 RESPOND TO STATION 4", "OK"]
    parts, pages, nb = [], [], 0
    for i in range(K_GAP):
        ric = int(rng.integers(8, 1 << 21))
        bits = P.pocsag_encode(ric, 3, texts[i % 3])
        nb += (len(bits) - 576) // 544
        parts.append(P.pocsag_waveform(bits, FE_POC, baud, fi=FI_POC))
        parts.append(np.zeros(int(GAP_POC * FE_POC), np.complex64))
        pages.append((ric, 3, texts[i % 3]))
    return np.concatenate(parts), pages, nb


def page_counts(got, pages):
    """(exact, truncated, spurious, lost): decoded pages equal to a sent
    one, with a sent (RIC, function) and another text, with an unsent
    (RIC, function); sent pages not decoded exactly."""
    sent = {(r, f): t for r, f, t in pages}
    exact = sum(p in pages for p in got)
    trunc = sum((r, f) in sent and t != sent[(r, f)] for r, f, t in got)
    spur = sum((r, f) not in sent for r, f, _ in got)
    return exact, trunc, spur, len(pages) - exact


def pocsag_card_vs_cpu(cfg, z, baud) -> tuple:
    """Decode z on the card and on a CPU copy: the card's pages and baud,
    and whether both decoders agree exactly (pages, baud, and the scan at
    that baud: batch positions, bits, codeword flags)."""
    from libtsd_tpu_torch.models import pocsag as P
    pages, scans = [], []
    for dev in (z.device, torch.device("cpu")):
        pdec = P.PocsagDecoder(cfg, device=dev)
        msgs, got = pdec.decode(z.to(dev), return_baud=True)
        pages.append(([(m.ric, m.function, m.text) for m in msgs], got))
        r = pdec.scan(pdec._front(z.to(dev)), baud)
        scans.append([t.cpu() for t in (r.position, r.bits, r.cw_ok,
                                        r.valid)])
    same = pages[0] == pages[1] and all(
        torch.equal(a, b) for a, b in zip(*scans))
    return pages[0][0], pages[0][1], same


def protocols_phase(seed: int, gen, dev, card: str) -> dict:
    """The protocol decoders as a monitoring station runs them.

    ADS-B: C_ADSB receivers x BLOCKS_ADSB blocks of 65,536 magnitude
    samples made on the card (noise, then DF17 squitters at known
    positions: ``adsb_frames``), ``AdsbDecoder.decode_block`` on (C_ADSB,
    65,536) a call.  Checks: every frame found once at its position with
    its bits and CRC, no other candidate with a good CRC; ``AdsbStream``
    over receiver 0 in the demo's odd-size pushes returns every frame of
    that receiver once at its absolute position; the published even/odd
    pair gives the published CPR fix.

    POCSAG: one T_POC s transmission of pages at each of 512, 1200 and 2400
    baud (``pocsag_transmission``), decoded on the card (1200 with auto
    baud).  Checks: noise-free, every page's RIC, function and text exact
    and nothing else decoded; with IF AWGN POC_NOISE added on the card, the
    card's decode equal to a CPU copy's (pages, baud, the scan's positions,
    bits and flags), 1200 detected; the pages lost to the sync pick at the
    plateau's first index (the JAX decoder's, ROADMAP §3) printed.  Then
    ``pocsag_gapped`` at the same noise, card against CPU, its spurious
    pages printed (a known fault of both packages, ROADMAP §3).  No
    kernel."""
    from libtsd_tpu_torch.models import pocsag as P
    from libtsd_tpu_torch.models.adsb import (AdsbConfig, AdsbDecoder,
                                              AdsbStream, _field,
                                              adsb_waveform, cpr_global)
    rng = np.random.default_rng(seed)
    out = {}
    cfg = AdsbConfig()
    dec = AdsbDecoder(cfg, device=dev)
    Ne, fl = cfg.Ne, dec._frame_len
    frames = adsb_frames(rng, Ne, fl)
    nframes = sum(len(v) for v in frames.values())
    t0 = time.perf_counter()
    x = ADSB_NOISE * torch.randn(C_ADSB, BLOCKS_ADSB * Ne, generator=gen,
                                 device=dev).abs()
    rows, cols, wfs = [], [], []
    for (c, b), fr in frames.items():
        for p, bits in fr:
            rows.append(c)
            cols.append(b * Ne + p)
            wfs.append(adsb_waveform(bits, osf=cfg.osf))
    W = torch.as_tensor(np.stack(wfs), device=dev)
    r = torch.as_tensor(rows, device=dev)[:, None].expand(-1, fl)
    k = (torch.as_tensor(cols, device=dev)[:, None]
         + torch.arange(fl, device=dev))
    x.index_put_((r, k), ADSB_AMP * W, accumulate=True)
    torch.cuda.synchronize()
    s_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = [dec.decode_block(x[:, b * Ne:(b + 1) * Ne])
           for b in range(BLOCKS_ADSB)]
    host = [torch.cat([d.position.reshape(C_ADSB, -1).float(),
                       d.crc_ok.float(), d.valid.float(),
                       d.bits.reshape(C_ADSB, -1).float()], 1).cpu().numpy()
            for d in res]
    s_dec = time.perf_counter() - t0
    K = cfg.max_frames
    missing = wrong = false_ok = noise_cand = 0
    for b, h in enumerate(host):
        pos, ok, val = h[:, :K].astype(int), h[:, K:2 * K] > 0, \
            h[:, 2 * K:3 * K] > 0
        bits = h[:, 3 * K:].astype(np.int8).reshape(C_ADSB, K, 112)
        for c in range(C_ADSB):
            got = {int(pos[c, j]): bits[c, j] for j in range(K)
                   if val[c, j] and ok[c, j]}
            want = dict(frames[(c, b)])
            missing += sum(p not in got for p in want)
            wrong += sum(p in got and not np.array_equal(got[p], want[p])
                         for p in want)
            false_ok += sum(p not in want for p in got)
            noise_cand += int((val[c] & ~ok[c]).sum())
    good = missing == wrong == false_ok == 0
    print(f"check protocols ADS-B monitor {C_ADSB} receivers x "
          f"{BLOCKS_ADSB} blocks of {Ne} (fe {cfg.fe:g}, threshold "
          f"{cfg.threshold}, max_frames {K}), {nframes} DF17 squitters: "
          f"{missing} missed, {wrong} with wrong bits, {false_ok} other "
          f"candidates with a good CRC (tol: 0, 0, 0); {noise_cand} "
          f"candidates rejected by the CRC {'ok' if good else 'FAIL'}")
    if not good:
        raise AssertionError("ADS-B monitor")
    xb = x[:, :Ne]
    ms = time_ms(lambda: dec.decode_block(xb))
    rate = C_ADSB * Ne / ms / 1e3
    print(f"time protocols ADS-B decode_block ({C_ADSB}, {Ne}) float32: "
          f"{ms:.4f} ms a call, {rate:.1f} input Msamples/s; all "
          f"{BLOCKS_ADSB} blocks with their host reads {1e3 * s_dec:.0f} "
          f"ms (host clock); making the input {1e3 * s_make:.0f} ms ({card})")
    out["adsb"] = {"frames": nframes, "ms_per_call": ms,
                   "msamples_per_s": rate, "blocks_ms": 1e3 * s_dec}
    # the streaming sink over receiver 0, pushed as an SDR delivers
    x0 = x[0].cpu().numpy()
    del x, res, xb
    st = AdsbStream(cfg, device=dev)
    got, i = [], 0
    t0 = time.perf_counter()
    while i < len(x0):
        n = int(min(len(x0) - i, 3000 + 500 * (i % 3)))
        got += st.push(x0[i:i + n])
        i += n
    got += st.flush()
    s_stream = time.perf_counter() - t0
    want = {b * Ne + p: bits for b in range(BLOCKS_ADSB)
            for p, bits in frames[(0, b)]}
    gp = sorted(f.position for f in got)
    ok = (gp == sorted(want) and all(np.array_equal(f.bits, want[f.position])
                                     for f in got))
    print(f"check protocols AdsbStream receiver 0, {len(x0)} samples in "
          f"pushes of 3000-4000: {len(got)} frames, each once at its "
          f"absolute position with its bits, of {len(want)} on air "
          f"{'ok' if ok else 'FAIL'}; {1e3 * s_stream:.0f} ms (host "
          f"clock, {len(x0) / s_stream / 1e6:.2f} Msamples/s)")
    if not ok:
        raise AssertionError("AdsbStream")
    cpr = {}
    for f in got:
        if 9 <= _field(f.bits, 32, 37) <= 18 and \
                _field(f.bits, 8, 32) == 0x40621D:
            cpr[int(f.bits[53])] = (_field(f.bits, 54, 71),
                                    _field(f.bits, 71, 88))
    fix = (cpr_global(*cpr[0], *cpr[1], newest_odd=False)
           if len(cpr) == 2 else None)
    ident = any("ident KLM1023" in f.text for f in got)
    ok = (fix is not None and ident
          and max(abs(fix[0] - CPR_FIX[0]), abs(fix[1] - CPR_FIX[1]))
          < TOL_CPR)
    print(f"check protocols CPR fix of the published even/odd pair: "
          f"{fix}, published {CPR_FIX}, tol={TOL_CPR:g} deg; ident "
          f"KLM1023 read {ident} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ADS-B CPR fix or ident")
    out["adsb"]["stream_ms"] = 1e3 * s_stream
    # POCSAG at each baud, 1200 with auto detection
    out["pocsag"] = {}
    for baud in (512, 1200, 2400):
        bits, pages, nb = pocsag_transmission(baud, T_POC, rng)
        z = torch.as_tensor(P.pocsag_waveform(bits, FE_POC, baud,
                                              fi=FI_POC), device=dev)
        auto = baud == 1200
        cfg = P.PocsagConfig(fe=FE_POC, fi=FI_POC,
                             debit=-1 if auto else baud, max_batches=nb + 8)
        pdec = P.PocsagDecoder(cfg, device=dev)
        clean, got_clean = pdec.decode(z, return_baud=True)
        clean = [(m.ric, m.function, m.text) for m in clean]
        w = torch.randn(2, z.shape[0], generator=gen, device=dev)
        z = z + POC_NOISE * torch.complex(w[0], w[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pdec.decode(z, return_baud=True)
        s = time.perf_counter() - t0
        gm, got_baud, same = pocsag_card_vs_cpu(cfg, z, baud)
        n_ok, n_tr, n_sp, n_lost = page_counts(gm, pages)
        n_clean = sum(a == b for a, b in zip(clean, pages))
        ok = (clean == pages and got_clean == baud and same
              and got_baud == baud)
        print(f"check protocols POCSAG {baud} baud{' (auto)' if auto else ''}"
              f", {z.shape[0] / FE_POC:.2f} s at fe {FE_POC:g} fi "
              f"{FI_POC:g} ({nb} batches, max_batches {nb + 8}), "
              f"{len(pages)} pages: noise-free {n_clean} of {len(pages)} "
              f"exact (tol: all, nothing else); IF AWGN "
              f"{POC_NOISE}: card {'=' if same else '!='} CPU copy (tol: "
              f"pages, baud, scan positions, bits, flags exact), baud "
              f"{got_baud} {'ok' if ok else 'FAIL'}; {n_ok} exact, {n_tr} "
              f"truncated, {n_sp} spurious, {n_lost} not read exactly (the "
              f"plateau pick, ROADMAP §3); decode {1e3 * s:.0f} ms (host "
              f"clock, {z.shape[0] / s / 1e6:.2f} Msamples/s)")
        if not ok:
            raise AssertionError(f"POCSAG {baud}")
        out["pocsag"][baud] = {"pages": len(pages), "batches": nb,
                               "decode_ms": 1e3 * s, "exact": n_ok,
                               "truncated": n_tr, "spurious": n_sp}
    # separate transmissions with carrier-off gaps
    zg, pages, nb = pocsag_gapped(1200, rng)
    z = torch.as_tensor(zg, device=dev)
    w = torch.randn(2, z.shape[0], generator=gen, device=dev)
    z = z + POC_NOISE * torch.complex(w[0], w[1])
    cfg = P.PocsagConfig(fe=FE_POC, fi=FI_POC, debit=1200,
                         max_batches=nb + 8)
    gm, _, same = pocsag_card_vs_cpu(cfg, z, 1200)
    n_ok, n_tr, n_sp, n_lost = page_counts(gm, pages)
    print(f"check protocols POCSAG 1200 baud, {K_GAP} transmissions with "
          f"{GAP_POC:g} s carrier-off gaps, {z.shape[0] / FE_POC:.2f} s, IF "
          f"AWGN {POC_NOISE} ({nb} batches, max_batches {nb + 8}): card "
          f"{'=' if same else '!='} CPU copy (tol: exact) "
          f"{'ok' if same else 'FAIL'}; {n_ok} of {len(pages)} exact, {n_tr} "
          f"truncated, {n_sp} spurious pages (the gaps' noise passes the "
          f"sync gate, ROADMAP §3)")
    if not same:
        raise AssertionError("POCSAG gapped")
    out["pocsag"]["gapped"] = {"pages": len(pages), "exact": n_ok,
                               "truncated": n_tr, "spurious": n_sp}
    return out


def link_phase(gen, dev, card: str) -> dict:
    """The channel in front of a BER sweep, at the QAM phase's working set:
    C_LINK x N_LINK complex64 QAM-16 from the port's modulator.

    Checks: ``propagation_channel`` at EBN0_CLEAN (frequency and phase
    offset, fractional clock delay) against float64 numpy of the same
    formula on channels 0-7; at EBN0_NOISY with phase noise, the noise
    variance against the formula's (the common phase walk estimated over
    the channels); ``dispersive_channel``: Rayleigh power and envelope,
    Rice LOS share, the Doppler band; ``fhss_modulate`` at N_FHSS against
    float64's exact phase; ``MatznerTracker`` over the noisy output against
    a float64 numpy recursion; ``LmsEqualizer`` (DFE, DEC) on N_LMS QPSK
    symbols through a 3-tap channel against the same steps on a CPU copy,
    with no decision error after LMS_SKIP.  No kernel."""
    from libtsd_tpu_torch.models import waveform as W
    from libtsd_tpu_torch.models.bitstream import randbits
    from libtsd_tpu_torch.models.channel import (ChannelConfig,
                                                 dispersive_channel,
                                                 propagation_channel)
    from libtsd_tpu_torch.models.equalizer import LmsEqualizer
    from libtsd_tpu_torch.models.modulator import ModConfig, Modulator
    from libtsd_tpu_torch.models.snr import MatznerTracker
    from libtsd_tpu_torch.models.spread import fhss_modulate
    from libtsd_tpu_torch.ops.signal import cycles
    out = {}
    wf = W.wf_qam(16, W.PulseShape.rcs(0.25), device=dev)
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0), device=dev)
    total = C_LINK * N_LINK
    x, _ = mod.modulate(randbits(gen, total))
    x = x[:total].reshape(C_LINK, N_LINK)
    # the deterministic path at Eb/N0 200 dB (sigma ~ 1e-10)
    cfg = ChannelConfig(fe=1.0, fsymb=0.25, fbit=1.0, Eb_N0=EBN0_CLEAN,
                        freq_offset=0.01, phase_offset=0.7, clock_delay=0.37)
    y = propagation_channel(gen, x, cfg)
    torch.cuda.synchronize()
    ms = time_ms(lambda: propagation_channel(gen, x, cfg), reps=3)
    x8 = x[:8].cpu().numpy().astype(np.complex128)
    z = x8 * np.exp(1j * (0.7 + 2 * np.pi * 0.01 * np.arange(N_LINK)))
    zp = np.zeros((8, 2 * N_LINK), complex)
    h0 = N_LINK // 2
    zp[:, h0:h0 + N_LINK] = z
    kf = np.fft.fftfreq(2 * N_LINK)
    ref = np.fft.ifft(np.fft.fft(zp) * np.exp(-2j * np.pi * kf * 0.37))[
        :, h0:h0 + N_LINK]
    out["ecp_err"] = check(
        f"link propagation_channel ({C_LINK}, {N_LINK}) QAM-16 at Eb/N0 "
        f"{EBN0_CLEAN:g} dB, freq 0.01, phase 0.7, clock delay 0.37: "
        "channels 0-7 vs float64 numpy", torch.view_as_real(y[:8]),
        torch.view_as_real(torch.as_tensor(ref, device=dev)), TOL_ECP)
    print(f"time link propagation_channel ({C_LINK}, {N_LINK}): {ms:.4f} ms,"
          f" {total / ms / 1e3:.1f} Msamples/s ({card})")
    out["ecp_ms"] = ms
    del y, zp, ref
    # the noisy pass with phase noise: the walk is common to the channels
    cfg2 = ChannelConfig(fe=1.0, fsymb=0.25, fbit=1.0, Eb_N0=EBN0_NOISY,
                         freq_offset=0.01, phase_offset=0.7,
                         phase_noise_db_hz=PN_DB_HZ)
    y2 = propagation_channel(gen, x, cfg2)
    xr = x * torch.exp(1j * (0.7 + 2 * np.pi * cycles(0.01, N_LINK,
                                                      device=dev)))
    walk = torch.sum(y2 * xr.conj(), dim=0)
    walk = walk / walk.abs()
    res = y2 - xr * walk
    var = float(res.abs().pow(2).mean())
    level2 = float(x.abs().pow(2).mean())
    var_f = 2 * level2 * 0.5 * (cfg2.fe / cfg2.fbit) / 10 ** (EBN0_NOISY / 10)
    step = torch.angle(walk[1:] * walk[:-1].conj())
    pn_f = np.sqrt(10 ** (PN_DB_HZ / 10) * cfg2.fe)
    ok = abs(var / var_f - 1) < TOL_NOISE_VAR
    print(f"check link propagation_channel at Eb/N0 {EBN0_NOISY:g} dB, phase "
          f"noise {PN_DB_HZ:g} dBc/Hz: noise variance {var:.6e} vs the "
          f"formula's {var_f:.6e} (rel {var / var_f - 1:+.2e}, tol "
          f"{TOL_NOISE_VAR:g}); phase steps std {float(step.std()):.5f} "
          f"rad vs {pn_f:.5f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("link noise variance")
    out["noise_var_rel"] = var / var_f - 1
    del res, xr, walk
    # Rayleigh and Rice fading
    one = torch.ones(N_FADE, dtype=torch.complex64, device=dev)
    h = dispersive_channel(gen, one, FD_FADE, 1.0)
    p2 = float(h.abs().pow(2).mean())
    kurt = float(h.abs().pow(4).mean()) / p2 ** 2
    H = torch.fft.fft(h).abs().pow(2)
    f = torch.fft.fftfreq(N_FADE, device=dev).abs()
    leak = float(H[f > 1.05 * FD_FADE].sum() / H.sum())
    hr = dispersive_channel(gen, one, FD_FADE, 1.0, rice_factor=RICE_K)
    los = float(hr.mean().abs().pow(2) / hr.abs().pow(2).mean())
    los_f = RICE_K / (RICE_K + 1)
    ok = (abs(p2 - 1) < TOL_FADE and abs(kurt - 2) < 0.1
          and leak < 1e-6 and abs(los / los_f - 1) < TOL_FADE)
    print(f"check link dispersive_channel n {N_FADE} fd {FD_FADE}: Rayleigh "
          f"power {p2:.6f} (tol 1 +- {TOL_FADE}), E|h|^4/E|h|^2^2 "
          f"{kurt:.4f} (2 +- 0.1), energy beyond 1.05 fd {leak:.2e} (tol "
          f"1e-6); Rice K {RICE_K:g} LOS share {los:.5f} vs {los_f:.5f} "
          f"(rel tol {TOL_FADE}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("link fading statistics")
    del one, h, hr, H, f
    # FHSS with the exact int32 phase at a length a float32 ramp loses
    hops = torch.randint(0, NF_FHSS, (97,), generator=gen, device=dev)
    hop = hops.cpu().numpy().astype(np.int64)
    ones = torch.ones(N_FHSS, dtype=torch.complex64, device=dev)
    yf = fhss_modulate(ones, hops, SLOT_FHSS, NF_FHSS)
    cyc = (torch.angle(yf).double() / (2 * np.pi)).cpu().numpy()
    kk = np.arange(N_FHSS, dtype=np.int64)
    hs = np.repeat(hop[np.arange(N_FHSS // SLOT_FHSS) % len(hop)],
                   SLOT_FHSS).astype(np.int64)
    exact = ((hs * kk) % NF_FHSS) / NF_FHSS
    d = np.abs((cyc - exact + 0.5) % 1.0 - 0.5).max()
    naive = np.abs(((hs / NF_FHSS).astype(np.float32) * kk.astype(
        np.float32) % 1.0 - exact + 0.5) % 1.0 - 0.5).max()
    ok = d < TOL_FHSS
    print(f"check link fhss_modulate n {N_FHSS}, {NF_FHSS} frequencies: phase "
          f"vs float64 exact max {d:.3e} cycles, tol={TOL_FHSS:g} (a float32 "
          f"f*k ramp: {naive:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("FHSS phase")
    del ones, yf
    # Matzner over the whole noisy output
    tr = MatznerTracker(0.1, clamp=True, device=dev)
    _, (S, N) = tr.step(tr.init(), y2)
    ms = time_ms(lambda: tr.step(tr.init(), y2), reps=3)
    a2 = y2.abs().pow(2).double().cpu().numpy()
    e2 = np.zeros(C_LINK)
    e4 = np.zeros(C_LINK)
    E2 = np.empty_like(a2)
    E4 = np.empty_like(a2)
    for i in range(N_LINK):
        e2 = 0.9 * e2 + 0.1 * a2[:, i]
        e4 = 0.9 * e4 + 0.1 * a2[:, i] ** 2
        E2[:, i], E4[:, i] = e2, e4
    S2_64 = np.maximum(2 * E2 * E2 - E4, 0.0)
    S, N = S.double(), N.double()
    err = max(check("link MatznerTracker(clamp) S^2 = max(2 e2^2 - e4, 0) "
                    f"over ({C_LINK}, {N_LINK}) vs float64 numpy",
                    S * S, torch.as_tensor(S2_64, device=dev), TOL_MATZNER),
              check("link MatznerTracker S + N = e2 vs float64 numpy",
                    S + N, torch.as_tensor(E2, device=dev), TOL_MATZNER))
    out["matzner_err"] = err
    print(f"time link MatznerTracker ({C_LINK}, {N_LINK}): {ms:.4f} ms, "
          f"{total / ms / 1e3:.1f} Msamples/s ({card})")
    del y2, S, N, a2, E2, E4, S2_64
    # the DFE on one channel of QPSK through a 3-tap ISI channel
    wq = W.wf_qpsk(W.PulseShape.nrz(), device=dev)
    idx = torch.randint(0, 4, (N_LMS,), generator=gen, device=dev)
    sym = wq.symbols[idx]
    isi = torch.as_tensor([1.0, 0.35 - 0.2j, 0.12j], dtype=torch.complex64,
                          device=dev)
    xi = (isi[0] * sym + isi[1] * torch.cat([sym[:1] * 0, sym[:-1]])
          + isi[2] * torch.cat([sym[:2] * 0, sym[:-2]]))
    wn = torch.randn(2, N_LMS, generator=gen, device=dev) * 0.02
    xi = xi + torch.complex(wn[0], wn[1])
    kw = dict(structure="dfe", errf="dec", alpha=0.01, N1=11, N2=7)
    eq = LmsEqualizer(wq, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, (ye, _, _) = eq.step(eq.init(), xi)
    torch.cuda.synchronize()
    s_lms = time.perf_counter() - t0
    eqh = LmsEqualizer(W.wf_qpsk(W.PulseShape.nrz(), device="cpu"), **kw)
    t0 = time.perf_counter()
    _, (yh, _, _) = eqh.step(eqh.init(), xi.cpu())
    s_lms_cpu = time.perf_counter() - t0
    dlms = float((ye.cpu() - yh).abs().max())
    syms = wq.symbols
    dec = syms[torch.argmin((ye[:, None] - syms).abs(), dim=1)]
    delay = kw["N1"] // 2
    nerr = int((dec[LMS_SKIP + delay:] - sym[LMS_SKIP:N_LMS - delay]).abs()
               .gt(1e-3).sum())
    ok = dlms < TOL_LMS and nerr == 0
    print(f"check link LmsEqualizer DFE DEC N1 11 N2 7, {N_LMS} QPSK symbols"
          f" through [1, 0.35-0.2j, 0.12j]: card vs CPU max |dy| {dlms:.3e} "
          f"tol={TOL_LMS:g}; {nerr} decision errors after symbol {LMS_SKIP} "
          f"(tol 0) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("LMS equalizer")
    print(f"time link LmsEqualizer step: {1e3 * s_lms / N_LMS:.4f} ms a "
          f"symbol on the card, {1e3 * s_lms_cpu / N_LMS:.4f} on one CPU "
          f"copy (host clock, a Python loop of device ops; {card})")
    out["lms_ms_per_symbol"] = 1e3 * s_lms / N_LMS
    out["lms_cpu_ms_per_symbol"] = 1e3 * s_lms_cpu / N_LMS
    return out


def estimation_phase(seed: int, gen, dev, card: str) -> dict:
    """The estimators: examples/doa_demo.py's two scenes at its own size,
    made on the card; MUSIC over N_PSDSS samples; a Kalman filter over
    N_KALMAN steps, the Kitagawa EKF over N_EKF, the IMU EKF over N_IMU.
    Checks: smoothed MUSIC within TOL_DOA_DEG of both sources, the demo's
    MDL counts, the spectra on the card against a CPU copy; the Kalman
    filter against float64 numpy; EKF steps from the card's states on a
    CPU copy; the IMU filter on K_IMU draws at once, against a CPU copy,
    tracking the attitude (tests/test_advanced.py:64's bound) and beating
    dead reckoning (tests/test_advanced.py:85's comparison, of the mean
    tail error over the draws).  No kernel."""
    from libtsd_tpu_torch.models import doa as D
    from libtsd_tpu_torch.models import imu as I
    from libtsd_tpu_torch.models import kalman as KF
    from libtsd_tpu_torch.models.stats import (mdl_source_count,
                                               psd_subspace,
                                               subspace_spectrum)
    from libtsd_tpu_torch.ops.filter_rt import _fp32_matmul
    from libtsd_tpu_torch.ops.rng import randcn
    from libtsd_tpu_torch.ops.signal import top_k_stable
    out = {}
    k = torch.arange(M_DOA, device=dev)

    def steer(deg):
        return torch.exp(2j * np.pi * D_DOA * np.cos(np.deg2rad(deg)) * k
                         ).to(torch.complex64)

    for coherent in (False, True):
        name = "coherent" if coherent else "incoherent"
        c1, c2 = randcn(gen, T_DOA), randcn(gen, T_DOA)
        if coherent:
            a = steer(DOA_DEG[0]) + 0.8 * np.exp(0.7j) * steer(DOA_DEG[1])
            X = a[:, None] * c1[None]
        else:
            X = (steer(DOA_DEG[0])[:, None] * c1[None]
                 + steer(DOA_DEG[1])[:, None] * c2[None])
        X = X + 0.1 * randcn(gen, M_DOA, T_DOA)
        with _fp32_matmul():
            R = X @ X.conj().T / T_DOA
        Rs = D.spatial_smoothing(R, L_DOA)
        t0 = time.perf_counter()
        ang = D.musicdoa_1d(Rs, D_DOA, 2, Nf=NF_DOA)
        torch.cuda.synchronize()
        s_music = time.perf_counter() - t0
        deg = np.sort(np.rad2deg(ang.cpu().numpy()))
        counts = (mdl_source_count(R, T_DOA)[0],
                  mdl_source_count(Rs, T_DOA)[0])
        want = (1, 2) if coherent else (2, 2)
        err = np.abs(deg - np.asarray(DOA_DEG)).max()
        same = all(torch.equal(f(Rx, D_DOA, 2, Nf=NF_DOA).cpu(),
                               f(Rx.cpu(), D_DOA, 2, Nf=NF_DOA))
                   for f in (D.musicdoa_1d, D.capondoa_1d)
                   for Rx in (R, Rs))
        ok = err < TOL_DOA_DEG and counts == want and same
        print(f"check estimation DOA {name} scene (M {M_DOA}, d {D_DOA}, L "
              f"{L_DOA}, T {T_DOA}, Nf {NF_DOA}): smoothed MUSIC {deg} deg, "
              f"max err {err:.3f} (tol {TOL_DOA_DEG:g}); MDL raw/smoothed "
              f"{counts} (want {want}); MUSIC and Capon angles on the card "
              f"= the CPU copy's: {same} {'ok' if ok else 'FAIL'}; MUSIC "
              f"{1e3 * s_music:.1f} ms (host clock)")
        if not ok:
            raise AssertionError(f"DOA {name}")
        for Rx, tag in ((R, "raw"), (Rs, "smoothed")):
            check(f"estimation capon_spectrum {name} {tag} Nf {NF_DOA}, "
                  "card vs CPU", D.capon_spectrum(Rx, D_DOA, NF_DOA)[1],
                  D.capon_spectrum(Rx.cpu(), D_DOA, NF_DOA)[1].to(dev),
                  TOL_DOA_SPEC)
        sc = subspace_spectrum(Rs, 2, NF_DOA)[1].double()
        sh = subspace_spectrum(Rs.cpu(), 2, NF_DOA)[1].double().to(dev)
        check(f"estimation MUSIC subspace_spectrum {name} smoothed: noise "
              "projection 10^(-dB/10), card vs CPU", 10 ** (-sc / 10),
              10 ** (-sh / 10), TOL_DOA_SPEC)
    # the line spectrum of three tones
    kk = torch.arange(N_PSDSS, device=dev, dtype=torch.float64)
    xs = (torch.exp(2j * np.pi * 0.1 * kk)
          + 0.5 * torch.exp(-2j * np.pi * 0.23 * kk)
          + 0.3 * torch.exp(2j * np.pi * 0.31 * kk)).to(torch.complex64)
    xs = xs + 0.3 * randcn(gen, N_PSDSS)
    t0 = time.perf_counter()
    grid, sp = psd_subspace(xs, 3, NF_DOA, M_PSDSS)
    torch.cuda.synchronize()
    s_ps = time.perf_counter() - t0
    _, sph = psd_subspace(xs.cpu(), 3, NF_DOA, M_PSDSS)
    check(f"estimation psd_subspace {N_PSDSS} samples, m {M_PSDSS}, Nf "
          f"{NF_DOA}: noise projection, card vs CPU",
          10 ** (-sp.double() / 10), 10 ** (-sph.double().to(dev) / 10),
          TOL_DOA_SPEC)
    peak = (sp > torch.roll(sp, 1)) & (sp >= torch.roll(sp, -1))
    top = np.sort(grid[top_k_stable(torch.where(peak, sp, sp.min()), 3)[1]]
                  .cpu().numpy())
    want = np.array([-0.31, -0.1, 0.23])
    ok = np.abs(top - want).max() <= 1.0 / NF_DOA
    print(f"check estimation psd_subspace: its three highest peaks at "
          f"{top} (the tones at 0.1, -0.23, 0.31 mirrored by the "
          f"reference's conjugate xcorr: {want} +- 1 bin) "
          f"{'ok' if ok else 'FAIL'}; {1e3 * s_ps:.1f} ms (host clock)")
    if not ok:
        raise AssertionError("psd_subspace peak")
    # Kalman over a random walk, against float64 numpy
    q, rr = 0.01, 1.0
    walk = torch.cumsum(np.sqrt(q) * torch.randn(N_KALMAN, generator=gen,
                                                 device=dev), 0)
    ys = (walk + np.sqrt(rr) * torch.randn(N_KALMAN, generator=gen,
                                           device=dev))[:, None]
    ssm = KF.ssm_random_walk(q, rr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xk, _ = KF.kalman_filter(ssm, ys)
    torch.cuda.synchronize()
    s_k = time.perf_counter() - t0
    yh = ys[:, 0].double().cpu().numpy()
    x64, P64, ref = 0.0, 1.0, np.empty(N_KALMAN)
    for i in range(N_KALMAN):
        Pp = P64 + q
        g = Pp / (Pp + rr)
        x64 = x64 + g * (yh[i] - x64)
        P64 = (1 - g) * Pp
        ref[i] = x64
    out["kalman_err"] = check(
        f"estimation kalman_filter random walk {N_KALMAN} steps vs float64 "
        "numpy", xk[:, 0], torch.as_tensor(ref, device=dev), TOL_KALMAN)
    # the Kitagawa EKF: observations from the host's seeded numpy
    rng = np.random.default_rng(seed)
    xt, yk = 0.1, []
    for i in range(N_EKF):
        xt = (0.5 * xt + 25 * xt / (1 + xt * xt) + 8 * np.cos(1.2 * i)
              + np.sqrt(10) * rng.standard_normal())
        yk.append(xt * xt / 20 + rng.standard_normal())
    yk = torch.as_tensor(np.asarray(yk, np.float32), device=dev)
    f, g = KF.kitagawa_model()
    Q, Rm, x0 = np.diag([10.0, 0.0]), np.eye(1), np.array([0.1, 0.0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xe, Pe = KF.ekf_filter(f, g, Q, Rm, yk, x0=x0)
    torch.cuda.synchronize()
    s_e = time.perf_counter() - t0
    xe_h, Pe_h, yk_h = xe.cpu(), Pe.cpu(), yk.cpu()
    worst = 0.0
    for i in range(50, N_EKF, 50):
        a, _ = KF.ekf_filter(f, g, Q, Rm, yk_h[i:i + 1], x0=xe_h[i - 1],
                             P0=Pe_h[i - 1])
        worst = max(worst, float(((a[0] - xe_h[i]).abs()
                                  / xe_h.abs().amax(0)).max()))
    xfull, _ = KF.ekf_filter(f, g, Q, Rm, yk_h, x0=x0)
    drift = float(((xfull - xe_h).abs() / xe_h.abs().amax(0)).max())
    ok = worst < TOL_EKF_STEP
    print(f"check estimation ekf_filter Kitagawa {N_EKF} steps: one CPU step"
          f" from the card's state at every 50th step vs the card's next "
          f"state, max {worst:.3e} of each component's peak, tol="
          f"{TOL_EKF_STEP:g} {'ok' if ok else 'FAIL'} (the whole CPU "
          f"trajectory drifts {drift:.3e} from the card's: this EKF "
          f"amplifies last-bit differences)")
    if not ok:
        raise AssertionError("EKF")
    # the IMU EKF (tests/test_advanced.py:67-85's model and gates) on K_IMU
    # draws: one draw's dead reckoning can beat the filter by luck (its
    # random walk wanders back), so the comparison is of the mean over them
    m = I.ImuModel(dt=0.01, gyro_noise=0.02, accel_noise=0.05,
                   mag_noise=0.05)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sims = [I.imu_simulate(m, gen, N_IMU) for _ in range(K_IMU)]
    torch.cuda.synchronize()
    s_sim = (time.perf_counter() - t0) / K_IMU
    qs, gyro, obs = (torch.stack(v) for v in zip(*sims))
    t0 = time.perf_counter()
    qh = torch.func.vmap(lambda g, o: I.imu_ekf(m, g, o))(gyro, obs)
    torch.cuda.synchronize()
    s_imu = time.perf_counter() - t0
    qc = I.imu_ekf(m, gyro[0].cpu(), obs[0].cpu())
    out["imu_err"] = check(f"estimation imu_ekf {N_IMU} steps, {K_IMU} draws"
                           f" at once on the card vs draw 0 alone on the CPU",
                           qh[0], qc.to(dev), TOL_IMU)
    # dead reckoning on the host: each draw's gyro integrated alone
    fv = torch.func.vmap(m.f)
    gh = gyro.cpu()
    q = torch.as_tensor([1.0, 0, 0, 0]).repeat(K_IMU, 1)
    dr = []
    for i in range(N_IMU):
        q = fv(q, gh[:, i])
        dr.append(q)
    dr = torch.stack(dr, 1)

    def qerr(a):
        t = qs.cpu()
        d = torch.minimum((t - a).norm(dim=-1), (t + a).norm(dim=-1))
        return d[:, N_IMU // 2:].mean(dim=1).double().numpy()
    e_ekf, e_dr = qerr(qh.cpu()), qerr(dr)
    ok = e_ekf.max() < TOL_IMU_TRACK and e_ekf.mean() < e_dr.mean()
    print(f"check estimation imu_ekf mean attitude error over steps "
          f"{N_IMU // 2}-{N_IMU}, {K_IMU} draws: EKF {e_ekf.mean():.6f} "
          f"(worst draw {e_ekf.max():.6f}, tol={TOL_IMU_TRACK:g}) against "
          f"dead reckoning {e_dr.mean():.6f} (tol: below it), ratio "
          f"{e_ekf.mean() / e_dr.mean():.4f} {'ok' if ok else 'FAIL'}; per "
          f"draw {' '.join(f'{r:.3f}' for r in e_ekf / e_dr)}, EKF better on "
          f"{int((e_ekf < e_dr).sum())} of {K_IMU} (tests/test_advanced.py:85"
          f" asks one draw for under 0.5)")
    if not ok:
        raise AssertionError("IMU EKF tracking")
    out["imu_track"] = {"ekf": e_ekf.tolist(), "dead_reckoning": e_dr.tolist()}
    per = {"kalman": 1e3 * s_k / N_KALMAN, "ekf": 1e3 * s_e / N_EKF,
           "imu_simulate": 1e3 * s_sim / N_IMU,
           f"imu_ekf ({K_IMU} draws at once)": 1e3 * s_imu / N_IMU}
    print("time estimation loops, ms a step (host clock, Python loops of "
          "device ops): " + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
          + f" ({card})")
    out["ms_per_step"] = per
    return out


def examples_phase(dev, card: str) -> dict:
    """The port's examples as a user runs them: each twin's ``main`` on the
    card, with the twin's own asserts (qam_serving: every channel's tail
    EVM < 0.2, no bit error on the sampled channels; serving_loop: every
    payload without a bit error, a bit-identical resume; iq_stream_demo:
    peak within 1e-3 of DC, rejection > 40 dB; fm_demo: corr > 0.97 each
    station; doa_demo: angles within 1 degree, MDL (2, 2) and (1, 2)), then
    what the twins do not check themselves: qam_serving's engine
    ("cuda-fused", #6) at C_QAM_SERVE channels; serving_loop's detections
    on the kernel engines (#9 "cuda", #10 "cuda-fused") against the plain
    "torch" engine's at the same granularity Ne on the same capture (the
    same stream samples and payload bits, scores within TOL_DET); fm_demo's
    Welch PSD (#4) against the same function on the CPU route on the same
    band, in linear power, within TOL_F32 of its peak; protocols_demo's
    decodes (the three published squitters at their positions with good
    CRCs, the CPR fix within TOL_CPR, the POCSAG page exact at 1200 baud,
    the RDS PS name and RadioText exact); ber_sweep's Eb/N0 points
    BER_GATED (gated) and BER_UNGATED at NBITS_BER bits.  Prints each
    twin's numbers and wall time (host clock)."""
    from libtsd_tpu_torch.examples import (ber_sweep, doa_demo, fm_demo,
                                           iq_stream_demo, protocols_demo,
                                           qam_serving, serving_loop)
    from libtsd_tpu_torch.ops.kernels import _build
    from libtsd_tpu_torch.ops.psd import psd_welch
    tmp = _build.BUILD_DIR.parent / "chip_smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    print(f"examples on {card}")
    out, wall = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        print(f"time examples {name}: {wall[name]:.2f} s (host clock)")
        out[name] = ({k: v for k, v in r.items()
                      if k not in ("detections", "psd_db")}
                     if isinstance(r, dict) else r)
        return r

    def gate(ok: bool, line: str) -> None:
        print(f"check examples {line} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"examples: {line}")

    for C in C_QAM_SERVE:
        r = run(f"qam_serving C {C}", lambda C=C: qam_serving.main(C, dev))
        gate(r["engine"] == "cuda-fused",
             f"qam_serving C {C}: engine {r['engine']}, tail EVM mean "
             f"{r['evm_mean']:.4f} max {r['evm_max']:.4f}, "
             f"{r['bit_errors']} bit errors on {min(C, 4)} channels, first "
             f"step {r['step_ms']:.2f} ms")
    sl = {}
    for eng in DET_ENGINES:
        sl[eng] = run(f"serving_loop {eng}",
                      lambda eng=eng: serving_loop.main(eng, dev))
    for eng in DET_ENGINES[1:]:
        k = sl[eng]
        t = run(f"serving_loop torch Ne {k['ne']}",
                lambda ne=k["ne"]: serving_loop.main("torch", dev, ne))
        a, b = t["detections"], k["detections"]
        same = (t["block_len"] == k["block_len"]
                and [p for p, _, _ in a] == [p for p, _, _ in b]
                and all(np.array_equal(x, y)
                        for (_, _, x), (_, _, y) in zip(a, b)))
        ds = max((abs(x - y) for (_, x, _), (_, y, _) in zip(a, b)),
                 default=0.0)
        gate(same and ds < TOL_DET,
             f"serving_loop {eng} (#{9 if eng == 'cuda' else 10}) vs torch "
             f"at Ne {k['ne']}, block {k['block_len']}: {len(b)} and "
             f"{len(a)} detections, the same stream samples and payload bits"
             f" {same}, max |dscore| {ds:.3e} (tol {TOL_DET:g})")
    for eng, r in sl.items():
        at = [p for p, _, _ in r["detections"]]
        low = [(p, round(x, 4)) for p, x, _ in r["detections"] if x < 0.6]
        print(f"examples serving_loop {eng}: Ne {r['ne']}, block "
              f"{r['block_len']}, {len(at)} frames detected, "
              f"{r['payloads']}/{serving_loop.NFRAMES} payloads, "
              f"{r['bit_errors']} bit errors, {r['false_alarms']} false "
              f"alarms, {r['msamples_per_s']:.3f} Msamp/s; detections at "
              f"{at}, those under 0.6 {low}")
    r = run("iq_stream_demo", lambda: iq_stream_demo.main(dev))
    print(f"examples iq_stream_demo: peak {r['peak']:+.5f}, rejection "
          f"{r['rejection_db']:.1f} dB, FirDecim step "
          f"{r['firdecim_ms']:.3f} ms")
    r = run("fm_demo", lambda: fm_demo.main(dev, str(tmp / "fm_demo"),
                                            report=False))
    print(f"examples fm_demo: corr {[round(c, 4) for c in r['corr']]}, PSD "
          f"peak {r['psd_peak']:+.4f}")
    band = fm_demo.synth_band(fm_demo.N, dev)[0].cpu()
    check(f"examples fm_demo psd_welch(band, {fm_demo.NPSD}) (#4) vs the "
          "CPU route on the same band, linear power",
          10 ** (torch.as_tensor(r["psd_db"]).double() / 10),
          10 ** (psd_welch(band, fm_demo.NPSD)[1].double() / 10), TOL_F32)
    r = run("protocols_demo", lambda: protocols_demo.main(dev))
    pos = [p for p, _, _ in r["adsb"]]
    fix = r["cpr"]
    cpr_err = (max(abs(a - b) for a, b in zip(fix, CPR_FIX))
               if fix else float("inf"))
    gate(pos == sorted(protocols_demo.ADSB_FRAMES)
         and all(c for _, _, c in r["adsb"]) and "KLM1023" in r["adsb"][0][1]
         and cpr_err < TOL_CPR,
         f"protocols_demo ADS-B: frames at {pos}, CRCs "
         f"{[c for _, _, c in r['adsb']]}, CPR fix {fix} err {cpr_err:.2e} "
         f"deg (tol {TOL_CPR:g})")
    gate(r["pocsag"] == [protocols_demo.POCSAG_PAGE] and r["baud"] == 1200,
         f"protocols_demo POCSAG: {r['pocsag']} at {r['baud']} baud")
    rd = r["rds"]
    gate(rd["ps"] == "TSD TPU!" and rd["rt"] == "TPU NATIVE DSP!",
         f"protocols_demo RDS ({rd['samples']} IF samples): {rd['groups']} "
         f"groups, {rd['clean']} clean, PS {rd['ps']!r}, RadioText "
         f"{rd['rt']!r}")
    r = run("doa_demo", lambda: doa_demo.main(dev))
    print(f"examples doa_demo: MDL {r['mdl']}, smoothed MUSIC "
          f"{r['music_deg']} deg")
    print(f"examples ber_sweep: reduced depth, one Eb/N0 a waveform and "
          f"{NBITS_BER} bits (the demo sweeps 11 points of 16384 bits): "
          "the clock-recovery loop runs one Python loop step a sample")
    wfs = dict(ber_sweep.waveforms(dev))
    pts = [(k, v[0]) for k, v in BER_GATED.items()] + list(
        BER_UNGATED.items())
    rows = run("ber_sweep", lambda: [
        (k, s, ber_sweep.measure_ber(wfs[k], s, NBITS_BER, 1000),
         float(wfs[k].ber(s))) for k, s in pts])
    for name, s, b, t in rows:
        if name in BER_GATED:
            f = BER_GATED[name][1]
            gate(b < f * t + BER_FLOOR,
                 f"ber_sweep {name} {s:g} dB: measured {b:.3e} < {f:g} x "
                 f"theory {t:.3e} + {BER_FLOOR:g}")
        else:
            print(f"examples ber_sweep {name} {s:g} dB: measured {b:.3e}, "
                  f"theory {t:.3e} (ungated)")
    out["wall_s"] = wall
    return out


def profile(mp, out_dir: str) -> None:
    """Optional phase: torch.profiler over 5 back-to-back calls of the
    fused int16/2 chain (with G's checked taps cached, as a caller gets
    them, and with the cache emptied before each call, as every call was
    before the cache), of the composed path (Fir.step -> #2) and of the
    main path's ``psd_welch`` (#4 on 8188 segments), after a warm-up, at
    the main path's shapes.  Prints, per window, the device's busy time
    (union of kernel, copy and fill intervals), its idle share of the span
    from the first to the last device interval, and the kernels that take
    most of the busy time."""
    from libtsd_tpu_torch.ops import psd
    from libtsd_tpu_torch.ops.kernels import chain
    from libtsd_tpu_torch.ops.kernels.chain import fir_periodogram4096
    from libtsd_tpu_torch.ops.kernels.periodogram import periodogram4096_acc
    x, G, fir, y4 = mp["x"], mp["G"], mp["fir"], mp["y"][:4]

    def uncached():
        chain._taps_cache.clear()
        return fir_periodogram4096(x, G, precision="int16", fir_passes=2)

    profile_windows({
        "fused_int16_2": lambda: fir_periodogram4096(
            x, G, precision="int16", fir_passes=2),
        "fused_int16_2_uncached": uncached,
        "composed": lambda: periodogram4096_acc(
            fir.step(fir.init_for(x), x)[1]),
        "psd_welch": lambda: psd.psd_welch(y4, NFFT),
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
                    help="also profile the fused and composed main path, "
                         "one step of each QAM and frame-receiver engine, "
                         "the FM chain, both sharded chain forms and the "
                         "config-3 chain; chrome traces go into DIR")
    if "--mp-worker" in sys.argv:       # a rank of the multiprocess phase
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return mp_worker(sys.argv)
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

    t_phase = time.perf_counter()
    kernels.reset_launches()
    wg0 = kernels.chain.fir_periodogram4096.wg_launches
    mp = main_path(h, gen, dev)
    launches = {k: v for k, v in kernels.launches().items()
                if k in PATH_KERNELS["main"]}
    print(f"launches #3 on the main path: "
          f"{launches['fir_periodogram4096']}, of which on the wgmma body "
          f"(wg_launches): "
          f"{kernels.chain.fir_periodogram4096.wg_launches - wg0}")
    for k, d in main_path_checks(mp).items():
        errs[k] = max(errs[k], d)
    t = timings(h, mp, dev)
    extra = main_bounds_and_library(h, mp, dev)
    welch_t = welch_timings(dev)
    if args.profile:
        profile(mp, args.profile)
    del mp
    torch.cuda.empty_cache()

    print(f"phase main: {time.perf_counter() - t_phase:.1f} s")

    # the QAM-16 receive path (kernels #5 and #6)
    t_phase = time.perf_counter()
    wf, bits, xq = qam_signal(gen, dev)
    kernels.reset_launches()
    qp = qam_path(wf, xq, dev)
    launches.update({k: v for k, v in kernels.launches().items()
                     if k in PATH_KERNELS["qam"]})
    errs.update(qam_checks(wf, bits, xq, qp))
    qam_step_checks(xq, qp)
    tq = qam_timings(xq, qp)
    tq.update(welch_t)
    if args.profile:
        xb = xq[:, :N_QAM]
        profile_windows({
            f"qam_{eng}": (lambda r=r: r["dd"].step(r["states"][0], xb))
            for eng, r in qp.items()}, args.profile, calls=3)

    del xq, qp
    torch.cuda.empty_cache()
    print(f"phase qam: {time.perf_counter() - t_phase:.1f} s")

    # the frame receiver (kernels #9 and #10)
    t_phase = time.perf_counter()
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
    del sig, rxs, fp
    torch.cuda.empty_cache()
    print(f"phase frame: {time.perf_counter() - t_phase:.1f} s")

    # the FM receiver (kernel #8), then a second pass at channel_freq 0.22
    t_phase = time.perf_counter()
    xfm, fa = fm_signal(gen, dev, C_FM, 0.25)
    kernels.reset_launches()
    fmp = fm_path(xfm, 0.25, dev)
    launches.update({k: v for k, v in kernels.launches().items()
                     if k in PATH_KERNELS["fm"]})
    errs["fm_chain"] = fm_checks(fmp, xfm, fa, "f0 0.25")
    tfm, fm_step_ms = fm_timings(fmp)
    tq.update(tfm)
    if args.profile:
        xr, xi, fc, rx = fmp["xr"], fmp["xi"], fmp["fc"], fmp["rx"]
        profile_windows({
            "fm_fused": lambda: fc(xr, xi, tb=TB_FM),
            "fm_composed": lambda: rx.step(rx.init_for(xfm), xfm)},
            args.profile, calls=3)
    del xfm, fmp
    torch.cuda.empty_cache()
    x22, fa22 = fm_signal(gen, dev, C_FM22, 0.22)
    errs["fm_chain"] = max(errs["fm_chain"], fm_checks(
        fm_path(x22, 0.22, dev), x22, fa22, "f0 0.22"))
    del x22
    torch.cuda.empty_cache()
    print(f"phase fm: {time.perf_counter() - t_phase:.1f} s")

    # the IIR cascade (kernel #7)
    t_phase = time.perf_counter()
    kernels.reset_launches()
    ip = iir_phase(gen, dev)
    launches.update({k: v for k, v in kernels.launches().items()
                     if k in PATH_KERNELS["iir"]})
    errs["iir_cascade"] = iir_checks(ip)
    tq.update(iir_timings(ip))
    del ip
    torch.cuda.empty_cache()
    print(f"phase iir: {time.perf_counter() - t_phase:.1f} s")

    # the parallel layer (kernel #11; #3 and #9 under the mesh)
    t_phase = time.perf_counter()
    ps = parallel_setup(h, gen, dev)
    kernels.reset_launches()
    wg0 = kernels.chain_halo.fir_periodogram4096_halo.wg_launches
    pp = parallel_path(ps)
    counts = kernels.launches()
    launches.update({k: counts[k] for k in PATH_KERNELS["parallel"]})
    shards = MESH_CHAN * MESH_TIME
    print("launches (parallel path): " + json.dumps(
        {k: counts[k] for k in PATH_KERNELS["parallel"] + PARALLEL_ALSO})
        + ", #11 on the wgmma body (wg_launches): "
        f"{kernels.chain_halo.fir_periodogram4096_halo.wg_launches - wg0}")
    if counts["fir_periodogram4096_halo"] != shards or any(
            counts[k] == 0 for k in PARALLEL_ALSO):
        raise AssertionError(f"parallel path launches {counts}: want "
                             f"{shards} of #11 and #3, #9 under the mesh")
    errs["fir_periodogram4096_halo"] = parallel_checks(ps, pp, gen)
    del pp
    torch.cuda.empty_cache()
    tpar, par_extra = parallel_timings(ps)
    tq.update(tpar)
    if args.profile:
        from libtsd_tpu_torch.parallel import sharded_fir_periodogram4096
        profile_windows({
            f"parallel_{f}": (lambda f=f: sharded_fir_periodogram4096(
                ps["mesh"], ps["xs"], ps["G"], precision="int16", halo=f,
                fir_passes=2)) for f in ("fused", "ppermute")},
            args.profile, calls=3)
    del ps
    torch.cuda.empty_cache()
    print(f"phase parallel: {time.perf_counter() - t_phase:.1f} s")

    # rows across processes (#11 through IPC-mapped slots; #3 and #9
    # under the mesh): each worker zeroes its counts before its run
    t_phase = time.perf_counter()
    mp = multiprocess_phase(args.seed, dev)
    for k, v in mp["err"].items():
        errs[k] = max(errs[k], v)
    torch.cuda.empty_cache()
    print(f"phase multiprocess: {time.perf_counter() - t_phase:.1f} s")

    # the QAM-16 modem, __graft_entry__.entry() (no kernel)
    t_phase = time.perf_counter()
    modem = modem_phase(args.seed, dev)
    print(f"phase modem: {time.perf_counter() - t_phase:.1f} s")

    # BASELINE config 3, the rational resampler (no kernel)
    t_phase = time.perf_counter()
    cfg3 = resample_phase(gen, dev, card, args.profile)
    torch.cuda.empty_cache()
    print(f"phase config3: {time.perf_counter() - t_phase:.1f} s")

    # the spectral layer, the channelizer and RDS (no kernel): each runs
    # with the counts at 0 and prints them after
    later = {}
    for name, fn in (("spectral", lambda: spectral_phase(
                          gen, dev, card, args.profile)),
                     ("channelizer", lambda: channelizer_phase(
                         gen, dev, card, args.profile)),
                     ("rds", lambda: rds_phase(dev, card, args.profile)),
                     ("protocols", lambda: protocols_phase(
                         args.seed, gen, dev, card)),
                     ("link", lambda: link_phase(gen, dev, card)),
                     ("estimation", lambda: estimation_phase(
                         args.seed, gen, dev, card)),
                     ("examples", lambda: examples_phase(dev, card))):
        t_phase = time.perf_counter()
        kernels.reset_launches()
        later[name] = fn()
        counts = {k: v for k, v in kernels.launches().items() if v}
        want = PATH_KERNELS.get(name, ())
        print(f"launches ({name} path{'' if want else ', no kernel'}): "
              + json.dumps(counts))
        if any(k not in counts for k in want):
            raise AssertionError(f"the {name} path launched no "
                                 f"{[k for k in want if k not in counts]}")
        torch.cuda.empty_cache()
        print(f"phase {name}: {time.perf_counter() - t_phase:.1f} s")

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
    shares = [(r["name"], r["ms"], r["plain_ms"], r["bound_ms"],
               r["bound_by"], r["library_ms"]) for r in rows]
    shares.insert(2, (PG_ONE, *t[PG_ONE][:2], *extra[PG_ONE]))
    for name, k, p, bms, by, lib in shares:
        print(f"share {name}: kernel {k:.4f} ms, bound {bms:.4f} ms by {by}"
              f" = {100 * bms / k:.1f} % of the bound; plain {p:.4f} ms; "
              "library " + ("none" if lib is None else f"{lib:.4f} ms"))
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
                                      for e, v in fsteps.items()},
                       "fm_step": {"composed_ms": fm_step_ms,
                                   "channels": C_FM, "n": N_FM},
                       "modem": modem, "parallel": par_extra,
                       "multiprocess": {k: v for k, v in mp.items()
                                        if k != "err"},
                       "config3": cfg3, **later},
                      f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
