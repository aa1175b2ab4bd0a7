"""Hand-written CUDA kernels for Hopper (sm_90a), one module per kernel,
each beside its plain PyTorch version.  Sources are in ``libtsd_tpu_torch/
csrc``; ``_build`` compiles them with nvcc at first use.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.  Each wrapper counts its launches in a plain
integer attribute, ``wrapper.launches``.
"""
from . import (chain, chain_halo, demod_sb, detfront, fft, fir,  # noqa: F401
               fm, iir, ola, periodogram, welch)

WRAPPERS = {
    "fir": fir.fir_kernel,
    "periodogram4096": periodogram.periodogram4096_acc,
    "fir_periodogram4096": chain.fir_periodogram4096,
    "fft_pow2": fft.fft_pow2,
    "demod_sb": demod_sb.demod_sb,
    "demod_sb_fused": demod_sb.demod_sb_fused_step,
    "ola": ola.ola_stream,
    "detfront": detfront.detfront,
    "iir_cascade": iir.iir_cascade,
    "fm_chain": fm.fm_chain,
    "fir_periodogram4096_halo": chain_halo.fir_periodogram4096_halo,
    "welch_frames": welch.welch_frames,
    "welch_power": welch.welch_power,
}


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def launches() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}
