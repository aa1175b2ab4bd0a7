"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all of them at
once, and the objects are linked into ONE shared library with a plain C
interface, loaded with ``ctypes``.  The library lives under
``build/libtsd_tpu_torch/`` at the root of the checkout (``.gitignore``
lists ``build/``); its file name carries a hash of the sources and flags,
so an edit rebuilds.  It is built at first use, never at import.

Each kernel's registers and spills, as ``nvcc -Xptxas -v`` reports them,
are kept in a log beside the library (:func:`ptxas_registers`).

A missing ``nvcc`` or a failed build raises: there is no fallback.  Every C
entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises if that is not 0.  Pointers and the stream are passed
as ``ctypes.c_void_p`` (a bare Python int would be cut to 32 bits).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "libtsd_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

SMEM_MAX = 227 * 1024   # dynamic shared memory one block may use on sm_90

P = ctypes.c_void_p
PP = ctypes.POINTER(ctypes.c_void_p)
I = ctypes.c_int
I64 = ctypes.c_longlong
U32 = ctypes.c_uint
F32 = ctypes.c_float
F64 = ctypes.c_double

# C entry points: name -> argument types (every one returns cudaError_t)
SIGNATURES = {
    "fir_f32": [P, P, P, I64, I, P],
    "periodogram4096_f32": [P, P, P, I, I64, P],
    "fir_periodogram4096": [P, P, P, P, P, I, I, I64, I, I, I, I, P],
    "fft_pow2_f32": [P, P, P, P, P, I, I, I, P],
    "demod_sb_f32": [P, I64, P, P, P, I, P, P, P, I, I, I, I, I, I, I, I, I,
                     F32, F32, F32, F32, I, I, P],
    "demod_sb_fused_f32": [P, P, I, P, I, P, P, P, I, P, P, I, I, I, I, I, I,
                           I, I, I, I, F32, F32, F32, F32, F32, I, I, I, P,
                           P, P, I, P],
    "ola_f32": [P, P, P, P, P, I, I64, I, I, P],
    "detfront_f32": [P, P, P, P, P, P, P, I, I, I, I, P],
    "iir_cascade_f32": [P, P, P, P, P, P, P, P, I, I64, I, P, U32, P],
    "fm_chain_f32": [P, P, P, P, P, I, I64, I, I, F64, F32, F32, F32, F32, P],
    "fir_periodogram4096_halo": [P, P, P, P, P, P, P, P, P, I, I, I64, I, I,
                                 I, I, I, I64, U32, P],
    "chain_halo_enable_peer": [I, I],
    "chain_halo_ipc_alloc": [I, I64, PP, P],
    "chain_halo_ipc_open": [I, P, PP],
    "chain_halo_ipc_close": [I, P],
    "chain_halo_ipc_free": [I, P],
    "welch_frames_f32": [P, P, P, P, I, I64, I, I, I, P],
    "welch_power_f32": [P, P, P, P, I, I, I, I, I, P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        p = Path(home) / "bin" / "nvcc"
        cand = str(p) if p.exists() else None
    if cand is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
            "cannot be built; CUDA tensors have no other path")
    return cand


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libtsd_kernels_{_digest()}.so"


def log_path() -> Path:
    """The compiler's report (``-Xptxas -v``) of the library's build."""
    return library_path().with_suffix(".log")


def _run(cmds: list) -> str:
    """Run the commands all at once; raise on the first that fails.
    Returns their joined output."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    outs, failed = [], None
    for c, p in procs:
        out = p.communicate()[0]
        outs.append(out)
        if p.returncode != 0 and failed is None:
            failed = (c, p.returncode, out)
    if failed:
        c, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(c)}\n{out}")
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile the sources into the hashed .so unless it already exists:
    one nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        log = _run([[nvcc, *compile_flags, "-Xptxas", "-v", "-c", "-o",
                     str(o), str(s)] for s, o in zip(srcs, objs)])
        log += _run([[nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]])
        logtmp = log_path().with_name(f"{log_path().name}.{os.getpid()}")
        logtmp.write_text(log)
        os.replace(logtmp, log_path())
        os.replace(tmp, out)   # atomic: concurrent builders never see a partial
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    if verbose:
        print(log)
    return out


def ptxas_registers() -> dict:
    """{mangled kernel name: (registers, spill store bytes)} from the build
    log of the current sources (empty if the library was built without
    one)."""
    if not log_path().exists():
        return {}
    out, name, spill = {}, None, 0
    for line in log_path().read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = (int(m.group(1)), spill)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = cdll
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def use_plain(t: torch.Tensor) -> bool:
    """Route of a wrapper: True for a CPU tensor (the plain PyTorch
    version), False for a CUDA tensor (the kernel, or an error).  Any other
    device raises: a kernel never falls back to a slower path."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
