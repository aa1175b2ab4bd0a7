"""LFSR / PRBS generation, self-synchronizing receiver, MLS & Barker codes
(PyTorch), ported from ``libtsd_tpu/models/lfsr.py``.

Parity: core/src/telecom/prbs.cc (LFSRGenerateur :87-180, LFSRRecepteur
:180-280, code_mls :66-86, Barker codes), core/include/tsd/telecom/lfsr.hpp.

The register recurrences are tiny sequential host work, run in numpy as the
JAX package runs them; the codes are returned as tensors on ``device``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import as_tensor, device as _device, real_dtype

__all__ = ["primitive_poly", "lfsr_bits", "mls_code", "barker_code",
           "prbs_check"]

# maximal-period tap masks for the Fibonacci right-shift recurrence
# reg' = (reg >> 1) | (parity(reg & mask) << (n-1)): the reference's masks
# (prbs.cc:pols_prim | 1, the implicit x^n term), so code_mls is
# bit-identical to the reference binary's (tests/test_golden_ref3.py)
_PRIMITIVE = {
    2: 3, 3: 5, 4: 9, 5: 9, 6: 33, 7: 65, 8: 113, 9: 33, 10: 129,
    11: 513, 12: 801, 13: 5633, 14: 43, 15: 16385, 16: 45,
}

_BARKER = {
    2: [1, -1], 3: [1, 1, -1], 4: [1, 1, -1, 1], 5: [1, 1, 1, -1, 1],
    7: [1, 1, 1, -1, -1, 1, -1], 11: [1, 1, 1, -1, -1, -1, 1, -1, -1, 1, -1],
    13: [1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1],
}


def primitive_poly(reglen: int) -> int:
    """Primitive polynomial tap mask for a register of length reglen."""
    if reglen not in _PRIMITIVE:
        raise ValueError(f"no primitive polynomial stored for reglen={reglen}")
    return _PRIMITIVE[reglen]


def lfsr_bits(reglen: int, nbits: int, seed: int = 1, pol: int = 0,
              device="cuda") -> torch.Tensor:
    """A PRBS from a Fibonacci LFSR (parity: LFSRGenerateur::step,
    prbs.cc:104-130: feedback = parity(reg & pol), output = feedback,
    reg = (reg >> 1) | (feedback << (reglen-1))), int8 on ``device``."""
    dev = _device(device)
    if pol == 0:
        pol = primitive_poly(reglen)
    reg = seed & ((1 << reglen) - 1)
    if reg == 0:
        reg = 1
    bits = np.empty(nbits, np.int8)
    for i in range(nbits):
        s = bin(reg & pol).count("1") & 1
        bits[i] = s
        reg = (reg >> 1) | (s << (reglen - 1))
    return torch.as_tensor(bits, device=dev)


def mls_code(reglen: int, device="cuda") -> torch.Tensor:
    """Maximum-length sequence of length 2^reglen - 1 (parity: code_mls,
    prbs.cc:66-86, LSB output convention), int8 on ``device``."""
    dev = _device(device)
    m = (1 << reglen) - 1
    pol = primitive_poly(reglen)
    bits = []
    reg = 1
    for _ in range(m):
        s = bin(reg & pol).count("1") & 1
        bits.append(reg & 1)          # POIDS_FAIBLE output
        reg = (reg >> 1) | (s << (reglen - 1))
    return torch.as_tensor(np.asarray(bits, np.int8), device=dev)


def barker_code(n: int, device="cuda") -> torch.Tensor:
    """Barker code of length n in +-1 (parity: code_Barker), float32 on
    ``device``."""
    if n not in _BARKER:
        raise ValueError(f"no Barker code of length {n}")
    return torch.as_tensor(_BARKER[n], dtype=real_dtype,
                           device=_device(device))


def prbs_check(bits, reglen: int, pol: int = 0,
               device="cuda") -> Tuple[float, int]:
    """Self-synchronizing PRBS error check: seed the register from the
    received bits themselves, then compare predicted and received bits
    (parity: LFSRRecepteur, prbs.cc:180-280).  Returns (ber, nerrs) over
    the bits after the sync preamble.

    The receiver injects the RECEIVED bit, so its register before bit i is
    bits[i - reglen : i] (newest at the MSB) whatever came before: every
    prediction is one masked parity of a window, computed for all bits at
    once on the input tensor's device (an array goes to ``device``)."""
    if pol == 0:
        pol = primitive_poly(reglen)
    b = as_tensor(bits, torch.int64, device)
    n = b.shape[-1]
    if n <= reglen:
        return 0.0, 0
    mask = torch.as_tensor([(pol >> k) & 1 for k in range(reglen)],
                           dtype=torch.int64, device=b.device)
    win = b.unfold(0, reglen, 1)[:n - reglen]       # row i: b[i : i+reglen]
    pred = (win * mask).sum(-1) % 2
    errs = int((pred != b[reglen:]).sum())
    return errs / (n - reglen), errs
