"""Bit vectors (parity: BitStream, core/include/tsd/telecom/bitstream.hpp),
ported from ``libtsd_tpu/models/bitstream.py``: int8 tensors of 0/1.

``randbits`` takes a ``torch.Generator`` where the JAX package takes a key;
the two give different bits from one seed, so the tests draw their bits
with numpy and hand them to both.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import device as _device

__all__ = [
    "bits_from_string", "bits_to_string", "randbits", "pad_bits",
    "hamming_distance", "bits_from_bytes", "bits_to_bytes", "altbits",
    "zerobits", "onebits",
]


def bits_from_string(s: str, device="cuda") -> torch.Tensor:
    """'0101...' -> bits (parity: BitStream(string ctor))."""
    return torch.tensor([int(c) for c in s if c in "01"], dtype=torch.int8,
                        device=_device(device))


def bits_to_string(b: torch.Tensor) -> str:
    return "".join(str(int(v)) for v in b.cpu().tolist())


def randbits(gen: torch.Generator, n: int) -> torch.Tensor:
    """n fair random bits on the generator's device (parity: randstream,
    bitstream.cc)."""
    return (torch.rand(n, generator=gen, device=gen.device) < 0.5).to(
        torch.int8)


def zerobits(n: int, device="cuda") -> torch.Tensor:
    return torch.zeros(n, dtype=torch.int8, device=_device(device))


def onebits(n: int, device="cuda") -> torch.Tensor:
    return torch.ones(n, dtype=torch.int8, device=_device(device))


def altbits(n: int, device="cuda") -> torch.Tensor:
    """Alternating 0, 1, 0, 1 (parity: BitStream::altern)."""
    return (torch.arange(n, device=_device(device)) % 2).to(torch.int8)


def pad_bits(b: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad so that the length is a multiple of ``mult`` (parity:
    BitStream::pad_mult)."""
    pad = (-b.shape[0]) % mult
    return torch.cat([b, b.new_zeros(pad)]) if pad else b


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Number of differing bits over the common length (parity:
    BitStream::dst_Hamming)."""
    n = min(a.shape[0], b.shape[0])
    return (a[:n].to(torch.int32) - b[:n].to(torch.int32)).abs().sum()


def bits_from_bytes(data: bytes, lsb_first: bool = True,
                    device="cuda") -> torch.Tensor:
    arr = np.frombuffer(data, np.uint8)
    bits = np.unpackbits(arr, bitorder="little" if lsb_first else "big")
    return torch.as_tensor(bits.astype(np.int8), device=_device(device))


def bits_to_bytes(b: torch.Tensor, lsb_first: bool = True) -> bytes:
    arr = b.cpu().numpy().astype(np.uint8)
    return np.packbits(arr, bitorder="little" if lsb_first else "big"
                       ).tobytes()
