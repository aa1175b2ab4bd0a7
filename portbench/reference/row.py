"""Plain reference of the sharded row, in float64 PyTorch: the unsharded
chain (``reference/chain.py``) over the whole row record, the shards side
by side.  The record's first samples start from zero history; shard r's
FIR reads the last len(taps) - 1 samples of shard r - 1.  The spectrum of
the record is the sum of the shards' spectra, each frame lying in one
shard.

Imports neither JAX nor anything of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import chain


def add_shard(acc, x: torch.Tensor, left: torch.Tensor | None,
              taps: np.ndarray, round_taps: bool = True) -> torch.Tensor:
    """acc plus the spectra of shard x, whose left neighbour is ``left``
    (None for the record's first shard)."""
    if left is None:
        left = torch.zeros((x.shape[0], len(taps) - 1), dtype=x.dtype,
                           device=x.device)
    return acc + chain.spectra(x, left, taps, round_taps)
