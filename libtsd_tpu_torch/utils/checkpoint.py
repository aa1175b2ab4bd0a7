"""Checkpoint / resume for streaming pipeline state (PyTorch), ported from
``libtsd_tpu/utils/checkpoint.py``.

The reference has no checkpointing (its filter state is hidden inside C++
objects; SURVEY §5.4).  Here every block's state is an explicit tree of
tensors, so checkpointing is structural: flatten to named arrays, save as
.npz, restore into the same structure.

The file layout is the JAX package's: ``leaf_i`` (real leaves) and
``leaf_i__ri`` ((2, ...) float32 re/im planes of complex leaves) in JAX's
leaf order (``block.tree_flatten``: dict keys sorted, dataclass fields in
order), ``__residue_ri__``/``__residue__`` and ``__ctr_<name>__`` for the
serving state.  So a JAX receiver checkpoint loads into the port's
receiver, and the other way round.  The structure is recorded as
``__structure__`` (``block.tree_signature``) and checked when present;
jax's ``__treedef__`` text cannot be compared with the port's structures
and is not read.
"""
from __future__ import annotations

import io
import os
from typing import Any

import numpy as np
import torch

from ..block import tree_flatten, tree_signature

__all__ = ["save_state", "load_state", "state_bytes", "state_from_bytes",
           "save_stream_state", "load_stream_state", "state_from_npz"]


def _flatten(state) -> dict:
    leaves, _ = tree_flatten(state)
    out = {}
    for i, l in enumerate(leaves):
        t = torch.as_tensor(l).detach().cpu()
        if t.is_complex():
            out[f"leaf_{i}__ri"] = np.stack([t.real.numpy(), t.imag.numpy()]
                                            ).astype(np.float32)
        else:
            out[f"leaf_{i}"] = t.numpy()
    out["__structure__"] = np.frombuffer(tree_signature(state).encode(),
                                         dtype=np.uint8)
    return out


def save_state(path: str, state: Any):
    """Save a state tree to ``path`` (.npz)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(state))


def load_state(path: str, like: Any) -> Any:
    """Restore a state saved with :func:`save_state` (or by the JAX
    package).  ``like`` gives the structure, shapes, dtypes and device
    (e.g. ``block.init()``)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz",
                   allow_pickle=False)
    return state_from_npz(data, like)


def state_from_npz(data, like: Any) -> Any:
    leaves, unflatten = tree_flatten(like)
    # a 'like' whose leaf shapes match by chance but whose structure does
    # not would otherwise silently mis-assign state
    if "__structure__" in data:
        saved = bytes(data["__structure__"]).decode()
        if saved != tree_signature(like):
            raise ValueError(
                "checkpoint tree structure does not match 'like':\n"
                f"  saved: {saved}\n  like:  {tree_signature(like)}")
    new_leaves = []
    for i, l in enumerate(leaves):
        key = f"leaf_{i}__ri" if f"leaf_{i}__ri" in data else f"leaf_{i}"
        if key not in data:
            raise ValueError(f"checkpoint is missing leaf {i}")
        arr = np.asarray(data[key])
        if key.endswith("__ri"):
            arr = (arr[0].astype(np.float32)
                   + 1j * arr[1].astype(np.float32)).astype(np.complex64)
        ref = torch.as_tensor(l)
        # real checks, not asserts (python -O must not let a wrong-shape or
        # wrong-kind checkpoint into the state)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(ref.shape)}")
        got = np.dtype(arr.dtype)
        if (np.issubdtype(got, np.complexfloating) != ref.is_complex()) or (
                np.issubdtype(got, np.integer)
                != (not ref.is_floating_point() and not ref.is_complex()
                    and ref.dtype != torch.bool)):
            raise ValueError(f"leaf {i}: checkpoint dtype {got} is "
                             f"incompatible with expected {ref.dtype}")
        new_leaves.append(torch.as_tensor(arr).to(device=ref.device,
                                                  dtype=ref.dtype))
    return unflatten(new_leaves)


def save_stream_state(path: str, state: Any, residue: np.ndarray,
                      counters: dict):
    """The shared mid-stream serving checkpoint (StreamRunner and
    StreamReceiver write it): the device state tree (complex leaves as
    re/im planes), the host ring residue (complex64 or float32 samples
    awaiting the next full block) and integer counters, in one .npz."""
    d = _flatten(state)
    if np.iscomplexobj(residue):
        d["__residue_ri__"] = np.stack([residue.real.astype(np.float32),
                                        residue.imag.astype(np.float32)])
    else:
        d["__residue__"] = np.asarray(residue, np.float32)
    for k, v in counters.items():
        d[f"__ctr_{k}__"] = np.int64(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **d)


def load_stream_state(path: str, like: Any):
    """Inverse of :func:`save_stream_state`; ``like`` gives the state's
    structure and device.  Returns (state, residue, counters)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz",
                   allow_pickle=False)
    state = state_from_npz(data, like)
    if "__residue_ri__" in data:
        r = data["__residue_ri__"]
        residue = (r[0] + 1j * r[1]).astype(np.complex64)
    else:
        residue = np.asarray(data["__residue__"], np.float32)
    counters = {k[6:-2]: int(data[k]) for k in data.files
                if k.startswith("__ctr_")}
    return state, residue, counters


def state_bytes(state: Any) -> bytes:
    """Serialise a state tree to bytes (for network transport)."""
    buf = io.BytesIO()
    np.savez(buf, **_flatten(state))
    return buf.getvalue()


def state_from_bytes(b: bytes, like: Any) -> Any:
    data = np.load(io.BytesIO(b), allow_pickle=False)
    return state_from_npz(data, like)
