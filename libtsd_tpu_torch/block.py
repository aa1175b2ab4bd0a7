"""Functional streaming-block protocol, PyTorch form.

The same pure protocol as the JAX package::

    state = block.init_for(x)
    state, y = block.step(state, x_block)

* ``block`` is an ``nn.Module``: coefficient tensors are registered
  buffers, so ``block.to(device)`` moves them and ``state_dict()`` saves
  them; configuration is plain attributes.
* ``state`` is a tensor or a tuple of tensors passed in and out
  explicitly; ``step`` never mutates the block or the state it is given.
* Delay/halo bookkeeping is explicit: every block reports ``delay`` (group
  delay in output samples) and ``ratio`` (output/input rate), and
  ``tail_state`` says whether its state is the last input samples (the
  overlap-save contract that a time-sharded caller may seed with a
  neighbour's tail).

States of composite blocks are nested dicts, tuples and dataclasses of
tensors ("trees").  :func:`tree_flatten` orders their leaves as JAX orders
a pytree's (dict keys sorted, tuple items and dataclass fields in order),
so that a checkpoint's ``leaf_i`` means the same leaf in both packages;
:func:`tree_signature` names the structure, in place of jax's treedef.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

State = Any


class Block(nn.Module):
    """Base class for streaming blocks.  Subclasses implement ``init`` or
    ``init_for`` and ``step``; both are pure."""

    def init(self) -> State:
        return ()

    def init_for(self, x: torch.Tensor) -> State:
        """Initial state for an input shaped/typed like ``x``.  Blocks whose
        state depends on batch shape or complex dtype override this."""
        return self.init()

    def step(self, state: State,
             x: torch.Tensor) -> Tuple[State, torch.Tensor]:
        raise NotImplementedError

    # --- bookkeeping -----------------------------------------------------
    @property
    def tail_state(self) -> bool:
        """True when this block's streaming state IS the last ``state_len``
        INPUT samples (the overlap-save contract).  Blocks carrying any
        other structured state return False (the default)."""
        return False

    @property
    def delay(self) -> float:
        """Group delay introduced by this block, in *output* samples."""
        return 0.0

    @property
    def ratio(self) -> float:
        """Output samples produced per input sample (rate change factor)."""
        return 1.0

    # --- conveniences ----------------------------------------------------
    def forward(self, state: State, x: torch.Tensor):
        return self.step(state, x)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """One-shot: fresh state, single step over the whole signal."""
        _, y = self.step(self.init_for(x), x)
        return y


class Chain(Block):
    """Sequential composition of blocks; the state is the tuple of member
    states."""

    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def init(self) -> State:
        return tuple(b.init() for b in self.blocks)

    def init_for(self, x: torch.Tensor) -> State:
        # Each member's state is sized by ITS input, which is the previous
        # member's output.  PyTorch has no eval_shape, so the output shape
        # and dtype are learned by running each member once on x (no grad).
        states = []
        xl = x
        with torch.no_grad():
            for b in self.blocks:
                s = b.init_for(xl)
                states.append(s)
                xl = b.step(s, xl)[1]
        return tuple(states)

    def step(self, state: State, x: torch.Tensor):
        new_states = []
        for b, s in zip(self.blocks, state):
            s, x = b.step(s, x)
            new_states.append(s)
        return tuple(new_states), x

    @property
    def delay(self) -> float:
        d = 0.0
        for b in self.blocks:
            d = d * b.ratio + b.delay
        return d

    @property
    def ratio(self) -> float:
        r = 1.0
        for b in self.blocks:
            r *= b.ratio
        return r


def chain(*blocks: Block) -> Chain:
    return Chain(blocks)


class Identity(Block):
    """Pass-through."""

    def step(self, state, x):
        return state, x


def stream(block: Block, x: torch.Tensor, block_size: int):
    """Drive ``block`` over ``x`` in fixed-size chunks along axis 0,
    carrying state across chunks.  A remainder (len(x) % block_size) is
    processed with one extra ``step`` call, so the output covers all of x.
    """
    n = (x.shape[0] // block_size) * block_size
    state = block.init_for(x[:block_size])
    ys = []
    for i in range(0, n, block_size):
        state, yb = block.step(state, x[i:i + block_size])
        ys.append(yb)
    if n < x.shape[0]:
        state, yt = block.step(state, x[n:])
        ys.append(yt)
    return state, torch.cat(ys, dim=0)


def pad_to_multiple(x: torch.Tensor, m: int, axis: int = 0) -> torch.Tensor:
    """Zero-pad ``axis`` at the back up to a multiple of m."""
    axis = axis % x.ndim
    pad = (-x.shape[axis]) % m
    if pad == 0:
        return x
    # F.pad lists (front, back) pairs from the LAST axis backwards
    spec = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, spec)


# ------------------------------------------------------------------ trees

def _children(tree) -> Tuple[str, list, Any]:
    """(kind, children, rebuild) of one tree node; kind "" for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "dict", [tree[k] for k in keys], \
            lambda ch: dict(zip(keys, ch))
    if isinstance(tree, (tuple, list)):
        typ = type(tree)
        return typ.__name__, list(tree), lambda ch: typ(ch)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return type(tree).__name__, [getattr(tree, k) for k in names], \
            lambda ch: dataclasses.replace(tree, **dict(zip(names, ch)))
    if tree is None:
        return "None", [], lambda ch: None
    return "", [], None


def tree_flatten(tree) -> Tuple[List[Any], Callable[[list], Any]]:
    """Leaves in JAX's order and a function that rebuilds the tree from a
    list of new leaves."""
    kind, ch, rebuild = _children(tree)
    if not kind:
        return [tree], lambda leaves: leaves[0]
    leaves, builders, counts = [], [], []
    for c in ch:
        lv, b = tree_flatten(c)
        leaves += lv
        builders.append(b)
        counts.append(len(lv))

    def unflatten(new):
        out, off = [], 0
        for b, k in zip(builders, counts):
            out.append(b(new[off:off + k]))
            off += k
        return rebuild(out)
    return leaves, unflatten


def tree_map(fn, tree, *rest):
    """fn applied leaf by leaf over trees of one structure."""
    leaves, unflatten = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return unflatten([fn(*ls) for ls in zip(leaves, *others)])


def tree_signature(tree) -> str:
    """The structure of a tree as text: node kinds, dict keys and dataclass
    field names, leaves as ``*``."""
    kind, ch, _ = _children(tree)
    if not kind:
        return "*"
    if kind == "dict":
        return "{" + ",".join(f"{k}:{tree_signature(tree[k])}"
                              for k in sorted(tree)) + "}"
    if dataclasses.is_dataclass(tree):
        return kind + "(" + ",".join(
            f"{f.name}:{tree_signature(getattr(tree, f.name))}"
            for f in dataclasses.fields(tree)) + ")"
    return kind + "(" + ",".join(tree_signature(c) for c in ch) + ")"
