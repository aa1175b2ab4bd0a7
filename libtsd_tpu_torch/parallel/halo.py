"""Overlap-save halo exchange over the time axis.

Ported from ``libtsd_tpu/parallel/halo.py``.  A streaming block's carried
state, sharded over time, becomes a halo: each time shard needs the last
state_len input samples of its left neighbour.  JAX moves every halo right
at once with ``lax.ppermute``.  Here, within a process, each tail is copied
to its right neighbour's device (``.to(device, non_blocking=True)``, a
peer copy between distinct cards, a view on one card); where a row crosses
processes (``mesh.RowLink``), the tail of this process's last shard goes
to the next rank and the first shard's halo comes from the previous one,
point to point over the row's group (``dist.batch_isend_irecv``; through
pinned host copies on the gloo transport, which does not take CUDA tensors
for send and receive).  The row's first shard gets zeros, the zero initial
filter state.

The halo IS the block's streaming state, so ``block.step(halo, local_x)``
agrees with the unsharded streaming run, whatever each block's delay:
every block carries its own state size (``Block.tail_state``).  Recursive
filters are exact across shards through the affine state composition of
:func:`iir_time_sharded`: JAX's ``all_gather`` of the shards' end states
(over the row's group across processes), then a short sequential prefix
over the row.

Functions take the global (C, N) tensor, or the grid of local tensors from
``mesh.shard``, and return the same form.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.distributed as dist

from ..block import Block, Chain
from ..ops.filter_rt import (DcBlocker, ExpSmoother, Iir, IirFrame, Sos,
                             _affine_matrix_scan, _mm)
from .mesh import Mesh, RowLink, gather, on_device, shard

__all__ = ["halo_exchange_left", "send_recv_tail", "sharded_fir",
           "sharded_chain", "iir_time_sharded"]


def send_recv_tail(tail: torch.Tensor, link: RowLink) -> torch.Tensor:
    """Send ``tail`` (this process's last shard's tail) to the rank on the
    right and return the matching tail from the rank on the left, on
    ``link.device`` (the row's NCCL traffic stays on one card); zeros at
    the row's first shard.  Sent as raw bytes (NCCL has no int16 or
    complex type)."""
    # gloo takes CUDA tensors for all-reduce and broadcast, not for send
    # and receive: those go through pinned host memory
    host = link.transport == "gloo" and tail.device.type == "cuda"
    where = torch.device("cpu") if host else link.device
    ops, buf = [], None
    if link.right is not None:
        b = tail.contiguous().reshape(-1).view(torch.uint8)
        b = (torch.empty(b.shape, dtype=torch.uint8,
                         pin_memory=True).copy_(b) if host else b.to(where))
        ops.append(dist.P2POp(dist.isend, b, link.right, link.group))
    if link.left is not None:
        buf = torch.empty(tail.numel() * tail.element_size(),
                          dtype=torch.uint8, device=where, pin_memory=host)
        ops.append(dist.P2POp(dist.irecv, buf, link.left, link.group))
    if ops:
        with on_device(link.device):
            for w in dist.batch_isend_irecv(ops):
                w.wait()
    if buf is None:
        return torch.zeros_like(tail, device=link.device)
    got = buf.view(tail.dtype).reshape(tail.shape)
    return got.to(link.device, non_blocking=True)


def halo_exchange_left(xs: list, halo: int,
                       link: Optional[RowLink] = None) -> list:
    """For a row of time shards (local tensors, left to right), each
    shard's left halo: the last ``halo`` samples (last axis) of its left
    neighbour, on its own device; zeros on the row's first shard.  With a
    ``link`` (the row crosses processes) the first shard's halo comes from
    the rank on the left and the last shard's tail goes to the rank on
    the right."""
    n = xs[0].shape[-1]
    if halo > n:
        raise ValueError(
            f"halo ({halo}) exceeds the local shard length ({n}); "
            f"use fewer/larger time shards")
    if halo == 0:
        # stateless block: x[..., -0:] would be the WHOLE shard
        return [x[..., :0] for x in xs]
    if link is None:
        out = [torch.zeros_like(xs[0][..., n - halo:])]
    else:
        got = send_recv_tail(xs[-1][..., n - halo:], link)
        out = [got.to(xs[0].device, non_blocking=True)]
    for left, x in zip(xs, xs[1:]):
        out.append(left[..., n - halo:].to(x.device, non_blocking=True))
    return out


def _mat_pow(M: torch.Tensor, p: int) -> torch.Tensor:
    """M^p by repeated squaring (static p), fp32 matmuls."""
    R = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    while p:
        if p & 1:
            R = _mm(M, R)
        M = _mm(M, M)
        p >>= 1
    return R


def iir_time_sharded(blk: IirFrame, xs: list,
                     link: Optional[RowLink] = None) -> list:
    """Run a frame-parallel IIR (``IirFrame``) over a row of time shards,
    exactly.

    The state map over any input span is affine: shard i maps an entry
    state s to M_tot s + v_i, with M_tot = M^(frames per shard) and v_i its
    zero-entry end state.  Each shard (1) runs the frame-parallel step
    from zero state (y0 and v_i together); (2) the row's (..., k) end
    states are gathered (across processes: each rank puts its shards' at
    their places in a zeroed (time, ..., k) tensor and the row's group
    sums it, JAX's ``all_gather``), and a prefix over the row composes
    them in float32, giving each shard its exact entry state s_i; (3) adds
    y += S (M^f s_i) per frame, one k-dim scan and one rank-k product.
    The output equals the unsharded ``IirFrame.step`` up to float32
    reassociation."""
    if xs[0].is_complex():
        re = iir_time_sharded(blk, [x.real for x in xs], link)
        im = iir_time_sharded(blk, [x.imag for x in xs], link)
        return [torch.complex(a, b) for a, b in zip(re, im)]
    L = blk.T.shape[0]
    n = xs[0].shape[-1]
    if n % L:
        raise ValueError(f"local shard length {n} is not a multiple of the "
                         f"IirFrame frame ({L})")
    nf = n // L
    blks = [_on(blk, x.device) for x in xs]
    # (1) local zero-entry passes
    runs = [b.step(b.init_for(x), x) for b, x in zip(blks, xs)]
    if link is None and len(xs) == 1:
        return [runs[0][1]]
    # (2) gather the end states, then compose the affine pairs along the
    # row (equal shard lengths, so every shard shares one M_tot)
    dev0 = xs[0].device
    vs = [v.to(dev0) for v, _ in runs]
    t0 = 0
    if link is not None:
        t0 = link.t0
        V = torch.zeros((link.time,) + tuple(vs[0].shape),
                        dtype=vs[0].dtype, device=dev0)
        V[t0:t0 + len(vs)] = torch.stack(vs)
        dist.all_reduce(V, group=link.group)     # gloo: CUDA all-reduce
        vs = list(V)
    M_tot = _mat_pow(blk.M.to(dev0), nf)
    acc = torch.zeros_like(vs[0])
    entries = []
    for v in vs:
        entries.append(acc)
        acc = _mm(acc, M_tot.T) + v
    out = []
    for j, (b, x, (_, y0)) in enumerate(zip(blks, xs, runs)):
        s_entry = entries[t0 + j].to(x.device)
        # (3) per-frame linear correction y += S (M^f s_entry)
        u = torch.zeros(tuple(x.shape[:-1]) + (nf, b.order),
                        dtype=s_entry.dtype, device=x.device)
        u[..., 0, :] = s_entry
        s_extra = _affine_matrix_scan(b.M, u)
        out.append(y0 + _mm(s_extra, b.S.T).reshape(x.shape))
    return out


def _on(block: Block, dev: torch.device) -> Block:
    """``block`` itself when its buffers live on ``dev``, else a copy moved
    there (a shard on another card; the blocks' taps are kilobytes)."""
    if all(b.device == dev for b in block.buffers()):
        return block
    return copy.deepcopy(block).to(dev)


def _grid(mesh: Mesh, x):
    """(the grid of local tensors, whether x was a global tensor)."""
    if isinstance(x, torch.Tensor):
        return shard(mesh, x), True
    return [list(row) for row in x], False


def _result(mesh: Mesh, grid: list, was_global: bool):
    return gather(mesh, grid) if was_global else grid


def sharded_fir(mesh: Mesh, block: Block, x, state_len: int):
    """Run a stateful streaming block over a (chan, time)-sharded signal.

    x: the global (C, N) tensor, or the grid from ``mesh.shard``.  Each time
    shard receives its left neighbour's tail as initial state; the output
    matches the unsharded streaming run.

    ``state_len`` is the number of carried samples: K - 1 for a K-tap FIR,
    or V (= ola_plan's overlap) for the overlap-save ``OlaFft``
    (engine="cuda", kernel #9), whose streaming state is exactly the last V
    input samples.  One stage of :func:`sharded_chain`, with its checks:
    a block whose state is not an input tail raises TypeError where the
    JAX function would seed it with the halo anyway."""
    return sharded_chain(mesh, [(block, state_len)], x)


def _check_stage(block: Block) -> None:
    recursive = (Iir, Sos, DcBlocker, ExpSmoother)
    if isinstance(block, IirFrame):
        return
    if isinstance(block, Chain):
        if all(isinstance(b, IirFrame) for b in block.blocks):
            return
        if any(isinstance(b, (IirFrame,) + recursive)
               for b in block.blocks):
            raise TypeError(
                "sharded_chain: a Chain mixing recursive stages with "
                "sample-tail stages cannot take the tail halo — pass "
                "the recursive stages as separate list entries "
                "(IirFrame / sos_frame_chain)")
    if isinstance(block, recursive):
        raise TypeError(
            f"sharded_chain: {type(block).__name__} carries recursion "
            f"state, which the sample-tail halo cannot seed — convert "
            f"to the frame-parallel form (IirFrame.create(b, a) or "
            f"sos_frame_chain) for exact cross-shard composition")
    if not block.tail_state:
        # POSITIVE protocol check (Block.tail_state), not an isinstance
        # denylist: any block whose state is not the last state_len INPUT
        # samples (phase counters, OA output residue, nested Chains,
        # future blocks) would silently consume the raw halo as state
        raise TypeError(
            f"sharded_chain: {type(block).__name__} does not declare "
            f"tail_state=True — its streaming state is not an "
            f"input-sample tail, so the halo cannot seed it.  Pass "
            f"tail-state blocks (Fir, OlaFft engine='cuda') or the "
            f"frame-parallel recursive forms as separate stages")


def _run_stage(block: Block, slen: int, row: list,
               link: Optional[RowLink]) -> list:
    if isinstance(block, IirFrame):
        return iir_time_sharded(block, row, link)
    if isinstance(block, Chain):     # all IirFrame (_check_stage)
        for b in block.blocks:
            row = iir_time_sharded(b, row, link)
        return row
    halos = halo_exchange_left(row, slen, link)
    out = []
    for h, x in zip(halos, row):
        with on_device(x.device):
            out.append(_on(block, x.device).step(h, x)[1])
    return out


def sharded_chain(mesh: Mesh, blocks_and_state_lens, x):
    """Cascade several blocks over a (chan, time)-sharded signal, with one
    halo exchange per stage (halo sizes differ per stage).

    Stages whose state is SAMPLES (FIR, overlap-save OLA, delay lines)
    take ``(block, state_len)`` and get the tail halo.  RECURSIVE stages
    are passed as ``IirFrame`` instances (or a ``Chain`` of them, e.g.
    ``sos_frame_chain``'s cascade) with any state_len; they go through the
    exact cross-shard affine state composition (:func:`iir_time_sharded`),
    so a chain with feedback stages time-shards end to end.  Any other
    block raises TypeError before anything runs."""
    stages = list(blocks_and_state_lens)
    for block, _ in stages:
        _check_stage(block)
    grid, was_global = _grid(mesh, x)
    out = []
    for row, link in zip(grid, mesh.links):
        for block, slen in stages:
            row = _run_stage(block, slen, row, link)
        out.append(row)
    return _result(mesh, out, was_global)
