"""Numpy models of two kernel designs of the port, on the CPU (no card).

* #7 ``csrc/iir.cu``: a grid over (channel, chunk of 64 frames) whose
  blocks take tickets in chunk-major order, hand each section's end state
  to the next chunk through epoch-tagged flags, and run the hop frame by
  frame.  The model schedules the blocks in a random order with a bounded
  number resident, and checks that no block ever waits on one that is not
  resident or done, and that every output and final state is bit for bit
  the plain hop's, for any chunk size and any cut of a stream into calls
  (with the workspace and its flags reused across calls).
* #6 ``csrc/demod_sb.cu`` (``demod_sb_fused_kernel``): the input staged
  one hop ahead into a ring of samples, a ring of matched-filter rows, the
  power sums and the ring of superframe scales.  The model replays the
  kernel's schedule with tags instead of values: every sample a row reads
  is in the input ring and not being overwritten by a copy in flight, every
  row a sub-block's window reads is in the row ring, each row is computed
  once, each lane's power sum takes the rows of ``_fused_scales``' order,
  and each superframe's scale is in place before it is read.
Edit a kernel and its model together.
"""
from __future__ import annotations

import numpy as np
import pytest

import torch_compare  # noqa: F401  (caps torch's threads)
from libtsd_tpu_torch.ops.kernels import demod_sb as KSB
from libtsd_tpu_torch.ops.kernels import iir as KIIR

# ------------------------------------------------------------- #7 model

KP = 8


def _hop_frame(Mr: np.ndarray, sv: np.ndarray, u: np.ndarray) -> np.ndarray:
    """One frame of the hop, s' = M s + u, each row an ordered float32 chain
    over q (the kernel's fmaf chain, here as rounded products and sums)."""
    out = np.empty(KP, np.float32)
    for r in range(KP):
        a = np.float32(0)
        for q in range(KP):
            a = np.float32(a + np.float32(Mr[r, q] * sv[q]))
        out[r] = np.float32(a + u[r])
    return out


def _plain_hop(Mr, s0, u):
    """The plain version's hop over all frames: (states at frame starts,
    end state)."""
    sv, sts = s0.copy(), []
    for j in range(u.shape[0]):
        sts.append(sv)
        sv = _hop_frame(Mr, sv, u[j])
    return np.array(sts), sv


def _grid_call(Mr, s_in, u, fr, ws, epoch, rng, resident):
    """One call of the chunk-parallel grid.  Mr (nsec, 8, 8), s_in (C, nsec,
    8), u (C, nsec, nf, 8).  ws: {"flags", "carries"} reused across calls.
    Returns the states at frame starts (C, nsec, nf, 8) and st_out."""
    C, nsec, nf, _ = u.shape
    nchunk = -(-nf // fr)
    nslot = C * nchunk * nsec
    if ws.get("n", 0) < nslot:                     # made or grown: zeroed
        ws.update(n=nslot, flags=np.zeros(nslot, np.int64),
                  carries=np.zeros((nslot, KP), np.float32))
    flags, carries = ws["flags"], ws["carries"]
    sst = np.zeros((C, nsec, nf, KP), np.float32)
    st_out = np.zeros((C, nsec, KP), np.float32)
    nblocks = C * nchunk
    ticket = 0
    live = []                                      # [ticket, next section]
    done = 0
    while done < nblocks:
        while ticket < nblocks and len(live) < resident:
            live.append([ticket, 0])               # atomicAdd(ticket, 1)
            ticket += 1
        ready = []
        for blk in live:
            v, s = blk
            b, c = divmod(v, C)
            slot = (c * nchunk + b) * nsec
            if b > 0:
                waited = v - C                     # ticket of chunk b - 1
                assert waited < v
                assert any(w[0] == waited for w in live) or \
                    flags[slot - nsec + s] == epoch, "waits on a later block"
            if b == 0 or flags[slot - nsec + s] == epoch:
                ready.append(blk)
        assert ready, "deadlock"
        blk = ready[rng.integers(len(ready))]
        v, s = blk
        b, c = divmod(v, C)
        slot = (c * nchunk + b) * nsec
        f0 = b * fr
        nfc = min(fr, nf - f0)
        sv = (s_in[c, s].copy() if b == 0
              else carries[slot - nsec + s].copy())
        for j in range(nfc):
            sst[c, s, f0 + j] = sv
            sv = _hop_frame(Mr[s], sv, u[c, s, f0 + j])
        if b + 1 < nchunk:
            carries[slot + s] = sv
            flags[slot + s] = epoch                # after the carry
        else:
            st_out[c, s] = sv
        blk[1] += 1
        if blk[1] == nsec:
            live.remove(blk)
            done += 1
    return sst, st_out


def _random_hop(rng, nsec, k=KP):
    """Stable hops (spectral radius 0.95) on the first k state rows."""
    Mr = np.zeros((nsec, KP, KP), np.float32)
    for s in range(nsec):
        m = rng.standard_normal((k, k))
        Mr[s, :k, :k] = m * (0.95 / np.abs(np.linalg.eigvals(m)).max())
    return Mr


@pytest.mark.parametrize("fr", [1, 3, 8, 64])
@pytest.mark.parametrize("cuts", [(48,), (8, 72, 432 - 8 - 72), (5, 1, 42)])
def test_iir_chunked_hop_matches_plain(fr, cuts):
    """Carries across chunks and calls reproduce the plain hop bit for
    bit, whatever the chunk size, the cut and the block order."""
    rng = np.random.default_rng(fr * 131 + len(cuts))
    C, nsec = 3, 2
    nf = sum(cuts)
    Mr = _random_hop(rng, nsec, k=2)
    u = rng.standard_normal((C, nsec, nf, KP)).astype(np.float32)
    u[..., 2:] = 0
    s0 = np.zeros((C, nsec, KP), np.float32)
    s0[..., :2] = rng.standard_normal((C, nsec, 2))
    plain = [[_plain_hop(Mr[s], s0[c, s], u[c, s]) for s in range(nsec)]
             for c in range(C)]
    ws, st, f0 = {}, s0, 0
    for epoch, n in enumerate(cuts, start=1):
        sst, st = _grid_call(Mr, st, u[:, :, f0:f0 + n], fr, ws, epoch, rng,
                             resident=int(rng.integers(1, 6)))
        for c in range(C):
            for s in range(nsec):
                assert np.array_equal(sst[c, s], plain[c][s][0][f0:f0 + n])
        f0 += n
    for c in range(C):
        for s in range(nsec):
            assert np.array_equal(st[c, s], plain[c][s][1])


def test_iir_flags_of_an_earlier_call_never_satisfy_a_wait():
    """A call that finds the flags of the call before it (same workspace)
    still waits for its own chunks: a stale flag carries an older epoch."""
    rng = np.random.default_rng(5)
    C, nsec, nf, fr = 2, 1, 12, 4
    Mr = _random_hop(rng, nsec)
    u = rng.standard_normal((C, nsec, nf, KP)).astype(np.float32)
    s0 = np.zeros((C, nsec, KP), np.float32)
    ws = {}
    _grid_call(Mr, s0, u, fr, ws, 1, rng, resident=8)
    assert (ws["flags"] == 1).sum() == C * nsec * (nf // fr - 1)
    # the next call: its chunk-1 blocks must not start from call 1's carries
    u2 = rng.standard_normal(u.shape).astype(np.float32)
    sst, st = _grid_call(Mr, s0, u2, fr, ws, 2, rng, resident=8)
    for c in range(C):
        want, end = _plain_hop(Mr[0], s0[c, 0], u2[c, 0])
        assert np.array_equal(sst[c, 0], want) and np.array_equal(st[c, 0],
                                                                  end)


def _hop_frame_kk(Mr, sv, u, kk: int):
    """csrc/iir.cu's hop_chunk<KK>: rows and columns from KK on left out,
    rows >= KK set to +0."""
    out = np.zeros(KP, np.float32)
    for r in range(kk):
        a = np.float32(0)
        for q in range(kk):
            a = np.float32(a + np.float32(Mr[r, q] * sv[q]))
        out[r] = np.float32(a + u[r])
    return out


@pytest.mark.parametrize("k,KK", [(1, 2), (2, 2), (3, 4), (4, 4), (5, 8)])
def test_iir_hop_on_the_used_state_rows_keeps_the_bits(k, KK):
    """Leaving out the zero rows and columns of M (and the zero columns of
    W, so u is +0 there) gives the full 8 x 8 chain's bits, zero signs
    included, from a state with garbage in its unused rows."""
    rng = np.random.default_rng(k)
    Mr = _random_hop(rng, 1, k)[0]
    sv = rng.standard_normal(KP).astype(np.float32)
    sv[k:] = rng.standard_normal(KP - k).astype(np.float32)   # unused rows
    sk = sv.copy()
    sk[KK:] = 0
    for j in range(200):
        u = np.zeros(KP, np.float32)
        u[:k] = rng.standard_normal(k) * (j % 3 != 0)
        if j % 7 == 0:
            u[:k] = -0.0
        sv = _hop_frame(Mr, sv, u)
        sk = _hop_frame_kk(Mr, sk, u, KK)
        assert np.array_equal(sv.view(np.int32), sk.view(np.int32)), j


@pytest.mark.parametrize("C,N,nsec", [(64, 1 << 18, 2), (1, 128 * 8, 4),
                                      (200, 128 * 72, 1)])
def test_iir_workspace_words(C, N, nsec):
    """The wrapper sizes the kernel's workspace as csrc/iir.cu lays it out:
    4 words, then a flag and 8 carry floats per (channel, chunk, section)."""
    nchunk = -(-(N // 128) // 64)
    assert KIIR.workspace_words(C, N, nsec) == 4 + C * nchunk * nsec * 9


# ------------------------------------------------------------- #6 model


def _in_slot(g: int, irg: int) -> int:
    s = g & (irg - 1)
    return s + 2 * (s >> 2)


def _fused_replay(S, osf, K, kmf, n, vec):
    """Replay demod_sb_fused_kernel's schedule for one channel (G consumer
    lanes, GP producer lanes) with tags: which sample each input slot
    holds, which row each row slot holds, the rows each virtual lane's
    power sum takes; in step t the producers make hop t + D while the
    consumers read sub-block t's rows and, at a superframe's start, its
    scale."""
    p = KSB.LoopParams("cspline", K, 32, osf, S, n, 0.0, 0.0, 0.0, 0.0,
                       True, True, True)
    lay = KSB.fused_layout(osf, S, K, n)
    f = KSB.fused_smem(p, lay, kmf, 16)
    G = 1 << (S - 1).bit_length()
    GP = G // 2 if G > 1 else 1
    hop, tb, hopt, nsb = S * osf, lay["tb"], lay["hopt"], p.nsb
    nT = nsb // tb
    z00 = lay["Z00"]
    F = lay["SFZ"] - hopt + hop
    D, RG, IRG, SQ = f["D"], f["RG"], f["IRG"], f["SQ"]
    hlast = nsb + D - 2
    assert -lay["XOFF"] <= ((z00 - kmf + 1) & ~1)   # the tail holds them
    xin = np.full(IRG // 4 * 6, -10 ** 9, np.int64)
    ring = np.full(RG, -1, np.int64)
    pending = {}
    made = np.zeros((hlast + 1) * hop, np.int64)
    lanes = [[[] for _ in range(G)] for _ in range(nT + 1)]
    sc = np.full(SQ, -1, np.int64)
    finished = []                                  # superframes, in order

    def stage(lo, hi):
        step = 2 if vec else 1
        if vec:
            assert (lo + 1) % 2 == 0 and (hi + 1) % 2 == 0
        for g in range(lo + 1, hi + 1):
            slot = _in_slot(g, IRG)
            assert slot not in pending
            pending[slot] = g
        assert (hi - lo) % step == 0

    def hop_end(h):
        return ((h + 1) * hop + z00 - 1) | 1

    sc[0] = 0
    stage(((z00 - kmf + 1) & ~1) - 1, hop_end(0))

    def produce(h, read_slot=None):
        for slot, g in pending.items():            # cp.async.wait_group 0
            xin[slot] = g
        pending.clear()
        if h + 1 <= hlast:
            stage(hop_end(h), hop_end(h + 1))
        sf = h // tb
        if h % tb == 0 and 0 < h and sf <= nT:
            for j in range(G):                     # its power is complete
                assert lanes[sf - 1][j] == list(range(j, hopt, G))
            finished.append(sf - 1)
            assert sf & (SQ - 1) != read_slot      # not the one being read
            sc[sf & (SQ - 1)] = sf
        R0 = h * hop
        for j in range(GP):
            for q in range(4 * j, hop, 4 * GP):    # rows q .. q + 3
                for i in range(4):
                    if q + i >= hop:
                        continue
                    R = R0 + q + i
                    for k in range(kmf):
                        g = R + z00 - k
                        slot = _in_slot(g, IRG)
                        assert xin[slot] == g and slot not in pending, \
                            (h, R, k)
                    ring[R & (RG - 1)] = R
                    made[R] += 1
        if h < nsb:
            base = (h % tb) * hop
            for j in range(G):
                for r in range(base + ((j - base) & (G - 1)), base + hop, G):
                    assert ring[(sf * hopt + r) & (RG - 1)] == sf * hopt + r
                    lanes[sf][j].append(r)

    for h in range(D):
        produce(h)
    for t in range(nsb):
        read_slot = None
        if t % tb == 0:
            read_slot = (t // tb) & (SQ - 1)
            assert sc[read_slot] == t // tb, t
            assert finished[:t // tb] == list(range(t // tb)), t
        if t + D <= hlast:
            produce(t + D, read_slot)
        rows = ring[(t * hop + np.arange(F)) & (RG - 1)]
        assert np.array_equal(rows, t * hop + np.arange(F)), t
    assert finished == list(range(nT))             # the last EMA step
    assert (made == 1).all()                       # every row once
    return lanes[:nT], G, hopt, f, lay


@pytest.mark.parametrize("S,osf,K,kmf,n,vec", [
    (16, 4, 4, 21, 2048, True),     # the QAM path's shape, nsb 32, tb 8
    (16, 4, 4, 129, 1024, True),    # the longest matched filter
    (8, 4, 4, 21, 512, True),       # 4 channels a warp, tb 8
    (32, 4, 4, 21, 256, True),      # one channel a warp, tb 2
    (16, 4, 4, 33, 64 * 3, False),  # tb 1, 8-byte copies
    (5, 2, 4, 9, 130, False),       # odd hop, G > S, tb 1
    (12, 4, 8, 21, 48 * 4, True),   # hop not a multiple of G, K 8
])
def test_fused_rings_serve_every_row_once(S, osf, K, kmf, n, vec):
    lanes, G, hopt, f, lay = _fused_replay(S, osf, K, kmf, n, vec)
    # _fused_scales' order: lane j takes rows j, j + G, ... < hopt in order
    for sf in lanes:
        for j in range(G):
            assert sf[j] == list(range(j, hopt, G))
    assert f["smem"] <= 227 * 1024


def test_fused_smem_matches_the_c_layout():
    """The Python mirror of fused_layout at the QAM path's shape: D 3 hops,
    256-row and 256-sample rings, 8 scales, 8 channels a block."""
    p = KSB.LoopParams("cspline", 4, 32, 4, 16, 8192, 0.0, 0.0, 0.0, 0.0,
                       True, True, True)
    lay = KSB.fused_layout(4, 16, 4, 8192)
    f = KSB.fused_smem(p, lay, 21, 16)
    assert (f["D"], f["RG"], f["IRG"], f["SQ"]) == (3, 256, 256, 8)
    assert f["smem"] == 8 * (256 * 8 + 64 * 48 + 8 * 4) + 6 * 16 + 8 * 16
