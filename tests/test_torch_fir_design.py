"""numpy model of kernel #1, ``csrc/fir.cu`` (the one-stream FIR on the
tensor cores), on the CPU.

The model follows the kernel: the grid of whole tiles (8192 outputs) a
block, a tile's items (one a chunk of 496 taps), each item's window (its
start, the bytes each cp.async copies, zeros outside x), the three bf16
planes and their chunk swizzle at a fixed plane stride, the ring of B
fragments of x1 and x2, x3's loaded where used, the A fragments of the
chunk's tap planes, the two accumulator sets (h1 x1; the five smaller
products) and the stores from the fragments into y.  It reuses the index
maps of the fused chain's model (``tests/test_torch_chain_design.py``:
mma's fragment maps, ``ldmatrix``, the tap planes), since the kernel runs
chain_body.cuh's helpers unchanged.  It checks the index maps, that the
model reproduces ``np.convolve`` at tap counts of one, two and three
chunks, the stores' sectors, and the split arithmetic's error against a
float64 FIR with mma.sync's truncating fp32 sums.  The kernel's header
says it is kept in step with this file; edit both together.
"""
import numpy as np
import pytest

from test_torch_chain_design import (LANE, a_fragments, a_map,
                                     c_map, chunk_at, ldmatrix, mma, split3,
                                     tap_blocks, tap_words, toeplitz_block,
                                     win_rows)
from torch_compare import rel

TILE, ROWS, THREADS = 8192, 512, 256
CHUNK_TAPS = 496
E_MAX = tap_blocks(CHUNK_TAPS)
WROWS = win_rows(E_MAX)
SLOTS = 132 * 2                       # an H100's resident blocks of #1


def chunks_of(K):
    return -(-K // CHUNK_TAPS)


def taps_of(K, c):
    return min(CHUNK_TAPS, K - CHUNK_TAPS * c)


def grid(n, slots=SLOTS):
    """fir_f32's grid: (blocks, tiles a block)."""
    tiles = -(-n // TILE)
    tpb = -(-tiles // slots)
    return -(-tiles // tpb), tpb


def items(n, K, slots=SLOTS):
    """Per block, its items (tile, chunk) in order, as fir_kernel walks
    them."""
    blocks, tpb = grid(n, slots)
    tiles, nch = -(-n // TILE), chunks_of(K)
    out = []
    for b in range(blocks):
        i0, i1 = b * tpb * nch, min((b + 1) * tpb, tiles) * nch
        out.append([(it // nch, it % nch) for it in range(i0, i1)])
    return out


def window_start(tile, c, K):
    """Sample of x at window row 0 of an item."""
    E = tap_blocks(taps_of(K, c))
    return tile * TILE - CHUNK_TAPS * c - 16 * (E - 1)


def copy_bytes(s, n):
    """The bytes a 16-byte cp.async copies from sample s (s % 4 == 0)."""
    s = np.asarray(s)
    left = n - s
    return np.where(s < 0, 0, np.where(left >= 4, 16,
                                       np.where(left > 0, 4 * left, 0)))


@pytest.mark.parametrize("n,K", [(1, 3), (5000, 3), (1 << 22, 256),
                                 (2 * TILE + 777, 600), (3 * TILE, 1000),
                                 (1000 * TILE + 1, 17)])
def test_grid_and_items(n, K):
    """Whole tiles a block, about one block per slot; every (tile, chunk)
    once, a tile's chunks in one block in order (the later ones add to y
    where the earlier wrote it)."""
    blocks, tpb = grid(n)
    assert blocks <= SLOTS or tpb > 1
    seen = [it for b in items(n, K) for it in b]
    tiles = -(-n // TILE)
    assert seen == [(t, c) for t in range(tiles) for c in range(chunks_of(K))]
    for b in items(n, K):
        assert len({t for t, _ in b}) * chunks_of(K) == len(b)


@pytest.mark.parametrize("K", [1, 3, 16, 17, 256, 496, 497, 600, 1000])
def test_windows_cover_the_taps(K):
    """For every chunk: the window's rows hold every sample that a tile's
    outputs read with that chunk's taps, the rows fit the staging buffer
    and the planes, and the chunk's tap blocks are its 16 E_c taps."""
    for c in range(chunks_of(K)):
        Kc = taps_of(K, c)
        E = tap_blocks(Kc)
        assert 1 <= Kc <= CHUNK_TAPS and E <= E_MAX
        rows = ROWS + E - 1
        assert rows <= ROWS + E_MAX - 1 and rows <= WROWS
        g0 = window_start(0, c, K)
        k = CHUNK_TAPS * c + np.arange(Kc)          # this chunk's taps
        t = np.arange(TILE)
        need = t[:, None] - k[None, :]
        assert need.min() >= g0 and need.max() < g0 + 16 * rows
        assert 16 * E >= Kc + 1                       # the straddle block


@pytest.mark.parametrize("n", [1, 3, 4, 5, 8191, 8192, 8193, 2 * TILE + 777])
def test_copies_stop_at_the_ends(n):
    """The staged copies read x[0 .. n) only: no byte before x[0] or from
    x[n] on, every sample of x inside a window copied once an item."""
    for tile in range(-(-n // TILE)):
        for c, K in ((0, 256), (1, 600)):
            if c >= chunks_of(K):
                continue
            E = tap_blocks(taps_of(K, c))
            s = window_start(tile, c, K) + 4 * np.arange(4 * (ROWS + E - 1))
            b = copy_bytes(s, n)
            got = np.concatenate([np.arange(si, si + bi // 4)
                                  for si, bi in zip(s, b)])
            assert got.min(initial=0) >= 0 and got.max(initial=-1) < n
            lo, hi = max(s[0], 0), min(s[-1] + 4, n)
            assert np.array_equal(got, np.arange(lo, hi))


def store_offsets():
    """(warp, m, k, lane) -> tile-relative output of s[m][k] at the lane:
    16 (64 w + m + 16 t) + g + (0, 128, 8, 136)[k]."""
    cr, cc = c_map()                          # (lane, k): row j, column r
    w = np.arange(8)[:, None, None, None]
    m = np.arange(8)[None, :, None, None]
    q = 64 * w + m + 8 * cc.T[None, None]     # tile rows of the lanes
    return 16 * q + cr.T[None, None]


def test_store_layout():
    """The stores cover the tile once; the code's closed form is the
    fragment map's; each store instruction of a warp writes four whole,
    aligned 32-byte sectors."""
    off = store_offsets()
    assert np.array_equal(np.sort(off.ravel()), np.arange(TILE))
    g, t = LANE >> 2, LANE & 3
    for w in range(8):
        for m in range(8):
            o = 16 * (64 * w + m + 16 * t) + g
            for k, d in enumerate((0, 128, 8, 136)):
                assert np.array_equal(off[w, m, k], o + d)
                sectors = (4 * off[w, m, k]) // 32
                assert len(set(sectors.tolist())) == 4
                for sct in set(sectors.tolist()):
                    words = off[w, m, k][sectors == sct]
                    assert sorted(words.tolist()) == list(
                        range(8 * sct, 8 * sct + 8))


# ---------------------------------------------------------------- model

def window_item(x, tile, c, K):
    """An item's window as the kernel stages and converts it: ROWS + E - 1
    rows from window_start (zeros outside x), three bf16 planes WROWS rows
    apart, chunk j at j ^ ((j >> 4) & 7)."""
    E = tap_blocks(taps_of(K, c))
    rows = ROWS + E - 1
    g = window_start(tile, c, K) + np.arange(16 * rows)
    s = np.where((g >= 0) & (g < len(x)), x[np.clip(g, 0, len(x) - 1)], 0.0)
    j = np.arange(2 * rows)
    p = j ^ ((j >> 4) & 7)
    planes = np.full((3, 16 * WROWS), np.nan)
    for pl, v in enumerate(split3(s)):
        for k in range(8):
            planes[pl, 8 * p + k] = v[8 * j + k]
    return planes


# (x plane, tap plane) products: h1 x1 into s1, the rest into s2, in the
# kernel's order
S1_PRODUCTS = ((0, 0),)
S2_PRODUCTS = ((1, 0), (1, 1), (2, 0), (0, 1), (0, 2))


def fir_item(planes, h, K, c):
    """fir_split3 for the 8 warps of a block, float64 sums: the ring of B
    fragments (x1 k 0-7, 8-15, x2 k 0-7, 8-15; lanes 16-31 address plane
    x2, 32 WROWS bytes on), x3's fragments at 64 WROWS bytes, the chunk's
    tap planes.  Returns (s1, s2), each (warp, m, lane, 4)."""
    Kc = taps_of(K, c)
    E = tap_blocks(Kc)
    hc = np.asarray(h, np.float64)[CHUNK_TAPS * c:CHUNK_TAPS * c + Kc]
    mem = planes.ravel()
    hp = [tap_words(hc, Kc, E, j) for j in range(3)]
    Q = 64 * np.arange(8)
    lane_plane = np.where(LANE >> 4, 32 * WROWS, 0)

    def load(s, base, nmat):
        addr = np.stack([base + chunk_at(q, E) for q in s])
        for j in range(nmat):                            # bank quads
            quad = (addr[:, 8 * j:8 * j + 8] // 16) % 8
            assert all(len(set(q.tolist())) == 8 for q in quad)
        return ldmatrix(mem, addr, nmat)

    ring = np.full((8, 8, 32, 4, 2), np.nan)
    for j in range(1, 8):
        ring[:, j] = load(Q + j, lane_plane, 4)
    s = np.zeros((2, 8, 8, 32, 4))
    for e in range(E):
        i = e % 8
        ring[:, (8 - i) & 7] = load(Q - e, lane_plane, 4)
        B = ring[:, [(m - i) & 7 for m in range(8)]]
        assert not np.isnan(B).any()
        fb = [B[..., 0:2, :], B[..., 2:4, :],
              np.stack([load(Q + m - e, 64 * WROWS, 2) for m in range(8)],
                       1)]
        for acc, prods in ((0, S1_PRODUCTS), (1, S2_PRODUCTS)):
            for xi, hj in prods:
                fa, _ = a_fragments(hp[hj], E, e)
                assert not np.isnan(fa).any()
                s[acc] = s[acc] + mma(np.zeros(s[acc].shape), fa, fb[xi])
    return s[0], s[1]


def model_fir(x, h, K):
    """#1 through the model: every block's items, the stores of s1 + s2,
    later chunks added to what the earlier wrote."""
    n = len(x)
    y = np.full(n, np.nan)
    off = store_offsets()                      # (w, m, k, lane)
    for block in items(n, K, slots=2):
        for tile, c in block:
            s1, s2 = fir_item(window_item(x, tile, c, K), h, K, c)
            v = np.moveaxis(s1 + s2, -1, 2)    # (w, m, k, lane)
            o = tile * TILE + off
            live = o < n
            if c == 0:
                y[o[live]] = v[live]
            else:
                y[o[live]] += v[live]
    return y


@pytest.mark.parametrize("K,n", [(3, 5000), (17, TILE + 3), (256, 2 * TILE),
                                 (600, TILE + 777), (1000, 4097)])
def test_model_reproduces_convolve(K, n):
    """The model (float64 sums of the six products) against np.convolve of
    the split-exact signal: the products left out (xi hj, i + j > 4) lie
    below 2^-24 of the peak; one, two and three chunks of taps."""
    rng = np.random.default_rng(K)
    x = rng.standard_normal(n).astype(np.float32).astype(np.float64)
    h = rng.standard_normal(K).astype(np.float32).astype(np.float64)
    y = model_fir(x, h, K)
    assert not np.isnan(y).any()
    assert rel(y, np.convolve(x, h)[:n]) < 2e-7


def test_fragments_are_toeplitz_blocks_of_each_chunk():
    """A chunk's tap planes give T_e of its taps h[496 c ..]: the blocks of
    all chunks, placed 31 blocks apart, sum to the whole filter's."""
    K = 1000
    h = np.random.default_rng(0).standard_normal(K)
    full = [toeplitz_block(h, K, e) for e in range(tap_blocks(K))]
    acc = [np.zeros((16, 16)) for _ in full]
    for c in range(chunks_of(K)):
        Kc = taps_of(K, c)
        hc = h[CHUNK_TAPS * c:CHUNK_TAPS * c + Kc]
        for e in range(tap_blocks(Kc)):
            planes = [tap_words(hc, Kc, tap_blocks(Kc), j) for j in range(3)]
            fa = sum(a_fragments(p, tap_blocks(Kc), e)[0] for p in planes)
            blk = np.zeros((16, 16))
            blk[a_map()] = fa
            acc[31 * c + e] += blk
    for a, b in zip(acc, full):
        assert np.allclose(a, b, atol=1e-12)


# ----------------------------------------------------------- precision

def trunc32(v):
    """float64 -> float32 rounded toward zero (mma.sync's fp32 sums)."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f.astype(np.float64)


def split_fir(x, h, two_sets=True):
    """The kernel's arithmetic on whole rows: per chunk and tap block e,
    each product T_e(hj) X(xi) added to its accumulator with one truncation
    per mma (16 exact products and the sum in float64, then toward zero
    to float32); y = fp32(s1 + s2), later chunks added in fp32.
    two_sets=False puts all six products into one accumulator."""
    n, K = len(x), len(h)
    nrows = -(-n // 16)
    y = np.zeros(16 * nrows, np.float32)
    for c in range(chunks_of(K)):
        Kc = taps_of(K, c)
        E = tap_blocks(Kc)
        hc = h[CHUNK_TAPS * c:CHUNK_TAPS * c + Kc]
        lag = CHUNK_TAPS * c + 16 * (E - 1)
        xp = np.concatenate([np.zeros(lag), x, np.zeros(16 * nrows - n)])
        X = split3(xp[:16 * nrows + lag])
        s = np.zeros((2, 16, nrows))
        for e in range(E):
            T = split3(toeplitz_block(hc, Kc, e))
            st = 16 * (E - 1 - e)   # xp[st + 16 q + i] = x[16 (q - e) + i - 496 c]
            B = [v[st:st + 16 * nrows].reshape(nrows, 16).T for v in X]
            for acc, prods in ((0, S1_PRODUCTS), (1, S2_PRODUCTS)):
                for xi, hj in prods:
                    a = acc if two_sets else 0
                    s[a] = trunc32(s[a] + T[hj] @ B[xi])
        yc = (s[0].astype(np.float32) + s[1].astype(np.float32)).T.ravel()
        y = yc if c == 0 else (y + yc).astype(np.float32)
    return y[:n]


@pytest.mark.parametrize("K", [3, 256, 600])
def test_split_keeps_the_gate(K):
    """The six products with truncating fp32 sums against the float64 FIR
    of the fp32 samples: within 1e-5 of the peak (the card gate) on 2
    tiles of random samples, random taps and (K = 256) the main path's
    lowpass; the h1 x1 set alone takes the big terms' truncations, and a
    single set errs more."""
    from libtsd_tpu_torch.ops.fir_design import fir_lowpass
    rng = np.random.default_rng(K)
    x = rng.standard_normal(2 * TILE).astype(np.float32).astype(np.float64)
    hs = [rng.standard_normal(K)]
    if K == 256:
        hs.append(np.asarray(fir_lowpass(256, 0.2)))
    for h in hs:
        h32 = h.astype(np.float32).astype(np.float64)
        ref = np.convolve(x, h)[:len(x)]
        two, one = split_fir(x, h32), split_fir(x, h32, two_sets=False)
        assert rel(two, ref) < 1e-5
        assert rel(two, ref) <= rel(one, ref)
