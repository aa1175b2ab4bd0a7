"""numpy model of the fused chain body ``csrc/chain_body.cuh`` (kernels #3
and #11) on the CPU: the tensor-core FIR as the kernel tiles it, and the
frame pairs it hands to the FFT.

The model follows the kernel lane by lane, vectorised over the 32 lanes
and the 8 warps of a block: the window's bf16 hi/lo planes with their
chunk swizzle, the ``ldmatrix`` row addresses of each B fragment and the
ring of 8 fragment registers, the A fragments read from the two
parity-shifted copies of the reversed taps, ``mma.sync.m16n8k16``'s
fragment index maps (A, B, C/D, from the PTX ISA) and the stores of the
accumulators into the two fp32 planes that the FFT's first pass reads.
It checks the index maps, that every shared-memory access is free of
bank conflicts, that the model reproduces ``np.convolve`` with a history
for every pass set, and the arithmetic facts the tiers rest on.  The FFT
core itself is modelled in ``tests/test_torch_fft_design.py``; here the
pair transform is ``np.fft``.  The header says it is kept in step with
this file; edit both together.
"""
import numpy as np
import pytest
import torch

from torch_compare import rel

NF, ROWS = 4096, 512
PLANE = NF + NF // 32
LANE = np.arange(32)
G_, T_ = LANE >> 2, LANE & 3         # mma's groupID, threadID_in_group


def bf16(a):
    """Round-to-nearest-even to bfloat16 (as __float2bfloat16_rn), as
    float64 values."""
    return (torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
            .to(torch.float64).numpy())


def tap_blocks(K):
    return (K + 14) // 16 + 1


def win_rows(E):
    """Rows of a window plane: 512 + E - 1, rounded up to whole 128-byte
    lines (4 rows), inside which the chunk swizzle permutes."""
    return (ROWS + E - 1 + 3) // 4 * 4


def odd_copy(E):
    return 32 * ((8 * E + 8 + 31) // 32) + 16


def tap_plane_words(E):
    return odd_copy(E) + 8 * E + 8


# ------------------------------------------------- fragment index maps
# mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (PTX ISA, "matrix
# fragments for mma.m16n8k16 with floating point type"): lane = 4 g + t;
# a 32-bit register holds two bf16, the lower column/row in its low half.

def a_map():
    """(lane, reg, half) -> (row, col) of A (16 x 16)."""
    r, h = np.meshgrid(np.arange(4), np.arange(2), indexing="ij")
    row = G_[:, None, None] + 8 * (r & 1)[None]
    col = 2 * T_[:, None, None] + h[None] + 8 * (r >> 1)[None]
    return row, col


def b_map():
    """(lane, reg, half) -> (k, n) of B (16 x 8)."""
    r, h = np.meshgrid(np.arange(2), np.arange(2), indexing="ij")
    k = 2 * T_[:, None, None] + h[None] + 8 * r[None]
    n = np.broadcast_to(G_[:, None, None], k.shape)
    return k, n


def c_map():
    """(lane, i) -> (row, col) of C/D (16 x 8)."""
    i = np.arange(4)
    return G_[:, None] + 8 * (i >> 1)[None], 2 * T_[:, None] + (i & 1)[None]


def ldmatrix(mem, addr, nmat):
    """ldmatrix.m8n8.x{nmat}.b16: lane 8 j + r gives the byte address of
    row r of matrix j; register j of lane l receives elements 2 (l & 3) and
    2 (l & 3) + 1 of row l >> 2 of matrix j.  mem: bf16 values by element
    (byte address / 2); addr: (..., 32) byte addresses.  Returns (..., 32,
    nmat, 2)."""
    rows = addr.reshape(addr.shape[:-1] + (4, 8))[..., :nmat, :]
    el = rows[..., :, G_] // 2                       # (..., nmat, 32)
    el = np.moveaxis(el, -2, -1)[..., None] + 2 * T_[:, None, None] \
        + np.arange(2)
    return mem[el]


def test_fragment_maps_cover_the_tiles():
    """Each map hits every element of its tile once, and an mma of the
    fragments (gathered and scattered through the maps) is A @ B."""
    for rows, cols, m in ((16, 16, a_map()), (16, 8, b_map()),
                          (16, 8, c_map())):
        flat = (m[0] * cols + m[1]).ravel()
        assert np.array_equal(np.sort(flat), np.arange(rows * cols))
    rng = np.random.default_rng(0)
    A, B = rng.standard_normal((16, 16)), rng.standard_normal((16, 8))
    fa, fb = A[a_map()], B[b_map()]
    assert np.allclose(mma(np.zeros((32, 4)), fa, fb), (A @ B)[c_map()],
                       atol=1e-12)


def mma(d, fa, fb):
    """d (..., 32, 4) += A B with A, B rebuilt from their fragments (...,
    32, 4, 2) and (..., 32, 2, 2) through the maps; float64 sums."""
    A = np.zeros(fa.shape[:-3] + (16, 16))
    B = np.zeros(fb.shape[:-3] + (16, 8))
    ar, ac = a_map()
    bk, bn = b_map()
    A[..., ar, ac] = fa
    B[..., bk, bn] = fb
    cr, cc = c_map()
    return d + (A @ B)[..., cr, cc]


# ------------------------------------------------------------- taps

def split3(v):
    """v = v1 + v2 + v3, vj = bf16(v - v1 - ... - v(j-1)), the kernel's
    planes of the signal (x1, x2, x3) and of the taps (h1, h2, h3)."""
    v = np.asarray(v, np.float64)
    out = []
    for _ in range(3):
        out.append(bf16(v))
        v = v - out[-1]
    return out


def x_planes(passes, f32):
    return 1 if passes <= 1 else 3 if (passes == 3 and f32) else 2


def products(passes, f32):
    """The (x plane, tap plane) products of a pass set, 0-based: passes 3
    takes every xi hj with i + j <= 4 (1-based) that is not zero."""
    if passes == 1:
        return [(0, 0)]
    if passes == 2:
        return [(0, 0), (1, 0)]
    return [(0, 0), (1, 0)] + ([(2, 0)] if f32 else []) + \
        [(0, 1), (1, 1), (0, 2)]


def tap_words(h, K, E, j=0):
    """Tap plane j as the kernel builds it (load_taps_bf16): element i <
    16 E + 16 of rv = hj[16 E - i] (zero outside 0 <= k < K) and, at 32-bit
    word odd_copy(E), rv[i + 1].  Returns the plane's bf16 values by
    element."""
    n = 16 * E + 16
    k = 16 * E - np.arange(n + 1)
    hz = np.where((k >= 0) & (k < K), np.asarray(h, np.float64)[
        np.clip(k, 0, K - 1)], 0.0)
    v = split3(hz)[j]
    plane = np.full(2 * tap_plane_words(E), np.nan)
    plane[:n] = v[:n]
    o = 2 * odd_copy(E)
    plane[o:o + n] = v[1:n + 1]
    return plane


def a_fragments(plane, E, e):
    """The A fragment of T_e at each lane: words w, w - 4, w + 4 (a3 = a0)
    of rv (g even) or of its odd copy (g odd), w = 8 (E - e) + t -
    ceil(g / 2).  Returns ((32, 4, 2) values, (3, 32) word addresses)."""
    w = (np.where(G_ & 1, odd_copy(E), 0) + 8 * E + T_ - ((G_ + (G_ & 1))
                                                           >> 1) - 8 * e)
    words = np.stack([w, w - 4, w + 4])
    vals = plane[2 * words[..., None] + np.arange(2)]     # (3, 32, 2)
    return np.stack([vals[0], vals[1], vals[2], vals[0]], 1), words


def toeplitz_block(h, K, e):
    """T_e[j][i] = h[16 e + j - i], zero outside 0 <= k < K."""
    k = 16 * e + np.arange(16)[:, None] - np.arange(16)[None, :]
    return np.where((k >= 0) & (k < K),
                    np.asarray(h, np.float64)[np.clip(k, 0, K - 1)], 0.0)


def banks_distinct(words):
    """True if 4-byte words (32 lanes) that differ lie in different banks
    (equal words are one broadcast)."""
    seen = {}
    for w in np.asarray(words).ravel().tolist():
        if seen.setdefault(w % 32, w) != w:
            return False
    return True


@pytest.mark.parametrize("K", [1, 31, 256, 257, 300])
def test_tap_fragments_are_toeplitz_blocks(K):
    """For every e < E and tap plane j, the lanes' loads assemble the
    block of hj, T_e(hj), exactly, the plane holds every word read, and a
    warp's three loads are each free of bank conflicts."""
    h = np.random.default_rng(K).standard_normal(K).astype(np.float32)
    E = tap_blocks(K)
    for j in range(3):
        plane = tap_words(h, K, E, j)
        for e in range(E):
            fa, words = a_fragments(plane, E, e)
            assert words.min() >= 0 and words.max() < tap_plane_words(E)
            assert not np.isnan(fa).any()
            want = split3(toeplitz_block(h, K, e))[j]
            assert np.array_equal(fa, want[a_map()])
            assert all(banks_distinct(w) for w in words)
    # every tap is in some block: rows past E are zero
    assert not toeplitz_block(h, K, E).any()
    assert toeplitz_block(h, K, E - 1).any() or K == 0


# ----------------------------------------------------------- window

def window_planes(x, hist, f, pair, E, xp):
    """The pair's window as load_window_bf16 stores it: rows (512 or 256)
    + E - 1 rows of 16 samples from sample 4096 f - 16 (E - 1) of the
    channel (x at g >= 0, the history before, zeros before that) as xp
    planes x1, x2, x3, chunk c at c ^ ((c >> 4) & 7).  Returns the planes
    (bf16 values by element) and the chunk slots in store order."""
    wrows = win_rows(E)
    rows = (ROWS if pair else ROWS // 2) + E - 1
    g = 4096 * f - 16 * (E - 1) + np.arange(16 * rows)
    xh = np.concatenate([hist, x])
    s = np.where(g >= -len(hist), xh[np.clip(g + len(hist), 0,
                                             len(xh) - 1)], 0.0)
    c = np.arange(2 * rows)
    p = c ^ ((c >> 4) & 7)
    planes = np.full((3, 16 * wrows), np.nan)
    for j, v in enumerate(split3(s)[:xp]):
        for k in range(8):
            planes[j, 8 * p + k] = v[8 * c + k]
    return planes, p


def chunk_at(s, E):
    """Chunk byte offset each lane gives for B(s) (pair rows s + 8 n):
    lane l names row l & 7 of matrix l >> 3, matrices 0, 1 (and 2, 3) k
    0-7 and 8-15."""
    R = s + 8 * (LANE & 7) + E - 1
    c = 2 * R + ((LANE >> 3) & 1)
    return 16 * (c ^ ((c >> 4) & 7))


def fir_pair(planes_w, taps, K, E, passes, f32, pair, acc=np.float64):
    """fir_mma for the 8 warps of a block: the ring of B(s) fragments of x1
    (and x2: lanes 16-31 address plane x2, 32 wrows bytes on; B(Q + 1) ..
    B(Q + 7) first, then step e loads B(Q - e) into slot -e mod 8), x3's
    fragments loaded where used (plane x3 at 64 wrows bytes), the e loop,
    the products of the pass set and the stores.  acc: the accumulators'
    dtype (each product tile is added in one rounding, float64 exact).
    Returns the two output frames (a, b)."""
    wrows = win_rows(E)
    mem = planes_w.ravel()
    hp = [tap_words(taps, K, E, j) for j in range(3)]
    Q = 64 * np.arange(8)
    nmat = 4 if x_planes(passes, f32) >= 2 else 2
    lane_plane = np.where(LANE >> 4, 32 * wrows, 0)

    def load(s, base, n):                                # s: (8,) rows
        addr = np.stack([base + chunk_at(q, E) for q in s])
        for j in range(n):                               # bank quads
            quad = (addr[:, 8 * j:8 * j + 8] // 16) % 8
            assert all(len(set(q.tolist())) == 8 for q in quad)
        return ldmatrix(mem, addr, n)

    ring = np.full((8, 8, 32, nmat, 2), np.nan)       # warp, slot, ...
    for j in range(1, 8):
        ring[:, j] = load(Q + j, lane_plane, nmat)
    d = np.zeros((8, 8, 32, 4), acc)                    # warp, m, lane
    for e in range(E):
        i = e % 8                              # step e loads B(Q - e)
        ring[:, (8 - i) & 7] = load(Q - e, lane_plane, nmat)
        B = ring[:, [(m - i) & 7 for m in range(8)]]   # B(Q + m - e)
        assert not np.isnan(B[:8 if pair else 4]).any()    # live warps
        fb = [B[..., 0:2, :], B[..., 2:4, :] if nmat == 4 else None]
        if x_planes(passes, f32) == 3:
            fb.append(np.stack([load(Q + m - e, 64 * wrows, 2)
                                for m in range(8)], 1))
        for xi, hj in products(passes, f32):
            fa, _ = a_fragments(hp[hj], E, e)
            d = (d + mma(np.zeros(d.shape), fa, fb[xi])).astype(acc)
    if not pair:
        d[4:] = 0
    out = np.full((2, PLANE), np.nan)
    cr, cc = c_map()
    for w in range(8):
        for m in range(8):
            q = (Q[w] & 255) + m + 8 * cc                  # rows of the lanes
            n = 16 * q + cr
            sl = slot_of(n)
            for k in range(4):
                assert banks_distinct(sl[:, k])
            out[w >> 2, sl] = d[w, m]
    n = slot_of(np.arange(NF))
    assert not np.isnan(out[:, n]).any()
    return out[0, n], out[1, n]


def slot_of(n):
    return n + 8 * (n >> 8)


def runs_of(frames, fpb):
    """Frames per block as grid_for cuts a channel: runs of fpb (even),
    the last one shorter."""
    return [min(fpb, frames - f) for f in range(0, frames, fpb)]


def model_channel(x, hist, taps, K, passes, f32, fpb):
    """One channel through the model blocks: per run, pairs (a lone last
    frame) -> FIR planes -> S += |FFT(a + i b)|^2 -> (S[k] + S[-k]) / 2."""
    E = tap_blocks(K)
    frames = len(x) // NF
    out, f = np.zeros(NF), 0
    for run in runs_of(frames, fpb):
        S = np.zeros(NF)
        for p in range(f, f + run, 2):
            pair = p + 1 < f + run
            planes, slots = window_planes(x, hist, p, pair, E,
                                          x_planes(passes, f32))
            for ph in range(0, len(slots), 8):          # 16-byte stores
                assert len(set((slots[ph:ph + 8] % 8).tolist())) == \
                    len(slots[ph:ph + 8])
            a, b = fir_pair(planes, taps, K, E, passes, f32, pair)
            # the FFT's first pass reads sample u + 256 i at u + 264 i
            S += np.abs(np.fft.fft(a + 1j * b)) ** 2
        out += (S + np.roll(S[::-1], 1)) / 2
        f += run
    return out


def direct(x, hist, h):
    xe = np.concatenate([hist, x])
    y = np.convolve(xe, h)[len(hist):len(xe)]
    return (np.abs(np.fft.fft(y.reshape(-1, NF), axis=-1)) ** 2).sum(0)


def conv_h(x, hist, h):
    """The FIR of x after its history, zero state before the history."""
    xe = np.concatenate([hist, x])
    return np.convolve(xe, h)[len(hist):len(xe)]


def pgram(y):
    return (np.abs(np.fft.fft(y.reshape(-1, NF), axis=-1)) ** 2).sum(0)


@pytest.mark.parametrize("frames,fpb", [(1, 2), (3, 4), (3, 2)])
@pytest.mark.parametrize("K", [1, 31, 256, 257, 300])
def test_model_reproduces_convolution(K, frames, fpb):
    """A history of whole 128-sample rows; one frame (N = 4096) or three (a
    pair and a lone frame in one run, or runs of 2 and 1).  int16 samples:
    passes 1 is the FIR of x1 with h1, passes 2 that of x with h1 (x1 + x2
    == x exactly), passes 3 sum of xi hj, i + j <= 4, each to 1e-12 of
    np.convolve (float64 sums).  fp32 samples at passes 3 (three planes)
    too; and passes 3 is within 1e-6 of the FIR of x with the fp32 taps
    (float64 sums: the dropped products are below 2^-24)."""
    rng = np.random.default_rng(K + frames)
    h = rng.standard_normal(K).astype(np.float32).astype(np.float64)
    H = 128 * ((K + 126) // 128)
    h1, h2, h3 = split3(h)
    xi = rng.integers(-20000, 20001, frames * NF + H).astype(np.float64)
    xf = rng.standard_normal(frames * NF + H).astype(np.float32) \
        .astype(np.float64)
    for x, f32 in ((xi, False), (xf, True)):
        hist, x = x[:H], x[H:]
        xs = [split3(v) for v in (hist, x)]

        def fir(i, j):
            return conv_h(xs[1][i], xs[0][i], (h1, h2, h3)[j])

        for passes in ((1, 2, 3) if not f32 else (3,)):
            taps = h if passes == 3 else h1
            got = model_channel(x, hist, taps, K, passes, f32, fpb)
            want = pgram(sum(fir(i, j) for i, j in products(passes, f32)))
            assert rel(got, want) < 1e-12, (passes, f32)
        assert rel(got, pgram(conv_h(x, hist, h))) < 1e-6


def test_int16_split_is_exact():
    """Every int16 value v: x1 = bf16(v), x2 = bf16(v - x1) sum to v
    exactly (x1 keeps the top 8 significant bits, |v - x1| <= 64 is an
    integer that bf16 holds), so x3 == 0; a float32 whose x3 is a normal
    number is x1 + x2 + x3 exactly."""
    v = np.arange(-32768, 32768, dtype=np.float64)
    x1, x2, x3 = split3(v)
    assert np.array_equal(x1 + x2, v) and not x3.any()
    assert np.abs(v - x1).max() <= 64
    f = np.random.default_rng(1).standard_normal(100000).astype(np.float32)
    f = np.concatenate([f, f * 1e-20, f * 1e20]).astype(np.float64)
    assert np.array_equal(sum(split3(f)), f)


def test_two_passes_in_fp32_are_the_fir_of_rounded_taps():
    """int16 x, passes 2 with the accumulators in float32 (each mma's 16
    products exact, added to D with one fp32 rounding): x1 h1 + x2 h1
    equals the float64 FIR of the bf16-rounded taps to fp32 rounding
    (4e-7 of the peak output, 2^-23 times a few), K = 256, one pair."""
    rng = np.random.default_rng(5)
    K, H = 256, 256
    h1 = bf16(rng.standard_normal(K).astype(np.float32))
    x = rng.integers(-32768, 32768, 2 * NF + H).astype(np.float64)
    hist, x = x[:H], x[H:]
    E = tap_blocks(K)
    planes, _ = window_planes(x, hist, 0, True, E, 2)
    a, b = fir_pair(planes, h1, K, E, 2, False, True, acc=np.float32)
    want = conv_h(x, hist, h1)
    got = np.concatenate([a, b])
    assert rel(got, want) < 4e-7
    assert rel(got, want) > 0          # the fp32 sums do round


def test_pair_identity_with_a_lone_frame():
    """Frames a, b as one complex transform Z = FFT(a + i b): |A|^2 + |B|^2
    = (|Z[k]|^2 + |Z[-k]|^2) / 2, and a lone frame (b = 0) gives |A|^2, to
    1e-12 in float64, on FIR outputs of the model."""
    rng = np.random.default_rng(6)
    K = 31
    h1 = bf16(rng.standard_normal(K))
    x = rng.integers(-2048, 2048, 3 * NF).astype(np.float64)
    E = tap_blocks(K)
    y = conv_h(x, np.zeros(0), h1).reshape(3, NF)
    for f, pair in ((0, True), (2, False)):
        planes, _ = window_planes(x, np.zeros(0), f, pair, E, 2)
        a, b = fir_pair(planes, h1, K, E, 2, False, pair)
        assert rel(a, y[f]) < 1e-12
        Z = np.abs(np.fft.fft(a + 1j * b)) ** 2
        S = (Z + np.roll(Z[::-1], 1)) / 2
        want = (np.abs(np.fft.fft(y[f:f + (2 if pair else 1)], axis=-1))
                ** 2).sum(0)
        assert rel(S, want) < 1e-12


# ======================================================== the wgmma body
# numpy model of ``csrc/chain_wg.cu``, #3's body for passes 1-2 at K <=
# 257: the 64 x 64 Toeplitz tap tiles and the window's bf16 planes in
# wgmma's K-major layout without a swizzle, the A and B descriptors of
# every tap block, step and plane, the accumulators' map (PTX ISA) and
# their float2 stores into the FFT's planes, and the block's walk over
# pair slots with its windows, planes and mbarrier phases.  The header
# says it is kept in step with this file; edit both together.

WG_EMAX = 5
WG_KMAX = 64 * (WG_EMAX - 1) + 1
WG_HALO = 64 * (WG_EMAX - 1)
WG_WIN = WG_HALO + 2 * NF
WG_WROWS = WG_WIN // 64
WG_LBO = 16 * (WG_WROWS + 1)
WG_XPLANE = 8 * WG_LBO
WG_TILE_LBO = 8 * 128
WG_PLANE = NF + NF // 32
WG_TILE_BYTES = 8 * WG_TILE_LBO
WG_SBO = 128
WG_WIN0 = 5 * 64 * 64 * 2 + 4096    # the window's shared byte address
WARP4 = np.arange(4)


def wg_blocks(K):
    """E: tap blocks of 64 phases, ceil((K - 1) / 64) + 1."""
    return (K + 62) // 64 + 1


def wg_tap_tiles(h, K):
    """put_tiles: tile e < E_MAX holds A[j][i] = h[64 e + j - i] (zero
    outside 0 <= k < K), chunk (j, c) (i = 8 c .. 8 c + 7) at e TILE_BYTES
    + c TILE_LBO + 16 j.  Returns the tiles' bf16 values by element, and
    checks that each quarter warp's 16-byte stores (chunk ci = tid + 128
    k: j fastest) hit 8 distinct bank quads."""
    h = np.asarray(h, np.float64)
    mem = np.full(WG_EMAX * WG_TILE_BYTES // 2, np.nan)
    ci = np.arange(WG_EMAX * 8 * 64)
    j, c, e = ci & 63, (ci >> 6) & 7, ci >> 9
    base = e * WG_TILE_BYTES + c * WG_TILE_LBO + 16 * j
    for q in range(0, len(ci), 8):
        assert len(set(((base[q:q + 8] // 16) % 8).tolist())) == 8
    for r in range(8):
        k = 64 * e + j - 8 * c - r
        mem[base // 2 + r] = np.where((k >= 0) & (k < K),
                                      h[np.clip(k, 0, K - 1)], 0.0)
    return mem


def wg_d_map(N=128):
    """wgmma m64nN f32 accumulators: d[i] of lane (g, t), warp w is row 16
    w + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 t + (i & 1).  (warp,
    lane, i) -> (row, col)."""
    i = np.arange(N // 2)
    row = (16 * WARP4[:, None, None] + G_[None, :, None]
           + 8 * ((i >> 1) & 1)[None, None])
    col = 8 * (i >> 2)[None, None] + 2 * T_[None, :, None] + (i & 1)
    return row, np.broadcast_to(col, row.shape)


def wg_desc(addr, lbo):
    """A shared-memory operand's descriptor: start >> 4 in bits 0-13, LBO
    >> 4 in 16-29, SBO (128) >> 4 in 32-45, base offset 0, layout type 0
    (no swizzle)."""
    return (((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16)
            | ((WG_SBO >> 4) << 32))


def wg_read(mem, desc, rows):
    """What wgmma reads for a K-major operand (rows x 16: A's M rows, or
    B's N columns) without a swizzle: element (row, k) at start + 16 (row
    % 8) + SBO (row // 8) + 2 (k % 8) + LBO (k // 8), each core matrix 8
    rows of 16 contiguous bytes.  mem: bf16 values by element; returns
    ((rows, 16) values, byte addresses)."""
    start = (desc & 0x3FFF) << 4
    lbo, sbo = ((desc >> 16) & 0x3FFF) << 4, ((desc >> 32) & 0x3FFF) << 4
    r, k = np.arange(rows)[:, None], np.arange(16)[None]
    addr = (start + 16 * (r % 8) + sbo * (r // 8) + 2 * (k % 8)
            + lbo * (k // 8))
    return mem[addr // 2], addr


def wg_split(v, kX):
    """The split of 8-sample chunks into kX bf16 planes: x1 = bf16(v), x2 =
    bf16(v - x1)."""
    return split3(v)[:kX]


def wg_window(x, hist, c, p, F, N_, hist_len):
    """Slot (c, p)'s window as the split stores it: samples 8192 p - 256
    .. of channel c, those in [lo, hi) from the raw stage (the halo from x,
    or for p = 0 the last min(hist_len, 256) of the history), zeros
    elsewhere (before the history, after a lone frame).  Returns (the
    window's samples, lo, hi)."""
    two = 2 * p + 1 < F
    lo = 0 if p > 0 else WG_HALO - min(hist_len, WG_HALO)
    hi = WG_HALO + (2 if two else 1) * NF
    g = 2 * p * NF - WG_HALO + np.arange(WG_WIN)
    xh = np.concatenate([hist[c][len(hist[c]) - hist_len:], x[c]])
    s = xh[np.clip(g + hist_len, 0, len(xh) - 1)]
    i = np.arange(WG_WIN)
    return np.where((i >= lo) & (i < hi), s, 0.0), lo, hi


def wg_store_window(samples, kX):
    """The window's kX planes in shared memory (bf16 values by element):
    chunk ci (row ci >> 3, column ci & 7) at (ci & 7) LBO + 16 (ci >> 3),
    plane j at j XPLANE.  Checks that the 16-byte stores of each quarter
    warp hit 8 distinct bank quads."""
    mem = np.full(kX * WG_XPLANE // 2, np.nan)
    ci = np.arange(WG_WIN // 8)
    base = (ci & 7) * WG_LBO + 16 * (ci >> 3)
    for q in range(0, len(ci), 8):
        assert len(set(((base[q:q + 8] // 16) % 8).tolist())) == 8
    planes = wg_split(samples, kX)
    for j in range(kX):
        for k in range(8):
            mem[(j * WG_XPLANE + base) // 2 + k] = planes[j][8 * ci + k]
    return mem


def wg_fir_pair(mem, tiles, kX):
    """fir_pair: every (e < E_MAX, s, plane) product, A from the tiles and
    B from the window through their descriptors (tiles at shared byte 0,
    the window at WG_WIN0), float64 sums (the blocks past E hold zero
    taps).  Returns D (64 phases j, 128 rows q): output sample 64 q + j of
    the pair."""
    memb = np.concatenate([tiles, np.full(WG_WIN0 // 2 - len(tiles),
                                          np.nan), mem])
    a0 = wg_desc(0, WG_TILE_LBO)
    b0 = wg_desc(WG_WIN0 + 16 * (WG_EMAX - 1), WG_LBO)
    D = np.zeros((64, 128))
    for e in range(WG_EMAX):
        for s in range(4):
            A, _ = wg_read(memb, a0 + (e * WG_TILE_BYTES
                                       + 2 * s * WG_TILE_LBO) // 16, 64)
            for j in range(kX):
                off = j * WG_XPLANE + 2 * s * WG_LBO - 16 * e
                B, _ = wg_read(memb, b0 + off // 16, 128)
                assert not np.isnan(A).any() and not np.isnan(B).any()
                D += A @ B.T
    return D


def wg_slot(n):
    return n + 4 * (n >> 7)


def wg_store_pair(D, two=True):
    """store_pair: d[r] and d[r + 32] (r < 32; frames a and b of one
    sample, b zeros for a lone frame) as one float2 at wg_slot(n), n = 64 q
    + j.  Checks that each 8-byte store's half warps hit 16 distinct bank
    pairs.  Returns the planes (PLANE,) complex: frame a real, b
    imaginary."""
    dr, dc = wg_d_map()                                 # (4, 32, 64)
    d = D[dr, dc]
    out = np.full(WG_PLANE, np.nan + 0j)
    for w in range(4):
        for r in range(32):
            n = 64 * dc[w, :, r] + dr[w, :, r]
            assert (dc[w, :, r + 32] == dc[w, :, r] + 64).all()
            sl = wg_slot(n)
            for half in (sl[:16], sl[16:]):
                assert len(set((half % 16).tolist())) == 16
            out[sl] = d[w, :, r] + 1j * (d[w, :, r + 32] if two else 0.0)
    return out


@pytest.mark.parametrize("K", [1, 31, 64, 65, 256, WG_KMAX])
def test_wg_tap_tiles_are_toeplitz_blocks(K):
    """Through its descriptor, step s of tile e reads T_e[:, 16 s: 16 s +
    16], T_e[j][i] = h[64 e + j - i], exactly, each core matrix 128
    contiguous bytes; blocks at e >= E are zero and E <= E_MAX up to the
    limit; and the tiles' banded product is np.convolve."""
    h = np.random.default_rng(K).standard_normal(K)
    E = wg_blocks(K)
    assert E <= WG_EMAX and wg_blocks(WG_KMAX + 1) == WG_EMAX + 1
    tiles = wg_tap_tiles(h, K)
    j, i = np.arange(64)[:, None], np.arange(64)[None]
    T = []
    for e in range(WG_EMAX + 1):
        k = 64 * e + j - i
        T.append(np.where((k >= 0) & (k < K), h[np.clip(k, 0, K - 1)], 0.0))
        assert (e < E) == bool(T[-1].any())
    for e in range(WG_EMAX):
        for s in range(4):
            d = wg_desc(e * WG_TILE_BYTES + 2 * s * WG_TILE_LBO, WG_TILE_LBO)
            A, addr = wg_read(tiles, d, 64)
            assert np.array_equal(A, T[e][:, 16 * s:16 * s + 16])
            for r0 in range(0, 64, 8):
                for k0 in (0, 8):
                    cm = np.sort(addr[r0:r0 + 8, k0:k0 + 8].ravel())
                    assert np.array_equal(cm - cm[0], np.arange(0, 128, 2))
    x = np.random.default_rng(K + 1).standard_normal(64 * 8)
    y = np.zeros(64 * 8)
    for q in range(8):
        for e in range(min(E, q + 1)):
            y[64 * q:64 * q + 64] += T[e] @ x[64 * (q - e):64 * (q - e) + 64]
    assert rel(y, np.convolve(x, h)[:len(x)]) < 1e-12


@pytest.mark.parametrize("kX", [1, 2])
@pytest.mark.parametrize("base", [0, 65536 + 16])
def test_wg_descriptors_address_the_shifted_rows(base, kX):
    """Every (e, s, plane) B descriptor reads B[k][n] = plane j's value of
    window sample 64 (n + 4 - e) + 16 s + k for the pair's 128 output rows
    n: the shift by e rows is the start address 16 e bytes back, which
    stays inside the plane, and adding off / 16 to the descriptor changes
    its start field alone (no carry into LBO).  Without a swizzle each core
    matrix is 128 contiguous bytes (32 distinct banks) whatever the shift,
    and the base-offset field stays 0; a 128-byte swizzle would move a
    one-row shift inside its 1024-byte atom instead."""
    rng = np.random.default_rng(base + kX)
    samples = rng.integers(-32768, 32768, WG_WIN).astype(np.float64)
    mem = wg_store_window(samples, kX)
    planes = wg_split(samples, kX)
    memb = np.concatenate([np.full(base // 2, np.nan), mem])
    b0 = wg_desc(base + 16 * (WG_EMAX - 1), WG_LBO)
    n, k = np.arange(128)[:, None], np.arange(16)[None]
    for e in range(WG_EMAX):
        for s in range(4):
            for j in range(kX):
                off = j * WG_XPLANE + 2 * s * WG_LBO - 16 * e
                d = b0 + off // 16
                assert d == wg_desc(base + 16 * (WG_EMAX - 1) + off, WG_LBO)
                assert (d >> 49) & 7 == 0 and d >> 62 == 0
                B, addr = wg_read(memb, d, 128)
                assert addr.min() >= base + j * WG_XPLANE
                assert addr.max() < base + (j + 1) * WG_XPLANE
                idx = 64 * (n + WG_EMAX - 1 - e) + 16 * s + k
                assert np.array_equal(B, planes[j][idx])
                for r0 in range(0, 128, 8):
                    for k0 in (0, 8):
                        cm = np.sort(addr[r0:r0 + 8, k0:k0 + 8].ravel())
                        assert np.array_equal(cm - cm[0],
                                              np.arange(0, 128, 2))
                        assert banks_distinct(cm[::2] // 4)


@pytest.mark.parametrize("dtype", ["int16", "int8", "bfloat16", "float32"])
def test_wg_split_is_exact(dtype):
    """The split into x1 (and x2 at passes 2): every int16 value is x1 + x2
    exactly; int8 and bfloat16 samples are x1 exactly (x2 == 0, so passes
    1 is their whole FIR); float32 samples (split/2) keep x1 + x2 with an
    error below 2^-16 of the value, the tier's stated arithmetic."""
    if dtype == "int16":
        v = np.arange(-32768, 32768, dtype=np.float64)
    elif dtype == "int8":
        v = np.arange(-128, 128, dtype=np.float64)
    elif dtype == "bfloat16":
        b = np.arange(0, 1 << 16, dtype=np.uint32) << 16
        v = b.view(np.float32)
        v = v[np.isfinite(v)].astype(np.float64)
    else:
        v = np.random.default_rng(3).standard_normal(100000).astype(
            np.float32).astype(np.float64)
    x1, x2 = wg_split(v, 2)
    if dtype in ("int8", "bfloat16"):
        assert np.array_equal(x1, v) and not x2.any()
    elif dtype == "int16":
        assert np.array_equal(x1 + x2, v)
    else:
        assert np.all(np.abs(x1 + x2 - v) <= np.abs(v) * 2.0 ** -16)


def wg_walk(C, F, G, seed):
    """The block walk and its hand-offs, run as the three roles would in a
    random interleaving: per block, slots [T b / G, T (b + 1) / G) of T =
    C ceil(F / 2); FIR warpgroup w takes slots i = w, w + 2, ... (its k-th:
    k = i >> 1), splits each into window w, runs its products, waits
    empty_pl[w] at parity (k - 1) & 1 from k = 1 and fills planes w, its
    slot advanced two at a time without a division; the FFT role waits
    full_pl[i & 1] at parity (i >> 1) & 1, transforms, flushes at a
    channel's run end (a countdown of the slots left in the channel) and
    releases.  An mbarrier is a count of completed phases; a parity wait
    passes when the count's parity differs from the waited one, which is
    right only while the count is the waited phase or one more: the model
    asserts that at every wait.  Returns per block the (channel, pair, two
    frames) of each slot the FFT consumed and the channels it flushed."""
    rng = np.random.default_rng(seed)
    P = (F + 1) // 2
    T = C * P
    out = []
    for b in range(G):
        t0, t1 = T * b // G, T * (b + 1) // G
        n = t1 - t0
        done = {(k, j): 0 for k in ("full", "empty") for j in (0, 1)}
        planes = {}

        def passes(key, phase):
            assert phase <= done[key] <= phase + 1, (key, phase, done[key])
            return done[key] & 1 != phase & 1

        def advance(slot, k):                        # (c, p) + k slots
            c, p = slot
            p += k
            while p >= P:
                p -= P
                c += 1
            return c, p

        nxt = [0, 1]                                 # each warpgroup's next i
        slots = [divmod(t0 + w, P) for w in (0, 1)]
        fft_i, consumed, flushed = 0, [], []
        c_fft, left = t0 // P, P - t0 % P
        while min(nxt) < n or fft_i < n:
            can = []
            for w in (0, 1):
                i = nxt[w]
                if i < n and (i < 2 or passes(("empty", w), (i >> 1) - 1)):
                    can.append(w)
            if fft_i < n and passes(("full", fft_i & 1), fft_i >> 1):
                can.append(2)
            assert can, "deadlock"
            r = can[rng.integers(len(can))]
            if r < 2:
                w, i = r, nxt[r]
                assert slots[w] == divmod(t0 + i, P)
                assert planes.get(w) is None         # released
                planes[w] = i
                done[("full", w)] += 1
                nxt[w] += 2
                slots[w] = advance(slots[w], 2)
            else:
                i = fft_i
                assert planes[i & 1] == i
                t = t0 + i
                c, p = divmod(t, P)
                assert c == c_fft
                consumed.append((c, p, 2 * p + 1 < F))
                if i + 1 == n or left == 1:
                    flushed.append(c)
                planes[i & 1] = None
                done[("empty", i & 1)] += 1
                fft_i += 1
                left -= 1
                if left == 0:
                    left, c_fft = P, c_fft + 1
        out.append((consumed, flushed))
    return out


@pytest.mark.parametrize("C,F,G", [(1, 1, 1), (1, 3, 1), (2, 7, 3),
                                   (3, 5, 2), (2, 8, 5), (1, 2, 4),
                                   (5, 9, 7), (4, 64, 3)])
def test_wg_rings_over_odd_runs_and_lone_frames(C, F, G):
    """Windows, planes and their phases over blocks that walk odd
    runs of slots (1, 2, 3 and more pairs, runs that cross channels), with
    a lone last frame wherever F is odd, and more blocks than slots (the
    empty ones return at once); in several random interleavings of the
    roles, every parity wait unambiguous.  Every slot is consumed once, in
    order, and every (block, channel) run flushed once at its end."""
    P = (F + 1) // 2
    for seed in range(6):
        walk = wg_walk(C, F, G, seed)
        seen = [s for consumed, _ in walk for s in consumed]
        assert seen == [(c, p, 2 * p + 1 < F) for c in range(C)
                        for p in range(P)]
        for consumed, flushed in walk:
            assert flushed == sorted(set(c for c, _, _ in consumed))
        assert sum(not two for _, _, two in seen) == (C if F % 2 else 0)


def wg_model(x, hist, hist_len, h, K, passes, G):
    """The blocks of a launch through the model: each slot's window and
    planes, the FIR from the tap tiles and descriptors into the pair's
    float2 planes, the FFT's first loads (column u: slots of u + 256 i,
    each warp's 8-byte loads on distinct bank pairs), S += |FFT(a + i
    b)|^2, and at each channel's run end (S[k] + S[-k]) / 2 added into
    the output."""
    C, N_ = x.shape
    F = N_ // NF
    P = (F + 1) // 2
    T = C * P
    tiles = wg_tap_tiles(h, K)
    out = np.zeros((C, NF))
    u = np.arange(256)
    for r in range(16):
        for w0 in range(0, 256, 16):
            assert len(set((wg_slot(u[w0:w0 + 16] + 256 * r) % 16)
                           .tolist())) == 16
    for b in range(G):
        S = np.zeros(NF)
        for t in range(T * b // G, T * (b + 1) // G):
            c, p = divmod(t, P)
            samples, _, _ = wg_window(x, hist, c, p, F, N_, hist_len)
            mem = wg_store_window(samples, passes)
            pl = wg_store_pair(wg_fir_pair(mem, tiles, passes),
                               2 * p + 1 < F)
            z = pl[wg_slot(np.arange(NF))]
            assert not np.isnan(z.real).any()
            S += np.abs(np.fft.fft(z)) ** 2
            if t + 1 == T * (b + 1) // G or (t + 1) % P == 0:
                out[c] += (S + np.roll(S[::-1], 1)) / 2
                S = np.zeros(NF)
    return out


@pytest.mark.parametrize("frames,G,hist_len", [(1, 1, 256), (3, 2, 128),
                                               (3, 1, 0), (4, 3, 384)])
@pytest.mark.parametrize("K", [1, 31, 64, 65, 256, WG_KMAX])
def test_wg_model_reproduces_convolution(K, frames, G, hist_len):
    """Two channels of int16 samples through the model's blocks (one frame;
    three, so a pair and a lone frame, cut between blocks or not; four
    over three blocks) with a history of 0-384 samples (zero state before
    it): passes 2 is the FIR of x with the bf16 taps, passes 1 that of x1
    (int16 -> bf16), each to 1e-12 of np.convolve's periodogram (float64
    sums)."""
    rng = np.random.default_rng(K + 7 * frames + hist_len)
    h1 = bf16(rng.standard_normal(K).astype(np.float32))
    C = 2
    x = rng.integers(-20000, 20001, (C, frames * NF)).astype(np.float64)
    hist = rng.integers(-20000, 20001, (C, 384)).astype(np.float64)
    for passes in (1, 2):
        got = wg_model(x, hist, hist_len, h1, K, passes, G)
        for c in range(C):
            hc = hist[c][384 - hist_len:]
            xs = x[c] if passes == 2 else split3(x[c])[0]
            hs = hc if passes == 2 else split3(hc)[0]
            want = pgram(conv_h(xs, hs, h1))
            assert rel(got[c], want) < 1e-12, (passes, c)


@pytest.mark.parametrize("passes,sample_bytes", [(1, 1), (1, 2), (2, 2),
                                                 (2, 4)])
def test_wg_route_and_shared_memory(passes, sample_bytes):
    """The wrapper's mirror of the C side: passes 1-2 take the wgmma body
    up to K_MAX_WG = 64 (E_MAX - 1) + 1 taps and chain_frames above it,
    passes 0 and 3 never; the body's shared memory (two pairs' planes, tap
    tiles, windows) is the model's and leaves the SM 60 KB of L1 (a 196 KB
    carve-out) for the first pass's twiddles."""
    from libtsd_tpu_torch.ops.kernels import _build, chain
    assert chain.K_MAX_WG == WG_KMAX
    assert chain.wg_route(passes, WG_KMAX)
    assert not chain.wg_route(passes, WG_KMAX + 1)
    assert not chain.wg_route(0, 1) and not chain.wg_route(3, 1)
    want = (128 + 2 * WG_PLANE * 8 + WG_EMAX * WG_TILE_BYTES
            + 2 * passes * WG_XPLANE)
    assert chain.smem_bytes(passes, 256, sample_bytes) == want
    assert want <= 196 * 1024 <= _build.SMEM_MAX


# ------------------------------------------ the wgmma body with #11's halo
# chain_wg.cu with kHalo on (chain_wg::chain_halo_kernel): persistent
# block b of G pushes channels [C b / G, C (b + 1) / G) of its shard's
# input tails (the last P = (D - 1) 128 samples) into the right
# neighbour's receive slot in its prologue, then publishes their flags;
# a FIR warpgroup whose pair slot is a channel's first (p == 0) on a shard
# with a left slot waits for that channel's flag before it splits, and
# then reads the history (hist_len P) from the slot.

def wg_push_ranges(C, G):
    """Each block's channels to push, as the kernel cuts them (64-bit
    products, floor division)."""
    return [range(C * b // G, C * (b + 1) // G) for b in range(G)]


def halo_len(K):
    """P = (D - 1) 128 for the D blocks of fir_toeplitz_mats at K taps."""
    return ((K - 2) // 128 + 1) * 128


def wg_halo_model(xs, hist0, h, K, passes, G):
    """A row of time shards through the model's blocks: shard t's blocks
    copy their channels' last P samples into shard t + 1's receive slot
    (each row once), and shard t > 0 runs wg_model with that slot as its
    history; shard 0 takes hist0 ((C, P) samples, or None: zero state).
    Returns each shard's partial spectra."""
    C, N_ = xs[0].shape
    P = halo_len(K)
    recv = [np.full((C, max(P, 1)), np.nan) for _ in xs]
    for t, x in enumerate(xs[:-1]):
        for chans in wg_push_ranges(C, G):
            for c in chans:
                assert np.isnan(recv[t + 1][c]).all()
                recv[t + 1][c, :P] = x[c, N_ - P:]
    none = np.zeros((C, 1))
    outs = []
    for t, x in enumerate(xs):
        if t > 0:
            hist, hist_len = (recv[t], P) if P else (none, 0)
        else:
            hist, hist_len = (hist0, P) if hist0 is not None else (none, 0)
        outs.append(wg_model(x, hist, hist_len, h, K, passes, G))
    return outs


@pytest.mark.parametrize("with_hist0", [False, True])
@pytest.mark.parametrize("K", [1, 64, 65, 256, WG_KMAX])
@pytest.mark.parametrize("T,frames", [(2, 3), (3, 1), (4, 2)])
def test_wg_halo_model_reproduces_the_row(T, frames, K, with_hist0):
    """Two channels of int16 samples cut into 2-4 time shards (three frames
    a shard, a pair and a lone frame; one; two) over 2 blocks a shard: the
    shards' spectra summed are np.convolve's periodogram of the whole row
    after hist0 (or zero state), each shard's history its left
    neighbour's pushed tail; passes 2 the FIR of x with the bf16 taps,
    passes 1 that of x1, to 1e-12 (float64 sums)."""
    rng = np.random.default_rng(K + 10 * T + with_hist0)
    h1 = bf16(rng.standard_normal(K).astype(np.float32))
    C, P = 2, halo_len(K)
    x = rng.integers(-20000, 20001, (C, T * frames * NF)).astype(np.float64)
    xs = np.split(x, T, axis=1)
    hist0 = (rng.integers(-20000, 20001, (C, P)).astype(np.float64)
             if with_hist0 and P else None)
    for passes in (1, 2):
        got = sum(wg_halo_model(xs, hist0, h1, K, passes, 2))
        for c in range(C):
            hc = hist0[c] if hist0 is not None else np.zeros(0)
            xc = x[c] if passes == 2 else split3(x[c])[0]
            hc = hc if passes == 2 else split3(hc)[0]
            want = pgram(conv_h(xc, hc, h1))
            assert rel(got[c], want) < 1e-12, (passes, c)


@pytest.mark.parametrize("G", [1, 7, 132, 300])
@pytest.mark.parametrize("C", [1, 3, 256])
def test_wg_push_ranges_cover_each_channel_once(C, G):
    """The prologue's channel ranges, over the grid's blocks in order, are
    0 .. C - 1 each exactly once: more blocks than channels leave some
    blocks none; a block takes at most ceil(C / G)."""
    ranges = wg_push_ranges(C, G)
    assert [c for r in ranges for c in r] == list(range(C))
    assert max(len(r) for r in ranges) == -(-C // G)
    assert sum(len(r) == 0 for r in ranges) == max(G - C, 0)


def wg_halo_walk(T, C, F, G, one_card, seed):
    """One call of #11 on the wgmma body over a row of T shards of G
    blocks, each block's prologue (its pushes, then after the fence and
    barrier its flags) and its two FIR warpgroups (after the tiles'
    barrier; slots i = w, w + 2, ... of [S b / G, S (b + 1) / G), S = C
    ceil(F / 2); at a channel's first pair on t > 0 a wait for that
    channel's flag, then the split that reads the slot) run as actors in a
    random interleaving, a wait passing only once its flag holds the
    call's epoch.  The receive slots start poisoned and the flags at the
    call two back's epoch.  one_card: a shard's blocks start once every
    block of the shard before it has ended (one stream in time order);
    else all shards run at once (a card each).  Returns each block's
    events and the number of wait steps that found the flag unset."""
    rng = np.random.default_rng(seed)
    S = C * ((F + 1) // 2)
    recv = [[None] * C for _ in range(T)]
    flag = np.full((T, C), -1)                 # the epoch of call e - 2
    through, ended = set(), set()              # past the tiles' barrier
    logs = {(t, b): [] for t in range(T) for b in range(G)}
    blocked = [0]

    def prologue(t, b):
        yield lambda: not one_card or t == 0 or all(
            (t - 1, a) in ended for a in range(G))
        chans = wg_push_ranges(C, G)[b] if t + 1 < T else []
        for c in chans:                        # 16-byte stores
            yield lambda: True
            recv[t + 1][c] = (t, c)
            logs[t, b].append(("push", c))
        for c in chans:                        # after the block's barrier
            yield lambda: True
            flag[t + 1, c] = 0
            logs[t, b].append(("release", c))
        yield lambda: True
        through.add((t, b))

    def warpgroup(t, b, w):
        yield lambda: (t, b) in through
        for i in range(S * b // G + w, S * (b + 1) // G, 2):
            c, p = divmod(i, (F + 1) // 2)
            if p == 0 and t > 0:
                def ready(c=c):
                    blocked[0] += flag[t, c] != 0
                    return flag[t, c] == 0
                yield ready
                logs[t, b].append(("wait", c))
                assert recv[t][c] == (t - 1, c)    # the left tail, pushed
            yield lambda: True
            logs[t, b].append(("split", c, p))

    # actors 3 k .. 3 k + 2: block k's prologue and two warpgroups; the
    # block ends when all three have
    live = {}
    for t in range(T):
        for b in range(G):
            for a in (prologue(t, b), warpgroup(t, b, 0),
                      warpgroup(t, b, 1)):
                live[len(live)] = a
    preds = {k: next(a) for k, a in live.items()}
    left = [3] * (T * G)
    while live:
        ready = [k for k in live if preds[k]()]
        assert ready, "deadlock"
        k = ready[rng.integers(len(ready))]
        try:
            preds[k] = next(live[k])
        except StopIteration:
            del live[k]
            left[k // 3] -= 1
            if left[k // 3] == 0:
                ended.add(divmod(k // 3, G))
    return logs, blocked[0]


@pytest.mark.parametrize("one_card", [False, True])
@pytest.mark.parametrize("T,C,F,G", [(2, 1, 1, 1), (2, 3, 5, 2),
                                     (4, 2, 8, 5), (3, 5, 9, 7),
                                     (4, 2, 2, 5), (2, 7, 3, 3)])
def test_wg_halo_pushes_precede_every_wait(T, C, F, G, one_card):
    """In random interleavings of every block of a row (more blocks than
    slots and than channels included): no deadlock; each block's pushes
    and flags all come before its first wait; each wait sees its
    channel's tail from the left shard; every slot is split once; every
    channel's first pair on t > 0 waits once.  In time order on one card
    no wait ever finds its flag unset."""
    for seed in range(8):
        logs, blocked = wg_halo_walk(T, C, F, G, one_card, seed)
        for (t, b), log in logs.items():
            kinds = [e[0] for e in log]
            if "wait" in kinds:
                first = kinds.index("wait")
                assert "push" not in kinds[first:]
                assert "release" not in kinds[first:]
            pushed = [e[1] for e in log if e[0] == "push"]
            want = list(wg_push_ranges(C, G)[b]) if t + 1 < T else []
            assert pushed == want
            assert [e[1] for e in log if e[0] == "release"] == want
        for t in range(T):
            splits = sorted(e[1:] for b in range(G) for e in logs[t, b]
                            if e[0] == "split")
            assert splits == [(c, p) for c in range(C)
                              for p in range((F + 1) // 2)]
            waits = sorted(e[1] for b in range(G) for e in logs[t, b]
                           if e[0] == "wait")
            assert waits == (list(range(C)) if t > 0 else [])
        if one_card:
            assert blocked == 0


def test_wg_halo_kernel_name_is_the_metrics():
    """The benchmark's #11 metrics find the kernel by its bare function
    name (portbench/trace.py's kernel_ident), so the wgmma body's #11 keeps
    the name chain_halo_kernel."""
    from portbench.trace import kernel_ident
    assert kernel_ident(
        "void chain_wg::chain_halo_kernel<short, 2>(short const*, short "
        "const*, short const*, unsigned int const*, short*, unsigned int*, "
        "float const*, float2 const*, float*, long long, int, int, int, "
        "int, int, long long, unsigned int)") == "chain_halo_kernel"
    assert kernel_ident("void chain_wg::chain_kernel<short, 2>(short "
                        "const*)") == "chain_kernel"
