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
