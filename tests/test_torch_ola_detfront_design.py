"""numpy models of the frame receiver's kernels, #9 (``csrc/ola.cu``) and
#10 (``csrc/detfront.cu``), on the CPU.

#9: one window through the register-resident FFT core of
``csrc/fft_reg.cuh`` forward and back, thread by thread as the kernel runs
it (min(Nf/16, 256) threads, W = Nf/4096 columns a thread above Nf =
4096): the forward's last pass leaves bins u + U k in register k of thread
u, which times H (conjugated) are exactly the inverse's first-pass input;
the inverse's first exchange may start only once every column has been
read (the kernel's barrier; at W > 1 a thread holds all W x 16 values
across it), and the window round-trips to ``np.fft`` within 1e-12 (float64
model), for every Nf = 2^8 .. 2^14.  A short stream through the model
windows equals ``np.convolve``.

#10: a block of the tensor-core detector front end: the five bf16 tap
planes of each chunk of tap blocks (reversed taps and their odd copy), the
A fragments each lane reads, the six swizzled bf16 window planes, the
ldmatrix addresses of the rings of e1/e2 and of xr/xi fragments (two
passes), the mma of a step (e1 + e2 with the ones; x1 h1 + x2 h1 + x1 h2
of cr = hr xr - hi xi and ci = hr xi + hi xr), runs of 4 steps summed
from zero and added to the sums, and the stores, in float64 sums.  It
equals the sum of the same products by ``np.convolve``, every ldmatrix
phase and 16-byte store hits 8 distinct bank quads, the chosen pieces keep
1e-5 of the peak on random data and on data with a large dynamic range,
and an exactly silent stretch gives exact zeros in every plane.

The models use test_torch_fft_design.py's model of the FFT core and
test_torch_chain_design.py's fragment maps (mma.m16n8k16, ldmatrix); the
kernels' headers say they are kept in step with this file.
"""
import numpy as np
import pytest

from libtsd_tpu_torch.ops.kernels.fft import twiddle_plan, twiddle_table
from test_torch_chain_design import (LANE, a_fragments, banks_distinct, bf16,
                                     c_map, ldmatrix, mma, odd_copy,
                                     tap_plane_words)
from test_torch_fft_design import dft_reg, fft_pos, half_warps_distinct, swz
from torch_compare import rel


def cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# ------------------------------------------------------------- #9 ola

class Core:
    """fft_reg::Core<L> on one transform, columns u vectorised: each method
    takes and returns the kernel's registers (16 arrays over u) or the
    exchange buffer, and says which slots it read or wrote."""

    def __init__(self, L):
        self.L, self.n, self.U = L, 1 << L, 1 << (L - 4)
        self.plan, self.tw = twiddle_plan(L), twiddle_table(L)

    def first_pass(self, v, u):
        mL, rL, off = self.plan[0]
        R, Q, S = 1 << rL, self.n >> rL, 16 >> rL
        v = list(v)
        for q in range(S):
            t = u + self.U * q
            out = dft_reg([v[q + S * r] for r in range(R)], rL)
            for k in range(R):
                v[q + S * k] = out[k] * (self.tw[off + (k - 1) * Q + t]
                                         if k else 1)
        return v

    def put_first(self, buf, v, u):
        slots = np.stack([swz(u + self.U * i, self.L) for i in range(16)], 1)
        buf[slots] = np.stack(v, 1)
        return slots

    def middle(self, buf, u):
        for mL, rL, off in self.plan[1:-1]:
            Q = 1 << (mL - 4)
            b, t = u >> (mL - 4), u & (Q - 1)
            pos = np.stack([(b << mL) + t + (r << (mL - 4))
                            for r in range(16)], 1)
            slots = swz(pos, self.L)
            out = dft_reg([buf[slots[:, r]] for r in range(16)], 4)
            for k in range(1, 16):
                out[k] = out[k] * self.tw[off + (k - 1) * Q + t]
            buf[slots] = np.stack(out, 1)

    def last_pass(self, buf, u):
        col = fft_pos(u, self.L) >> 4
        slots = np.stack([swz(16 * col + r, self.L) for r in range(16)], 1)
        return dft_reg([buf[slots[:, r]] for r in range(16)], 4), slots


def ola_window(win, H, L, V):
    """One window of ola_kernel<L>: returns its samples p >= V (scaled,
    conjugated) and asserts the handoff's order: each thread u0 <
    min(U, 256) takes columns u0 + 256 k, k < W."""
    core = Core(L)
    NT = min(core.U, 256)
    W = core.U // NT
    u0 = np.arange(NT)
    cols = [u0 + NT * k for k in range(W)]
    buf = np.full(core.n, np.nan + 0j)
    for u in cols:                                    # forward
        v = core.first_pass([win[u + core.U * i] for i in range(16)], u)
        core.put_first(buf, v, u)
    core.middle(buf, np.arange(core.U))
    z, read = [], []
    for u in cols:
        v, slots = core.last_pass(buf, u)
        read.append(slots)
        # natural-order bins u + U j, times H[u + U j], conjugated
        z.append([np.conj(v[j] * H[u + core.U * j]) for j in range(16)])
    # --- barrier: every column read; W x 16 values a thread held ---
    wrote = []
    for u, v in zip(cols, z):                         # inverse
        v = core.first_pass(v, u)
        wrote.append(core.put_first(buf, v, u))
    for slots in (read, wrote):                       # each a permutation
        flat = np.concatenate([s.ravel() for s in slots])
        assert np.array_equal(np.sort(flat), np.arange(core.n))
    # the hazard is real: a thread's stores hit slots that other threads
    # read, and (W > 1) column k's stores hit slots of a later column
    assert any(set(w.tolist()) != set(r.tolist())
               for w, r in zip(wrote[0], read[0]))
    for k in range(W):
        for kk in range(k + 1, W):
            assert np.intersect1d(wrote[k], read[kk]).size > 0
    for slots in wrote:                               # 256-thread block
        for i in range(16):
            assert half_warps_distinct(slots[:, i])
    core.middle(buf, np.arange(core.U))
    y = np.full(core.n, np.nan + 0j)
    for u in cols:
        v, _ = core.last_pass(buf, u)
        for j in range(16):
            y[u + core.U * j] = np.conj(v[j]) / core.n
    assert not np.isnan(y).any()
    return y[V:]


@pytest.mark.parametrize("L", list(range(8, 15)))
def test_ola_handoff_round_trip(L):
    """The forward's last-pass registers x H are the inverse's first-pass
    registers: the model window equals IFFT(FFT(window) H) to 1e-12
    (float64), at every Nf the kernel takes, with the column order and
    register hold of Nf > 4096."""
    rng = np.random.default_rng(L)
    n, V = 1 << L, 128
    win, H = cplx(rng, n), cplx(rng, n)
    want = np.fft.ifft(np.fft.fft(win) * H)[V:]
    assert rel(ola_window(win, H, L, V), want) < 1e-12


@pytest.mark.parametrize("complex_taps", [False, True])
def test_ola_stream_matches_convolve(complex_taps):
    """A stream of 4 windows (Nf 256, 100 taps, V 128) after a random state,
    window w from stream sample w Ne - V, the last Ne samples kept: the
    causal filter of [state | x] by np.convolve, to 1e-12."""
    rng = np.random.default_rng(7 + complex_taps)
    L, K, V = 8, 100, 128
    ne = (1 << L) - V
    h = cplx(rng, K) if complex_taps else rng.standard_normal(K)
    H = np.fft.fft(h, 1 << L)
    st, x = cplx(rng, V), cplx(rng, 4 * ne)
    xx = np.concatenate([st, x])
    y = np.concatenate([ola_window(xx[w * ne:w * ne + (1 << L)], H, L, V)
                        for w in range(4)])
    assert rel(y, np.convolve(xx, h)[V:V + 4 * ne]) < 1e-12


# -------------------------------------------------------- #10 detfront

NT, ROWS, EC = 4, 256, 24                 # DF_NT, DF_ROWS, DF_EC
TILE = 16 * ROWS
Q = 8 * NT * np.arange(8)                  # each warp's first row


def df_blocks(M):
    return (M + 14) // 16 + 1


def df_win_rows(E):
    return (ROWS + E - 1 + 3) // 4 * 4


def df_swz(c):
    return c ^ ((c >> 3) & 7)


def split2(v):
    """v (float32 values) as bf16 pieces v1 = bf16(v), v2 = bf16(v - v1),
    float64; v - v1 is exact in float32."""
    v = np.asarray(v, np.float64)
    v1 = bf16(v)
    return v1, bf16(v - v1)


def energy(x):
    """|x|^2 in float32 as the kernel rounds it: xr*xr + xi*xi, no
    contraction."""
    xr = np.asarray(x.real, np.float32)
    xi = np.asarray(x.imag, np.float32)
    return (xr * xr + xi * xi).astype(np.float32)


def tap_planes(h, M, e0, EL):
    """load_taps: element i <= 16 EL + 16 of rv = v[16 (e0 + EL) - i] (zero
    outside 0 <= k < M) at i (i < 16 EL + 16) and at word odd_copy(EL)
    element i - 1, for v = hr1, hr2, hi1, hi2, ones."""
    n = 16 * EL + 16
    k = 16 * (e0 + EL) - np.arange(n + 1)
    inside = (k >= 0) & (k < M)
    hk = np.where(inside, np.asarray(h)[np.clip(k, 0, M - 1)], 0)
    hr1, hr2 = split2(hk.real.astype(np.float32))
    hi1, hi2 = split2(hk.imag.astype(np.float32))
    out = []
    for v in (hr1, hr2, hi1, hi2, inside.astype(np.float64)):
        plane = np.full(2 * tap_plane_words(EL), np.nan)
        plane[:n] = v[:n]
        o = 2 * odd_copy(EL)
        plane[o:o + n] = v[1:n + 1]
        out.append(plane)
    return out


def window_mem(x, st, n, R0, e0, EL):
    """put_window_chunk for the chunk: rows ROWS + EL - 1 from stream row R0
    - e0 - EL + 1 (x at g >= 0 below n, the state's V samples before,
    zeros elsewhere) as six bf16 planes (xr1, xr2, xi1, xi2, e1, e2), chunk
    c of 8 samples at df_swz(c), 2 win_rows(EL) chunks a plane.  Returns
    the memory by element and asserts the 16-byte stores of 8 neighbouring
    threads hit 8 distinct bank quads."""
    V, rows, wrows = len(st), ROWS + EL - 1, df_win_rows(EL)
    c = np.arange(2 * rows)
    g = 16 * (R0 - e0 - EL + 1) + 8 * c[:, None] + np.arange(8)
    s = np.where((g >= 0) & (g < n), x[np.clip(g, 0, len(x) - 1)],
                 np.where((g < 0) & (g >= -V), st[np.clip(V + g, 0, V - 1)],
                          0))
    p = df_swz(c)
    for ph in range(0, len(p), 8):
        assert len(set((p[ph:ph + 8] % 8).tolist())) == len(p[ph:ph + 8])
    mem = np.full((6, 2 * wrows, 8), np.nan)
    planes = (*split2(s.real.astype(np.float32)),
              *split2(s.imag.astype(np.float32)), *split2(energy(s)))
    for j, v in enumerate(planes):
        mem[j, p] = v
    return mem.ravel()


def b_fragments(mem, EL, s, pairs=(0, 1)):
    """The ldmatrix.x4 of B(s) for the plane pairs asked (0: xr1/xr2, 1:
    xi1/xi2, 2: e1/e2), s (...,) rows: lane l names row l & 7 (row s + 4
    (l & 7) + EL - 1 of the window), k half (l >> 3) & 1, the pair's second
    plane for l >= 16.  Returns (..., pairs, 32, 4, 2); asserts every
    phase of 8 lanes hits 8 distinct bank quads."""
    wrows = df_win_rows(EL)
    row = np.asarray(s)[..., None] + 4 * (LANE & 7) + EL - 1
    chunk = df_swz(2 * row + ((LANE >> 3) & 1))
    base = np.where(LANE >> 4, 16 * 2 * wrows, 0) + 16 * chunk
    out = []
    for pair in pairs:
        addr = base + pair * 2 * 16 * 2 * wrows
        quads = ((addr // 16) % 8).reshape(-1, 8)
        assert all(len(set(q.tolist())) == 8 for q in quads)
        out.append(ldmatrix(mem, addr, 4))
    return np.stack(out, -4)


def model_block(x, st, h, M, n, R0):
    """detfront_kernel's block at tile row R0 of one channel: the chunks of
    tap blocks, each in two passes, the energy (a ring of e1/e2 fragments:
    B(Q + 1..3) first, step el loads B(Q - el) into slot -el mod 4, n-tile
    m reads slot (m - el) mod 4; 2 mma with the ones) and the correlation
    (the same ring of xr/xi fragments; 12 mma a step), each run of 4 steps
    summed from zero and added to the sums, then the stores (float64 sums).
    Returns cr, ci, en, sc for outputs 16 R0 + (0 .. TILE) (NaN past
    n)."""
    E = df_blocks(M)
    d = np.zeros((3, 8, NT, 32, 4))               # o, warp, m, lane, reg
    for e0 in range(0, E, EC):
        EL = min(EC, E - e0)
        mem = window_mem(x, st, n, R0, e0, EL)
        tp = tap_planes(h, M, e0, EL)
        a_all = [[a_fragments(p, EL, el)[0] for p in tp] for el in range(EL)]
        for pairs in ((2,), (0, 1)):       # the energy, the correlation
            ring = np.full((8, NT, len(pairs), 32, 4, 2), np.nan)
            for j in range(1, NT):
                ring[:, j] = b_fragments(mem, EL, Q + j, pairs)
            for el in range(EL):
                i = el % NT
                ring[:, (NT - i) % NT] = b_fragments(mem, EL, Q - el, pairs)
                B = ring[:, [(m - i) % NT for m in range(NT)]]
                assert not np.isnan(B).any()
                b = [(B[:, :, p, ..., 0:2, :], B[:, :, p, ..., 2:4, :])
                     for p in range(len(pairs))]
                a = a_all[el]
                for f in a:
                    assert not np.isnan(f).any()
                if el % NT == 0:                    # a run starts
                    run = np.zeros(d.shape)
                z = np.zeros(d.shape[1:])
                if pairs == (2,):                   # e1 + e2 with the ones
                    run[2] += mma(z, a[4], b[0][0]) + mma(z, a[4], b[0][1])
                else:
                    xr, xi = b
                    hr, hi = (a[0], a[1]), (a[2], a[3])
                    for xp, hp in ((0, 0), (1, 0), (0, 1)):
                        run[0] += (mma(z, hr[hp], xr[xp])
                                   + mma(z, -hi[hp], xi[xp]))
                        run[1] += (mma(z, hr[hp], xi[xp])
                                   + mma(z, hi[hp], xr[xp]))
                if el % NT == NT - 1 or el == EL - 1:  # the run's flush
                    d += run
    cr_, cc_ = c_map()                             # (lane, reg) -> (j, nn)
    out = np.full((4, TILE), np.nan)
    for w in range(8):
        for m in range(NT):
            s = 16 * (Q[w] + m + 4 * cc_) + cr_
            for k in range(4):    # lanes of one t: a 32-byte segment
                seg = s[:, k].reshape(8, 4).T
                assert all(np.array_equal(r, r[0] + np.arange(8))
                           for r in seg)
            a, b = d[0, w, m], d[1, w, m]
            e = np.maximum(d[2, w, m], 0)
            out[:, s] = np.stack([a, b, e,
                                  np.sqrt((a * a + b * b) / (e + 1e-20))])
    out[:, np.arange(TILE) + 16 * R0 >= n] = np.nan
    return out


def conv_valid(xx, hh, V, n):
    """Outputs 0 .. n of the causal filter of [state | x] (the state's V
    samples first): sum_k hh[k] xx[V + t - k], by float64 FFTs (~1e-15 of
    the peak)."""
    size = 1 << (len(xx) + len(hh) - 2).bit_length()
    y = np.fft.ifft(np.fft.fft(xx, size) * np.fft.fft(hh, size))[V:V + n]
    real = not (np.iscomplexobj(xx) or np.iscomplexobj(hh))
    return y.real if real else y


def pieces_reference(x, st, h, M):
    """The same products through np.convolve: x1 h1 + x2 h1 + x1 h2 of the
    four real correlations, e1 + e2 with ones; float64 sums."""
    xx = np.concatenate([st, x])
    V, n = len(st), len(x)
    xr, xi = (split2(xx.real.astype(np.float32)),
              split2(xx.imag.astype(np.float32)))
    hr, hi = (split2(h.real.astype(np.float32)),
              split2(h.imag.astype(np.float32)))
    terms = ((0, 0), (1, 0), (0, 1))

    def c(xp, hp):
        return sum(conv_valid(xp[i], hp[j], V, n) for i, j in terms)

    cr = c(xr, hr) - c(xi, hi)
    ci = c(xi, hr) + c(xr, hi)
    e1, e2 = split2(energy(xx))
    en = conv_valid(e1 + e2, np.ones(M), V, n)
    return cr, ci, en


@pytest.mark.parametrize("M", [1, 88, 128, 1500])
def test_detfront_tap_fragments_are_toeplitz_blocks(M):
    """For every chunk and block e = e0 + el, the five tap planes' A
    fragments are T_e of hr1, hr2, hi1, hi2 and the ones exactly, every
    word read lies in its plane, a warp's loads are free of bank
    conflicts, and the chunks cover every tap."""
    from test_torch_chain_design import a_map, toeplitz_block
    rng = np.random.default_rng(M)
    h = cplx(rng, M).astype(np.complex64)
    E, seen = df_blocks(M), 0
    hr, hi = split2(h.real), split2(h.imag)
    want = (hr[0], hr[1], hi[0], hi[1], np.ones(M))
    for e0 in range(0, E, EC):
        EL = min(EC, E - e0)
        tp = tap_planes(h, M, e0, EL)
        for el in range(EL):
            for p, v in zip(tp, want):
                fa, words = a_fragments(p, EL, el)
                assert words.min() >= 0 and words.max() < tap_plane_words(EL)
                assert np.array_equal(fa, toeplitz_block(v, M, e0 + el)[
                    a_map()])
                assert all(banks_distinct(w) for w in words)
            seen += 1
    assert seen == E and not toeplitz_block(np.ones(M), M, E).any()


@pytest.mark.parametrize("M,n,R0", [(88, 2 * TILE + 384, 2), (128, TILE, 0),
                                    (1500, 2 * TILE, 1)])
def test_detfront_model_reproduces_convolve(M, n, R0):
    """One block (tile R0; the last of a ragged n, or one that starts in
    the state) through the fragment model equals the same products summed
    by np.convolve, 1e-12 of the peak (float64 sums), every plane."""
    rng = np.random.default_rng(M + R0)
    V = 128 * ((M - 2) // 128 + 1)
    x = cplx(rng, n).astype(np.complex64)
    st = cplx(rng, V).astype(np.complex64)
    h = (cplx(rng, M) / np.sqrt(2 * M)).astype(np.complex64)
    got = model_block(x, st, h, M, n, R0 * ROWS)
    want = pieces_reference(x, st, h, M)
    t = 16 * R0 * ROWS + np.arange(TILE)
    live = t < n
    for g, w in zip(got[:3], want):
        assert rel(g[live], w[t[live]]) < 1e-12
    assert np.isfinite(got[3, live]).all()


@pytest.mark.parametrize("kind", ["random", "dynamic_range"])
def test_detfront_split_keeps_the_gate(kind):
    """The chosen pieces (x1 h1 + x2 h1 + x1 h2; e1 + e2) against the exact
    float64 correlation and energy of the float32 inputs: cr, ci and en
    within 1e-5 of their peak, the score within 1e-4, on 8 channels x
    32768 random samples (unit-norm taps, M = 128 and 1500) and on samples
    whose level steps over 1e-3 .. 1e3 every 256 samples."""
    rng = np.random.default_rng(len(kind))
    for M in (128, 1500):
        V = 128 * ((M - 2) // 128 + 1)
        x = cplx(rng, 8, 32768 + V)
        if kind == "dynamic_range":
            x *= np.exp(rng.uniform(-6.9, 6.9, (8, x.shape[1] // 256 + 1))
                        ).repeat(256, 1)[:, :x.shape[1]]
        x = x.astype(np.complex64)
        h = cplx(rng, M)
        h = (h / np.linalg.norm(h)).astype(np.complex64)
        for row in x:
            st, xb = row[:V], row[V:]
            cr, ci, en = pieces_reference(xb, st, h, M)
            xx = np.concatenate([st, xb]).astype(np.complex128)
            c = conv_valid(xx, h.astype(np.complex128), V, len(xb))
            e = conv_valid(energy(xx).astype(np.float64), np.ones(M), V,
                           len(xb))
            assert rel(cr, c.real) < 1e-5 and rel(ci, c.imag) < 1e-5
            assert rel(en, e) < 1e-5
            sc = np.sqrt((cr * cr + ci * ci) / (en + 1e-20))
            assert np.abs(sc - np.abs(c) / np.sqrt(e + 1e-20)).max() < 1e-4


def test_detfront_silent_stretch_is_exact_zero():
    """A block whose middle 4096 samples are exact zeros (M = 128, and M =
    1500 over two chunks): every output whose window lies in the silence is
    exactly 0 in cr, ci, en and the score; the others are not."""
    rng = np.random.default_rng(3)
    for M in (128, 1500):
        V = 128 * ((M - 2) // 128 + 1)
        n = 3 * TILE
        x = cplx(rng, n).astype(np.complex64)
        x[TILE:2 * TILE] = 0
        st = cplx(rng, V).astype(np.complex64)
        h = (cplx(rng, M) / np.sqrt(2 * M)).astype(np.complex64)
        got = model_block(x, st, h, M, n, ROWS)        # the silent tile
        t = TILE + np.arange(TILE)
        silent = t - (M - 1) >= TILE
        assert (got[:, silent] == 0).all()
        assert (got[2, ~silent] > 0).all()
