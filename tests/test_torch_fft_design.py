"""numpy model of the register-resident FFT core ``csrc/fft_reg.cuh`` and of
the pair trick of kernel #2 (``csrc/periodogram.cu``), on the CPU.

The model runs the core's passes thread by thread, vectorised over the
threads of one transform: the element each thread loads, each pass's
in-register DFT (the radix-2 steps with the header's special-cased
twiddles), its twiddle table (``ops.kernels.fft.twiddle_table``, the table
the kernels read), each exchange's swizzled shared-memory address and the
bins each thread stores.  It checks them against ``np.fft`` to 1e-12, and
that every exchange puts the 16 threads of each half-warp in distinct bank
pairs.  Then the pair identity of #2, |A|^2 + |B|^2 = (|Z[k]|^2 +
|Z[-k]|^2) / 2 for Z = FFT(a + i b), on runs of frames as blocks get them,
against float64 ``np.fft`` and against the JAX kernel interpreted.  The
header says it is kept in step with this file; edit both together.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from libtsd_tpu.ops.pallas.periodogram import periodogram4096_acc as pg_j
from libtsd_tpu_torch.ops.kernels.fft import twiddle_plan, twiddle_table
from torch_compare import rel

K2 = np.sqrt(0.5)
LOG2NS = list(range(8, 15))          # n = 256 .. 16384, every size #4 takes


# ------------------------------------------------------- index maps

def fft_bin(p, L):
    """Bin held by position p after the passes (mixed-radix digit
    reversal, the remainder digit first)."""
    p = np.asarray(p)
    rb = (L & 3) or 4
    out, shift, rem = np.zeros_like(p), 0, L
    while rem > 0:
        rem -= rb
        out = out + (((p >> rem) & ((1 << rb) - 1)) << shift)
        shift += rb
        rb = 4
    return out


def fft_pos(k, L):
    """Inverse of fft_bin."""
    k = np.asarray(k)
    rb = (L & 3) or 4
    out, rem = np.zeros_like(k), L
    while rem > 0:
        rem -= rb
        out = out + ((k & ((1 << rb) - 1)) << rem)
        k = k >> rb
        rb = 4
    return out


def swz(p, L):
    """Shared-memory slot (in float2) of position p: p XOR the low nibble of
    its bin, in Core::swz's closed form (test_swizzle_closed_forms holds it
    to fft_bin)."""
    rho = L & 3
    if rho == 0:
        return p ^ ((p >> (L - 4)) & 15)
    return p ^ (((p >> (L - rho)) | ((p >> (L - rho - 4)) << rho)) & 15)


@pytest.mark.parametrize("L", LOG2NS)
def test_swizzle_closed_forms(L):
    """Core::swz is p ^ (fft_bin(p) & 15); for L % 4 == 0 the first pass
    stores v[i] at (u ^ i) + U i, a middle pass's column at swz(base) +
    (r << (mL - 4)); the last pass reads 16 col + (r ^ h), h = swz(16 col)
    & 15, for every L."""
    n, U = 1 << L, 1 << (L - 4)
    p = np.arange(n)
    assert np.array_equal(swz(p, L), p ^ (fft_bin(p, L) & 15))
    assert np.array_equal(np.sort(swz(p, L)), p)
    u = np.arange(U)
    col = fft_pos(u, L) >> 4
    for r in range(16):
        assert np.array_equal(swz(16 * col + r, L),
                              16 * col + (r ^ (swz(16 * col, L) & 15)))
    if L & 3:
        return
    for i in range(16):
        assert np.array_equal(swz(u + U * i, L), (u ^ i) + U * i)
    for mL, _, _ in twiddle_plan(L)[1:-1]:
        b, t = u >> (mL - 4), u & ((1 << (mL - 4)) - 1)
        base = (b << mL) + t
        for r in range(16):
            assert np.array_equal(swz(base + (r << (mL - 4)), L),
                                  swz(base, L) + (r << (mL - 4)))


def half_warps_distinct(slots):
    """slots: (threads, ...) float2 slots of one access, threads in lane
    order.  True if the 16 threads of every half-warp hit 16 distinct bank
    pairs (4-byte words 2s and 2s+1 lie in banks 2s mod 32, 2s+1 mod 32)."""
    words = 2 * np.asarray(slots)
    banks = (words % 32).reshape(-1, 16, words[0].size)
    return all(len(set(banks[h, :, j].tolist())) == 16
               for h in range(banks.shape[0]) for j in range(banks.shape[2]))


# ------------------------------------------------- in-register DFT

def mul_w16(d, e):
    """d * exp(-2 pi i e / 16) as the header computes it (e < 8)."""
    x, y = d.real, d.imag
    if e == 0:
        return d
    if e == 4:
        return y - 1j * x
    if e == 2:
        return (x + y) * K2 + 1j * ((y - x) * K2)
    if e == 6:
        return (y - x) * K2 - 1j * ((x + y) * K2)
    wr, wi = np.cos(2 * np.pi * e / 16), -np.sin(2 * np.pi * e / 16)
    return (x * wr - y * wi) + 1j * (x * wi + y * wr)


def dft_reg(v, LR):
    """The header's radix-2^LR DFT of the list v (natural order in and out):
    radix-2 decimation in frequency, then a bit-reversal of the slots."""
    R = 1 << LR
    v = list(v)
    for s in range(LR - 1, -1, -1):
        m = 1 << s
        for j in range(R // 2):
            k = j & (m - 1)
            i0 = ((j >> s) << (s + 1)) + k
            i1 = i0 + m
            a, c = v[i0], v[i1]
            v[i0] = a + c
            v[i1] = mul_w16(a - c, k * (8 >> s))
    out = [None] * R
    for q in range(R):
        r = int(format(q, f"0{LR}b")[::-1], 2) if LR else 0
        out[r] = v[q]
    return out


# ------------------------------------------------------ the core

def model_fft(x, L, check_banks=True):
    """One n = 2^L transform as the core runs it, threads u < n/16
    vectorised.  Returns the natural-order DFT and, if asked, asserts that
    every exchange access is free of bank conflicts."""
    n, U = 1 << L, 1 << (L - 4)
    plan = twiddle_plan(L)     # [(log2 M, log2 R, offset)]; the last pass
    tw = twiddle_table(L)      # has no twiddles
    u = np.arange(U)
    buf = np.full(n, np.nan + 0j)
    # first pass: thread u loads x[u + U i], i < 16 (coalesced for each i)
    v = [x[u + U * i] for i in range(16)]
    mL, rL, off = plan[0]
    R, Q = 1 << rL, n >> rL
    S = 16 // R                          # register stride of a column
    for q in range(S):                   # columns t = u + U q
        t = u + U * q
        out = dft_reg([v[q + S * r] for r in range(R)], rL)
        for k in range(R):
            v[q + S * k] = out[k] * (tw[off + (k - 1) * Q + t] if k else 1)
    slots = np.stack([swz(u + U * i, L) for i in range(16)], 1)
    assert not check_banks or half_warps_distinct(slots)
    buf[slots] = np.stack(v, 1)
    # middle radix-16 passes, in place: column c = u
    for mL, rL, off in plan[1:-1]:
        Q = 1 << (mL - 4)
        b, t = u >> (mL - 4), u & (Q - 1)
        pos = np.stack([(b << mL) + t + (r << (mL - 4)) for r in range(16)], 1)
        slots = swz(pos, L)
        assert not check_banks or half_warps_distinct(slots)
        out = dft_reg([buf[slots[:, r]] for r in range(16)], 4)
        for k in range(1, 16):
            out[k] = out[k] * tw[off + (k - 1) * Q + t]
        buf[slots] = np.stack(out, 1)
    # last pass: thread u reads column fft_pos(u) / 16 and holds bins u + U k
    assert plan[-1][0] == 4
    col = fft_pos(u, L) >> 4
    assert np.all(fft_pos(u, L) & 15 == 0)
    slots = np.stack([swz(16 * col + r, L) for r in range(16)], 1)
    assert not check_banks or half_warps_distinct(slots)
    out = dft_reg([buf[slots[:, r]] for r in range(16)], 4)
    assert np.array_equal(fft_bin(16 * col[:, None] + np.arange(16), L),
                          u[:, None] + U * np.arange(16))
    y = np.empty(n, complex)
    for k in range(16):
        y[u + U * k] = out[k]            # coalesced for each k
    return y


@pytest.mark.parametrize("L", LOG2NS)
def test_core_reproduces_fft(L):
    """Loads, passes with their tables, swizzled exchanges and stores give
    np.fft.fft to 1e-12, every exchange free of bank conflicts."""
    rng = np.random.default_rng(L)
    n = 1 << L
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    assert rel(model_fft(x, L), np.fft.fft(x)) < 1e-12


@pytest.mark.parametrize("L", LOG2NS)
def test_twiddle_table_layout(L):
    """Each pass's table T[k - 1][t] = W_M^(t k), in the reader's order (t
    fastest, so a half-warp reads 16 consecutive entries); the last pass
    has none."""
    plan, tw = twiddle_plan(L), twiddle_table(L)
    size = 0
    for mL, rL, off in plan[:-1]:
        R, Q = 1 << rL, 1 << (mL - rL)
        assert off == size
        k, t = np.meshgrid(np.arange(1, R), np.arange(Q), indexing="ij")
        want = np.exp(-2j * np.pi * (t * k) / (1 << mL)).ravel()
        assert np.abs(tw[off:off + (R - 1) * Q] - want).max() < 1e-15
        size += (R - 1) * Q
    assert plan[-1][:2] == (4, 4) and len(tw) == size


@pytest.mark.parametrize("L", [8, 12, 14])
def test_block_of_transforms_is_conflict_free(L):
    """A block of 256 threads: for n < 4096, 4096 / n transforms side by
    side (thread tid works on transform tid // (n/16)); for n > 4096 each
    thread takes columns tid + 256 w in turn.  Every half-warp still hits
    16 distinct bank pairs in every exchange."""
    U = 1 << (L - 4)
    NT = min(U, 256)
    tid = np.arange(256)
    for w in range(max(1, U // 256)):
        tr, u = tid // NT, tid % NT + NT * w
        base = (tr << L) if U < 256 else 0
        for i in range(16):
            assert half_warps_distinct(base + swz(u + U * i, L))
        col = fft_pos(u, L) >> 4
        for r in range(16):
            assert half_warps_distinct(base + swz(16 * col + r, L))


def test_periodogram_epilogue_is_conflict_free():
    """#2's epilogue: thread j writes S[j + 256 k] in natural order, then
    reads S[j + 256 k] and S[-(j + 256 k) mod 4096] (4-byte words): every
    warp hits 32 distinct banks."""
    j = np.arange(256)
    for k in range(16):
        for words in (j + 256 * k, (4096 - j - 256 * k) & 4095):
            banks = (words % 32).reshape(-1, 32)
            assert all(len(set(b.tolist())) == 32 for b in banks)


# ------------------------------------------------------ pair trick

def pair_periodogram(frames_ch, runs, fft=np.fft.fft):
    """#2's arithmetic for one channel: the frames cut into runs as blocks
    get them; each run transforms its frames two at a time as z = a + i b
    (an odd run's last frame alone, b = 0), accumulates S[k] = sum |Z[k]|^2
    and contributes (S[k] + S[-k]) / 2."""
    out, f = np.zeros(4096), 0
    for run in runs:
        S = np.zeros(4096)
        for g in range(f, f + run, 2):
            z = frames_ch[g] + (1j * frames_ch[g + 1] if g + 1 < f + run
                                else 0)
            S += np.abs(fft(z)) ** 2
        out += (S + np.roll(S[::-1], 1)) / 2
        f += run
    assert f == len(frames_ch)
    return out


@pytest.mark.parametrize("runs", [[3], [5], [8], [3, 5, 8], [1, 2, 3, 5, 8]])
def test_pair_identity(runs):
    """Runs of 3, 5 and 8 frames (odd runs end on a lone frame): the pair
    sums equal the per-frame sum of |FFT|^2 to 1e-12 (float64)."""
    rng = np.random.default_rng(sum(runs))
    fr = rng.standard_normal((sum(runs), 4096))
    want = (np.abs(np.fft.fft(fr, axis=-1)) ** 2).sum(0)
    assert rel(pair_periodogram(fr, runs), want) < 1e-12
    got = pair_periodogram(fr, runs, fft=lambda z: model_fft(z, 12, False))
    assert rel(got, want) < 1e-12


def test_pair_periodogram_matches_jax_kernel():
    """2 channels x 16 frames, split into runs of 3, 5 and 8, through the
    model core, against the JAX Pallas periodogram interpreted: 1e-5 of the
    peak (the JAX kernel computes in float32)."""
    rng = np.random.default_rng(42)
    y = rng.standard_normal((2, 16 * 4096)).astype(np.float32)
    got = np.stack([pair_periodogram(
        y[c].astype(np.float64).reshape(16, 4096), [3, 5, 8],
        fft=lambda z: model_fft(z, 12, False)) for c in range(2)])
    want = np.asarray(pg_j(jnp.asarray(y), interpret=True))
    assert got.shape == want.shape == (2, 4096)
    assert rel(got, want) < 1e-5
