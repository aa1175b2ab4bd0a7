"""Numpy models of two kernel designs of the port, on the CPU (no card).

* #5 ``csrc/demod_sb.cu`` (``demod_sb_kernel`` and the ``sb_step`` it
  shares with #6): the per-launch table of interpolator taps is exact (every
  tau that quantises to one phase gives that row's bits); a division by a
  power of two is a multiplication by its exact reciprocal, bit for bit;
  the tree argmin over 16-point chunks padded with far points is the
  serial strict-< scan (first minimum on ties, a NaN distance never taken,
  nothing taken where every distance is NaN or inf); the window ring staged one sub-block ahead
  by cp.async holds every sample a sub-block can read, at either parity of
  a row's start, with pairs on 16-byte slots.
* #8 ``csrc/fm.cu``: the division-free placement of input samples in the
  polyphase planes (groups of 4 at R 4, (rho, m) loops at any other R) is
  the old ``%``/``/`` map; the register-blocked FIR (a sliding window a
  plane, 4 outputs a thread, thread 0's edge output, swizzled slots) gives
  the plain version's z.
Edit a kernel and its model together.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_compare  # noqa: F401  (caps torch's threads)
from libtsd_tpu_torch.ops.kernels import demod_sb as KSB
from libtsd_tpu_torch.ops.kernels import fm as KFM

# ------------------------------------------------------------- #5 model

KINDS = [("cspline", 4), ("linear", 2), ("lagrange", 4), ("sinc", 15)]


@pytest.mark.parametrize("kind,K", KINDS)
def test_tap_table_rows_are_exact(kind, K):
    """interp_taps at any tau equals, bit for bit, its table row: the taps
    at q / nph for q = rint(clamp(tau) nph).  (The loop's tau = pc -
    floor(pc) is never -0, the one value whose row would differ in the sign
    of a zero tap.)"""
    nph = 256
    rng = np.random.default_rng(K)
    q = np.arange(nph + 1, dtype=np.float32)
    edges = (q[:-1] + np.float32(0.5)) / np.float32(nph)
    tau = np.concatenate([
        rng.random(4000).astype(np.float32), edges,
        np.nextafter(edges, np.float32(0)), np.nextafter(edges, np.float32(1)),
        np.array([0, 1, -1e-30, 1.5, -2, np.inf, -np.inf],
                 np.float32)]).astype(np.float32)
    table = KSB.interp_taps(kind, torch.from_numpy(q / np.float32(nph)),
                            nph, K)
    qi = np.rint(np.clip(tau, 0, 1) * np.float32(nph)).astype(np.int64)
    got = KSB.interp_taps(kind, torch.from_numpy(tau), nph, K)
    assert torch.equal(got.view(torch.int32), table[qi].view(torch.int32))


def _subnormals_and_zeros():
    return np.concatenate([
        np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0], np.float32),
        (np.arange(1, 4000, dtype=np.uint32) * 2099).view(np.float32),
        -(np.arange(1, 4000, dtype=np.uint32) * 2099).view(np.float32),
        np.float32(2.0) ** -np.arange(100, 150, dtype=np.float32)])


def test_pow2_division_is_reciprocal_multiplication():
    """x / 2^k == x * 2^-k in float32, bit for bit (numpy and torch), on
    random values of every exponent, subnormals, +-0 and +-inf."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        (rng.standard_normal(20000) * 2.0 ** rng.integers(-140, 120, 20000)
         ).astype(np.float32), _subnormals_and_zeros()])
    for k in list(range(0, 12)) + [20, 60, 126]:
        d = np.float32(2.0 ** k)
        inv = np.float32(1) / d
        assert inv == np.float32(2.0 ** -k)
        with np.errstate(under="ignore", over="ignore"):
            a, b = x / d, x * inv
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), k
        ta = torch.div(torch.from_numpy(x), torch.tensor(d))
        tb_ = torch.from_numpy(x) * torch.tensor(inv)
        assert torch.equal(ta.view(torch.int32), tb_.view(torch.int32))
    # not a power of two: a reciprocal multiplication differs somewhere
    assert not np.array_equal(x / np.float32(3), x * (np.float32(1) /
                                                      np.float32(3)))


def _argmin_serial(d: np.ndarray):
    """sb_step's old loop: strict <, from best = inf; (index, taken)."""
    best, bi, taken = np.float32(np.inf), 0, False
    for m, v in enumerate(d):
        if v < best:
            best, bi, taken = v, m, True
    return bi, taken


FAR = np.float32(3.0e38)      # csrc/demod_sb.cu's SB_FAR


def _dist(y: complex, pts: np.ndarray) -> np.ndarray:
    """sb_step's float32 distances, one rounding per operation."""
    with np.errstate(over="ignore", invalid="ignore"):
        dr = np.float32(np.real(y)) - pts.real.astype(np.float32)
        di = np.float32(np.imag(y)) - pts.imag.astype(np.float32)
        return (dr * dr + di * di).astype(np.float32)


def _argmin_tree(d: np.ndarray, pad: np.ndarray | None = None):
    """sb_step's chunked tree over distances d (M,): s_sym is padded to
    16-point chunks with far points, whose distances (pad, inf by default)
    are inf or NaN; a pair (i, i + s) takes i + s when d[i + s] < d[i] or
    d[i] is NaN; chunks combine in order by strict <; nothing is taken
    unless the best is < inf."""
    M = len(d)
    n16 = -(-M // 16) * 16
    full = np.full(n16, np.inf, np.float32)
    full[:M] = d
    if pad is not None:
        full[M:] = pad[:n16 - M]
    best, bi = np.float32(np.inf), -1
    for m0 in range(0, n16, 16):
        dc = full[m0:m0 + 16].copy()
        ix = np.arange(m0, m0 + 16)
        s = 1
        while s < 16:
            for i in range(0, 16, 2 * s):
                if dc[i + s] < dc[i] or np.isnan(dc[i]):
                    dc[i], ix[i] = dc[i + s], ix[i + s]
            s *= 2
        if dc[0] < best:
            best, bi = dc[0], ix[0]
    return (int(bi), True) if bi >= 0 else (0, False)


def _argmin_cases():
    rng = np.random.default_rng(7)
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    cases = []
    for M in (1, 2, 3, 4, 5, 15, 16, 17, 31, 33, 64):
        for _ in range(40):
            d = rng.random(M).astype(np.float32)
            r = rng.random()
            if r < 0.3:        # ties: a few values repeated
                d = rng.choice(d[:max(1, M // 3)], M).astype(np.float32)
            elif r < 0.5:      # NaN here and there
                d[rng.random(M) < 0.3] = nan
            elif r < 0.6:      # inf here and there
                d[rng.random(M) < 0.5] = inf
            cases.append(d)
        cases += [np.full(M, nan, np.float32), np.full(M, inf, np.float32),
                  np.where(np.arange(M) % 2, nan, inf).astype(np.float32),
                  np.zeros(M, np.float32)]
    d = np.array([nan, 0.5, 0.5, nan, 0.25] + [0.25] * 12 + [nan],
                 np.float32)
    return cases + [d, d[::-1].copy()]


def test_tree_argmin_is_serial_strict_scan():
    for d in _argmin_cases():
        assert _argmin_tree(d) == _argmin_serial(d), d


def test_tree_argmin_on_points_with_far_padding():
    """Distances from y to real points and to the far pad points, as the
    kernel computes them: the pads are never taken (their distance is inf
    or NaN for |y| < 1e38), ties (y equidistant from several points), a
    NaN or inf y (nothing taken) and NaN points included."""
    rng = np.random.default_rng(11)
    g = np.array([-3, -1, 1, 3], np.float32) / np.sqrt(np.float32(10))
    qam16 = (g[:, None] + 1j * g[None, :]).ravel().astype(np.complex64)
    qpsk = np.array([1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j],
                    np.complex64) / np.float32(np.sqrt(2))
    pts_sets = [qam16, qpsk, qam16[:5], np.tile(qpsk, 5),
                np.concatenate([qpsk, [np.nan + 0j], qpsk])]
    ys = [0, 1e-3, 1 + 1j, -0.3162 + 0.9487j, 1e30, -1e37 + 1e37j,
          np.nan, np.inf, -np.inf + 1j, complex(0, np.nan)]
    ys += list(rng.standard_normal(40) + 1j * rng.standard_normal(40))
    far = np.full(32, FAR + 1j * FAR, np.complex64)
    for pts in pts_sets:
        for y in ys:
            d, pad = _dist(y, pts), _dist(y, far)
            assert not np.any(pad < np.inf)
            assert _argmin_tree(d, pad) == _argmin_serial(d), (pts, y)


def _sb_ring(osf: int, S: int, K: int, par: int):
    """sb_layout's W and RS, and demod_sb_kernel's batch ends."""
    hop = S * osf
    W = 2 * hop + osf + osf // 2 + K
    RS = 1 << (hop + W + 2 - 1).bit_length()

    def batch_end(b):
        return ((b * hop + W + par + 1) & ~1) - par
    return hop, W, RS, batch_end


@pytest.mark.parametrize("osf,S,K", [(4, 16, 4), (2, 8, 8), (4, 32, 15),
                                     (4, 12, 4)])
@pytest.mark.parametrize("par", [0, 1])
def test_window_ring_holds_every_read(osf, S, K, par):
    """Replay the staging of nsb sub-blocks: every sample a sub-block can
    read (any o in [0, ML + MH], every lane and tap, symbol and midpoint)
    was copied by the batches done before it and is still in its slot with
    the next batch already landed; pairs sit on even slots and start at
    an even g + par; only the first sample may be a lone 8-byte copy."""
    hop, W, RS, batch_end = _sb_ring(osf, S, K, par)
    h, ML, MH = osf // 2, S * osf, 2 * osf
    reads = np.unique((np.arange(ML + MH + 1)[:, None, None]
                       + np.arange(S)[None, :, None] * osf
                       + np.arange(K)[None, None, :]).ravel())
    reads = np.unique(np.concatenate([reads, reads + h]))
    assert reads.min() == 0 and reads.max() == W - 1
    ring = np.full(RS, -1)
    nsb = 12

    def stage(lo, hi):
        if (lo + par) & 1:
            assert lo == 0
            ring[(lo + par) % RS] = lo
            lo += 1
        for g in range(lo, hi, 2):
            assert (g + par) % 2 == 0 and ((g + par) % RS) % 2 == 0
            ring[(g + par) % RS] = g
            ring[(g + 1 + par) % RS] = g + 1
    stage(0, batch_end(0))
    for t in range(nsb):
        if t + 1 < nsb:
            stage(batch_end(t), batch_end(t + 1))
        g = t * hop + reads
        assert np.array_equal(ring[(g + par) % RS], g), t


# ------------------------------------------------------------- #8 model


def _cdiv(a, b):
    """C's truncating integer division and remainder."""
    q = np.trunc(a / b).astype(np.int64)
    return q, a - q * b


def _old_map(R, Kp, chunk, Q=1024):
    """fm.cu's former loop: element e of the block at n = nbase + e, rho =
    ((-n) % R + R) % R and mm = (n + rho) / R - m_lo in C's arithmetic."""
    m_lo = chunk * Q - Kp
    Mn = Q + Kp
    n = R * m_lo - (R - 1) + np.arange(R * Mn, dtype=np.int64)
    rho = _cdiv(_cdiv(-n, R)[1] + R, R)[1]
    mm = _cdiv(n + rho, R)[0] - m_lo
    return {(int(a), int(b)): int(c) for a, b, c in zip(rho, mm, n)}


def _new_map(R, Kp, chunk, Q=1024):
    """fm.cu's division-free placement: groups of 4 at R 4 (sample 4g is rho
    0 of m = g, 4g + r rho 4 - r of m = g + 1), else n = R m - rho."""
    m_lo = chunk * Q - Kp
    Mn = Q + Kp
    out = {}
    if R == 4:
        for gi in range(Mn + 1):
            n0 = 4 * (m_lo - 1 + gi)
            if gi >= 1:
                assert (0, gi - 1) not in out
                out[(0, gi - 1)] = n0
            if gi < Mn:
                for r in (1, 2, 3):
                    assert (4 - r, gi) not in out
                    out[(4 - r, gi)] = n0 + r
    else:
        for rho in range(R):
            for mm in range(Mn):
                out[(rho, mm)] = R * (m_lo + mm) - rho
    return out


@pytest.mark.parametrize("R", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("chunk", [0, 1, 37])
def test_fm_plane_map_without_division(R, chunk):
    Kp = -(-63 // R)
    assert _new_map(R, Kp, chunk) == _old_map(R, Kp, chunk)
    if chunk == 0:
        assert min(_new_map(R, Kp, chunk).values()) < 0


def _slot(i):
    return i ^ ((i >> 5) & 3)


def test_fm_swizzle_reads_are_bank_free():
    """The FIR's reads, index 4 t + c across the 32 lanes of a warp, hit 32
    banks for every c; the slots of one 32-aligned row stay in that row."""
    t = np.arange(32)
    for c in range(0, 200):
        assert len(np.unique(_slot(4 * t + c) % 32)) == 32
    i = np.arange(4096)
    assert np.array_equal(np.sort(_slot(i)), i)
    assert np.array_equal(_slot(i) >> 5, i >> 5)


def _fm_model_z(xr, xi, h, R, f0, Q=1024, V=4):
    """fm.cu's mix and FIR per block, in numpy float32: planes at swizzled
    slots, each thread's V outputs from a sliding window of V samples a
    plane (a new read per plane and tap row), taps ascending in k = R jj +
    rho, plus thread 0's edge output; returns z (C, N // R) complex and
    each block's edge."""
    C, N = xr.shape
    K = len(h)
    Kp = -(-K // R)
    Mn = Q + Kp
    ps = (Mn + 31) & ~31
    hs = np.zeros(Kp * R, np.float32)
    hs[:K] = h
    nout = N // R
    nch = -(-nout // Q)
    z = np.zeros((C, nch * Q), np.complex64)
    edges = np.zeros((C, nch), np.complex64)
    threads = np.arange(Q // V)
    for ch in range(C):
        for chunk in range(nch):
            P = np.zeros((2, R * ps), np.float32)
            for (rho, mm), n in _new_map(R, Kp, chunk, Q).items():
                if 0 <= n < N:
                    t = f0 * float(n)
                    t -= np.floor(t)
                    s = np.float32(np.sin(np.pi * np.float32(2 * t)))
                    c = np.float32(np.cos(np.pi * np.float32(2 * t)))
                    a, b = xr[ch, n], xi[ch, n]
                    P[0, rho * ps + _slot(mm)] = np.float32(a * c + b * s)
                    P[1, rho * ps + _slot(mm)] = np.float32(b * c - a * s)

            def fir(m0, NV):
                acc = np.zeros((2, NV) + np.shape(m0), np.float32)
                w = np.zeros((2, R, NV) + np.shape(m0), np.float32)
                for rho in range(R):
                    for v in range(NV):
                        w[:, rho, v] = P[:, rho * ps + _slot(m0 + Kp + v)]
                for jj in range(Kp):
                    if jj:
                        w[:, :, 1:] = w[:, :, :-1].copy()
                        for rho in range(R):
                            w[:, rho, 0] = P[:, rho * ps + _slot(m0 + Kp - jj)]
                    for rho in range(R):
                        acc = acc + hs[jj * R + rho] * w[:, rho]
                return acc[0] + 1j * acc[1]
            zt = fir(V * threads, V)                       # (V, threads)
            z[ch, chunk * Q:(chunk + 1) * Q] = zt.T.reshape(-1)
            edges[ch, chunk] = 0 if chunk == 0 else fir(np.array(-1), 1)[0]
    return z[:, :nout], edges


def test_fm_register_fir_model_matches_plain():
    """The model's z equals fm_fir_plain's within 1e-6 of its peak at C 2 x
    N 2^14 (R 4, the configs' 63 taps), and each block's edge output is the
    z before the block."""
    rng = np.random.default_rng(2)
    C, N, R, f0 = 2, 1 << 14, 4, 0.2371
    xr = rng.standard_normal((C, N)).astype(np.float32)
    xi = rng.standard_normal((C, N)).astype(np.float32)
    h = KFM.FmChain(f0, R, 63, 0.1, 0.05, device="cpu").h.numpy()
    z, edges = _fm_model_z(xr, xi, h, R, f0)
    zr, zi = KFM.fm_fir_plain(torch.from_numpy(xr), torch.from_numpy(xi),
                              torch.from_numpy(h), R=R, f0=f0)
    zp = zr.numpy() + 1j * zi.numpy()
    peak = np.abs(zp).max()
    assert np.abs(z - zp).max() / peak < 1e-6
    assert np.abs(edges[:, 1:] - zp[:, 1023::1024][:, :edges.shape[1] - 1]
                  ).max() / peak < 1e-6
