// Kernels #5 and #6: the batched sub-block decision-directed demodulator.
//
// #5 demod_sb_kernel replaces ops/pallas/demod_sb.py::demod_sb_pallas (the
// JAX package's _kernel/_subblock); #6 demod_sb_fused_kernel replaces
// demod_sb_pallas_fused (_fused_kernel: the same loop with the matched
// filter and a streaming power-EMA AGC inside the kernel).  The loop is
// the one of libtsd_tpu/models/demod_sb.py:363-444: per sub-block of S
// symbols, one shared fractional phase tau, S symbol and S midpoint
// interpolations, decisions, the Gardner TED, a second-order carrier loop
// and the AGC, with one loop update per sub-block.
//
// Bound on the H100: #5 reads the padded matched-filter output zp once
// (8 bytes a sample) and writes 9 bytes a symbol; #6 reads the raw input
// once.  At C = 4096, n = 8192 that is ~0.4 GB, ~0.12 ms at 3.35 TB/s; the
// arithmetic (~1-3 GFLOP) is negligible.  What bounds the kernels in
// practice is latency: sub-blocks within a channel are strictly
// sequential (each one's window position depends on the previous timing
// update), so a channel is a chain of nsb dependent steps.
//
// Design: the TPU kernel put 128 channels in the lanes of one vector and
// ran the sub-blocks on a sequential grid axis with the state in VMEM.
// Here a group of G = pow2 >= S lanes of one warp serves one channel (two
// channels a warp at S = 16): lane j computes symbol j's and midpoint j's
// interpolations, decision, TED term and phase error; warp shuffles form
// the sums of the TED terms, phase errors and AGC errors; every lane then
// applies the same loop update, so the state stays in registers.  C = 4096
// channels give 2048 warps, ~16 per SM: too few to hide a step's latency,
// so a step's own chain sets the time.  #5 therefore keeps the device
// memory off it: each group stages sub-block t + 1's window samples from zp
// into a ring in shared memory by cp.async while sub-block t runs (the
// window's start within the frame depends on the state, the frame's does
// not), and the step reads the ring.  The step's chain is short: the
// interpolator taps come from a table of the nph + 1 quantised phases made
// once per launch, S and nph (powers of 2) divide as exact reciprocal
// multiplications, one sincosf, the nearest point by a tree over 16-point
// chunks, the three lane sums in one butterfly; every result is the
// plain version's bit for bit.  The phase error is atan2f (the TPU kernel
// used a polynomial).  #6 runs the same sub-block step on fp32
// matched-filter rows that it computes itself, with their power for the
// AGC's EMA; the filtered signal never reaches device memory.  Producer
// warps stage the input in shared memory by cp.async one hop (S osf
// samples) ahead of use and compute each row once from there into a ring
// of rows per channel, for a sub-block D hops ahead of the one that the
// consumer warps' loop runs (details above the kernel): the filter's
// independent arithmetic runs beside the loop's latency, where the first
// port computed a whole superframe's rows (13 % of them twice, each input
// sample read kmf times from L1) and then ran the loop on them.
#include <cuda_runtime.h>
#include <math.h>

#define SB_THREADS 128   // threads a block of #5
#define SBF_THREADS 128  // consumer threads a block of #6 (producers beside)
#define SB_APW 0.25f
#define SB_FULL 0xffffffffu
#define SB_FAR 3.0e38f

enum { SB_CARRIER = 1, SB_CLOCK = 2, SB_AGC = 4 };
enum { ITRP_CSPLINE = 0, ITRP_LINEAR = 1, ITRP_LAGRANGE = 2, ITRP_SINC = 3 };

struct SbCfg {
  int S, osf, K, nph, itrp, M, n, G, flags;
  float tgain, aga, gamma, rho;
  float inv_S, inv_nph;   // 1 / S and 1 / nph where a power of 2, else 0
};

struct SbState {
  float ptr, theta, gain, lf_th, lf_mu, lf_last, ypr, ypi;
};

__device__ __forceinline__ SbState sb_load(const float* st, int c, int C) {
  SbState s;
  s.ptr = st[c];
  s.theta = st[C + c];
  s.gain = st[2 * C + c];
  s.lf_th = st[3 * C + c];
  s.lf_mu = st[4 * C + c];
  s.lf_last = st[5 * C + c];
  s.ypr = st[6 * C + c];
  s.ypi = st[7 * C + c];
  return s;
}

__device__ __forceinline__ void sb_store(float* st, int c, int C,
                                         const SbState& s) {
  st[c] = s.ptr;
  st[C + c] = s.theta;
  st[2 * C + c] = s.gain;
  st[3 * C + c] = s.lf_th;
  st[4 * C + c] = s.lf_mu;
  st[5 * C + c] = s.lf_last;
  st[6 * C + c] = s.ypr;
  st[7 * C + c] = s.ypi;
}

// Every float operation below is rounded on its own (no fused multiply-add
// contraction, IEEE division and square root), in the order that the plain
// PyTorch version (ops/kernels/demod_sb.py) spells out: the two then agree
// bit for bit.  That matters because the loop is not continuous: the
// interpolator's phase is quantised to 1/nph and the decisions are hard,
// so a last-bit difference in the pointer can move a symbol by ~3e-3.
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fsq(float a, float b) {   // a^2 + b^2
  return fadd(fmul(a, a), fmul(b, b));
}

// The divisors S and nph of a configuration, as `x / d`: a multiplication
// by the exact reciprocal `inv` where d is a power of two (the same bits:
// both round the same real number once), else an IEEE division.
__device__ __forceinline__ float fdiv_cfg(float x, float d, float inv) {
  return inv != 0.f ? fmul(x, inv) : fdiv(x, d);
}

// The interpolator's quantised phase index rint(clamp(tau) nph), 0 .. nph.
__device__ __forceinline__ float sb_phase(float tau, int nph) {
  return rintf(fmul(fminf(fmaxf(tau, 0.f), 1.f), (float)nph));
}

// Fractional-delay taps in closed form at the quantised tau t = q / nph:
// the formulas of ops/resample.py's builders (cspline_coefs, linear_coefs,
// lagrange_coefs of degree K - 1, sinc_interp_coefs with fc = 0.5 and the
// tau-shifted Hann window), as the JAX package evaluates them.  KMAX >= 4.
template <int KMAX>
__device__ __forceinline__ void sb_taps(int itrp, float t, int K,
                                        float (&tp)[KMAX]) {
  static_assert(KMAX >= 4, "KMAX >= 4");
#pragma unroll
  for (int k = 0; k < KMAX; ++k) tp[k] = 0.f;
  if (itrp == ITRP_CSPLINE) {
    const float tm = fsub(t, 1.f);
    const float tm2 = fmul(tm, tm);
    const float h0 = fmul(fadd(1.f, fmul(2.f, t)), tm2);
    const float h1 = fmul(t, tm2);
    const float h2 = fmul(fmul(t, t), fsub(3.f, fmul(2.f, t)));
    const float h3 = fmul(fmul(t, t), tm);
    tp[0] = -fmul(h1, 0.5f);
    tp[1] = fsub(h0, fmul(h3, 0.5f));
    tp[2] = fadd(h2, fmul(h1, 0.5f));
    tp[3] = fmul(h3, 0.5f);
  } else if (itrp == ITRP_LINEAR) {
    tp[0] = fsub(1.f, t);
    tp[1] = t;
  } else if (itrp == ITRP_LAGRANGE) {
    const int d = K - 1;
    const float tt = fadd(t, 0.5f * (float)(d - 1));
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < K) {
        float hh = 1.f;
        for (int jj = 0; jj < K; ++jj)
          if (jj != i)
            hh = fdiv(fmul(hh, fsub(tt, (float)jj)), (float)(i - jj));
        tp[i] = hh;
      }
    }
  } else {  // windowed sinc, nc = K
    const float PI = 3.14159265358979323846f;
    const float w = fdiv(fmul(2.f, PI), (float)K);
    float ssum = 0.f;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < K) {
        const float k = fsub((float)(i - K / 2), t);
        const float px = fmul(PI, k);
        const float s = fabsf(px) < 1e-6f
                            ? fsub(1.f, fdiv(fmul(px, px), 6.f))
                            : fdiv(sinf(px), px == 0.f ? 1.f : px);
        tp[i] = fmul(s, fadd(0.5f, fmul(0.5f, cosf(fmul(k, w)))));
        ssum = fadd(ssum, tp[i]);
      }
    }
    const float den = fabsf(ssum) > 1e-12f ? ssum : 1.f;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) tp[i] = fdiv(tp[i], den);
  }
}

// The taps at tau from the closed form (#6, and #5 where the table does not
// fit).
template <int KMAX>
struct TapsClosed {
  int itrp, nph, K;
  float inv_nph;
  __device__ __forceinline__ void operator()(float tau,
                                             float (&tp)[KMAX]) const {
    sb_taps<KMAX>(itrp, fdiv_cfg(sb_phase(tau, nph), (float)nph, inv_nph), K,
                  tp);
  }
};

// #5's taps from the per-launch table of the nph + 1 quantised phases, row
// q = sb_taps(q / nph) (the same function on the same t: the same bits),
// KT floats a row (4 at KMAX 4: one 16-byte load).
template <int KMAX>
struct TapsTable {
  TapsClosed<KMAX> closed;
  const float* tab;   // nullptr: the closed form
  int kt;
  __device__ __forceinline__ void operator()(float tau,
                                             float (&tp)[KMAX]) const {
    if (tab == nullptr) {
      closed(tau, tp);
      return;
    }
    const int q = (int)sb_phase(tau, closed.nph);
    if constexpr (KMAX == 4) {
      const float4 v = *reinterpret_cast<const float4*>(tab + 4 * q);
      tp[0] = v.x; tp[1] = v.y; tp[2] = v.z; tp[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        tp[k] = k < closed.K ? tab[q * kt + k] : 0.f;
    }
  }
};

// #5's outputs of a symbol: y, the decision's index and the valid flag.
// Invalid symbols are zeros.
struct SymOut {
  float2* y;
  int* s;
  unsigned char* v;
  __device__ __forceinline__ void operator()(int idx, bool upd, float y_r,
                                             float y_i, int bi) const {
    y[idx] = upd ? make_float2(y_r, y_i) : make_float2(0.f, 0.f);
    s[idx] = upd ? bi : 0;
    v[idx] = upd ? 1 : 0;
  }
};

// #6's outputs of a symbol: y and the valid flag, then the decision's k bits,
// least significant first (waveform.symbol_indices_to_bits), and the flag
// repeated k times, as bytes.  At k = 4 a lane stores each as one 4-byte
// word, so a group's S lanes write S * 4 contiguous bytes.
struct BitsOut {
  float2* y;
  unsigned char* v;
  unsigned char* b;
  unsigned char* bv;
  int k;
  __device__ __forceinline__ void operator()(int idx, bool upd, float y_r,
                                             float y_i, int bi) const {
    y[idx] = upd ? make_float2(y_r, y_i) : make_float2(0.f, 0.f);
    v[idx] = upd ? 1 : 0;
    const unsigned s = upd ? (unsigned)bi : 0u;
    if (k == 4) {
      reinterpret_cast<unsigned*>(b)[idx] = (s & 1u) | ((s >> 1) & 1u) << 8 |
                                            ((s >> 2) & 1u) << 16 |
                                            ((s >> 3) & 1u) << 24;
      reinterpret_cast<unsigned*>(bv)[idx] = upd ? 0x01010101u : 0u;
    } else {
      for (int i = 0; i < k; ++i) {
        b[idx * k + i] = (unsigned char)((s >> i) & 1u);
        bv[idx * k + i] = upd ? 1 : 0;
      }
    }
  }
};

// One sub-block of one channel, lane j of its group.  win(u) returns the
// window sample at frame offset u, where the frame of sub-block t starts
// ML + (K - 1) + osf/2 samples before the nominal pointer t*S*osf; taps(tau,
// tp) gives the interpolator's taps; the interpolated sums are multiplied
// by `scale` (the fused AGC pre-scale); out(idx, upd, y_r, y_i, index)
// stores symbol idx of the channel's row.
template <int KMAX, class Win, class Taps, class Out>
__device__ __forceinline__ void sb_step(const SbCfg& c, SbState& st, int t,
                                        int j, const Win& win, const Taps& taps,
                                        float scale,
                                        const float2* __restrict__ s_sym,
                                        const Out& out, bool active) {
  const int S = c.S, osf = c.osf, G = c.G;
  const int h = osf >> 1, ML = S * osf, MH = 2 * osf;
  const float nom = (float)(t * S * osf);
  const bool ready = fadd(st.ptr, (float)((S - 1) * osf)) < (float)c.n;
  const float pc = ready ? st.ptr : fadd(nom, 0.5f * (float)osf);
  const float ip = floorf(pc);
  const float tau = fsub(pc, ip);
  const float o_raw = fadd(fsub(ip, nom), (float)ML);
  const bool inrange = (o_raw >= 0.f) && (o_raw <= (float)(ML + MH));
  const int o = (int)fminf(fmaxf(o_raw, 0.f), (float)(ML + MH));

  float tp[KMAX];
  taps(tau, tp);
  const int jr = j < S ? j : S - 1;   // lanes past S read in bounds
  const int u0 = o + jr * osf;
  float mr = 0.f, mi = 0.f, yr = 0.f, yi = 0.f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < c.K) {
      const float2 a = win(u0 + k);
      const float2 b = win(u0 + h + k);
      mr = fadd(mr, fmul(tp[k], a.x));
      mi = fadd(mi, fmul(tp[k], a.y));
      yr = fadd(yr, fmul(tp[k], b.x));
      yi = fadd(yi, fmul(tp[k], b.y));
    }
  }
  mr = fmul(mr, scale); mi = fmul(mi, scale);
  yr = fmul(yr, scale); yi = fmul(yi, scale);

  // carrier phase ramped inside the sub-block: theta_j = theta + j mu / S;
  // y = raw exp(-i theta_j) gain
  const float th = fadd(st.theta, fmul((float)j, fdiv_cfg(st.lf_mu, (float)S,
                                                          c.inv_S)));
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float y_r = fmul(fadd(fmul(yr, cs), fmul(yi, sn)), st.gain);
  const float y_i = fmul(fsub(fmul(yi, cs), fmul(yr, sn)), st.gain);
  const float m_r = fmul(fadd(fmul(mr, cs), fmul(mi, sn)), st.gain);
  const float m_i = fmul(fsub(fmul(mi, cs), fmul(mr, sn)), st.gain);

  // nearest constellation point: the first minimum of a strict-< serial
  // scan, which never takes a NaN distance and takes nothing where every
  // distance is NaN or inf (then index 0 and ye = 0).  Chunks of 16 points
  // (s_sym padded with far points) reduce as trees: a pair keeps its lower
  // point unless the upper one is nearer or the lower one's distance is
  // NaN; then chunk after chunk in order by strict <.
  float best = INFINITY;
  int bi = -1;
  for (int m0 = 0; m0 < c.M; m0 += 16) {
    float d[16];
    int ix[16];
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const float4 sp = *reinterpret_cast<const float4*>(s_sym + m0 + i);
      const float d0 = fsq(fsub(y_r, sp.x), fsub(y_i, sp.y));
      const float d1 = fsq(fsub(y_r, sp.z), fsub(y_i, sp.w));
      d[i] = d0;
      d[i + 1] = d1;
      ix[i] = m0 + i;
      ix[i + 1] = m0 + i + 1;
    }
#pragma unroll
    for (int s = 1; s < 16; s <<= 1) {
#pragma unroll
      for (int i = 0; i < 16; i += 2 * s) {
        if (d[i + s] < d[i] || d[i] != d[i]) {
          d[i] = d[i + s];
          ix[i] = ix[i + s];
        }
      }
    }
    if (d[0] < best) { best = d[0]; bi = ix[0]; }
  }
  float ye_r = 0.f, ye_i = 0.f;
  if (bi >= 0) {
    const float2 sm = s_sym[bi];
    ye_r = sm.x;
    ye_i = sm.y;
  } else {
    bi = 0;
  }

  // Gardner TED over the sub-block, y_{-1} carried
  float p_r = __shfl_up_sync(SB_FULL, y_r, 1, G);
  float p_i = __shfl_up_sync(SB_FULL, y_i, 1, G);
  if (j == 0) { p_r = st.ypr; p_i = st.ypi; }
  const bool lane_ok = j < S;
  const float e_t =
      lane_ok ? fadd(fmul(fsub(y_r, p_r), m_r), fmul(fsub(y_i, p_i), m_i))
              : 0.f;
  // decision-directed phase error arg(y conj(ye)), 0 where y == 0
  const float z_r = fadd(fmul(y_r, ye_r), fmul(y_i, ye_i));
  const float z_i = fsub(fmul(y_i, ye_r), fmul(y_r, ye_i));
  const float y2 = fsq(y_r, y_i);
  const float e_ph = (lane_ok && y2 > 0.f) ? atan2f(z_i, z_r) : 0.f;
  const float eg = fdiv(__fsqrt_rn(y2),
                        fmaxf(__fsqrt_rn(fsq(ye_r, ye_i)), 1e-9f));
  const float e_g = lane_ok ? fdiv(1.f, fmaxf(eg, 1e-9f)) : 0.f;

  // the sums over the G lanes of the group, three values in one xor
  // butterfly (every lane ends with the same sums: IEEE addition commutes)
  float sum_t = e_t, sum_ph = e_ph, sum_g = e_g;
  for (int m = G >> 1; m > 0; m >>= 1) {
    sum_t = fadd(sum_t, __shfl_xor_sync(SB_FULL, sum_t, m, G));
    sum_ph = fadd(sum_ph, __shfl_xor_sync(SB_FULL, sum_ph, m, G));
    sum_g = fadd(sum_g, __shfl_xor_sync(SB_FULL, sum_g, m, G));
  }
  const float e_mean = fdiv_cfg(sum_ph, (float)S, c.inv_S);
  const float g_mean = fdiv_cfg(sum_g, (float)S, c.inv_S);
  const float yl_r = __shfl_sync(SB_FULL, y_r, S - 1, G);
  const float yl_i = __shfl_sync(SB_FULL, y_i, S - 1, G);
  const float dec = fminf(fmaxf(fmul(c.tgain, sum_t), -0.5f * (float)osf),
                          0.5f * (float)osf);
  const bool upd = ready && inrange;
  float ptr_adv = fsub(fadd(st.ptr, (float)(S * osf)),
                       ((c.flags & SB_CLOCK) && inrange) ? dec : 0.f);
  if (!inrange)
    ptr_adv = fadd(fadd(nom, (float)(S * osf)), 0.5f * (float)osf);
  if (upd) {
    if (c.flags & SB_CARRIER) {
      const float th2 = fadd(st.lf_th, st.lf_mu);
      const float mu2 = fadd(
          st.lf_mu, fmul(c.gamma, fsub(fmul(fadd(1.f, c.rho), e_mean),
                                       st.lf_last)));
      st.theta = th2;
      st.lf_th = th2;
      st.lf_mu = mu2;
      st.lf_last = e_mean;
    }
    if (c.flags & SB_AGC)
      st.gain = fadd(fmul(fsub(1.f, c.aga), st.gain), fmul(c.aga, g_mean));
    st.ypr = yl_r;
    st.ypi = yl_i;
  }
  if (ready) st.ptr = ptr_adv;

  if (active && lane_ok) out(t * S + j, upd, y_r, y_i, bi);
}

// Constellation points a kernel holds in shared memory: M rounded up to a
// whole chunk of the argmin's 16, padded with far points (SB_FAR, SB_FAR),
// whose distance to any |y| < 1e38 overflows to inf (or is NaN), so that
// the argmin never takes one.
__host__ __device__ __forceinline__ int sym_slots(int M) {
  return (M + 15) / 16 * 16;
}

// #5's shared-memory layout (one per launch): the constellation, the tap
// table (nph + 1 rows of KT floats, where it fits in TAB_MAX bytes, else
// none: the closed form), then per channel a ring of RS samples (a power of
// 2 >= hop + W + 2, W = the span of a sub-block's window) into which the
// window of sub-block t + 1 is staged while sub-block t runs.
#define SB_TAB_MAX (48 * 1024)
struct SbLayout {
  int kt, tab_floats, RS, W, smem;
};

static int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

static SbLayout sb_layout(const SbCfg& c, int kmax) {
  SbLayout l;
  const int hop = c.S * c.osf;
  l.W = 2 * hop + c.osf + c.osf / 2 + c.K;   // u <= ML + MH + (S-1) osf + h + K - 1
  l.kt = kmax == 4 ? 4 : c.K;
  l.tab_floats = (c.nph + 1) * l.kt;
  if (l.tab_floats * 4 > SB_TAB_MAX) l.tab_floats = 0;
  l.tab_floats = (l.tab_floats + 3) / 4 * 4;
  l.RS = pow2_at_least(hop + l.W + 2);
  l.smem = sym_slots(c.M) * 8 + l.tab_floats * 4 +
           (SB_THREADS / c.G) * l.RS * 8;
  return l;
}

// cp.async copies of 16 (a sample pair) and 8 bytes (one sample) into shared
// memory; src_bytes < size zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// #5: zp (C, ldz) complex, the matched-filter output behind its carried
// tail; sub-block t's frame starts at zp[c, fs0 + t*S*osf].  A group of G
// lanes stages the frame's samples into its ring by cp.async one sub-block
// ahead: sub-block t reads samples [t hop, t hop + W) of the frame, so while
// it runs, the group copies [hi(t), hi(t + 1)), hi(b) = b hop + W rounded up
// to a pair boundary, and waits for them when sub-block t + 1 starts.  The
// copy's addresses are fixed (the frame's start), so the load no longer
// waits on the previous step's pointer.  Sample g lies in ring slot
// (g + par) mod RS, par = 1 where the frame's sample 0 is not 16-byte
// aligned, so that pairs are 16-byte copies on both sides at any ldz, fs0
// or base; a lone sample at the start is an 8-byte copy, samples past the
// row are zero-filled (never read).
template <int KMAX>
__global__ void __launch_bounds__(SB_THREADS)
demod_sb_kernel(const float2* __restrict__ zp, long long ldz,
                const float* __restrict__ st_in, float* __restrict__ st_out,
                const float2* __restrict__ sym, SbCfg c, SbLayout l, int C,
                int nsb, int fs0, float2* __restrict__ y,
                int* __restrict__ sidx, unsigned char* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* s_sym = reinterpret_cast<float2*>(smem_raw);
  float* s_tab = reinterpret_cast<float*>(s_sym + sym_slots(c.M));
  float2* rings = reinterpret_cast<float2*>(s_tab + l.tab_floats);
  for (int i = threadIdx.x; i < sym_slots(c.M); i += blockDim.x)
    s_sym[i] = i < c.M ? sym[i] : make_float2(SB_FAR, SB_FAR);
  if (l.tab_floats) {
    for (int q = threadIdx.x; q <= c.nph; q += blockDim.x) {
      float tp[KMAX];
      sb_taps<KMAX>(c.itrp, fdiv_cfg((float)q, (float)c.nph, c.inv_nph), c.K,
                    tp);
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < l.kt) s_tab[q * l.kt + k] = tp[k];
    }
  }
  const int G = c.G;
  const int j = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int ch = blockIdx.x * (blockDim.x / G) + grp;
  const bool active = ch < C;
  const int cc = active ? ch : C - 1;   // idle groups shadow a real channel
  SbState st = sb_load(st_in, cc, C);
  const float2* row = zp + (long long)cc * ldz + fs0;
  const long long ldo = (long long)nsb * c.S;
  const SymOut out{y + (long long)cc * ldo, sidx + (long long)cc * ldo,
                   valid + (long long)cc * ldo};
  float2* ring = rings + grp * l.RS;
  const int mask = l.RS - 1;
  const int hop = c.S * c.osf;
  const int par = (int)((reinterpret_cast<size_t>(row) >> 3) & 1);
  const long long lim = ldz - fs0;      // samples of the row from the frame
  // the end of batch b: b hop + W rounded up so that g + par is even there
  auto batch_end = [&](int b) { return ((b * hop + l.W + par + 1) & ~1) - par; };
  auto stage = [&](int lo, int hi) {
    if ((lo + par) & 1) {               // a lone first sample
      if (j == 0) cp_async8(ring + ((lo + par) & mask), row + lo,
                            lo < lim ? 8 : 0);
      ++lo;
    }
    for (int g = lo + 2 * j; g < hi; g += 2 * G) {
      const int nb = g + 1 < lim ? 16 : (g < lim ? 8 : 0);
      cp_async16(ring + ((g + par) & mask), row + (nb ? g : 0), nb);
    }
    cp_async_commit();
  };
  const TapsTable<KMAX> taps{{c.itrp, c.nph, c.K, c.inv_nph},
                             l.tab_floats ? s_tab : nullptr, l.kt};
  stage(0, batch_end(0));
  __syncthreads();                      // the constellation and the table
  for (int t = 0; t < nsb; ++t) {
    cp_async_wait_all();
    __syncwarp();
    if (t + 1 < nsb) stage(batch_end(t), batch_end(t + 1));
    const int base = t * hop + par;
    sb_step<KMAX>(c, st, t, j,
                  [ring, base, mask](int u) { return ring[(base + u) & mask]; },
                  taps, 1.f, s_sym, out, active);
  }
  if (active && j == 0) sb_store(st_out, cc, C, st);
}

// #6's ring layout, one per launch (ops/kernels/demod_sb.py's fused_smem
// mirrors it): D hops of matched-filter rows span a sub-block's window; the
// row ring holds RG >= (D + 1) hop rows (a power of 2), the input ring IRG
// >= 2 hop + kmf + 2 samples (a power of 2) at 6 float2 slots per 4
// samples, the scale ring SQ >= D + 2 superframe scales (a power of 2).
struct FusedLayout {
  int D, RG, IRG, SQ, group_bytes, smem;
};

static FusedLayout fused_layout(int S, int osf, int G, int tb, int sfz,
                                int kmf, int M) {
  FusedLayout f;
  const int hop = S * osf;
  const int F = sfz - tb * hop + hop;   // rows one sub-block's window reads
  f.D = (F + hop - 1) / hop;
  f.RG = pow2_at_least((f.D + 1) * hop);
  f.IRG = pow2_at_least(2 * hop + kmf + 2);
  if (f.IRG < 4) f.IRG = 4;
  f.SQ = pow2_at_least(f.D + 2);
  if (f.SQ < 4) f.SQ = 4;
  f.group_bytes = f.RG * 8 + f.IRG / 4 * 6 * 8 + f.SQ * 4;
  f.smem = (SBF_THREADS / G) * f.group_bytes + (kmf + 3) / 4 * 16 +
           sym_slots(M) * 8;
  return f;
}

// Input ring slot of sample x_g: g mod IRG, 4 samples to 6 slots (2-way
// bank conflicts at most where the lanes' 4-row chunks read 4 samples
// apart; a pair at an even g stays one 16-byte line).
__device__ __forceinline__ int in_slot(int g, int irg) {
  const int s = g & (irg - 1);
  return s + 2 * (s >> 2);
}

__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// #6: x (C, n) complex raw input, xtail (C, xoff) the carried input before
// it.  Rows: global row R is the matched filter's output at x_g = R + z00,
// z00 = -(S osf + K - 1 + osf/2); sub-block t reads rows [t hop, t hop + F).
// A block holds SBF_THREADS / G channels and two kinds of warps.  Consumer
// warps (the first SBF_THREADS threads, G lanes a channel) run the
// sub-block loop on the rows in the ring.  Producer warps (GP = G / 2 lanes
// a channel, one warp for every two consumer warps; GP = G = 1 for S = 1)
// make the rows: produce(h) waits for hop h's input samples (cp.async,
// issued one hop ahead), issues hop h + 1's, computes hop h's rows from the
// staged input (each lane chunks of 4 consecutive rows, a sliding window
// of 4 samples, every row summed k = 0 .. kmf-1 with separate roundings)
// into the row ring, and adds their power into per-lane sums (virtual lane
// jv of G: superframe-local rows jv, jv + G, ... in order, as the plain
// version's _fused_scales; a producer lane holds G / GP virtual lanes and
// adds its two first, which is the butterfly's first step).  The
// producers make hops 0 .. D-1, then in step t hop t + D while the
// consumers run sub-block t; a named barrier per producer warp and its
// consumer warps ends every step.  So the filter runs beside the loop and
// every row is computed once.  When hop T tb starts, superframe T-1's
// power is complete: the power EMA steps and superframe T's AGC pre-scale
// goes into the scale ring.
//
// One launch is the whole of a DecisionDemodSB step: the consumers write y,
// valid, the decisions' bits and the bits' valid flags (BitsOut) and the
// state rows with the pointer re-based to the next block (ptr - n); the
// producers copy the input's last xoff samples, the next step's xtail, into
// xt_out.
template <int KMAX>
__global__ void __launch_bounds__(2 * SBF_THREADS)
demod_sb_fused_kernel(const float2* __restrict__ x,
                      const float2* __restrict__ xtail, int xoff,
                      const float* __restrict__ h_mf, int kmf,
                      const float* __restrict__ st_in,
                      float* __restrict__ st_out,
                      const float2* __restrict__ sym, SbCfg c, int C, int nsb,
                      int tb, FusedLayout f, bool vec, float rms_ref,
                      float2* __restrict__ y,
                      unsigned char* __restrict__ valid,
                      unsigned char* __restrict__ bits,
                      unsigned char* __restrict__ bvalid, int k,
                      float2* __restrict__ xt_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = c.G, S = c.S, osf = c.osf, n = c.n;
  const int ngrp = SBF_THREADS / G;
  const int GP = G > 1 ? G / 2 : 1;      // producer lanes a channel
  const int V = G / GP;                  // virtual lanes a producer lane
  const int bar_count = G > 1 ? 96 : 64; // a producer warp + its consumers
  float* s_h = reinterpret_cast<float*>(smem_raw + ngrp * f.group_bytes);
  float2* s_sym = reinterpret_cast<float2*>(s_h + (kmf + 3) / 4 * 4);
  for (int i = threadIdx.x; i < sym_slots(c.M); i += blockDim.x)
    s_sym[i] = i < c.M ? sym[i] : make_float2(SB_FAR, SB_FAR);
  for (int i = threadIdx.x; i < kmf; i += blockDim.x) s_h[i] = h_mf[i];
  __syncthreads();

  const bool consumer = threadIdx.x < SBF_THREADS;
  const int pt = threadIdx.x - SBF_THREADS;          // producer thread
  const int grp = consumer ? threadIdx.x / G : pt / GP;
  unsigned char* gbase = smem_raw + grp * f.group_bytes;
  float2* ring = reinterpret_cast<float2*>(gbase);                // RG rows
  float2* xin = ring + f.RG;                                      // input
  float* s_sc = reinterpret_cast<float*>(xin + f.IRG / 4 * 6);    // SQ
  const int ch = blockIdx.x * ngrp + grp;
  const bool active = ch < C;
  const int cc = active ? ch : C - 1;
  const int hop = S * osf, hopt = tb * hop, nT = nsb / tb;
  const int hlast = nsb + f.D - 2;     // the last hop a window reads

  if (consumer) {
    const int j = threadIdx.x % G;
    const int bar_id = 1 + (G > 1 ? threadIdx.x / 64 : threadIdx.x / 32);
    SbState st = sb_load(st_in, cc, C);
    const long long ldo = (long long)nsb * S;
    const BitsOut out{y + cc * ldo, valid + cc * ldo, bits + cc * ldo * k,
                      bvalid + cc * ldo * k, k};
    const int mask = f.RG - 1;
    float s = 1.f;
    const TapsClosed<KMAX> taps{c.itrp, c.nph, c.K, c.inv_nph};
    named_bar(bar_id, bar_count);      // hops 0 .. D-1 are in the ring
    for (int t = 0; t < nsb; ++t) {
      if (t % tb == 0) s = s_sc[(t / tb) & (f.SQ - 1)];
      const int base = t * hop;
      sb_step<KMAX>(c, st, t, j,
                    [ring, base, mask](int u) { return ring[(base + u) & mask]; },
                    taps, s, s_sym, out, active);
      named_bar(bar_id, bar_count);
    }
    st.ptr = fsub(st.ptr, (float)n);
    if (active && j == 0) sb_store(st_out, cc, C, st);
    return;
  }

  const int jp = pt % GP;
  const int bar_id = 1 + pt / 32;
  const int z00 = -(S * osf + (c.K - 1) + osf / 2);
  const bool agc = (c.flags & SB_AGC) != 0;
  float p_ema = st_in[8 * C + cc];
  const float2* xr = x + (long long)cc * n;
  const float2* tr = xtail + (long long)cc * xoff + xoff;   // tr[g], g < 0

  // the AGC pre-scale of a superframe from the EMA of the earlier ones
  auto scale_of = [&](float pe) {
    return (agc && pe > 0.f) ? fdiv(rms_ref, __fsqrt_rn(fmaxf(pe, 1e-20f)))
                             : 1.f;
  };
  // samples x_g, g in (lo, hi], into the input ring (lo, hi odd when vec)
  auto stage = [&](int lo, int hi) {
    if (vec) {
      for (int g = lo + 1 + 2 * jp; g <= hi; g += 2 * GP) {
        const float2* src = g < 0 ? tr + g : xr + (g < n ? g : 0);
        const int nb = g < 0 ? 16 : (g + 1 < n ? 16 : (g < n ? 8 : 0));
        cp_async16(xin + in_slot(g, f.IRG), src, nb);
      }
    } else {
      for (int g = lo + 1 + jp; g <= hi; g += GP) {
        const float2* src = g < 0 ? tr + g : xr + (g < n ? g : 0);
        cp_async8(xin + in_slot(g, f.IRG), src, g < n ? 8 : 0);
      }
    }
    cp_async_commit();
  };
  // the last sample hop h's rows read, rounded up to an odd index
  auto hop_end = [&](int h) { return (((h + 1) * hop + z00 - 1) | 1); };

  float pw[2] = {0.f, 0.f};   // power sums of virtual lanes jp, jp + GP
  if (jp == 0) s_sc[0] = scale_of(p_ema);
  stage(((z00 - kmf + 1) & ~1) - 1, hop_end(0));

  auto produce = [&](int h) {
    cp_async_wait_all();
    __syncwarp();
    if (h + 1 <= hlast) stage(hop_end(h), hop_end(h + 1));
    const int sf = h / tb;
    if (h % tb == 0 && h > 0 && sf <= nT) {   // superframe sf - 1 is done
      float tot = V == 2 ? fadd(pw[0], pw[1]) : pw[0];
      for (int m = GP >> 1; m > 0; m >>= 1)
        tot = fadd(tot, __shfl_xor_sync(SB_FULL, tot, m, GP));
      const float pwt = fdiv(tot, (float)hopt);
      if (agc) p_ema = p_ema > 0.f
                           ? fadd(fmul(fsub(1.f, SB_APW), p_ema),
                                  fmul(SB_APW, pwt))
                           : pwt;
      if (jp == 0) s_sc[sf & (f.SQ - 1)] = scale_of(p_ema);
      pw[0] = pw[1] = 0.f;
    }
    const int R0 = h * hop;
    for (int q = 4 * jp; q < hop; q += 4 * GP) {
      const int g = R0 + q + z00;    // x_g of row R0 + q
      float zr[4] = {0.f, 0.f, 0.f, 0.f}, zi[4] = {0.f, 0.f, 0.f, 0.f};
      float2 w[4];                   // w[i] = x_{g + i - k}
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = xin[in_slot(g + i, f.IRG)];
      // taps four at a time from one 16-byte load, then the rest
      auto tap = [&](float hk, int k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          zr[i] = fadd(zr[i], fmul(hk, w[i].x));
          zi[i] = fadd(zi[i], fmul(hk, w[i].y));
        }
        w[3] = w[2]; w[2] = w[1]; w[1] = w[0];
        w[0] = xin[in_slot(g - k - 1, f.IRG)];
      };
      int k = 0;
      for (; k + 4 <= kmf; k += 4) {
        const float4 h4 = *reinterpret_cast<const float4*>(s_h + k);
        tap(h4.x, k);
        tap(h4.y, k + 1);
        tap(h4.z, k + 2);
        tap(h4.w, k + 3);
      }
      for (; k < kmf; ++k) tap(s_h[k], k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (q + i < hop)
          ring[(R0 + q + i) & (f.RG - 1)] = make_float2(zr[i], zi[i]);
    }
    __syncwarp();
    if (h < nsb) {                   // rows of superframe sf, in lane order
      const int base = (h % tb) * hop;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        if (v >= V) break;
        const int jv = jp + v * GP;
        for (int r = base + ((jv - base) & (G - 1)); r < base + hop; r += G) {
          const float2 z = ring[(sf * hopt + r) & (f.RG - 1)];
          pw[v] = fadd(pw[v], fsq(z.x, z.y));
        }
      }
    }
  };

  for (int h = 0; h < f.D; ++h) produce(h);
  named_bar(bar_id, bar_count);
  for (int t = 0; t < nsb; ++t) {
    if (t + f.D <= hlast) produce(t + f.D);
    named_bar(bar_id, bar_count);
  }
  if (active && jp == 0) st_out[8 * C + cc] = p_ema;
  if (active) {   // x[n - xoff:], the next step's carried input
    const float2* src = xr + (n - xoff);
    float2* dst = xt_out + (long long)cc * xoff;
    if (vec) {
      for (int i = 2 * jp; i < xoff; i += 2 * GP)
        *reinterpret_cast<float4*>(dst + i) =
            *reinterpret_cast<const float4*>(src + i);
    } else {
      for (int i = jp; i < xoff; i += GP) dst[i] = src[i];
    }
  }
}

static SbCfg make_cfg(int S, int osf, int K, int nph, int itrp, int M, int n,
                      float tgain, float aga, float gamma, float rho,
                      int flags) {
  SbCfg c;
  c.S = S; c.osf = osf; c.K = K; c.nph = nph; c.itrp = itrp; c.M = M;
  c.n = n; c.flags = flags;
  c.G = 1;
  while (c.G < S) c.G <<= 1;
  c.tgain = tgain; c.aga = aga; c.gamma = gamma; c.rho = rho;
  c.inv_S = (S & (S - 1)) == 0 ? 1.f / (float)S : 0.f;
  c.inv_nph = nph > 0 && (nph & (nph - 1)) == 0 ? 1.f / (float)nph : 0.f;
  return c;
}

extern "C" int demod_sb_f32(const float2* zp, long long ldz,
                            const float* st_in, float* st_out,
                            const float2* sym, int M, float2* y, int* sidx,
                            unsigned char* valid, int C, int nsb, int S,
                            int osf, int K, int nph, int itrp, int n, int fs0,
                            float tgain, float aga, float gamma, float rho,
                            int flags, int kmax, cudaStream_t stream) {
  const SbCfg c = make_cfg(S, osf, K, nph, itrp, M, n, tgain, aga, gamma,
                           rho, flags);
  const SbLayout l = sb_layout(c, kmax);
  const int cpb = SB_THREADS / c.G;
  const unsigned blocks = (unsigned)((C + cpb - 1) / cpb);
#define SB_LAUNCH(KM)                                                        \
  do {                                                                       \
    cudaFuncSetAttribute(demod_sb_kernel<KM>,                                \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                         l.smem);                                            \
    demod_sb_kernel<KM><<<blocks, SB_THREADS, l.smem, stream>>>(             \
        zp, ldz, st_in, st_out, sym, c, l, C, nsb, fs0, y, sidx, valid);     \
  } while (0)
  if (kmax == 4)
    SB_LAUNCH(4);
  else if (kmax == 16)
    SB_LAUNCH(16);
  else
    SB_LAUNCH(32);
#undef SB_LAUNCH
  return (int)cudaGetLastError();
}

// #6: y, valid, bits, bvalid (k bytes a symbol), the rows with the pointer
// re-based, and xt_out.
extern "C" int demod_sb_fused_f32(
    const float2* x, const float2* xtail, int xoff, const float* h_mf, int kmf,
    const float* st_in, float* st_out, const float2* sym, int M, float2* y,
    unsigned char* valid, int C, int nsb, int tb, int sfz, int S,
    int osf, int K, int nph, int itrp, int n, float rms_ref, float tgain,
    float aga, float gamma, float rho, int flags, int kmax, int smem_bytes,
    cudaStream_t stream, unsigned char* bits, unsigned char* bvalid, int k,
    float2* xt_out) {
  const SbCfg c = make_cfg(S, osf, K, nph, itrp, M, n, tgain, aga, gamma,
                           rho, flags);
  const FusedLayout f = fused_layout(S, osf, c.G, tb, sfz, kmf, M);
  if (f.smem != smem_bytes) return (int)cudaErrorInvalidValue;
  // 16-byte staging where every pair at an even x_g is one aligned line
  const bool vec = (reinterpret_cast<size_t>(x) % 16 == 0) &&
                   (reinterpret_cast<size_t>(xtail) % 16 == 0) &&
                   n % 2 == 0 && xoff % 2 == 0;
  const int cpb = SBF_THREADS / c.G;
  const unsigned blocks = (unsigned)((C + cpb - 1) / cpb);
  // consumer threads, then GP = G / 2 producer lanes a channel (1 at G = 1)
  const int threads = SBF_THREADS + cpb * (c.G > 1 ? c.G / 2 : 1);
#define SB_FUSED_LAUNCH(KM)                                                  \
  do {                                                                       \
    cudaFuncSetAttribute(demod_sb_fused_kernel<KM>,                          \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                         smem_bytes);                                        \
    demod_sb_fused_kernel<KM><<<blocks, threads, smem_bytes, stream>>>(      \
        x, xtail, xoff, h_mf, kmf, st_in, st_out, sym, c, C, nsb, tb, f,     \
        vec, rms_ref, y, valid, bits, bvalid, k, xt_out);                    \
  } while (0)
  if (kmax == 4)
    SB_FUSED_LAUNCH(4);
  else if (kmax == 16)
    SB_FUSED_LAUNCH(16);
  else
    SB_FUSED_LAUNCH(32);
#undef SB_FUSED_LAUNCH
  return (int)cudaGetLastError();
}
