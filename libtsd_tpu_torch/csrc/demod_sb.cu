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
// channels give 2048 warps, ~16 per SM.  The window reads zp in place at
// the channel's own offset (a plain indexed read: no materialised frame
// stack, no lane-shift network), and the phase error is atan2f (the TPU
// kernel used a polynomial).  #6 computes, per superframe of tb
// sub-blocks, the fp32 matched-filter rows it needs into shared memory,
// with their power for the AGC's EMA, then runs the same sub-block step on
// them; the filtered signal never reaches device memory.
#include <cuda_runtime.h>
#include <math.h>

#define SB_THREADS 128
#define SB_APW 0.25f
#define SB_FULL 0xffffffffu

enum { SB_CARRIER = 1, SB_CLOCK = 2, SB_AGC = 4 };
enum { ITRP_CSPLINE = 0, ITRP_LINEAR = 1, ITRP_LAGRANGE = 2, ITRP_SINC = 3 };

struct SbCfg {
  int S, osf, K, nph, itrp, M, n, G, flags;
  float tgain, aga, gamma, rho;
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

// Sum over the G lanes of a group by an xor butterfly (every lane ends
// with the same value: IEEE addition commutes).
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int m = G >> 1; m > 0; m >>= 1)
    v = fadd(v, __shfl_xor_sync(SB_FULL, v, m, G));
  return v;
}

// Fractional-delay taps in closed form at the LUT-quantised tau: the
// formulas of ops/resample.py's builders (cspline_coefs, linear_coefs,
// lagrange_coefs of degree K - 1, sinc_interp_coefs with fc = 0.5 and the
// tau-shifted Hann window), as the JAX package evaluates them.  KMAX >= 4.
template <int KMAX>
__device__ __forceinline__ void sb_taps(int itrp, float tau, int nph, int K,
                                        float (&tp)[KMAX]) {
  static_assert(KMAX >= 4, "KMAX >= 4");
  const float t =
      fdiv(rintf(fmul(fminf(fmaxf(tau, 0.f), 1.f), (float)nph)), (float)nph);
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

// One sub-block of one channel, lane j of its group.  win(u) returns the
// window sample at frame offset u, where the frame of sub-block t starts
// ML + (K - 1) + osf/2 samples before the nominal pointer t*S*osf; the
// interpolated sums are multiplied by `scale` (the fused AGC pre-scale).
template <int KMAX, class Win>
__device__ __forceinline__ void sb_step(const SbCfg& c, SbState& st, int t,
                                        int j, const Win& win, float scale,
                                        const float2* __restrict__ s_sym,
                                        float2* yo, int* so,
                                        unsigned char* vo, bool active) {
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
  sb_taps<KMAX>(c.itrp, tau, c.nph, c.K, tp);
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
  const float th = fadd(st.theta, fmul((float)j, fdiv(st.lf_mu, (float)S)));
  const float cs = cosf(th), sn = sinf(th);
  const float y_r = fmul(fadd(fmul(yr, cs), fmul(yi, sn)), st.gain);
  const float y_i = fmul(fsub(fmul(yi, cs), fmul(yr, sn)), st.gain);
  const float m_r = fmul(fadd(fmul(mr, cs), fmul(mi, sn)), st.gain);
  const float m_i = fmul(fsub(fmul(mi, cs), fmul(mr, sn)), st.gain);

  // nearest constellation point (the first minimum, as argmin)
  float best = INFINITY, ye_r = 0.f, ye_i = 0.f;
  int bi = 0;
  for (int m = 0; m < c.M; ++m) {
    const float2 sm = s_sym[m];
    const float d2 = fsq(fsub(y_r, sm.x), fsub(y_i, sm.y));
    if (d2 < best) { best = d2; bi = m; ye_r = sm.x; ye_i = sm.y; }
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

  const float sum_t = group_sum(e_t, G);
  const float e_mean = fdiv(group_sum(e_ph, G), (float)S);
  const float g_mean = fdiv(group_sum(e_g, G), (float)S);
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

  if (active && lane_ok) {
    const int idx = t * S + j;
    yo[idx] = upd ? make_float2(y_r, y_i) : make_float2(0.f, 0.f);
    so[idx] = upd ? bi : 0;
    vo[idx] = upd ? 1 : 0;
  }
}

// #5: zp (C, ldz) complex, the matched-filter output behind its carried
// tail; sub-block t's frame starts at zp[c, fs0 + t*S*osf].
template <int KMAX>
__global__ void __launch_bounds__(SB_THREADS)
demod_sb_kernel(const float2* __restrict__ zp, long long ldz,
                const float* __restrict__ st_in, float* __restrict__ st_out,
                const float2* __restrict__ sym, SbCfg c, int C, int nsb,
                int fs0, float2* __restrict__ y, int* __restrict__ sidx,
                unsigned char* __restrict__ valid) {
  extern __shared__ float2 s_sym[];
  for (int i = threadIdx.x; i < c.M; i += blockDim.x) s_sym[i] = sym[i];
  __syncthreads();
  const int G = c.G;
  const int j = threadIdx.x % G;
  const int ch = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const bool active = ch < C;
  const int cc = active ? ch : C - 1;   // idle groups shadow a real channel
  SbState st = sb_load(st_in, cc, C);
  const float2* row = zp + (long long)cc * ldz + fs0;
  const long long ldo = (long long)nsb * c.S;
  float2* yo = y + (long long)cc * ldo;
  int* so = sidx + (long long)cc * ldo;
  unsigned char* vo = valid + (long long)cc * ldo;
  for (int t = 0; t < nsb; ++t) {
    const float2* fr = row + (long long)t * c.S * c.osf;
    sb_step<KMAX>(c, st, t, j, [fr](int u) { return __ldg(fr + u); }, 1.f,
                  s_sym, yo, so, vo, active);
  }
  if (active && j == 0) sb_store(st_out, cc, C, st);
}

// #6: x (C, n) complex raw input, xtail (C, xoff) the carried input before
// it.  Per superframe T of tb sub-blocks the group computes the sfz
// matched-filter rows from x_g = T*tb*S*osf + z00 on into shared memory
// (fp32, taps h_mf), with the mean power of the first tb*S*osf rows; the
// AGC pre-scale comes from the power EMA of the earlier superframes.
template <int KMAX>
__global__ void __launch_bounds__(SB_THREADS)
demod_sb_fused_kernel(const float2* __restrict__ x,
                      const float2* __restrict__ xtail, int xoff,
                      const float* __restrict__ h_mf, int kmf,
                      const float* __restrict__ st_in,
                      float* __restrict__ st_out,
                      const float2* __restrict__ sym, SbCfg c, int C, int nsb,
                      int tb, int sfz, float rms_ref,
                      float2* __restrict__ y, int* __restrict__ sidx,
                      unsigned char* __restrict__ valid) {
  extern __shared__ float2 smem[];
  float2* s_sym = smem;                              // M
  float* s_h = reinterpret_cast<float*>(s_sym + c.M);  // kmf, padded to even
  float2* s_z = reinterpret_cast<float2*>(s_h + ((kmf + 1) & ~1));
  for (int i = threadIdx.x; i < c.M; i += blockDim.x) s_sym[i] = sym[i];
  for (int i = threadIdx.x; i < kmf; i += blockDim.x) s_h[i] = h_mf[i];
  __syncthreads();

  const int G = c.G, S = c.S, osf = c.osf, n = c.n;
  const int j = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int ch = blockIdx.x * (blockDim.x / G) + grp;
  const bool active = ch < C;
  const int cc = active ? ch : C - 1;
  const int hop = S * osf, hopt = tb * hop, nT = nsb / tb;
  const int z00 = -(S * osf + (c.K - 1) + osf / 2);
  SbState st = sb_load(st_in, cc, C);
  float p_ema = st_in[8 * C + cc];
  const float2* xr = x + (long long)cc * n;
  const float2* tr = xtail + (long long)cc * xoff + xoff;   // tr[g], g < 0
  float2* zw = s_z + (long long)grp * sfz;
  const long long ldo = (long long)nsb * S;
  float2* yo = y + (long long)cc * ldo;
  int* so = sidx + (long long)cc * ldo;
  unsigned char* vo = valid + (long long)cc * ldo;

  for (int T = 0; T < nT; ++T) {
    const int g0 = T * hopt + z00;   // x_g of shared row 0
    float pw = 0.f;
    for (int r = j; r < sfz; r += G) {
      const int xg = g0 + r;
      float zr = 0.f, zi = 0.f;
      if (xg - (kmf - 1) >= 0 && xg < n) {
        for (int k = 0; k < kmf; ++k) {
          const float2 v = __ldg(xr + xg - k);
          zr = fadd(zr, fmul(s_h[k], v.x));
          zi = fadd(zi, fmul(s_h[k], v.y));
        }
      } else {
        for (int k = 0; k < kmf; ++k) {
          const int g = xg - k;
          const float2 v = g < 0 ? __ldg(tr + g)
                                 : (g < n ? __ldg(xr + g)
                                          : make_float2(0.f, 0.f));
          zr = fadd(zr, fmul(s_h[k], v.x));
          zi = fadd(zi, fmul(s_h[k], v.y));
        }
      }
      zw[r] = make_float2(zr, zi);
      if (r < hopt) pw = fadd(pw, fsq(zr, zi));
    }
    pw = fdiv(group_sum(pw, G), (float)hopt);
    const float s = ((c.flags & SB_AGC) && p_ema > 0.f)
                        ? fdiv(rms_ref, __fsqrt_rn(fmaxf(p_ema, 1e-20f)))
                        : 1.f;
    __syncwarp();
    for (int tbi = 0; tbi < tb; ++tbi) {
      const float2* fr = zw + tbi * hop;
      sb_step<KMAX>(c, st, T * tb + tbi, j, [fr](int u) { return fr[u]; },
                    s, s_sym, yo, so, vo, active);
    }
    if (c.flags & SB_AGC)
      p_ema = p_ema > 0.f
                  ? fadd(fmul(fsub(1.f, SB_APW), p_ema), fmul(SB_APW, pw))
                  : pw;
    __syncwarp();
  }
  if (active && j == 0) {
    sb_store(st_out, cc, C, st);
    st_out[8 * C + cc] = p_ema;
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
  const int cpb = SB_THREADS / c.G;
  const unsigned blocks = (unsigned)((C + cpb - 1) / cpb);
  const size_t smem = (size_t)M * sizeof(float2);
  if (kmax == 4)
    demod_sb_kernel<4><<<blocks, SB_THREADS, smem, stream>>>(
        zp, ldz, st_in, st_out, sym, c, C, nsb, fs0, y, sidx, valid);
  else if (kmax == 16)
    demod_sb_kernel<16><<<blocks, SB_THREADS, smem, stream>>>(
        zp, ldz, st_in, st_out, sym, c, C, nsb, fs0, y, sidx, valid);
  else
    demod_sb_kernel<32><<<blocks, SB_THREADS, smem, stream>>>(
        zp, ldz, st_in, st_out, sym, c, C, nsb, fs0, y, sidx, valid);
  return (int)cudaGetLastError();
}

extern "C" int demod_sb_fused_f32(
    const float2* x, const float2* xtail, int xoff, const float* h_mf, int kmf,
    const float* st_in, float* st_out, const float2* sym, int M, float2* y,
    int* sidx, unsigned char* valid, int C, int nsb, int tb, int sfz, int S,
    int osf, int K, int nph, int itrp, int n, float rms_ref, float tgain,
    float aga, float gamma, float rho, int flags, int kmax, int smem_bytes,
    cudaStream_t stream) {
  const SbCfg c = make_cfg(S, osf, K, nph, itrp, M, n, tgain, aga, gamma,
                           rho, flags);
  const int cpb = SB_THREADS / c.G;
  const unsigned blocks = (unsigned)((C + cpb - 1) / cpb);
#define SB_FUSED_LAUNCH(KM)                                                  \
  do {                                                                       \
    cudaFuncSetAttribute(demod_sb_fused_kernel<KM>,                          \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                         smem_bytes);                                        \
    demod_sb_fused_kernel<KM><<<blocks, SB_THREADS, smem_bytes, stream>>>(   \
        x, xtail, xoff, h_mf, kmf, st_in, st_out, sym, c, C, nsb, tb, sfz,   \
        rms_ref, y, sidx, valid);                                            \
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
