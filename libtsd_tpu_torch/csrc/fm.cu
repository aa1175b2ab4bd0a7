// Kernel #8: the fused FM broadcast receiver chain.  Replaces
// ops/pallas/fm.py::_kernel (via _fm_chain and FmChainPallas): NCO mix to
// baseband -> channel lowpass + decimation by R -> quadrature
// discriminator -> first-order de-emphasis, in one pass, the mixed,
// filtered and discriminated signals never in device memory.
//
// Semantics (the JAX kernel's, zero state at the start of every call):
// b[n] = x[n] exp(-2 pi i frac(f0 n)); z[q] = sum_k h[k] b[R q - k] (b = 0
// before the call); d[q] = arg(z[q] conj(z[q - 1])) / (2 pi dev), z[-1] =
// 0; y[q] = b0 d[q] + w[q - 1], w[q] = p w[q - 1] + c d[q], w[-1] = 0 (the
// transposed form of the order-1 de-emphasis, p = -a1, c = b1 - a1 b0).
//
// Bound on the H100: 8 bytes read per input sample and 4 written per output
// (9 a sample at R = 4) against ~K + 12 flop a sample (the polyphase FIR,
// K / R taps a sample in re and im, plus the mix and, per output, the
// discriminator and de-emphasis): ~8 flop/byte at K = 63, below the fp32
// ridge of 20, so device memory bounds it.
//
// Design: a block takes Q = 1024 outputs of one channel, 256 threads.
//  * It mixes its R Q + K input samples into shared memory as R polyphase
//    planes, P[rho][m] = b[R m - rho], so that the FIR's reads are
//    consecutive across a warp.  The phase is formed in float64, wrapped to
//    cycles, then sincospif: exact at any stream length (f0 n in float32
//    is off by up to 2^-7 cycles at n ~ 2^18).
//  * The FIR is the direct polyphase sum, taps in ascending order, for the
//    Q outputs and the one before them (the discriminator's edge: recomputed
//    from x, so the FIR history and the edge need no carry between blocks).
//  * Each thread then takes four consecutive outputs: discriminator
//    (atan2f), and the de-emphasis run from w = 0.  The carry is exact:
//    the affine maps (p^4, w) of the threads are scanned across the block
//    (warp shuffles, then across warps), and across blocks by a chained
//    scan: blocks take tickets in chunk-major order, publish their chunk's
//    outgoing w packed with a flag in one 64-bit word, and wait only for
//    the previous chunk of their own channel, which holds an earlier
//    ticket.  No truncation of the recursion, for any de-emphasis pole.
// The TPU kernel's strided-Toeplitz MXU products, shift matrices and
// polynomial atan2 were TPU choices and are not carried over.
#include <cuda_runtime.h>

namespace {
constexpr int Q = 1024;       // outputs per block
constexpr int THREADS = 256;  // 4 outputs a thread
}  // namespace

__device__ __forceinline__ void affine_combine(float& m, float& v, float mu,
                                               float vu) {
  // (mu, vu) then (m, v): w_out = m (mu w_in + vu) + v
  v = fmaf(m, vu, v);
  m = m * mu;
}

__global__ void __launch_bounds__(THREADS)
fm_chain_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ h, float* __restrict__ y,
                unsigned long long* __restrict__ status,
                unsigned int* __restrict__ ticket, int C, long long N, int R,
                int K, double f0, float scale, float b0, float cc, float p,
                int nchunk) {
  extern __shared__ __align__(16) float sm[];
  const int Kp = (K + R - 1) / R;
  const int Mn = Q + Kp;                 // polyphase samples a plane
  float* pr = sm;                        // R * Mn
  float* pi = pr + R * Mn;               // R * Mn
  float* zr = pi + R * Mn;               // Q + 1
  float* zi = zr + Q + 1;                // Q + 1
  float* hs = zi + Q + 1;                // Kp * R, zero-padded
  __shared__ float wm[THREADS / 32], wv[THREADS / 32];
  __shared__ float wblk;
  __shared__ unsigned int tk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) tk = atomicAdd(ticket, 1u);
  for (int e = tid; e < Kp * R; e += THREADS) hs[e] = e < K ? h[e] : 0.f;
  __syncthreads();
  const int chunk = (int)(tk / (unsigned)C);
  const int ch = (int)(tk - (unsigned)chunk * (unsigned)C);
  const long long Nout = N / R;
  const long long q0 = (long long)chunk * Q;
  const long long m_lo = q0 - Kp;
  const float* xrc = xr + (long long)ch * N;
  const float* xic = xi + (long long)ch * N;

  // mix into the polyphase planes
  const long long nbase = (long long)R * m_lo - (R - 1);
  for (int e = tid; e < R * Mn; e += THREADS) {
    const long long n = nbase + e;
    const int rho = (int)((((-n) % R) + R) % R);
    const int mm = (int)((n + rho) / R - m_lo);
    float br = 0.f, bi = 0.f;
    if (n >= 0 && n < N) {
      double t = f0 * (double)n;
      t -= floor(t);
      float s, c;
      sincospif(2.0f * (float)t, &s, &c);
      const float a = xrc[n], b = xic[n];
      br = fmaf(a, c, b * s);
      bi = fmaf(b, c, -(a * s));
    }
    pr[rho * Mn + mm] = br;
    pi[rho * Mn + mm] = bi;
  }
  __syncthreads();

  // FIR + decimation: z[qq] for q = q0 - 1 + qq, qq = 0 .. Q
  for (int qq = tid; qq <= Q; qq += THREADS) {
    float ar = 0.f, ai = 0.f;
    for (int jj = 0; jj < Kp; ++jj) {
      const int base = qq + Kp - 1 - jj;
      for (int rho = 0; rho < R; ++rho) {
        const float hv = hs[jj * R + rho];
        ar = fmaf(hv, pr[rho * Mn + base], ar);
        ai = fmaf(hv, pi[rho * Mn + base], ai);
      }
    }
    if (q0 == 0 && qq == 0) ar = ai = 0.f;   // z[-1] = 0
    zr[qq] = ar;
    zi[qq] = ai;
  }
  __syncthreads();

  // discriminator and the local de-emphasis (w = 0 at the thread's start)
  float yl[4], wloc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int qq = 1 + 4 * tid + j;
    const float a = zr[qq], b = zi[qq];
    const float c = zr[qq - 1], dn = -zi[qq - 1];  // conj of the previous
    // z conj(z_prev) as a complex product, (a c - b dn, a dn + b c)
    const float wr = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, dn));
    const float wi = __fadd_rn(__fmul_rn(a, dn), __fmul_rn(b, c));
    const float d = __fdiv_rn(atan2f(wi, wr), scale);
    yl[j] = fmaf(b0, d, wloc);
    wloc = fmaf(p, wloc, cc * d);
  }
  // block scan of the threads' affine maps (p^4, wloc)
  const float p2 = p * p;
  float m = p2 * p2, v = wloc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float mu = __shfl_up_sync(0xffffffffu, m, off);
    const float vu = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) affine_combine(m, v, mu, vu);
  }
  if (lane == 31) {
    wm[warp] = m;
    wv[warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
    float m2 = lane < THREADS / 32 ? wm[lane] : 1.f;
    float v2 = lane < THREADS / 32 ? wv[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < THREADS / 32; off <<= 1) {
      const float mu = __shfl_up_sync(0xffffffffu, m2, off);
      const float vu = __shfl_up_sync(0xffffffffu, v2, off);
      if (lane >= off) affine_combine(m2, v2, mu, vu);
    }
    if (lane < THREADS / 32) {
      wm[lane] = m2;      // inclusive over warps 0 .. lane
      wv[lane] = v2;
    }
  }
  __syncthreads();
  // the chunk's carry: the previous chunk of this channel, then publish
  if (tid == 0) {
    float win = 0.f;
    if (chunk > 0) {
      unsigned long long* src = status + (long long)(chunk - 1) * C + ch;
      unsigned long long s;
      while (((s = atomicAdd(src, 0ull)) >> 32) == 0ull) __nanosleep(64);
      win = __uint_as_float((unsigned)(s & 0xffffffffull));
    }
    wblk = win;
    if (chunk + 1 < nchunk) {
      const float wout = fmaf(wm[THREADS / 32 - 1], win, wv[THREADS / 32 - 1]);
      atomicExch(status + (long long)chunk * C + ch,
                 (1ull << 32) | (unsigned long long)__float_as_uint(wout));
    }
  }
  __syncthreads();
  // this thread's incoming w: the block carry through the warps before it
  // and the lanes before it
  float me = 1.f, ve = 0.f;                 // exclusive within the warp
  {
    const float mu = __shfl_up_sync(0xffffffffu, m, 1);
    const float vu = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane > 0) {
      me = mu;
      ve = vu;
    }
  }
  float w_in = wblk;
  if (warp > 0) w_in = fmaf(wm[warp - 1], w_in, wv[warp - 1]);
  w_in = fmaf(me, w_in, ve);
  const long long qs = q0 + 4 * tid;
  if (qs < Nout) {
    float4 o;
    float e = w_in;
    o.x = yl[0] + e; e *= p;
    o.y = yl[1] + e; e *= p;
    o.z = yl[2] + e; e *= p;
    o.w = yl[3] + e;
    *reinterpret_cast<float4*>(y + (long long)ch * Nout + qs) = o;
  }
}

extern "C" int fm_chain_f32(const float* xr, const float* xi, const float* h,
                            float* y, unsigned long long* scratch, int C,
                            long long N, int R, int K, double f0, float scale,
                            float b0, float cc, float p, cudaStream_t stream) {
  const long long Nout = N / R;
  const int nchunk = (int)((Nout + Q - 1) / Q);
  const int Kp = (K + R - 1) / R;
  const int smem = (2 * R * (Q + Kp) + 2 * (Q + 1) + Kp * R) * (int)sizeof(float);
  cudaFuncSetAttribute(fm_chain_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // scratch: C * nchunk status words, then the ticket counter; zeroed
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + (long long)C * nchunk);
  const long long blocks = (long long)C * nchunk;
  fm_chain_kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      xr, xi, h, y, scratch, ticket, C, N, R, K, f0, scale, b0, cc, p, nchunk);
  return (int)cudaGetLastError();
}
