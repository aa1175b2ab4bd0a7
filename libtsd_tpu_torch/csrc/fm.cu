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
// ridge of 20, so device memory bounds it; what the kernel issues per
// sample (the mix's phase, the FIR's shared-memory reads) is what it has to
// keep small to get near that.
//
// Design: a block takes Q = 1024 outputs of one channel, 256 threads, 4
// blocks an SM (64 registers: the FIR's window fits without spills, and
// the mix's device-memory reads of four blocks overlap one another).
//  * It mixes its R Q + R Kp input samples into shared memory as R
//    polyphase planes, P[rho][m] = b[R m - rho] (Kp = ceil(K / R)), with no
//    division: at R = 4 a thread takes one aligned group of 4 samples (one
//    float4 of xr and one of xi): sample 4g is rho 0 of m = g, samples
//    4g + 1 .. 4g + 3 are rho 3 .. 1 of m = g + 1; any other R loops over
//    (rho, m) with n = R m - rho.  The phase is formed in float64, wrapped
//    to cycles, then sincospif: exact at any stream length (f0 n in float32
//    is off by up to 2^-7 cycles at n ~ 2^18).  Plane index i is stored at
//    i ^ ((i >> 5) & 3), so that the FIR's reads 4 apart across a warp hit
//    32 banks.
//  * The FIR: each thread computes 4 consecutive outputs, taps in ascending
//    order k = R jj + rho.  At R = 4 and Kp = 16 (the configs' 63 taps) it
//    holds a sliding window of 4 samples a plane in registers: one new read
//    a plane and part per tap row jj, against 3 reads for 2 FMAs of a read
//    per tap; the taps are broadcast 4 at a time.  Thread 0 also computes
//    the output before the block (the discriminator's edge; recomputed from
//    x, so the FIR history and the edge need no carry between blocks).
//  * Each thread then runs the discriminator on its own 4 outputs (the
//    output before them from the lane before, the warp before, or the
//    edge) (atan2f), and the de-emphasis from w = 0.  The carry is exact:
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
constexpr int V = 4;          // outputs a thread
}  // namespace

__device__ __forceinline__ void affine_combine(float& m, float& v, float mu,
                                               float vu) {
  // (mu, vu) then (m, v): w_out = m (mu w_in + vu) + v
  v = fmaf(m, vu, v);
  m = m * mu;
}

// Shared-memory slot of plane index i (a bank swizzle within 32 slots).
__device__ __forceinline__ int slot(int i) { return i ^ ((i >> 5) & 3); }

// b[n] = x[n] exp(-2 pi i frac(f0 n)), the phase in float64 cycles.
__device__ __forceinline__ void mix(float a, float b, long long n, double f0,
                                    float& br, float& bi) {
  double t = f0 * (double)n;
  t -= floor(t);
  float s, c;
  sincospif(2.0f * (float)t, &s, &c);
  br = fmaf(a, c, b * s);
  bi = fmaf(b, c, -(a * s));
}

// NV outputs at plane indices m0 + v + Kp - jj (v < NV), taps k = R jj + rho
// ascending.  RT, KPT > 0: a sliding window of NV samples a plane and part
// in registers; 0: R and Kp at run time, a read a tap.
template <int RT, int KPT, int NV>
__device__ __forceinline__ void fir(const float* pr, const float* pi, int ps,
                                    const float* hs, int R, int Kp, int m0,
                                    float (&ar)[NV], float (&ai)[NV]) {
#pragma unroll
  for (int v = 0; v < NV; ++v) ar[v] = ai[v] = 0.f;
  if constexpr (RT > 0 && KPT > 0) {
    constexpr int RR = RT, KK = KPT;
    float wr[RR][NV], wi[RR][NV];
#pragma unroll
    for (int rho = 0; rho < RR; ++rho)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        wr[rho][v] = pr[rho * ps + slot(m0 + KK + v)];
        wi[rho][v] = pi[rho * ps + slot(m0 + KK + v)];
      }
#pragma unroll
    for (int jj = 0; jj < KK; ++jj) {
      if (jj > 0) {
#pragma unroll
        for (int rho = 0; rho < RR; ++rho) {
#pragma unroll
          for (int v = NV - 1; v > 0; --v) {
            wr[rho][v] = wr[rho][v - 1];
            wi[rho][v] = wi[rho][v - 1];
          }
          wr[rho][0] = pr[rho * ps + slot(m0 + KK - jj)];
          wi[rho][0] = pi[rho * ps + slot(m0 + KK - jj)];
        }
      }
      float hv[RR];
      if constexpr (RR == 4) {
        const float4 h4 = *reinterpret_cast<const float4*>(hs + jj * 4);
        hv[0] = h4.x; hv[1] = h4.y; hv[2] = h4.z; hv[3] = h4.w;
      } else {
#pragma unroll
        for (int rho = 0; rho < RR; ++rho) hv[rho] = hs[jj * RR + rho];
      }
#pragma unroll
      for (int rho = 0; rho < RR; ++rho)
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          ar[v] = fmaf(hv[rho], wr[rho][v], ar[v]);
          ai[v] = fmaf(hv[rho], wi[rho][v], ai[v]);
        }
    }
  } else {
    for (int jj = 0; jj < Kp; ++jj)
      for (int rho = 0; rho < R; ++rho) {
        const float hv = hs[jj * R + rho];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int e = rho * ps + slot(m0 + v + Kp - jj);
          ar[v] = fmaf(hv, pr[e], ar[v]);
          ai[v] = fmaf(hv, pi[e], ai[v]);
        }
      }
  }
}

// RT, KPT: the decimation and the taps a plane as template constants (> 0;
// xr and xi 16-byte aligned when RT = 4), or 0 for any at run time.
template <int RT, int KPT>
__global__ void __launch_bounds__(THREADS, 4)
fm_chain_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ h, float* __restrict__ y,
                unsigned long long* __restrict__ status,
                unsigned int* __restrict__ ticket, int C, long long N,
                int R_, int K, int Kp_, int ps, double f0, float scale,
                float b0, float cc, float p, int nchunk) {
  extern __shared__ __align__(16) float sm[];
  const int R = RT > 0 ? RT : R_;
  const int Kp = KPT > 0 ? KPT : Kp_;
  const int Mn = Q + Kp;                 // plane indices 0 .. Mn - 1
  const int hsz = (Kp * R + 3) & ~3;
  float* hs = sm;                        // Kp * R taps, zero-padded
  float* pr = hs + hsz;                  // R planes of ps slots
  float* pi = pr + R * ps;
  __shared__ float wm[THREADS / 32], wv[THREADS / 32];
  __shared__ float lzr[THREADS / 32], lzi[THREADS / 32];   // warps' last z
  __shared__ float ezr, ezi;             // the edge, z[q0 - 1]
  __shared__ float wblk;
  __shared__ unsigned int tk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) tk = atomicAdd(ticket, 1u);
  for (int e = tid; e < hsz; e += THREADS) hs[e] = e < K ? h[e] : 0.f;
  __syncthreads();
  const int chunk = (int)(tk / (unsigned)C);
  const int ch = (int)(tk - (unsigned)chunk * (unsigned)C);
  const long long Nout = N / R;
  const long long q0 = (long long)chunk * Q;
  const long long m_lo = q0 - Kp;        // plane index 0 is m = m_lo
  const float* xrc = xr + (long long)ch * N;
  const float* xic = xi + (long long)ch * N;

  // mix into the polyphase planes
  if constexpr (RT == 4) {
    for (int gi = tid; gi <= Mn; gi += THREADS) {
      const long long n0 = 4 * (m_lo - 1 + gi);   // group g = m_lo - 1 + gi
      float br[4] = {0.f, 0.f, 0.f, 0.f}, bi[4] = {0.f, 0.f, 0.f, 0.f};
      if (n0 >= 0 && n0 < N) {                    // N % 4 == 0
        const float4 a = *reinterpret_cast<const float4*>(xrc + n0);
        const float4 b = *reinterpret_cast<const float4*>(xic + n0);
        mix(a.x, b.x, n0, f0, br[0], bi[0]);
        mix(a.y, b.y, n0 + 1, f0, br[1], bi[1]);
        mix(a.z, b.z, n0 + 2, f0, br[2], bi[2]);
        mix(a.w, b.w, n0 + 3, f0, br[3], bi[3]);
      }
      if (gi >= 1) {                              // rho 0 of m = g
        pr[slot(gi - 1)] = br[0];
        pi[slot(gi - 1)] = bi[0];
      }
      if (gi < Mn) {                              // rho 4 - r of m = g + 1
#pragma unroll
        for (int r = 1; r < 4; ++r) {
          pr[(4 - r) * ps + slot(gi)] = br[r];
          pi[(4 - r) * ps + slot(gi)] = bi[r];
        }
      }
    }
  } else {
    for (int rho = 0; rho < R; ++rho)
      for (int mm = tid; mm < Mn; mm += THREADS) {
        const long long n = (long long)R * (m_lo + mm) - rho;
        float br = 0.f, bi = 0.f;
        if (n >= 0 && n < N) mix(xrc[n], xic[n], n, f0, br, bi);
        pr[rho * ps + slot(mm)] = br;
        pi[rho * ps + slot(mm)] = bi;
      }
  }
  __syncthreads();

  // FIR + decimation: z[q0 + V tid + v], plane indices V tid + v + Kp - jj
  float zr[V], zi[V];
  fir<RT, KPT, V>(pr, pi, ps, hs, R, Kp, V * tid, zr, zi);
  if (lane == 31) {
    lzr[warp] = zr[V - 1];
    lzi[warp] = zi[V - 1];
  }
  if (tid == 0) {                        // the edge z[q0 - 1]; z[-1] = 0
    float er[1], ei[1];
    fir<RT, KPT, 1>(pr, pi, ps, hs, R, Kp, -1, er, ei);
    ezr = q0 == 0 ? 0.f : er[0];
    ezi = q0 == 0 ? 0.f : ei[0];
  }
  __syncthreads();

  // discriminator and the local de-emphasis (w = 0 at the thread's start)
  float pzr = __shfl_up_sync(0xffffffffu, zr[V - 1], 1);
  float pzi = __shfl_up_sync(0xffffffffu, zi[V - 1], 1);
  if (lane == 0) {
    pzr = warp > 0 ? lzr[warp - 1] : ezr;
    pzi = warp > 0 ? lzi[warp - 1] : ezi;
  }
  float yl[V], wloc = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float a = zr[j], b = zi[j];
    const float c = j > 0 ? zr[j - 1] : pzr;
    const float dn = -(j > 0 ? zi[j - 1] : pzi);   // conj of the previous
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
  const int ps = (Q + Kp + 31) & ~31;    // plane slots, whole swizzle rows
  const int smem = (((Kp * R + 3) & ~3) + 2 * R * ps) * (int)sizeof(float);
  const bool aligned = reinterpret_cast<size_t>(xr) % 16 == 0 &&
                       reinterpret_cast<size_t>(xi) % 16 == 0;
  // the configs' decimation and taps (R 4, 61-64 taps) as constants; any
  // other R or K, or unaligned planes, on the run-time instance
  auto kern = R == 4 && Kp == 16 && aligned ? fm_chain_kernel<4, 16>
                                             : fm_chain_kernel<0, 0>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  // scratch: C * nchunk status words, then the ticket counter; zeroed
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + (long long)C * nchunk);
  const long long blocks = (long long)C * nchunk;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
      xr, xi, h, y, scratch, ticket, C, N, R, K, Kp, ps, f0, scale, b0, cc,
      p, nchunk);
  return (int)cudaGetLastError();
}
