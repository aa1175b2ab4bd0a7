// Kernel #10: the pattern detector's front end in one pass over complex x:
//
//     c[t]  = sum_{k < M} h[k] x[t - k]          complex correlation
//     en[t] = sum_{k < M} |x[t - k]|^2           window energy
//     sc[t] = sqrt(|c[t]|^2 / (en[t] + 1e-20))   raw normalised score
//
// written as four fp32 planes (cr, ci, en, sc), each (C, n).  Samples
// before the block come from the state (the last V inputs of the channel).
// Replaces ops/pallas/detfront.py::_detfront_jit (its _kernel: Karatsuba
// complex correlation and the energy as banded-Toeplitz bf16 hi/lo
// matmuls on the MXU, one grid step per 128-row tile).
//
// Bound on the H100: the function's least work (the correlation by
// overlap-save at ola_plan(M), ~130 flop a sample at M = 128, and the
// energy as a running sum) is bound by its 8 bytes in and 16 out a
// sample.  The direct form does ~5 M FMAs a sample: on an H100's FP32
// pipes that alone takes 0.16 ms at M = 128, 64 x 131,072, of the 0.357
// ms an FP32 direct form took there (PERF.md), so it ran on the wrong
// unit.
//
// Design: the direct form on the tensor cores (mma.sync m16n8k16 bf16 ->
// fp32), as the JAX kernel's banded Toeplitz product cut to 16-sample rows
// and as #3's FIR (chain_body.cuh, whose helpers it uses):
//   y[16 q + j] = sum_e sum_i T_e[j][i] x[16 (q - e) + i],
//   T_e[j][i] = h[16 e + j - i] (zero outside 0 <= k < M), e < E =
//   (M + 14) / 16 + 1.  The taps are the A operand, the signal rows the B
//   operand (N = 8 rows), read by ldmatrix from swizzled bf16 planes.
// Precision ("split", the JAX kernel's default tier): every real product
// x h is x1 h1 + x2 h1 + x1 h2, x1 = bf16(x), x2 = bf16(x - x1), h1, h2
// likewise, summed in fp32: ~2^-18 relative a product, 4-5e-6 of the peak
// on random data at M = 88 .. 5000 (numpy model), inside the 1e-5 gate;
// every xi hj with i + j <= 4 would cost twice as much.  The complex
// correlation is four real ones, cr = hr xr - hi xi, ci = hr xi + hi xr,
// so the B fragments of the xr and xi planes serve both outputs (12 mma a
// row block and tap block).  The energy is a fifth product: e2 = xr^2 +
// xi^2 in fp32 once a sample, split into e1 = bf16(e2), e2' = bf16(e2 -
// e1) (2^-18 relative), times an all-ones Toeplitz (1 for k < M: exact in
// bf16), 2 mma.  The tensor cores sum a run of 4 steps from zero; each
// run is then added to fp32 sums in shared memory, rounded to nearest: the
// tensor cores' own sums do not round to nearest, and accumulated across
// all E steps they drift by ~6 E ulp (3.7e-5 of the peak at M = 1500 on
// an H100 when every product went straight into the accumulators).  Sums
// of products are never differences of prefix sums, so an exactly silent
// window gives exactly 0 in cr, ci and en, and a score of 0.
// Blocks: one per (channel, tile of 4096 outputs = 256 rows), independent.
// Warp w owns rows 32 w .. 32 w + 31 as 4 n-tiles m (rows 32 w + m + 4 n,
// n < 8), so one B fragment, rows s + 4 n, feeds n-tile m = s - 32 w + e
// at every e.  Two passes over each chunk's steps, each with a ring of 4
// B fragment sets: the energy (e1/e2, one ldmatrix.x4 and 2 mma per
// n-tile a step), then the correlation (xr1/xr2 and xi1/xi2, two
// ldmatrix.x4 and 12 mma; -hi is hi with its sign bits flipped in
// registers), so that neither holds the other's fragments and run sums.
// The 48 sums a thread live in shared memory (48 KB a block) and take one
// load, add and store per run.  Measured slower (PERF.md): every
// step's products summed from zero in registers and added there (one
// pass: 412 bytes spilled at 128 registers, 0.175 ms at M = 128; two
// passes: 288-632 bytes, 0.165-0.172 ms).  The taps come in
// chunks of up to EC tap blocks (384 taps): for each, the block builds
// the five bf16 tap planes (hr1, hr2, hi1, hi2, ones) as reversed taps
// with a parity-shifted copy (chain_body.cuh's layout: 3 conflict-free
// 32-bit loads per plane and step) and converts its window (the tile's
// rows and the chunk's E - 1 rows of history; state, x, or zeros past the
// end) into six bf16 planes, 16-byte chunk c of a plane at c ^ ((c >> 3) &
// 7), so that the 8 rows s + 4 n of an ldmatrix matrix hit 8 distinct bank
// quads.  The epilogue forms the score from the fp32 sums and writes the
// four planes once.
// Shared memory: the sums, six window planes of (256 + EC' - 1) rows
// (rounded up to whole 128-byte lines) of 32 bytes and five tap planes,
// EC' = min(E, EC): 101 KB at M = 128, 109 KB from M = 354 on (KiB; two
// blocks an SM).
// tests/test_torch_ola_detfront_design.py is a numpy model of these maps
// (tap and window fragments, chunks, swizzle, products); keep it in step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include "chain_body.cuh"

namespace {

constexpr int DF_THREADS = 256;
constexpr int DF_NT = 4;                      // n-tiles of a warp
constexpr int DF_ROWS = 8 * 8 * DF_NT;        // 16-sample rows of a block
constexpr int DF_TILE = 16 * DF_ROWS;         // outputs of a block
constexpr int DF_EC = 24;                     // tap blocks of a chunk
constexpr int DF_XP = 6;                      // window planes
constexpr int DF_HP = 5;                      // tap planes
constexpr int DF_PARK = 12 * DF_NT * DF_THREADS * 4;  // the fp32 sums
constexpr int DF_MAX_DEVICES = 64;

__host__ __device__ constexpr int df_blocks(int M) {
  return (M + 14) / 16 + 1;
}
__host__ __device__ constexpr int df_win_rows(int E) {
  return (DF_ROWS + E - 1 + 3) / 4 * 4;
}
inline int df_smem(int M) {
  const int E = df_blocks(M) < DF_EC ? df_blocks(M) : DF_EC;
  return DF_PARK + DF_XP * df_win_rows(E) * 32 +
         DF_HP * chain::tap_plane_words(E) * 4;
}

__device__ __forceinline__ int df_swz(int c) { return c ^ ((c >> 3) & 7); }

// bf16 pieces of the pair (a, b): w1 = bf16x2(a, b), w2 = bf16x2 of the
// rest
__device__ __forceinline__ void split2(float a, float b, uint32_t& w1,
                                       uint32_t& w2) {
  w1 = chain::bf16x2(a, b);
  w2 = chain::bf16x2(a - __uint_as_float(w1 << 16),
                     b - __uint_as_float(w1 & 0xffff0000u));
}

// Window chunk c (8 samples from stream index g, g % 8 == 0) of channel
// row xc / state row sv into the six planes (xr1, xr2, xi1, xi2, e1, e2),
// plane_chunks 16-byte chunks apart.
__device__ __forceinline__ void put_window_chunk(
    const float2* __restrict__ xc, const float2* __restrict__ sv, int n,
    int V, long long g, int c, uint4* win, int plane_chunks) {
  float2 v[8];
  const float2* src = g >= 0 ? xc + g : sv + V + g;
  const bool whole = g >= 0 ? g + 8 <= n : g >= -(long long)V;
  if (whole && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 q = __ldg(p + k);
      v[2 * k] = make_float2(q.x, q.y);
      v[2 * k + 1] = make_float2(q.z, q.w);
    }
  } else {                        // the end of x, before the state, or odd
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long s = g + k;
      v[k] = s >= 0 ? (s < n ? __ldg(xc + s) : make_float2(0.0f, 0.0f))
                    : (s >= -(long long)V ? __ldg(sv + V + s)
                                          : make_float2(0.0f, 0.0f));
    }
  }
  uint32_t w[DF_XP][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 a = v[2 * k], b = v[2 * k + 1];
    split2(a.x, b.x, w[0][k], w[1][k]);
    split2(a.y, b.y, w[2][k], w[3][k]);
    // |x|^2 rounded as the plain version rounds it (no contraction)
    split2(__fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)),
           __fadd_rn(__fmul_rn(b.x, b.x), __fmul_rn(b.y, b.y)), w[4][k],
           w[5][k]);
  }
  const int p = df_swz(c);
#pragma unroll
  for (int j = 0; j < DF_XP; ++j)
    win[j * plane_chunks + p] = make_uint4(w[j][0], w[j][1], w[j][2],
                                           w[j][3]);
}

// Tap planes of the chunk of EL tap blocks from block e0: element i <= 16
// EL + 16 of rv = v[16 (e0 + EL) - i] at element i (i < 16 EL + 16) and at
// odd_copy(EL) words + i - 1 (i > 0), for v = hr1, hr2, hi1, hi2 and the
// ones (1 for 0 <= k < M), each plane tap_plane_words(EL) words apart.
__device__ __forceinline__ void load_taps(const float2* __restrict__ taps,
                                          int M, int e0, int EL,
                                          __nv_bfloat16* planes) {
  const int n = 16 * EL + 16, odd = 2 * chain::odd_copy(EL);
  const int stride = 2 * chain::tap_plane_words(EL);
  for (int i = threadIdx.x; i <= n; i += DF_THREADS) {
    const int k = 16 * (e0 + EL) - i;
    const bool in = k >= 0 && k < M;
    const float2 h = in ? __ldg(taps + k) : make_float2(0.0f, 0.0f);
    __nv_bfloat16 b[DF_HP];
    b[0] = __float2bfloat16_rn(h.x);
    b[1] = __float2bfloat16_rn(h.x - __bfloat162float(b[0]));
    b[2] = __float2bfloat16_rn(h.y);
    b[3] = __float2bfloat16_rn(h.y - __bfloat162float(b[2]));
    b[4] = __float2bfloat16_rn(in ? 1.0f : 0.0f);
#pragma unroll
    for (int j = 0; j < DF_HP; ++j) {
      __nv_bfloat16* pl = planes + j * stride;
      if (i < n) pl[i] = b[j];
      if (i > 0) pl[odd + i - 1] = b[j];
    }
  }
}

__global__ void __launch_bounds__(DF_THREADS, 2)
detfront_kernel(const float2* __restrict__ x, const float2* __restrict__ st,
                const float2* __restrict__ taps, float* __restrict__ cr,
                float* __restrict__ ci, float* __restrict__ en,
                float* __restrict__ sc, int n, int M, int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.y;
  const long long R0 = (long long)blockIdx.x * DF_ROWS;   // first row
  const float2* xc = x + (long long)c * n;
  const float2* sv = st + (long long)c * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Q = 8 * DF_NT * warp;               // the warp's first row
  const int E = df_blocks(M);
  // The sums of output o (0 cr, 1 ci, 2 en) of n-tile m, {D[g][2t],
  // D[g][2t+1], D[g+8][2t], D[g+8][2t+1]} (D[j][nn] sample j of row Q + m
  // + 4 nn), live in park[at(o, m, k)], one column a thread; the passes
  // sum runs of 4 steps in registers and add each run to them.
  float* park = reinterpret_cast<float*>(smem);
  auto at = [&](int o, int m, int k) {
    return ((o * DF_NT + m) * 4 + k) * DF_THREADS + threadIdx.x;
  };
#pragma unroll
  for (int k = 0; k < 12 * DF_NT; ++k)
    park[k * DF_THREADS + threadIdx.x] = 0.0f;
  unsigned char* chunk = smem + DF_PARK;
#pragma unroll 1
  for (int e0 = 0; e0 < E; e0 += DF_EC) {
    const int EL = min(DF_EC, E - e0);
    const int wrows = df_win_rows(EL);
    uint4* win = reinterpret_cast<uint4*>(chunk);
    auto* tp = reinterpret_cast<__nv_bfloat16*>(chunk + DF_XP * wrows * 32);
    __syncthreads();                            // the last chunk is consumed
    load_taps(taps, M, e0, EL, tp);
    // local row r is stream row R0 - e0 - EL + 1 + r
    const long long gw = 16 * (R0 - e0 - EL + 1);
    for (int k = threadIdx.x; k < 2 * (DF_ROWS + EL - 1); k += DF_THREADS)
      put_window_chunk(xc, sv, n, V, gw + 8 * k, k, win, 2 * wrows);
    __syncthreads();
    // ldmatrix: lane l gives row l & 7 of matrix l >> 3 (0, 1: the first
    // plane of a pair, k 0-7 and 8-15; 2, 3: the second); B(s) holds rows
    // s + 4 nn, rows of n-tile m at step el are Q + m + 4 nn - el (local
    // row + EL - 1)
    const unsigned base = chain::smem_addr(win) +
                          ((lane >> 4) ? 16u * 2 * wrows : 0u);
    const int lane_h = (lane >> 3) & 1;
    const int lane_row = 4 * (lane & 7) + EL - 1;
    const unsigned pair = 2u * 16u * 2 * wrows;   // bytes between pairs
    auto addr = [&](int s) {
      return base + 16u * (unsigned)df_swz(2 * (s + lane_row) + lane_h);
    };
    // A fragment of T_el at lane (g, t): words w, w - 4, w + 4 of rv (g
    // even) or of its odd copy (g odd), w = 8 (EL - el) + t - ceil(g / 2)
    const uint32_t* pa = reinterpret_cast<const uint32_t*>(tp) +
                         ((g & 1) ? chain::odd_copy(EL) : 0) + 8 * EL + t -
                         ((g + (g & 1)) >> 1);
    const int gwds = chain::tap_plane_words(EL);
    auto a_frag = [&](int el, int plane, uint32_t (&f)[3]) {
      const uint32_t* p = pa - 8 * el + plane * gwds;
      f[0] = p[0];
      f[1] = p[-4];
      f[2] = p[4];
    };
    // Each pass runs the chunk's steps el in branch-free runs of 4 (slot
    // i = el % 4 a constant), then the last EL % 4: step el loads B(Q -
    // el) into ring slot -el mod 4, n-tile m reads B(Q + m - el) from slot
    // (m - el) mod 4, the fresh fragment last.  After each run, flush()
    // adds the run's sums to park.
    auto steps = [&](auto&& step, auto&& flush) {
      int eb = 0;
      for (; eb + DF_NT <= EL; eb += DF_NT) {
#pragma unroll
        for (int i = 0; i < DF_NT; ++i) step(eb + i, i);
        flush();
      }
#pragma unroll
      for (int i = 0; i < DF_NT - 1; ++i)
        if (eb + i < EL) step(eb + i, i);
      flush();
    };
    {  // the energy: planes e1/e2, the ones
      float de[DF_NT][4] = {};
      uint32_t ring[DF_NT][4];
#pragma unroll
      for (int j = 1; j < DF_NT; ++j)
        chain::ldsm_x4(ring[j], addr(Q + j) + 2 * pair);
      steps([&](int el, int i) {
        chain::ldsm_x4(ring[(DF_NT - i) & (DF_NT - 1)],
                       addr(Q - el) + 2 * pair);
        uint32_t one[3];
        a_frag(el, 4, one);
#pragma unroll
        for (int mm = 1; mm <= DF_NT; ++mm) {
          const int m = mm & (DF_NT - 1);
          const uint32_t(&b)[4] = ring[(m - i) & (DF_NT - 1)];
          chain::mma(de[m], one[0], one[1], one[2], b[0], b[1]);
          chain::mma(de[m], one[0], one[1], one[2], b[2], b[3]);
        }
      }, [&] {
#pragma unroll
        for (int m = 0; m < DF_NT; ++m)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            park[at(2, m, k)] += de[m][k];
            de[m][k] = 0.0f;
          }
      });
    }
    {  // the correlation: planes xr1/xr2 and xi1/xi2, taps hr and hi
      float d[DF_NT][2][4] = {};
      uint32_t ring[DF_NT][2][4];
#pragma unroll
      for (int j = 1; j < DF_NT; ++j) {
        chain::ldsm_x4(ring[j][0], addr(Q + j));
        chain::ldsm_x4(ring[j][1], addr(Q + j) + pair);
      }
      steps([&](int el, int i) {
        uint32_t(&fresh)[2][4] = ring[(DF_NT - i) & (DF_NT - 1)];
        chain::ldsm_x4(fresh[0], addr(Q - el));
        chain::ldsm_x4(fresh[1], addr(Q - el) + pair);
        uint32_t a[4][3];                       // hr1, hr2, hi1, hi2
#pragma unroll
        for (int j = 0; j < 4; ++j) a_frag(el, j, a[j]);
        uint32_t na[2][3];                      // -hi1, -hi2
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int k = 0; k < 3; ++k) na[j][k] = a[2 + j][k] ^ 0x80008000u;
        // x1 h1, x2 h1, x1 h2 in rounds over the n-tiles; cr = hr xr -
        // hi xi, ci = hr xi + hi xr
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const int q = r == 1 ? 2 : 0;         // x2's registers in round 1
          const int h = r == 2 ? 1 : 0;         // h2 in round 2
#pragma unroll
          for (int mm = 1; mm <= DF_NT; ++mm) {
            const int m = mm & (DF_NT - 1);
            const uint32_t(&b)[2][4] = ring[(m - i) & (DF_NT - 1)];
            chain::mma(d[m][0], a[h][0], a[h][1], a[h][2], b[0][q],
                       b[0][q + 1]);
            chain::mma(d[m][1], a[h][0], a[h][1], a[h][2], b[1][q],
                       b[1][q + 1]);
            chain::mma(d[m][0], na[h][0], na[h][1], na[h][2], b[1][q],
                       b[1][q + 1]);
            chain::mma(d[m][1], a[2 + h][0], a[2 + h][1], a[2 + h][2],
                       b[0][q], b[0][q + 1]);
          }
        }
      }, [&] {
#pragma unroll
        for (int m = 0; m < DF_NT; ++m)
#pragma unroll
          for (int o = 0; o < 2; ++o)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              park[at(o, m, k)] += d[m][o][k];
              d[m][o][k] = 0.0f;
            }
      });
    }
  }
  const long long o = (long long)c * n;
  const long long t0 = 16 * (R0 + Q);
#pragma unroll
  for (int m = 0; m < DF_NT; ++m) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long s = t0 + 16 * (m + 4 * (2 * t + (k & 1))) + g +
                          8 * (k >> 1);
      if (s < n) {
        const float a = park[at(0, m, k)], b = park[at(1, m, k)];
        const float e = fmaxf(park[at(2, m, k)], 0.0f);
        cr[o + s] = a;
        ci[o + s] = b;
        en[o + s] = e;
        sc[o + s] = sqrtf((a * a + b * b) / (e + 1e-20f));
      }
    }
  }
}

}  // namespace

// taps: M complex taps (the wrapper's padded vector; entries past M are not
// read); state (C, V).  Returns cudaGetLastError() after the launch.
extern "C" int detfront_f32(const float2* x, const float2* st,
                            const float2* taps, float* cr, float* ci,
                            float* en, float* sc, int C, int n, int M, int V,
                            cudaStream_t stream) {
  const int smem = df_smem(M);
  if (smem > 48 * 1024) {
    // once per device for the largest size asked (the attribute is per
    // device)
    static int set[DF_MAX_DEVICES];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= DF_MAX_DEVICES || set[dev] < smem) {
      const cudaError_t e = cudaFuncSetAttribute(
          detfront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < DF_MAX_DEVICES) set[dev] = smem;
    }
  }
  const dim3 grid((unsigned)((n + DF_TILE - 1) / DF_TILE), (unsigned)C);
  detfront_kernel<<<grid, DF_THREADS, smem, stream>>>(x, st, taps, cr, ci,
                                                      en, sc, n, M, V);
  return (int)cudaGetLastError();
}
