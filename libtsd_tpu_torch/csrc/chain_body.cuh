// Body of the fused metric chain, shared by kernel #3 (chain.cu) and kernel
// #11 (chain_halo.cu): one block's share of
//
//     out[c, k] = sum_f |FFT_4096(y[c, 4096 f : 4096 (f + 1)])[k]|^2,
//     y[c, n]   = sum_{k < K} h[k] * x[c, n - k],
//
// where x[c, n < 0] comes from hist (the last hist_len samples before x,
// row c at hist + c * hist_stride; zeros beyond them).  It replaces the
// body of ops/pallas/chain.py::_kernel (the JAX package's
// fir_periodogram4096), whose tiers define the FIR's arithmetic:
//   passes 0  ("highest")           fp32 products and sums;
//   passes 1  ("bf16", "int8")      x1 h1;
//   passes 2  ("split"/"int16", 2)  x1 h1 + x2 h1;
//   passes 3  ("split"/"int16", 3)  every xi hj with i + j <= 4;
// x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2), h1, h2, h3
// likewise from h, bf16 products summed in fp32.  x1 + x2 + x3 == x for
// fp32 x (x3 == 0 for int16, x2 == 0 for bf16 and int8) and h1 + h2 + h3
// == h, so passes 3 drops only terms below 2^-24: the JAX kernel's 3-pass
// x1 h1 + x2 h1 + x1 h2 errs by ~2^-17 relative, which a single frame's
// deep bins show against the fp32 reference.  The host rounds h to bf16
// where the tier asks for it (fir_passes == 2: then h == h1).
//
// Bound on the H100 at 256 x 2^22 int16, 256 taps: 2 bytes a sample read
// (0.64 ms), 512 useful flop a sample and pass in the FIR (1.11 ms for two
// passes on the bf16 tensor cores, 8.2 ms for the fp32 FIR on the FMA
// pipes) and ~30 in the FFT (two real frames per complex transform, 0.5
// ms at 67 TFLOP/s).  So the fast tiers are bound by the tensor-core FIR,
// "highest" by its fp32 FMAs, and the FFT must stay out of their way.
//
// Design.  Block (s, c) owns a run of frames of channel c (an even count,
// but a channel's last run), taken two at a time: frames a, b of a pair
// are the re and im parts of one complex 4096-point transform on the
// register-resident core of fft_reg.cuh, and with Z = FFT(a + i b),
// |A[k]|^2 + |B[k]|^2 = (|Z[k]|^2 + |Z[-k]|^2) / 2, so each thread adds
// |Z|^2 of its 16 natural-order bins to registers and the block forms
// (S[k] + S[-k]) / 2 once at the end (#2's scheme; a lone last frame takes
// b = 0).  Blocks of a channel combine by atomicAdd into an output the
// wrapper zeroes; the grid (about 8 blocks per resident slot) is sized
// here.  Per pair:
//   window  the pair's 8192 samples and their halo, in 8-sample chunks,
//           converted once: to bf16 planes x1 (x2, x3) (passes >= 1) or to
//           fp32 (passes 0).  2-byte samples on the tensor cores are copied
//           raw a pair ahead (cp.async.cg, 16 bytes a chunk, into a staging
//           buffer), so that the next pair's read is in flight over this
//           pair's FIR and FFT; each thread converts the chunks it copied,
//           so neither needs a barrier.  Other samples are read with vector
//           loads (the history through L2 where kCoherentHist);
//   FIR     passes >= 1: on the tensor cores, mma.sync m16n8k16 bf16 ->
//           fp32, as the banded Toeplitz product of the JAX kernel cut to
//           16-sample rows: y[16 q + j] = sum_e sum_i T_e[j][i] x[16 (q -
//           e) + i], T_e[j][i] = h[16 e + j - i], e < E = (K + 14) / 16 + 1
//           (useful products K + ~16 a sample).  The taps are mma's A
//           operand (M = the 16 phases j, K = i), the signal its B operand
//           (N = 8 rows).  Warp w owns rows 64 w .. 64 w + 63 of the pair
//           as 8 n-tiles m, n-tile m holding rows 64 w + m + 8 n (n < 8), so
//           one B fragment, rows s + 8 n, feeds n-tile m = s - 64 w + e at
//           every e: B fragments sit in a ring of 8 register sets, one
//           ldmatrix.x4 (planes x1 and x2) per e, and each e costs 8 mma
//           per product (x3's fragments are loaded where used).  The e
//           steps run in branch-free runs of 8 (each step's ring slot a
//           constant), so that a step's loads overlap the last one's mma,
//           then the E % 8 left.  A fragments come from two parity-shifted
//           copies of the reversed bf16 taps (3 32-bit loads per e and
//           plane: a3 == a0 in a Toeplitz block).  passes 0: fir_tile.cuh's
//           fp32 core, a frame at a time.  Either way the outputs go to two
//           fp32 planes (frame a, frame b), sample n at n + 8 (n >> 8),
//           which the FFT's first pass reads and then overwrites with its
//           first exchange;
//   FFT     fft_reg::Core<12> (two conflict-free exchanges), |Z|^2 summed.
// Shared memory (bank pairs and index maps in tests/test_torch_chain_design
// .py, a numpy model of this file; keep the two in step):
//   planes  2 x 4224 floats, the FFT's exchange buffer aliases them;
//   window  passes >= 1: 512 + E - 1 rows of 16 bf16 a plane (rounded up
//           to whole 128-byte lines, win_rows), row R's 16-byte chunk c =
//           2 R + h at c ^ ((c >> 4) & 7), so that the 8 rows s + 8 n of an
//           ldmatrix matrix hit 8 distinct bank quads;
//           passes 0: 8192 + kp floats;
//   stage   2-byte samples, passes >= 1: (512 + E - 1) x 32 bytes;
//   taps    passes >= 1: per plane (h1, h2, h3) rv[i] = hj[16 E - i],
//           i < 16 E + 16, and its odd copy rv[i + 1] at 32-bit word
//           offset odd_copy(E) == 16 mod 32 (the two halves of a warp's A
//           loads then use disjoint banks); passes 0: kp fp32 taps.
// Registers: 32 accumulators, 32 ring words, 16 spectrum sums: 2 blocks of
// 256 threads an SM, passes 0 too (at 3 blocks its fp32 core spilled and
// ran slower).  Without staging, a thread reads one chunk at a time:
// issuing 4 before using any, or holding the next pair's window in
// registers over the FFT, measured slower (the latter spilled).
//
// CHAIN_FIR_ONLY (a measurement build, ab_kernels.py --stages): the FFT
// stage is left out, so the kernel times the window and the FIR alone
// (its spectra are zeros).
//
// kCoherentHist: hist may have been written during this kernel's lifetime
// by another kernel (#11's receive slot, filled by a neighbour through a
// peer pointer); such loads go through L2 (ld.global.cg, cp.async.cg),
// never through the non-coherent read-only path.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>
#include "fft_reg.cuh"
#include "fir_tile.cuh"

namespace chain {

constexpr int NF = 4096;                    // samples of a DFT frame
constexpr int THREADS = 256;
constexpr int ROWS = 2 * NF / 16;           // 16-sample rows of a pair
constexpr int PLANE = NF + NF / 32;         // floats of an output plane
constexpr int PLANES_BYTES = 2 * PLANE * 4;
using Core = fft_reg::Core<12>;
static_assert(FIR_TILE == NF && FIR_THREADS == THREADS, "one tile a frame");
static_assert(PLANES_BYTES >= NF * 8, "the exchange fits in the planes");

__host__ __device__ constexpr int tap_blocks(int K) {
  return (K + 14) / 16 + 1;
}
__host__ __device__ constexpr int odd_copy(int E) {
  return 32 * ((8 * E + 8 + 31) / 32) + 16;
}
__host__ __device__ constexpr int tap_plane_words(int E) {
  return odd_copy(E) + 8 * E + 8;
}
// rows of a window plane: the ROWS + E - 1 rows of a pair, rounded up to
// whole 128-byte lines (4 rows), inside which the chunk swizzle permutes
__host__ __device__ constexpr int win_rows(int E) {
  return (ROWS + E - 1 + 3) / 4 * 4;
}
constexpr int MIN_BLOCKS = 2;                // resident blocks an SM
// bf16 planes of the signal: x1; x1, x2; or, fp32 input at passes 3, x1,
// x2, x3
__host__ __device__ constexpr int x_planes(int passes, bool f32) {
  return passes <= 1 ? 1 : (passes == 3 && f32) ? 3 : 2;
}

// 2-byte samples on the tensor cores: the next pair's window is copied raw
// into a staging buffer (cp.async) while this pair is transformed
__host__ __device__ constexpr bool staged(int passes, int sample_bytes) {
  return passes > 0 && sample_bytes == 2;
}

// Dynamic shared memory of chain_frames: passes 0 with kp (padded) taps,
// passes >= 1 with K taps.
inline int smem_bytes(int passes, int K, int sample_bytes) {
  if (passes == 0) return PLANES_BYTES + (2 * NF + K) * 4 + K * 4;
  const int E = tap_blocks(K);
  return PLANES_BYTES +
         x_planes(passes, sample_bytes == 4) * win_rows(E) * 32 +
         (passes == 3 ? 3 : 1) * tap_plane_words(E) * 4 +
         (staged(passes, sample_bytes) ? (ROWS + E - 1) * 32 : 0);
}

// slot of output sample n < NF in its plane
__device__ __forceinline__ int slot(int n) { return n + 8 * (n >> 8); }

// ------------------------------------------------------------ loads

template <bool kCoherent>
__device__ __forceinline__ uint4 ld16(const void* p) {
  if constexpr (kCoherent) return __ldcg(reinterpret_cast<const uint4*>(p));
  else return __ldg(reinterpret_cast<const uint4*>(p));
}

template <bool kCoherent>
__device__ __forceinline__ uint2 ld8(const void* p) {
  if constexpr (kCoherent) return __ldcg(reinterpret_cast<const uint2*>(p));
  else return __ldg(reinterpret_cast<const uint2*>(p));
}

// 8 samples as loaded: 32 bytes of fp32, 16 of bf16 or int16 (in a), 8 of
// int8 (in a.x, a.y)
struct Raw8 {
  uint4 a, b;
};

template <bool kC>
__device__ __forceinline__ Raw8 ld_raw(const float* p) {
  return {ld16<kC>(p), ld16<kC>(p + 4)};
}
template <bool kC>
__device__ __forceinline__ Raw8 ld_raw(const __nv_bfloat16* p) {
  return {ld16<kC>(p), make_uint4(0, 0, 0, 0)};
}
template <bool kC>
__device__ __forceinline__ Raw8 ld_raw(const int16_t* p) {
  return {ld16<kC>(p), make_uint4(0, 0, 0, 0)};
}
template <bool kC>
__device__ __forceinline__ Raw8 ld_raw(const int8_t* p) {
  const uint2 t = ld8<kC>(p);
  return {make_uint4(t.x, t.y, 0, 0), make_uint4(0, 0, 0, 0)};
}

__device__ __forceinline__ void unpack(const Raw8& r, float (&v)[8], float) {
  const uint32_t w[8] = {r.a.x, r.a.y, r.a.z, r.a.w,
                         r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __uint_as_float(w[k]);
}
__device__ __forceinline__ void unpack(const Raw8& r, float (&v)[8],
                                       __nv_bfloat16) {
  const uint32_t w[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const Raw8& r, float (&v)[8],
                                       int16_t) {
  const uint32_t w[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = (float)(int16_t)(w[k] & 0xffffu);
    v[2 * k + 1] = (float)(int16_t)(w[k] >> 16);
  }
}
__device__ __forceinline__ void unpack(const Raw8& r, float (&v)[8], int8_t) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = (float)(int8_t)((r.a.x >> (8 * k)) & 0xffu);
    v[4 + k] = (float)(int8_t)((r.a.y >> (8 * k)) & 0xffu);
  }
}

// Samples g .. g + 7 (g % 8 == 0) of a channel: x (g >= 0), its history
// (hist_len samples before x), zeros before that.
template <typename T, bool kCoherentHist>
__device__ __forceinline__ void chunk8(const T* row, const T* hrow,
                                       int hist_len, long long g,
                                       float (&v)[8]) {
  Raw8 r{make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  if (g >= 0) r = ld_raw<false>(row + g);
  else if (g >= -(long long)hist_len)
    r = ld_raw<kCoherentHist>(hrow + hist_len + g);
  unpack(r, v, T());
}

// ------------------------------------------- kernel #11's halo exchange
// (the protocol: the comment at the top of chain_halo.cu)

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The block pushes channels [c0, c1) of its shard's input tails (the last
// P samples of each row of x, 16-byte stores) into the right neighbour's
// receive slot, fences at system scope, then publishes the epoch in the
// neighbour's flag of each channel.  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void push_tails(const T* x, long long N, int P,
                                           int c0, int c1, T* peer_recv,
                                           unsigned* peer_flag,
                                           unsigned epoch) {
  const int nvec = (int)(P * sizeof(T) / sizeof(uint4));
  for (int c = c0; c < c1; ++c) {
    const uint4* src =
        reinterpret_cast<const uint4*>(x + (long long)c * N + (N - P));
    uint4* dst = reinterpret_cast<uint4*>(peer_recv + (long long)c * P);
    for (int j = threadIdx.x; j < nvec; j += blockDim.x) dst[j] = src[j];
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int c = c0; c < c1; ++c) st_release_sys(peer_flag + c, epoch);
}

// One thread spins until *flag holds epoch (acquire at system scope), then
// fences; after wait_ns it traps, so that a broken exchange fails the
// launch instead of hanging the card.  The caller's barrier then lets its
// other threads read the slot, through L2.
__device__ __forceinline__ void wait_flag(const unsigned* flag,
                                          unsigned epoch,
                                          long long wait_ns) {
  const unsigned long long t0 = global_ns();
  while (ld_acquire_sys(flag) != epoch) {
    __nanosleep(256);
    if (global_ns() - t0 > (unsigned long long)wait_ns) __trap();
  }
  __threadfence_system();
}

// ------------------------------------------------------ tensor cores

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// 16 bytes global -> shared, asynchronous, through L2 (coherent); zeros
// when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d += A B; A (16 x 16, row) = {a0, a1, a2, a0}: a Toeplitz block has
// a3 == a0; B (16 x 8, col) = {b0, b1}
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %4}, {%7, %8}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(b0), "r"(b1));
}

// Window of a pair: rows window rows (16 samples each) from sample g0 of the
// channel, as kX bf16 planes x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x -
// x1 - x2) (x1 + x2 + x3 == x for fp32 x), each with the chunk swizzle, a
// plane every plane_chunks 16-byte chunks.
// One window chunk c (8 samples) into the kX planes, swizzled.
template <int kX>
__device__ __forceinline__ void put_chunk(float (&v)[8], int c, uint4* win,
                                          int plane_chunks) {
  const int p = c ^ ((c >> 4) & 7);
#pragma unroll
  for (int j = 0; j < kX; ++j) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = bf16x2(v[2 * k], v[2 * k + 1]);
      v[2 * k] -= __uint_as_float(w[k] << 16);
      v[2 * k + 1] -= __uint_as_float(w[k] & 0xffff0000u);
    }
    win[j * plane_chunks + p] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T, int kX, bool kCoherentHist>
__device__ __forceinline__ void load_window_bf16(
    const T* row, const T* hrow, int hist_len, long long g0, int rows,
    uint4* win, int plane_chunks) {
  for (int c = threadIdx.x; c < 2 * rows; c += THREADS) {
    float v[8];
    chunk8<T, kCoherentHist>(row, hrow, hist_len, g0 + 8 * c, v);
    put_chunk<kX>(v, c, win, plane_chunks);
  }
}

// kG tap planes, tap_plane_words(E) words apart: h1 = bf16(h), h2 =
// bf16(h - h1), h3 = bf16(h - h1 - h2).  In each, rv[i] = hj[16 E - i] for
// i < 16 E + 16 (zero outside 0 <= k < K) at element 0 and its odd copy
// rv[i + 1] at word odd_copy(E).
template <int kG>
__device__ __forceinline__ void load_taps_bf16(const float* taps, int K,
                                               int E, __nv_bfloat16* planes) {
  const int n = 16 * E + 16, odd = 2 * odd_copy(E);
  const int stride = 2 * tap_plane_words(E);
  for (int i = threadIdx.x; i <= n; i += THREADS) {
    const int k = 16 * E - i;
    float h = (k >= 0 && k < K) ? taps[k] : 0.0f;
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const __nv_bfloat16 b = __float2bfloat16_rn(h);
      h -= __bfloat162float(b);
      __nv_bfloat16* pl = planes + j * stride;
      if (i < n) pl[i] = b;
      if (i > 0) pl[odd + i - 1] = b;
    }
  }
}

// The pair's FIR on the tensor cores: sum over the products xi hj of the
// tier (kX x planes, kG tap planes; chain_frames).  Warp w computes pair
// rows 64 w .. 64 w + 63 and stores them into the planes (frame w / 4);
// with a lone frame (warps 4-7 then idle) it stores zeros.
template <int kX, int kG>
__device__ __forceinline__ void fir_mma(const uint4* win, int plane_chunks,
                                        const uint32_t* taps_w, int E,
                                        bool pair, float* planes) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Q = 64 * warp;
  float d[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int k = 0; k < 4; ++k) d[m][k] = 0.0f;
  if (pair || warp < 4) {
    // ldmatrix: lane l gives row l & 7 of matrix l >> 3 (0, 1: plane x1,
    // k 0-7 and 8-15; 2, 3: plane x2); B(s) holds pair rows s + 8 n
    const unsigned x1 = smem_addr(win);
    const unsigned x12 = x1 + ((lane >> 4) ? 16u * plane_chunks : 0u);
    const unsigned x3 = x1 + 32u * plane_chunks;
    const int lane_h = (lane >> 3) & 1;
    const int lane_row = 8 * (lane & 7) + E - 1;
    auto chunk_at = [&](int s) {
      const int c = 2 * (s + lane_row) + lane_h;
      return 16u * (unsigned)(c ^ ((c >> 4) & 7));
    };
    uint32_t ring[8][4];       // slot s % 8 holds B(s) of x1 (and x2)
    auto load_ring = [&](int s, uint32_t(&r)[4]) {
      if constexpr (kX >= 2) ldsm_x4(r, x12 + chunk_at(s));
      else ldsm_x2(r, x12 + chunk_at(s));
    };
#pragma unroll
    for (int j = 1; j < 8; ++j) load_ring(Q + j, ring[j]);
    // A fragment of T_e at lane (g, t): words w, w - 4, w + 4 of rv (g
    // even) or of its odd copy (g odd), w = 8 (E - e) + t - ceil(g / 2)
    const uint32_t* pa = taps_w + ((g & 1) ? odd_copy(E) : 0) + 8 * E + t -
                         ((g + (g & 1)) >> 1);
    const int gw = tap_plane_words(E);
    // step e (i = e % 8, a constant once unrolled): B(Q - e) into the ring,
    // then n-tile m takes B(Q + m - e), the fresh fragment last
    auto step = [&](int e, int i) {
      load_ring(Q - e, ring[(8 - i) & 7]);
      const uint32_t* p = pa - 8 * e;
      {                                        // h1 with x1, x2, x3
        const uint32_t a0 = p[0], a1 = p[-4], a2 = p[4];
#pragma unroll
        for (int mm = 1; mm <= 8; ++mm) {
          const int m = mm & 7;
          mma(d[m], a0, a1, a2, ring[(m - i) & 7][0], ring[(m - i) & 7][1]);
        }
        if constexpr (kX >= 2) {
#pragma unroll
          for (int mm = 1; mm <= 8; ++mm) {
            const int m = mm & 7;
            mma(d[m], a0, a1, a2, ring[(m - i) & 7][2],
                ring[(m - i) & 7][3]);
          }
        }
        if constexpr (kX == 3) {
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            uint32_t b[4];
            ldsm_x2(b, x3 + chunk_at(Q + m - e));
            mma(d[m], a0, a1, a2, b[0], b[1]);
          }
        }
      }
      if constexpr (kG == 3) {
        const uint32_t* q = p + gw;            // h2 with x1, x2
        const uint32_t a0 = q[0], a1 = q[-4], a2 = q[4];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          mma(d[m], a0, a1, a2, ring[(m - i) & 7][0], ring[(m - i) & 7][1]);
#pragma unroll
        for (int m = 0; m < 8; ++m)
          mma(d[m], a0, a1, a2, ring[(m - i) & 7][2], ring[(m - i) & 7][3]);
        const uint32_t* r = p + 2 * gw;        // h3 with x1
        const uint32_t c0 = r[0], c1 = r[-4], c2 = r[4];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          mma(d[m], c0, c1, c2, ring[(m - i) & 7][0], ring[(m - i) & 7][1]);
      }
    };
    // whole runs of 8 steps without a branch (the scheduler may overlap a
    // step's loads with the last one's mma), then the last E % 8 steps
    int eb = 0;
    for (; eb + 8 <= E; eb += 8) {
#pragma unroll
      for (int i = 0; i < 8; ++i) step(eb + i, i);
    }
#pragma unroll
    for (int i = 0; i < 7; ++i)
      if (eb + i < E) step(eb + i, i);
  }
  // d[m] = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}, D[j][n] the
  // sample j of pair row 64 w + m + 8 n
  float* pl = planes + (warp >> 2) * PLANE;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int n = 16 * ((Q & 255) + m + 16 * t) + g;
    pl[slot(n)] = d[m][0];
    pl[slot(n + 128)] = d[m][1];
    pl[slot(n + 8)] = d[m][2];
    pl[slot(n + 136)] = d[m][3];
  }
}

// ------------------------------------------------------------- body

template <typename T, int kPasses, bool kCoherentHist>
__device__ __forceinline__ void chain_frames(
    const T* __restrict__ x, const T* hist, const float* __restrict__ taps,
    const float2* __restrict__ tw, float* __restrict__ out, long long N,
    int K, int hist_len, int hist_stride, int frames_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* planes = reinterpret_cast<float*>(smem);
  float2* buf = reinterpret_cast<float2*>(smem);
  const int c = blockIdx.y, u = threadIdx.x;
  const long long frames = N / NF;
  const long long f0 = (long long)blockIdx.x * frames_per_block;
  const long long f1 = min(f0 + frames_per_block, frames);
  if (f0 >= f1) return;
  const T* row = x + (long long)c * N;
  const T* hrow = hist + (long long)c * hist_stride;
  unsigned char* rest = smem + PLANES_BYTES;
  const int E = tap_blocks(K);
  const int wrows = win_rows(E);
  uint4* win = reinterpret_cast<uint4*>(rest);
  float* s_win = reinterpret_cast<float*>(rest);
  const uint32_t* taps_w = nullptr;
  float* s_taps = nullptr;
  constexpr int kX = x_planes(kPasses, std::is_same_v<T, float>);
  constexpr int kG = kPasses == 3 ? 3 : 1;
  if constexpr (kPasses == 0) {
    s_taps = s_win + 2 * NF + K;
    for (int k = u; k < K; k += THREADS) s_taps[k] = taps[k];
  } else {
    auto* gh = reinterpret_cast<__nv_bfloat16*>(rest + kX * wrows * 32);
    load_taps_bf16<kG>(taps, K, E, gh);
    taps_w = reinterpret_cast<const uint32_t*>(gh);
  }
  constexpr bool kStaged = staged(kPasses, sizeof(T));
  uint4* stage = reinterpret_cast<uint4*>(
      rest + kX * wrows * 32 + (kG == 3 ? 3 : 1) * tap_plane_words(E) * 4);
  // raw chunk c (8 samples) of pair f's window: thread c % THREADS copies
  // it and later converts it, so neither step needs a barrier
  auto stage_pair = [&](long long f) {
    const int n = 2 * ((f + 1 < f1 ? ROWS : ROWS / 2) + E - 1);
    const long long g0 = f * NF - 16LL * (E - 1);
    for (int c = u; c < n; c += THREADS) {
      const long long g = g0 + 8 * c;
      const bool in_x = g >= 0, in_hist = g >= -(long long)hist_len;
      cp_async16(stage + c, in_x ? row + g : in_hist ? hrow + hist_len + g
                                                     : row,
                 in_hist);
    }
    cp_async_commit();
  };
  if constexpr (kStaged) stage_pair(f0);
  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
#pragma unroll 1
  for (long long f = f0; f < f1; f += 2) {
    const bool pair = f + 1 < f1;              // the same for the block
    if constexpr (kPasses == 0) {
      // window: samples 4096 f - K .. of the pair (K = kp here)
      const long long g0 = f * NF - K;
      const int chunks = ((pair ? 2 * NF : NF) + K) / 8;
      for (int j = u; j < chunks; j += THREADS) {
        float v[8];
        chunk8<T, kCoherentHist>(row, hrow, hist_len, g0 + 8 * j, v);
        float4* w = reinterpret_cast<float4*>(s_win) + 2 * j;
        w[0] = make_float4(v[0], v[1], v[2], v[3]);
        w[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncthreads();
#pragma unroll 1
      for (int fr = 0; fr < 2; ++fr) {
        float y[FIR_R];
        if (fr == 0 || pair) {
          fir_tile(s_win + 1 + fr * NF, s_taps, K, y);
        } else {
#pragma unroll
          for (int r = 0; r < FIR_R; ++r) y[r] = 0.0f;
        }
#pragma unroll
        for (int r = 0; r < FIR_R; ++r)
          planes[fr * PLANE + slot(fir_out_index(r))] = y[r];
      }
    } else {
      const int rows = (pair ? ROWS : ROWS / 2) + E - 1;
      if constexpr (kStaged) {
        cp_async_wait_all();
        for (int c = u; c < 2 * rows; c += THREADS) {
          float v[8];
          unpack(Raw8{stage[c], make_uint4(0, 0, 0, 0)}, v, T());
          put_chunk<kX>(v, c, win, 2 * wrows);
        }
        if (f + 2 < f1) stage_pair(f + 2);   // in flight over this pair
      } else {
        load_window_bf16<T, kX, kCoherentHist>(
            row, hrow, hist_len, f * NF - 16LL * (E - 1), rows, win,
            2 * wrows);
      }
      __syncthreads();
      fir_mma<kX, kG>(win, 2 * wrows, taps_w, E, pair, planes);
    }
    __syncthreads();
#ifndef CHAIN_FIR_ONLY
    float2 v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = make_float2(planes[u + 264 * i], planes[PLANE + u + 264 * i]);
    Core::first_pass(v, u, tw);
    __syncthreads();                           // the planes are read
    Core::put_first(buf, v, u);
    __syncthreads();
    Core::middle<THREADS>(buf, tw, u);
    Core::last_pass(buf, v, u);
#pragma unroll
    for (int k = 0; k < 16; ++k)
      acc[k] = fmaf(v[k].x, v[k].x, fmaf(v[k].y, v[k].y, acc[k]));
    // the next pair writes the planes only after the barrier that
    // follows its window, so these reads are safe without another
#endif
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 16; ++k) planes[u + 256 * k] = acc[k];
  __syncthreads();
  float* o = out + (long long)c * NF;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int bin = u + 256 * k;
    atomicAdd(o + bin,
              0.5f * (planes[bin] + planes[(NF - bin) & (NF - 1)]));
  }
}

// Frames per block (even) and the grid of a launch of `kernel` with `smem`
// bytes: about 8 blocks per resident slot of the card, at least 4 frames
// a block.
template <typename Kernel>
inline dim3 grid_for(Kernel kernel, int smem, int C, long long frames,
                     int* frames_per_block) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                smem);
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long want = (8 * slots + C - 1) / C;
  const long long most = (frames + 3) / 4;
  const long long splits = want < 1 ? 1 : want > most ? most : want;
  long long fpb = (frames + splits - 1) / splits;
  fpb += fpb & 1;
  *frames_per_block = (int)fpb;
  return dim3((unsigned)((frames + fpb - 1) / fpb), (unsigned)C);
}

}  // namespace chain
