// Kernel #3's body for the tensor-core tiers with one tap plane (passes 1:
// bf16, int8; passes 2: int16/2, split/2) and K <= K_MAX taps: the FIR on
// Hopper's asynchronous warpgroup products (wgmma), overlapped with the FFT
// of the pairs before.  It computes chain_body.cuh's function (the metric
// kernel of ops/pallas/chain.py::fir_periodogram4096, single-device
// branch) with its arithmetic (x1 = bf16(x), x2 = bf16(x - x1), bf16 taps
// h1, products summed in fp32, an fp32 DFT) and its pair scheme (frames a,
// b of a pair as one complex 4096-point transform on fft_reg::Core<12>,
// |Z|^2 summed, (S[k] + S[-k]) / 2 per channel, atomicAdd into the zeroed
// output).  chain.cu's C entry sends the other tiers and larger K to
// chain::chain_frames.
//
// Kernel #11 (chain_halo.cu: a time shard of a mesh row, its halo
// exchanged inside the kernel) runs the same body with kHalo on, as
// chain_halo_kernel, for the same tiers and K: each block first pushes its
// share of the shard's input tails to the right neighbour, and a FIR
// warpgroup whose pair is a channel's first waits for the left
// neighbour's flag before it loads the history from the receive slot
// through L2 (chain_halo.cu has the protocol).  With kHalo off the body
// compiles to chain_kernel as before.
//
// Bound on the H100 at 256 x 2^22 int16, 256 taps: 0.64 ms to read the
// samples once; the banded-Toeplitz FIR below does 640 tensor flops a
// sample and pass (512 useful), 1.39 ms for int16/2's two passes at 989
// TFLOP/s; the FFT ~30 fp32 flops a sample.  chain_frames ran its FIR on
// mma.sync (a third of the tensor rate, every operand through registers)
// and its FFT after it, the two adding up.  Here the products are wgmma's,
// issued by two warpgroups and run by the tensor cores from shared memory
// while the block's other warps split windows and transform.
//
// One persistent block of 512 threads an SM, four warpgroups:
//   FIR warpgroups 0 and 1 take alternate pairs.  Each, for its pair: the
//     window's raw chunks loaded from x and hist (all of a thread's chunks
//     first, so that their latencies overlap), split into the bf16 planes
//     x1 (x2) of its own window; the pair's products, wgmma m64n128k16
//     bf16 -> fp32 from the tap tiles and the window (all E_MAX tap
//     blocks: a branch around a wgmma makes ptxas serialize them); the
//     accumulators stored into its own planes, frames a and b of a sample
//     as one float2.  One warpgroup's products run while the other splits
//     or stores.
//   FFT warpgroups 2 and 3 (256 threads, Core<12>'s columns): Core<12> on
//     each pair in turn, the middle pass with a named barrier of their own
//     (Core<12>::middle's __syncthreads would stop the FIR warpgroups),
//     |Z|^2 into 16 registers a thread; at the end of a channel's run they
//     fold the spectrum and add it into the output.
// Block b walks pair slots [T b / G, T (b + 1) / G) of the T = C ceil(F /
// 2) slots (channel-major; a channel's last slot holds one frame when F
// is odd), so the work splits evenly and the pipeline runs across
// channels.  Hand-offs: full_pl[w] (FIR warpgroup w has stored a pair in
// its planes) and empty_pl[w] (the FFT is done with them); a wait's phase
// is the parity of the warpgroup's use count (each barrier serves one
// warpgroup's pairs in order, so no waiter runs two phases ahead).
//
// Tile.  Output sample 64 q + j of a pair (q < 128 rows of 64 samples, j
// < 64 phases) is sum_e sum_i T_e[j][i] x[64 (q - e) + i], T_e[j][i] =
// h[64 e + j - i], e < E = ceil((K - 1) / 64) + 1 <= E_MAX: the taps are
// wgmma's A (M = 64 phases j, K = 16 phases i a step s < 4), the signal
// its B (N = 128 rows q, the pair).  64-phase blocks do 640 flops a sample
// a pass at K = 256 (16-phase blocks would do 544, but an N = 16 tile
// reads its shared operand about as fast as the tensor core uses it).
// Both operands are in wgmma's canonical K-major layout without a
// swizzle: core matrices of 8 rows of 16 contiguous bytes, SBO = 128
// between groups of 8 rows.  Tap tile e, chunk (j, c) (i = 8 c ..) at e
// TILE_BYTES + c TILE_LBO + 16 j, written once a block.  The window's 16-
// byte chunk of row r (samples 64 r + 8 c ..) at c LBO + 16 r, LBO = 16
// (WROWS + 1), odd in chunks, so that the split's stores of the 8 chunks
// of a row hit 8 distinct bank quads.  Shifting the signal operand by e
// rows is then an exact start address, 16 e bytes back, with the
// descriptor's base-offset field 0 (in a 128-byte swizzle a one-row shift
// moves inside the swizzle atom, which the base offset would have to
// carry).  A pair's planes put sample n at float2 slot n + 4 (n >> 7), so
// that the accumulator stores (lanes g + 128 t) and the FFT's first loads
// (u + 256 i) hit distinct bank pairs.  tests/test_torch_chain_design.py
// holds a numpy model of the tiles, descriptors, split, stores and the
// block's walk with its phases; keep them in step.
//
// Registers: 128 a thread (512 threads); a FIR thread holds the 64
// accumulators of m64n128, an FFT thread Core<12>'s 16 values and 16
// sums.  Shared memory (smem_bytes): two pairs' planes (the FFT's
// exchange aliases them), the tap tiles and two windows of kX bf16
// planes; at most 196 KB, so that the SM keeps 60 KB of L1 for the
// first pass's 30 KB of twiddles.
//
// CHAIN_FIR_ONLY (a measurement build, ab_kernels.py --stages): the FFT
// warpgroups only hand the planes back, so the kernel times the loads,
// the split, the products and the stores (its spectra are zeros).
#include "chain_body.cuh"

namespace chain_wg {

using chain::NF;
using chain::smem_addr;
constexpr int E_MAX = 5;                       // tap blocks of 64
constexpr int K_MAX = 64 * (E_MAX - 1) + 1;    // 257 taps
constexpr int HALO = 64 * (E_MAX - 1);         // samples before a pair
constexpr int WIN = HALO + 2 * NF;             // samples of a window
constexpr int WROWS = WIN / 64;                // 132 rows of 64 samples
constexpr int CHUNKS = WIN / 8;                // 8-sample chunks of a window
constexpr int CPT = (CHUNKS + 127) / 128;      // chunks a FIR thread: 9
constexpr int LBO = 16 * (WROWS + 1);          // bytes between chunk columns
constexpr int XPLANE = 8 * LBO;                // bytes of a bf16 plane
constexpr int PLANE = NF + NF / 32;            // float2 slots of a pair
constexpr int TILE_LBO = 8 * 128;              // bytes between tile columns
constexpr int TILE_BYTES = 8 * TILE_LBO;       // 64 x 64 bf16 taps
constexpr int FIR_THREADS = 256;               // two FIR warpgroups
constexpr int FFT_THREADS = 256;               // two FFT warpgroups
constexpr int THREADS = FIR_THREADS + FFT_THREADS;
constexpr int BAR_BYTES = 128;
constexpr int BAR_FIR = 1, BAR_FFT = 3;        // named barriers (0: block;
                                               // FIR warpgroup w: 1 + w)
using Core = fft_reg::Core<12>;
static_assert(Core::MID_TOP == 8 && Core::RHO == 0 && Core::U == 256,
              "one middle pass, 256 columns");
static_assert(PLANE >= NF, "the FFT's exchange fits in a pair's planes");
static_assert(((LBO / 16) & 1) == 1, "odd chunk stride: conflict-free split");

__host__ __device__ constexpr int smem_bytes(int passes) {
  return BAR_BYTES + 2 * PLANE * 8 + E_MAX * TILE_BYTES + 2 * passes * XPLANE;
}
static_assert(smem_bytes(2) <= 196 * 1024, "L1 keeps the twiddles");

__device__ __forceinline__ int slot(int n) { return n + 4 * (n >> 7); }

// ------------------------------------------------------------ barriers

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(b)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(b)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------- wgmma

// (after an mbarrier spin: .aligned wants the warp converged)
__device__ __forceinline__ void wg_fence() {
  __syncwarp();
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits for every committed group; d is then read by other instructions
__device__ __forceinline__ void wg_wait(float (&d)[64]) {
  __syncwarp();
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// K-major, no swizzle: start >> 4, LBO (between the two 8-element chunks
// of a k-step) and SBO (between groups of 8 rows) in 16-byte units, base
// offset 0, layout type 0
__device__ __forceinline__ uint64_t desc(uint32_t addr, int lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d (64 x 128, fp32) (+)= A (64 x 16) B (16 x 128), both bf16 in shared
// memory at descriptors a and b
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// A pair's FIR: output rows 0 .. 127 (frames a, b) from the window at
// shared address win (plane x1; x2 at + XPLANE) and the tap tiles at
// shared address tiles, every (e < E_MAX, s, plane) product into d, the
// first one overwriting it (the taps past K are zeros).
template <int kX>
__device__ __forceinline__ void fir_pair(float (&d)[64], uint32_t tiles,
                                         uint32_t win) {
  const uint64_t a0 = desc(tiles, TILE_LBO);
  const uint64_t b0 = desc(win + 16 * (E_MAX - 1), LBO);
#pragma unroll
  for (int e = 0; e < E_MAX; ++e) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int j = 0; j < kX; ++j) {
        const int offa = e * TILE_BYTES + 2 * s * TILE_LBO;
        const long long offb = (long long)j * XPLANE + 2 * s * LBO - 16 * e;
        wgmma128(d, a0 + offa / 16, b0 + offb / 16, (e | s | j) != 0);
      }
    }
  }
}

// A pair's accumulators into its planes, frame a and b of sample n as one
// float2 (b zeros for a lone frame: it holds the tail of frame a's FIR):
// d[r] (r = 4 c + 2 h + l) is sample n = 64 q + j of frame c >> 3, q = 8
// (c & 7) + 2 t + l, j = 16 w + g + 8 h, so d[r] and d[r + 32] are one
// sample of the two frames.
__device__ __forceinline__ void store_pair(const float (&d)[64], float2* pl,
                                           int tid, bool two) {
  const int w = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int n = 64 * (8 * (r >> 2) + 2 * t + (r & 1)) + 16 * w + g +
                  8 * ((r >> 1) & 1);
    pl[slot(n)] = make_float2(d[r], two ? d[r + 32] : 0.0f);
  }
}

// Tap tile e (64 x 64, A[j][i] = h[64 e + j - i], bf16, zeros outside 0
// <= k < K) for every e < E_MAX: chunk (j, c) (i = 8 c .. 8 c + 7) at e
// TILE_BYTES + c TILE_LBO + 16 j; the block's threads store whole 16-byte
// chunks, j fastest
__device__ __forceinline__ void put_tiles(const float* __restrict__ taps,
                                          int K, unsigned char* tiles,
                                          int tid) {
  for (int ci = tid; ci < E_MAX * 8 * 64; ci += THREADS) {
    const int j = ci & 63, c = (ci >> 6) & 7, e = ci >> 9;
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 64 * e + j - 8 * c - 2 * r;
      const float lo = (k >= 0 && k < K) ? __ldg(taps + k) : 0.0f;
      const float hi = (k >= 1 && k <= K) ? __ldg(taps + k - 1) : 0.0f;
      w[r] = chain::bf16x2(lo, hi);
    }
    *reinterpret_cast<uint4*>(tiles + e * TILE_BYTES + c * TILE_LBO +
                              16 * j) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ------------------------------------------------------------- windows

struct Slot {                 // pair slot t = c P + p of the block's walk
  int c;                      // channel
  int p;                      // pair of the channel (frames 2 p, 2 p + 1)
  bool two;                   // both frames exist
};
__device__ __forceinline__ Slot slot_at(long long t, int P, int F) {
  const int c = (int)(t / P), p = (int)(t - (long long)c * P);
  return {c, p, 2 * p + 1 < F};
}
// slot t + k from slot t, without a division
__device__ __forceinline__ Slot advance(Slot s, int k, int P, int F) {
  for (s.p += k; s.p >= P; s.p -= P) ++s.c;
  s.two = 2 * s.p + 1 < F;
  return s;
}

// Chunk ci (8 samples: window row ci >> 3, column ci & 7) into the kX
// bf16 planes x1 = bf16(v), x2 = bf16(v - x1), at (ci & 7) LBO + 16 (ci >>
// 3) of each.
template <typename T, int kX>
__device__ __forceinline__ void put_chunk(const chain::Raw8& r, int ci,
                                          unsigned char* win) {
  float v[8];
  chain::unpack(r, v, T());
  unsigned char* dst = win + (ci & 7) * LBO + (ci >> 3) * 16;
#pragma unroll
  for (int j = 0; j < kX; ++j) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = chain::bf16x2(v[2 * k], v[2 * k + 1]);
      v[2 * k] -= __uint_as_float(w[k] << 16);
      v[2 * k + 1] -= __uint_as_float(w[k] & 0xffff0000u);
    }
    *reinterpret_cast<uint4*>(dst + j * XPLANE) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Slot sl's window, samples 8192 p - 256 .. 8192 p + 8191 of channel c,
// into a FIR warpgroup's planes: x where it exists, the history's last
// min(hist_len, 256) samples before a channel's first pair, zeros before
// that and after a lone frame.  A thread's chunks ci = tid + 128 k are all
// loaded first, then converted and stored.
template <typename T, int kX, bool kCoherentHist>
__device__ __forceinline__ void split(const T* x, const T* hist, long long N,
                                      int hist_len, int hist_stride,
                                      const Slot& sl, unsigned char* win,
                                      int tid) {
  const int lo = sl.p > 0 ? 0 : HALO - min(hist_len, HALO);
  const int hi = HALO + (sl.two ? 2 : 1) * NF;
  const T* row = x + sl.c * N + 2LL * sl.p * NF - HALO;
  const T* hrow = hist + (long long)sl.c * hist_stride + hist_len - HALO;
  chain::Raw8 r[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int ci = tid + 128 * k;
    r[k] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
    if (ci < CHUNKS && 8 * ci >= lo && 8 * ci < hi) {
      if constexpr (kCoherentHist)   // a peer's stores: through L2
        r[k] = sl.p > 0 || 8 * ci >= HALO ? chain::ld_raw<false>(row + 8 * ci)
                                          : chain::ld_raw<true>(hrow + 8 * ci);
      else
        r[k] = chain::ld_raw<false>(sl.p > 0 || 8 * ci >= HALO ? row + 8 * ci
                                                               : hrow + 8 * ci);
    }
  }
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    if (tid + 128 * k < CHUNKS) put_chunk<T, kX>(r[k], tid + 128 * k, win);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------- body

// Kernel #11's exchange, for frames<..., true>: flag, this shard's flags of
// the call's slot (null: no left slot, hist is the caller's); peer_recv and
// peer_flag, the right neighbour's slot (null: the last shard); P samples
// pushed a channel; wait_ns before a wait traps; the call's epoch.  #3
// passes a null pointer: a temporary passed by reference instead changed
// chain_kernel's SASS (the same instructions, some in another order).
template <typename T>
struct Halo {
  const unsigned* flag;
  T* peer_recv;
  unsigned* peer_flag;
  int P;
  long long wait_ns;
  unsigned epoch;
};

template <typename T, int kPasses, bool kHalo>
__device__ __forceinline__ void frames(
    const T* __restrict__ x, const T* __restrict__ hist,
    const float* __restrict__ taps, const float2* __restrict__ tw,
    float* __restrict__ out, long long N, int C, int K, int hist_len,
    int hist_stride, const Halo<T>* halo) {
  constexpr int kX = kPasses;                  // x2 == 0 at passes 1
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full_pl = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty_pl = full_pl + 2;
  float2* planes = reinterpret_cast<float2*>(smem + BAR_BYTES);
  unsigned char* tiles = smem + BAR_BYTES + 2 * PLANE * 8;
  unsigned char* wins = tiles + E_MAX * TILE_BYTES;

  const int F = (int)(N / NF), P = (F + 1) / 2;
  const long long T_ = (long long)P * C;
  const long long t0 = T_ * blockIdx.x / gridDim.x;
  const long long t1 = T_ * (blockIdx.x + 1) / gridDim.x;
  const int n = (int)(t1 - t0);
  if constexpr (kHalo) {
    // before any wait of the block (the no-cycle argument): channels [C b
    // / G, C (b + 1) / G), each pushed by exactly one block
    if (halo->peer_recv != nullptr)
      chain::push_tails(x, N, halo->P, (int)((long long)C * blockIdx.x /
                                             gridDim.x),
                        (int)((long long)C * (blockIdx.x + 1) / gridDim.x),
                        halo->peer_recv, halo->peer_flag, halo->epoch);
  }
  if (n <= 0) return;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&full_pl[b], 128);
      mbar_init(&empty_pl[b], FFT_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  put_tiles(taps, K, tiles, threadIdx.x);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x < FIR_THREADS) {
    // ---------------------------------------------------------- FIR
    // warpgroup wg: slots i = wg, wg + 2, ... (its k-th: k = i >> 1), its
    // own window and planes
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    unsigned char* win = wins + wg * kX * XPLANE;
    float2* pl = planes + wg * PLANE;
    const uint32_t tiles0 = smem_addr(tiles), win0 = smem_addr(win);
    Slot sl = slot_at(t0 + wg, P, F);
    float d[64];
#pragma unroll 1
    for (int i = wg; i < n; i += 2, sl = advance(sl, 2, P, F)) {
      if constexpr (kHalo) {
        if (sl.p == 0 && halo->flag != nullptr) {  // a channel's first pair
          if (tid == 0) chain::wait_flag(halo->flag + sl.c, halo->epoch,
                                         halo->wait_ns);
          __syncwarp();                          // bar.sync is .aligned
          bar_sync(BAR_FIR + wg, 128);
          // the history's loads cannot be hoisted above the wait
          asm volatile("" : "+l"(hist)::"memory");
        }
      }
      split<T, kX, kHalo>(x, hist, N, hist_len, hist_stride, sl, win, tid);
      bar_sync(BAR_FIR + wg, 128);             // the window is whole
      wg_fence();
      fir_pair<kX>(d, tiles0, win0);
      wg_commit();
      wg_wait(d);
      if (i >= 2) mbar_wait(&empty_pl[wg], ((i >> 1) - 1) & 1);
      store_pair(d, pl, tid, sl.two);
      mbar_arrive(&full_pl[wg]);
    }
  } else {
    // ---------------------------------------------------------- FFT
    const int u = threadIdx.x - FIR_THREADS;
    // Core<12>::middle's column u (M = 256): slots mid + 16 r, twiddles
    // twm[16 (k - 1)]
    const int mid = Core::swz(((u >> 4) << 8) + (u & 15));
    const float2* twm = tw + Core::tw_off(8) + (u & 15);
    int c = (int)(t0 / P), left = P - (int)(t0 - (long long)c * P);
    float acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int b = i & 1;
      float2* pl = planes + b * PLANE;
      mbar_wait(&full_pl[b], (i >> 1) & 1);
#ifndef CHAIN_FIR_ONLY
      float2 v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] = pl[slot(u + 256 * r)];
      Core::first_pass(v, u, tw);
      bar_sync(BAR_FFT, FFT_THREADS);          // the planes are read
      Core::put_first(pl, v, u);
      bar_sync(BAR_FFT, FFT_THREADS);
      // Core<12>::middle (M = 256) with the FFT warpgroups' barrier
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] = pl[mid + (r << 4)];
      fft_reg::dft<4, 1>(v, 0);
#pragma unroll
      for (int k = 1; k < 16; ++k)
        v[k] = fft_reg::cmul(v[k], __ldg(twm + (k - 1) * 16));
#pragma unroll
      for (int k = 0; k < 16; ++k) pl[mid + (k << 4)] = v[k];
      bar_sync(BAR_FFT, FFT_THREADS);
      Core::last_pass(pl, v, u);
#pragma unroll
      for (int k = 0; k < 16; ++k)
        acc[k] = fmaf(v[k].x, v[k].x, fmaf(v[k].y, v[k].y, acc[k]));
      if (i + 1 == n || left == 1) {           // the channel's run ends
        float* s = reinterpret_cast<float*>(pl);
        bar_sync(BAR_FFT, FFT_THREADS);        // the transform is read
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          s[u + 256 * k] = acc[k];
          acc[k] = 0.0f;
        }
        bar_sync(BAR_FFT, FFT_THREADS);
        float* o = out + (long long)c * NF;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int bin = u + 256 * k;
          atomicAdd(o + bin, 0.5f * (s[bin] + s[(NF - bin) & (NF - 1)]));
        }
      }
#endif
      mbar_arrive(&empty_pl[b]);
      if (--left == 0) {                       // the next pair's channel
        left = P;
        ++c;
      }
    }
  }
}

template <typename T, int kPasses>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const T* __restrict__ x, const T* __restrict__ hist,
             const float* __restrict__ taps, const float2* __restrict__ tw,
             float* __restrict__ out, long long N, int C, int K,
             int hist_len, int hist_stride) {
  frames<T, kPasses, false>(x, hist, taps, tw, out, N, C, K, hist_len,
                            hist_stride, nullptr);
}

// Kernel #11 on this body.  recv/flag: this shard's slot (null on shard 0:
// history from hist0); peer_recv/peer_flag: the right neighbour's slot
// (null on the last shard).
template <typename T, int kPasses>
__global__ void __launch_bounds__(THREADS, 1)
chain_halo_kernel(const T* __restrict__ x, const T* __restrict__ hist0,
                  const T* recv, const unsigned* flag, T* peer_recv,
                  unsigned* peer_flag, const float* __restrict__ taps,
                  const float2* __restrict__ tw, float* __restrict__ out,
                  long long N, int C, int K, int P, int hist0_len,
                  int hist0_stride, long long wait_ns, unsigned epoch) {
  const bool from_left = recv != nullptr && P > 0;
  const Halo<T> halo{from_left ? flag : nullptr, P > 0 ? peer_recv : nullptr,
                     peer_flag, P, wait_ns, epoch};
  frames<T, kPasses, true>(
      x, from_left ? recv : hist0, taps, tw, out, N, C, K,
      from_left ? P : hist0_len, from_left ? P : hist0_stride, &halo);
}

// The grid of a launch of `kernel`: one persistent block a resident slot
// (one an SM), at most one a pair slot.
template <typename Kernel>
static unsigned grid_for(Kernel kernel, int smem, long long N, int C) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                smem);
  const long long pairs = (N / NF + 1) / 2 * C;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (unsigned)(pairs < slots ? pairs : slots);
}

// The (dtype, passes) pairs this body takes, with K <= K_MAX: launch(Tier<T,
// passes>()) for those, -1 (chain_frames runs it) for any other.
template <typename T, int kPasses>
struct Tier {
  using type = T;
  static constexpr int passes = kPasses;
};
template <typename Launch>
static int route(int dtype, int passes, int K, Launch launch) {
  if (K > K_MAX) return -1;
  switch (dtype * 4 + passes) {
    case 2: return launch(Tier<float, 2>());
    case 5: return launch(Tier<__nv_bfloat16, 1>());
    case 9: return launch(Tier<int8_t, 1>());
    case 14: return launch(Tier<int16_t, 2>());
    default: return -1;
  }
}

}  // namespace chain_wg

// The route of chain.cu's fir_periodogram4096: -1 where chain_frames runs
// the call, else the launch's cudaGetLastError().
int chain_wg_launch(const void* x, const void* hist, const float* taps,
                    const float* tw, float* out, int dtype, int passes,
                    long long N, int C, int K, int hist_len, int hist_stride,
                    cudaStream_t stream) {
  using namespace chain_wg;
  return route(dtype, passes, K, [&](auto tier) {
    using T = typename decltype(tier)::type;
    constexpr int kP = decltype(tier)::passes;
    constexpr int smem = smem_bytes(kP);
    const unsigned grid = grid_for(chain_kernel<T, kP>, smem, N, C);
    chain_kernel<T, kP><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(hist), taps,
        reinterpret_cast<const float2*>(tw), out, N, C, K, hist_len,
        hist_stride);
    return (int)cudaGetLastError();
  });
}

// The same route for chain_halo.cu's fir_periodogram4096_halo (kernel #11).
int chain_wg_halo_launch(const void* x, const void* hist0, const void* recv,
                         const unsigned* flag, void* peer_recv,
                         unsigned* peer_flag, const float* taps,
                         const float* tw, float* out, int dtype, int passes,
                         long long N, int C, int K, int P, int hist0_len,
                         int hist0_stride, long long wait_ns, unsigned epoch,
                         cudaStream_t stream) {
  using namespace chain_wg;
  return route(dtype, passes, K, [&](auto tier) {
    using T = typename decltype(tier)::type;
    constexpr int kP = decltype(tier)::passes;
    constexpr int smem = smem_bytes(kP);
    const unsigned grid = grid_for(chain_halo_kernel<T, kP>, smem, N, C);
    chain_halo_kernel<T, kP><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(hist0),
        static_cast<const T*>(recv), flag, static_cast<T*>(peer_recv),
        peer_flag, taps, reinterpret_cast<const float2*>(tw), out, N, C, K, P,
        hist0_len, hist0_stride, wait_ns, epoch);
    return (int)cudaGetLastError();
  });
}
