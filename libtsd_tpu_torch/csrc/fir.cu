// Kernel #1: one-shot real FIR, zero initial state, output length = input
// length,
//
//     y[n] = sum_{k < K} h[k] x[n - k],   x[n < 0] = 0,   0 <= n < N.
//
// Replaces ops/pallas/fir.py::fir_pallas (the JAX package's _fir_kernel,
// banded-Toeplitz matmuls over 128-sample frames at Precision.HIGHEST).
//
// Bound on the H100: 2K flop a sample (512 at K = 256) against 8 bytes of
// device-memory traffic (fp32 in, fp32 out).  The FIR runs on the tensor
// cores at fp32-class accuracy: x = x1 + x2 + x3 and h = h1 + h2 + h3 in
// bf16 (x2 = bf16(x - x1), ...), and every product xi hj with i + j <= 4
// as mma.sync m16n8k16 bf16 -> fp32, six products: the terms left out lie
// below 2^-24 of x h, the accuracy of the JAX kernel's HIGHEST.  So the
// bound is 6 x 2K flop a sample at the bf16 tensor-core peak (0.013 ms at
// 2^22 samples and 256 taps) against 0.010 ms of bytes.
//
// Design.  The tensor-core FIR of chain_body.cuh at its passes-3 tier, its
// helpers included unchanged (ldsm_x4/x2, mma, put_chunk, load_taps_bf16,
// chunk swizzle, tap planes and their odd copies; tests/test_torch_chain_
// design.py models them), cut loose from the FFT:
//   grid   one stream: a block takes a run of whole tiles of TILE = 8192
//          outputs (512 rows of 16 samples), the grid about one block per
//          resident slot (2 an SM), so that a block has a next tile to
//          stage while it computes this one;
//   taps   in chunks of CHUNK_TAPS (496): chunk c is the FIR of h[496 c ..
//          496 c + 495] on x delayed by 496 c, with E_c <= 32 tap blocks
//          (chain::tap_blocks).  A tile is one item per chunk; items of a
//          tile run in the same block, so any K fits a fixed 94 KB of
//          shared memory (K <= 496: one item a tile, taps loaded once);
//   window a tile's item reads x from 16 (E_c - 1) + 496 c samples before
//          the tile (zeros before x[0] and from x[N] on: cp.async with the
//          valid bytes only), fp32, 16 bytes a copy, one item ahead into a
//          staging buffer: the next item's read is in flight over this
//          item's products.  Each thread converts the chunks it copied
//          into the three swizzled bf16 planes (put_chunk<3>), so neither
//          step needs a barrier of its own;
//   FIR    warp w computes rows 64 w .. 64 w + 63 of the tile as 8 n-tiles
//          m (rows 64 w + m + 8 n, n < 8), a ring of 8 B fragment sets of
//          x1 and x2 (one ldmatrix.x4 a step), x3 loaded where used; h1 x1
//          sums into one accumulator set, the five smaller products into a
//          second: mma.sync's fp32 sums truncate (round toward zero) at
//          each step, and a step's error is relative to the accumulator
//          it adds to, so the big product's accumulator takes E steps, not
//          6 E;
//   store  the two sums added and written to y from the fragments: each
//          store of a warp fills four whole 32-byte sectors (lanes g = 0..7
//          of a quad row are 8 consecutive samples).  A tile's later
//          chunks add to what the earlier ones wrote (the same thread's
//          addresses: no barrier, and each chunk's sums start from zero).
// tests/test_torch_fir_design.py is a numpy model of this file (grid,
// items, windows, copies, fragments, stores, the split's error with
// truncating sums); edit the two together.
// Registers: 64 accumulators and 32 ring words a thread, 2 blocks of 256
// threads an SM (128 registers, 160 bytes of spill stores: one block an
// SM without spills ran 5 % slower).
#include "chain_body.cuh"

namespace fir1 {

constexpr int TILE = 2 * chain::NF;          // outputs a tile
constexpr int ROWS = chain::ROWS;            // 16-sample rows a tile
constexpr int THREADS = chain::THREADS;
constexpr int CHUNK_BLOCKS = 31;             // 16-tap blocks a chunk
constexpr int CHUNK_TAPS = 16 * CHUNK_BLOCKS;
constexpr int E_MAX = chain::tap_blocks(CHUNK_TAPS);
constexpr int WROWS = chain::win_rows(E_MAX);
constexpr int PLANE_CHUNKS = 2 * WROWS;      // 16-byte chunks a bf16 plane
constexpr int WIN_BYTES = 3 * WROWS * 32;    // the three bf16 planes
constexpr int TAP_BYTES = 3 * chain::tap_plane_words(E_MAX) * 4;
constexpr int STAGE_BYTES = (ROWS + E_MAX - 1) * 64;
constexpr int SMEM = WIN_BYTES + TAP_BYTES + STAGE_BYTES;
static_assert(E_MAX == 32, "chunk of 31 whole tap blocks");
static_assert(WIN_BYTES % 16 == 0 && TAP_BYTES % 16 == 0, "16-byte parts");

// 16 bytes global -> shared, asynchronous, through L2; the first `bytes`
// (0, 4, 8, 12 or 16) from src, zeros after them
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(chain::smem_addr(dst)), "l"(src), "r"(bytes));
}

// The tile's FIR for one chunk of taps: s1 += h1 x1 and s2 += the five
// smaller products, over the E tap blocks of the chunk.  win: the three
// bf16 planes (PLANE_CHUNKS chunks apart); taps_w: the chunk's tap planes
// (chain::load_taps_bf16<3> with E).
__device__ __forceinline__ void fir_split3(const uint4* win,
                                           const uint32_t* taps_w, int E,
                                           float (&s1)[8][4],
                                           float (&s2)[8][4]) {
  using chain::ldsm_x2;
  using chain::ldsm_x4;
  using chain::mma;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Q = 64 * warp;
  // ldmatrix: lane l gives row l & 7 of matrix l >> 3 (0, 1: plane x1, k
  // 0-7 and 8-15; 2, 3: plane x2); B(s) holds tile rows s + 8 n
  const unsigned x1 = chain::smem_addr(win);
  const unsigned x12 = x1 + ((lane >> 4) ? 16u * PLANE_CHUNKS : 0u);
  const unsigned x3 = x1 + 32u * PLANE_CHUNKS;
  const int lane_h = (lane >> 3) & 1;
  const int lane_row = 8 * (lane & 7) + E - 1;
  auto chunk_at = [&](int s) {
    const int c = 2 * (s + lane_row) + lane_h;
    return 16u * (unsigned)(c ^ ((c >> 4) & 7));
  };
  uint32_t ring[8][4];         // slot s % 8 holds B(s) of x1 and x2
#pragma unroll
  for (int j = 1; j < 8; ++j) ldsm_x4(ring[j], x12 + chunk_at(Q + j));
  // A fragment of T_e at lane (g, t): words w, w - 4, w + 4 of rv (g even)
  // or of its odd copy (g odd), w = 8 (E - e) + t - ceil(g / 2)
  const uint32_t* pa = taps_w + ((g & 1) ? chain::odd_copy(E) : 0) + 8 * E +
                       t - ((g + (g & 1)) >> 1);
  const int gw = chain::tap_plane_words(E);
  // step e (i = e % 8, a constant once unrolled): B(Q - e) into the ring,
  // then n-tile m takes B(Q + m - e), the fresh fragment last
  auto step = [&](int e, int i) {
    ldsm_x4(ring[(8 - i) & 7], x12 + chunk_at(Q - e));
    const uint32_t* p = pa - 8 * e;
    const uint32_t a0 = p[0], a1 = p[-4], a2 = p[4];
#pragma unroll
    for (int mm = 1; mm <= 8; ++mm) {                  // h1 x1
      const int m = mm & 7;
      mma(s1[m], a0, a1, a2, ring[(m - i) & 7][0], ring[(m - i) & 7][1]);
    }
    const uint32_t* q = p + gw;
    const uint32_t b0 = q[0], b1 = q[-4], b2 = q[4];
#pragma unroll
    for (int mm = 1; mm <= 8; ++mm) {                  // h1 x2
      const int m = mm & 7;
      mma(s2[m], a0, a1, a2, ring[(m - i) & 7][2], ring[(m - i) & 7][3]);
    }
#pragma unroll
    for (int m = 0; m < 8; ++m)                        // h2 x2
      mma(s2[m], b0, b1, b2, ring[(m - i) & 7][2], ring[(m - i) & 7][3]);
#pragma unroll
    for (int m = 0; m < 8; ++m) {                      // h1 x3
      uint32_t b[4];
      ldsm_x2(b, x3 + chunk_at(Q + m - e));
      mma(s2[m], a0, a1, a2, b[0], b[1]);
    }
#pragma unroll
    for (int m = 0; m < 8; ++m)                        // h2 x1
      mma(s2[m], b0, b1, b2, ring[(m - i) & 7][0], ring[(m - i) & 7][1]);
    const uint32_t* r = p + 2 * gw;                    // h3 x1
    const uint32_t c0 = r[0], c1 = r[-4], c2 = r[4];
#pragma unroll
    for (int m = 0; m < 8; ++m)
      mma(s2[m], c0, c1, c2, ring[(m - i) & 7][0], ring[(m - i) & 7][1]);
  };
  // whole runs of 8 steps without a branch, then the last E % 8 steps
  int eb = 0;
  for (; eb + 8 <= E; eb += 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) step(eb + i, i);
  }
#pragma unroll
  for (int i = 0; i < 7; ++i)
    if (eb + i < E) step(eb + i, i);
}

}  // namespace fir1

__global__ void __launch_bounds__(fir1::THREADS, 2)
fir_kernel(const float* __restrict__ x, const float* __restrict__ taps,
           float* __restrict__ y, long long n, int K, int tiles_per_block) {
  using namespace fir1;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* win = reinterpret_cast<uint4*>(smem);
  auto* tap_planes = reinterpret_cast<__nv_bfloat16*>(smem + WIN_BYTES);
  const uint32_t* taps_w = reinterpret_cast<const uint32_t*>(tap_planes);
  uint4* stage = reinterpret_cast<uint4*>(smem + WIN_BYTES + TAP_BYTES);
  const int u = threadIdx.x;
  const int chunks = (K + CHUNK_TAPS - 1) / CHUNK_TAPS;
  const long long tiles = (n + TILE - 1) / TILE;
  const long long it0 = (long long)blockIdx.x * tiles_per_block * chunks;
  const long long it1 = min((long long)(blockIdx.x + 1) * tiles_per_block,
                            tiles) * chunks;
  if (it0 >= it1) return;
  auto taps_of = [&](int c) { return min(CHUNK_TAPS, K - CHUNK_TAPS * c); };
  // raw 8-sample chunk j of item it's window, as two 16-byte copies: thread
  // j % THREADS copies it and later converts it
  auto stage_item = [&](long long it) {
    const int c = (int)(it % chunks);
    const int E = chain::tap_blocks(taps_of(c));
    const long long g0 =
        (it / chunks) * TILE - (long long)CHUNK_TAPS * c - 16LL * (E - 1);
    for (int j = u; j < 2 * (ROWS + E - 1); j += THREADS) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long s = g0 + 8 * j + 4 * h;
        const long long left = n - s;
        const int bytes = s < 0 ? 0 : left >= 4 ? 16 : left > 0 ? 4 * (int)left
                                                                : 0;
        cp_async(stage + 2 * j + h, bytes ? x + s : x, bytes);
      }
    }
    chain::cp_async_commit();
  };
  stage_item(it0);
  const int lane = u & 31, g = lane >> 2, t = lane & 3;
  const int Q = 64 * (u >> 5);
#pragma unroll 1
  for (long long it = it0; it < it1; ++it) {
    const int c = (int)(it % chunks);
    const int E = chain::tap_blocks(taps_of(c));
    chain::cp_async_wait_all();
    __syncthreads();                 // the last item's planes are read
    for (int j = u; j < 2 * (ROWS + E - 1); j += THREADS) {
      float v[8];
      chain::unpack(chain::Raw8{stage[2 * j], stage[2 * j + 1]}, v, 0.0f);
      chain::put_chunk<3>(v, j, win, PLANE_CHUNKS);
    }
    if (chunks > 1 || it == it0)
      chain::load_taps_bf16<3>(taps + CHUNK_TAPS * c, taps_of(c), E,
                               tap_planes);
    if (it + 1 < it1) stage_item(it + 1);      // in flight over the mma
    __syncthreads();
    float s1[8][4], s2[8][4];
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int k = 0; k < 4; ++k) s1[m][k] = s2[m][k] = 0.0f;
    fir_split3(win, taps_w, E, s1, s2);
    // s[m] = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}, D[j][r] the
    // sample j of tile row Q + m + 8 r
    const long long t0 = (it / chunks) * TILE;
    float* yt = y + t0;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int o = 16 * (Q + m + 16 * t) + g;
      const int off[4] = {o, o + 128, o + 8, o + 136};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (t0 + off[k] < n) {
          float v = s1[m][k] + s2[m][k];
          if (c > 0) v += yt[off[k]];
          yt[off[k]] = v;
        }
      }
    }
  }
}

// y = FIR(taps, x): x, y fp32, n samples, x 16-byte aligned; taps: K fp32
// (any K >= 1, unpadded).  The grid: about one block per resident slot,
// whole tiles a block.
extern "C" int fir_f32(const float* x, const float* taps, float* y,
                       long long n, int K, cudaStream_t stream) {
  using namespace fir1;
  if (n <= 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  // resident slots of the card, found once per device (a host call's
  // cost is the kernel's at small n)
  static long long slots_of[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (slots_of[dev] == 0) {
    cudaFuncSetAttribute(fir_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fir_kernel,
                                                  THREADS, SMEM);
    slots_of[dev] = (long long)sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long slots = slots_of[dev];
  const long long tiles = (n + TILE - 1) / TILE;
  const long long tpb = (tiles + slots - 1) / slots;
  const long long blocks = (tiles + tpb - 1) / tpb;
  fir_kernel<<<(unsigned)blocks, THREADS, SMEM, stream>>>(x, taps, y, n, K,
                                                          (int)tpb);
  return (int)cudaGetLastError();
}
