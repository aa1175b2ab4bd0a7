// Kernel #2: framed 4096-point periodogram, accumulated per channel:
//     out[c, k] = sum_f |FFT_4096(y[c, 4096 f : 4096 (f + 1)])[k]|^2
// unnormalized, natural bin order.  Replaces
// ops/pallas/periodogram.py::periodogram4096_acc (the JAX package's 32x128
// Cooley-Tukey as two MXU matmul stages).
//
// Bound on the H100: 4 bytes per sample read (the output is C x 16 KB),
// against an FFT-4096 of about 60 flop per sample, 30 with two real frames
// in one complex transform: 7.5 flop/byte, under the fp32 ridge of 20, so
// the kernel is bound by device memory (1.28 ms at 256 x 2^22), if on-chip
// work keeps up: a real frame transformed as a complex one spends half of
// the arithmetic and of the shared-memory traffic on zeros, and the
// first port's shared-memory FFT (five conflicted sweeps) held such a
// kernel at a sixth of the bound.
//
// Design: two real frames a, b of one channel per complex transform z = a +
// i b on the register-resident core of fft_reg.cuh (loads straight into
// the first pass, two conflict-free exchanges).  With Z = FFT(z),
// |A[k]|^2 + |B[k]|^2 = (|Z[k]|^2 + |Z[-k]|^2) / 2 exactly, so each thread
// accumulates S[k] = sum |Z[k]|^2 over the block's pairs for its 16 bins
// (k = thread + 256 j, natural order) in registers, and the block forms
// (S[k] + S[-k]) / 2 once at the end, through shared memory.  A run with
// an odd count of frames transforms its last frame alone (b = 0), for
// which the same formula gives |A[k]|^2.  Each block owns a run of frames
// of one channel; blocks of a channel combine by one coalesced atomicAdd
// per bin into an output the wrapper zeroes.  The grid is sized here: about
// 16 blocks per resident slot of the card (three 32 KB blocks of at most
// 80 registers a thread per SM), at least 4 frames a block.
#include <cuda_runtime.h>
#include "fft_reg.cuh"

namespace {

constexpr int PG_N = 4096;
constexpr int PG_THREADS = 256;
constexpr int PG_MAX_DEVICES = 64;
using PgCore = fft_reg::Core<12>;

__global__ void __launch_bounds__(PG_THREADS, 3)
periodogram_kernel(const float* __restrict__ y, float* __restrict__ out,
                   const float2* __restrict__ tw, long long N,
                   int frames_per_block) {
  __shared__ float2 buf[PG_N];
  const int c = blockIdx.y, u = threadIdx.x;
  const long long frames = N / PG_N;
  const long long f0 = (long long)blockIdx.x * frames_per_block;
  const long long f1 = min(f0 + frames_per_block, frames);
  if (f0 >= f1) return;
  const float* row = y + (long long)c * N;
  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
#pragma unroll 1
  for (long long f = f0; f < f1; f += 2) {
    const float* a = row + f * PG_N;
    const bool pair = f + 1 < f1;             // the same for the whole block
    float2 v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = make_float2(__ldg(a + u + 256 * i),
                         pair ? __ldg(a + PG_N + u + 256 * i) : 0.0f);
    PgCore::first_pass(v, u, tw);
    __syncthreads();                          // the last pair's reads are done
    PgCore::put_first(buf, v, u);
    __syncthreads();
    PgCore::middle<PG_THREADS>(buf, tw, u);
    PgCore::last_pass(buf, v, u);
#pragma unroll
    for (int k = 0; k < 16; ++k)
      acc[k] = fmaf(v[k].x, v[k].x, fmaf(v[k].y, v[k].y, acc[k]));
  }
  float* s = reinterpret_cast<float*>(buf);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 16; ++k) s[u + 256 * k] = acc[k];
  __syncthreads();
  float* o = out + (long long)c * PG_N;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int bin = u + 256 * k;
    atomicAdd(o + bin, 0.5f * (s[bin] + s[(PG_N - bin) & (PG_N - 1)]));
  }
}

}  // namespace

// tw: ops/kernels/fft.py twiddles(12).  Returns cudaGetLastError() after
// the launch.
extern "C" int periodogram4096_f32(const float* y, float* out, const float* tw,
                                   int C, long long N, cudaStream_t stream) {
  static int slots[PG_MAX_DEVICES];           // resident blocks, per device
  int dev = 0;
  cudaGetDevice(&dev);
  int sl = dev < PG_MAX_DEVICES ? slots[dev] : 0;
  if (sl == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, periodogram_kernel,
                                                  PG_THREADS, 0);
    sl = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < PG_MAX_DEVICES) slots[dev] = sl;
  }
  const long long frames = N / PG_N;
  if (C <= 0 || frames <= 0) return 0;
  const long long want = (16LL * sl + C - 1) / C;     // blocks per channel
  const long long most = (frames + 3) / 4;            // >= 4 frames a block
  const long long splits = want < 1 ? 1 : want > most ? most : want;
  long long fpb = (frames + splits - 1) / splits;
  fpb += fpb & 1;                      // whole pairs, but a channel's last
  const unsigned blocks_x = (unsigned)((frames + fpb - 1) / fpb);
  dim3 grid(blocks_x, (unsigned)C);
  periodogram_kernel<<<grid, PG_THREADS, 0, stream>>>(
      y, out, reinterpret_cast<const float2*>(tw), N, (int)fpb);
  return (int)cudaGetLastError();
}
