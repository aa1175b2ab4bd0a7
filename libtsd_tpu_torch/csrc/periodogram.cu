// Kernel #2: framed 4096-point periodogram, accumulated per channel:
//     out[c, k] = sum_f |FFT_4096(y[c, 4096 f : 4096 (f + 1)])[k]|^2
// unnormalized, natural bin order.  Replaces
// ops/pallas/periodogram.py::periodogram4096_acc (the JAX package's 32x128
// Cooley-Tukey as two MXU matmul stages).
//
// Bound on the H100: an FFT-4096 is about 5 n log2 n = 246k flop per
// frame, 60 flop per sample, against 4 bytes per sample read: 15
// flop/byte, just under the card's fp32 ridge of 20, so a fast version is
// near the memory bound (4 bytes per sample at 3.35 TB/s).  This simple
// design is held by the shared-memory passes of fft_smem.cuh (three
// radix-16 passes, a load and a store of every point each) and its
// barriers; one block per 4096-point frame keeps 16 points per thread.
//
// Design: the TPU kernel revisits one output block across a sequential
// grid; here each block owns a contiguous run of frames of one channel and
// keeps its 16 bins per thread of |X|^2 in registers.  A channel's frames
// are split over gridDim.x blocks, so that C * gridDim.x blocks fill the
// 132 SMs even for few channels; the partial sums are combined by
// atomicAdd into an output the wrapper zeroes.  The FFT leaves its bins in
// digit-reversed positions (fft_smem.cuh): each thread accumulates fixed
// positions and the permutation is applied once, at the atomicAdd.
#include <cuda_runtime.h>
#include "fft_smem.cuh"

constexpr int PG_N = 4096;
constexpr int PG_LOG2N = 12;
constexpr int PG_THREADS = 256;
constexpr int PG_PER_THREAD = PG_N / PG_THREADS;   // 16
constexpr int PG_SMEM = fft_padded(PG_N) * 8 + (PG_N / 2) * 8; // frame + tw

// >= 3 resident blocks per SM (<= 85 registers a thread) to hide the
// latency of the shared-memory passes
__global__ void __launch_bounds__(PG_THREADS, 3)
periodogram_kernel(const float* __restrict__ y, float* __restrict__ out,
                   long long N, int frames_per_block) {
  extern __shared__ float2 sm2[];
  float2* buf = sm2;                      // fft_padded(PG_N)
  float2* tw = sm2 + fft_padded(PG_N);    // PG_N / 2
  const int c = blockIdx.y;
  const long long frames = N / PG_N;
  const long long f0 = (long long)blockIdx.x * frames_per_block;
  const long long f1 = min(f0 + frames_per_block, frames);
  if (f0 >= f1) return;
  fft_twiddles(tw, PG_LOG2N);
  float p[PG_PER_THREAD];
#pragma unroll
  for (int q = 0; q < PG_PER_THREAD; ++q) p[q] = 0.0f;
  const float* row = y + (long long)c * N;
  for (long long f = f0; f < f1; ++f) {
    const float* fr = row + f * PG_N;
#pragma unroll
    for (int q = 0; q < PG_PER_THREAD; ++q) {
      const int i = threadIdx.x + PG_THREADS * q;
      buf[fft_pad(i)] = make_float2(fr[i], 0.0f);
    }
    fft_forward(buf, tw, PG_LOG2N, 1);
#pragma unroll
    for (int q = 0; q < PG_PER_THREAD; ++q) {
      const float2 v = buf[fft_pad(threadIdx.x + PG_THREADS * q)];
      p[q] = fmaf(v.x, v.x, fmaf(v.y, v.y, p[q]));
    }
    // no barrier needed here: the next frame's load writes only the
    // positions this thread just read, and fft_forward starts with one
  }
  float* o = out + (long long)c * PG_N;
#pragma unroll
  for (int q = 0; q < PG_PER_THREAD; ++q)
    atomicAdd(o + fft_bin(threadIdx.x + PG_THREADS * q, PG_LOG2N), p[q]);
}

extern "C" int periodogram4096_f32(const float* y, float* out, int C,
                                   long long N, int frames_per_block,
                                   cudaStream_t stream) {
  cudaFuncSetAttribute(periodogram_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, PG_SMEM);
  const long long frames = N / PG_N;
  const unsigned splits =
      (unsigned)((frames + frames_per_block - 1) / frames_per_block);
  dim3 grid(splits, (unsigned)C);
  periodogram_kernel<<<grid, PG_THREADS, PG_SMEM, stream>>>(
      y, out, N, frames_per_block);
  return (int)cudaGetLastError();
}
