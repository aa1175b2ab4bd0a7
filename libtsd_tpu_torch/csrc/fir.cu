// Kernel #1: one-shot real FIR, zero initial state, output length = input
// length.  Replaces ops/pallas/fir.py::fir_pallas (the JAX package's
// _fir_kernel, banded-Toeplitz matmuls over 128-sample frames).
//
// Bound on the H100: a K-tap FIR costs 2K flop per sample (512 for K=256)
// against 8 bytes of device-memory traffic (f32 in, f32 out), 64 flop/byte,
// well above the 20 flop/byte at which the card's 67 TFLOP/s of fp32 CUDA
// cores meet its 3.35 TB/s.  So the kernel is bound by FMA issue and by
// the shared-memory loads that feed the FMAs.
//
// Design: blocks are independent (Hopper runs them in no order), so there
// is no carried history as in the TPU kernel's sequential grid: each block
// loads its own tile of FIR_TILE samples plus the kp - 1 samples to its
// left straight from x (zeros before the start) into shared memory, then
// runs the register-blocked core of fir_tile.cuh, which issues about one
// shared-memory load per four FMAs.  fp32 accumulation throughout.
#include <cuda_runtime.h>
#include "fir_tile.cuh"

__global__ void __launch_bounds__(FIR_THREADS)
fir_kernel(const float* __restrict__ x, const float* __restrict__ taps,
           float* __restrict__ y, long long n, int kp) {
  extern __shared__ float smem[];
  float* s_taps = smem;              // kp
  float* s_win = smem + kp;          // kp - 1 + FIR_TILE
  const long long t0 = (long long)blockIdx.x * FIR_TILE;
  const int wlen = kp - 1 + FIR_TILE;
  for (int k = threadIdx.x; k < kp; k += blockDim.x) s_taps[k] = taps[k];
  for (int j = threadIdx.x; j < wlen; j += blockDim.x) {
    const long long g = t0 - (kp - 1) + j;
    s_win[j] = (g >= 0 && g < n) ? x[g] : 0.0f;
  }
  __syncthreads();
  float acc[FIR_R];
  fir_tile(s_win, s_taps, kp, acc);
#pragma unroll
  for (int r = 0; r < FIR_R; ++r) {
    const long long i = t0 + fir_out_index(r);
    if (i < n) y[i] = acc[r];
  }
}

extern "C" int fir_f32(const float* x, const float* taps, float* y,
                       long long n, int kp, int smem_bytes,
                       cudaStream_t stream) {
  cudaFuncSetAttribute(fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes);
  const long long blocks = (n + FIR_TILE - 1) / FIR_TILE;
  fir_kernel<<<(unsigned)blocks, FIR_THREADS, smem_bytes, stream>>>(
      x, taps, y, n, kp);
  return (int)cudaGetLastError();
}
