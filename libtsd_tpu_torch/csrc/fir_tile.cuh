// FIR core of chain_body.cuh's passes-0 tier: one block of FIR_THREADS threads
// computes FIR_TILE consecutive outputs of a real FIR in fp32,
//
//     y[i] = sum_{k < kp} taps[k] * win[kp - 1 + i - k],   0 <= i < FIR_TILE,
//
// from a window of kp - 1 + FIR_TILE input samples and kp taps, both in
// shared memory.  kp is a multiple of FIR_TAP_QUANTUM (the wrapper pads
// the taps with zeros).
//
// Register blocking.  Lane l of warp w owns outputs i = 512 w + l + 32 r
// (r < FIR_R), so a warp's loads hit 32 consecutive words: no bank
// conflicts.  Taps are taken as k + 32 j: output r at tap k + 32 (jb + j)
// reads the same sample as output r - j at tap k + 32 jb, so FIR_R + FIR_J
// - 1 window loads and FIR_J broadcast tap loads feed FIR_R * FIR_J FMAs
// (31 loads per 128 FMAs: about as many shared-memory instructions as the
// SM issues FMA instructions, instead of one load per FMA).
#pragma once
#include <cuda_runtime.h>

constexpr int FIR_TILE = 4096;
constexpr int FIR_THREADS = 256;
constexpr int FIR_R = 16;                       // outputs per thread
constexpr int FIR_J = 8;                        // tap blocking factor
constexpr int FIR_TAP_QUANTUM = 32 * FIR_J;     // kp % this == 0
static_assert(FIR_THREADS * FIR_R == FIR_TILE, "tile / thread mapping");

// Output index of this thread's r-th accumulator.
__device__ __forceinline__ int fir_out_index(int r) {
  return (threadIdx.x >> 5) * (32 * FIR_R) + (threadIdx.x & 31) + 32 * r;
}

__device__ __forceinline__ void fir_tile(const float* win, const float* taps,
                                         int kp, float acc[FIR_R]) {
  const float* base = win + (kp - 1) + fir_out_index(0);
#pragma unroll
  for (int r = 0; r < FIR_R; ++r) acc[r] = 0.0f;
  const int kb_count = kp / 32;
  for (int k = 0; k < 32; ++k) {
    for (int jb = 0; jb < kb_count; jb += FIR_J) {
      float hj[FIR_J];
#pragma unroll
      for (int j = 0; j < FIR_J; ++j) hj[j] = taps[k + 32 * (jb + j)];
      const float* p = base - k - 32 * jb;
      float xr[FIR_R + FIR_J - 1];
#pragma unroll
      for (int q = 0; q < FIR_R + FIR_J - 1; ++q)
        xr[q] = p[32 * (q - (FIR_J - 1))];
#pragma unroll
      for (int r = 0; r < FIR_R; ++r) {
#pragma unroll
        for (int j = 0; j < FIR_J; ++j)
          acc[r] = fmaf(hj[j], xr[r - j + FIR_J - 1], acc[r]);
      }
    }
  }
}
