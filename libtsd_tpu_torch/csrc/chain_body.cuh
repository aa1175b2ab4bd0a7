// Body of the fused metric chain, shared by kernel #3 (chain.cu) and kernel
// #11 (chain_halo.cu): one block's share of
//
//     out[c, k] = sum_f |FFT_4096(y[c, 4096 f : 4096 (f + 1)])[k]|^2,
//     y[c, n]   = sum_{k < kp} taps[k] * x[c, n - k],
//
// where x[c, n < 0] comes from hist (the last hist_len samples before x,
// row c at hist + c * hist_stride; zeros beyond them) and taps are fp32
// (bf16-rounded on the host where the tier asks for it).  x is read in its
// ingest dtype (f32, bf16, int8 or int16) and converted to fp32 in shared
// memory; all arithmetic is fp32.
//
// Design: Hopper blocks run in no order, so nothing is carried between
// them.  Block (s, c) owns a contiguous run of frames of channel c; for
// each frame it loads the frame plus its kp - 1 left-halo samples straight
// from x (only a channel's first frame, the block with blockIdx.x == 0,
// reads hist), computes the 4096 FIR outputs with the register-blocked core
// of fir_tile.cuh, stores them as complex values in the FFT buffer, runs
// fft_smem.cuh's mixed-radix FFT and adds |X|^2 to 16 per-thread registers
// (fixed, digit-reversed positions, un-permuted once at the end).  The
// partial spectra of a channel's blocks are combined by atomicAdd into an
// output the wrapper zeroes.
//
// kCoherentHist: hist may have been written during this kernel's lifetime
// by another kernel (#11's receive slot, filled by a neighbour through a
// peer pointer); such loads go through L2 (ld.global.cg), never through
// the non-coherent read-only path that a const __restrict__ pointer
// allows.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include "fft_smem.cuh"
#include "fir_tile.cuh"

constexpr int CH_N = 4096;
constexpr int CH_LOG2N = 12;
constexpr int CH_PER_THREAD = CH_N / FIR_THREADS;   // 16 bins per thread
static_assert(FIR_TILE == CH_N, "one FIR tile per DFT frame");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(int16_t v) { return (float)v; }

template <bool kCoherent, typename T>
__device__ __forceinline__ T load_hist(const T* p) {
  if constexpr (kCoherent) return __ldcg(p);
  else return *p;
}

// Dynamic shared memory of chain_frames for kp padded taps.
inline int chain_smem_bytes(int kp) {
  return fft_padded(CH_N) * 8 + (CH_N / 2) * 8 + (2 * kp - 1 + CH_N) * 4;
}

template <typename T, bool kCoherentHist>
__device__ __forceinline__ void chain_frames(
    const T* __restrict__ x, const T* hist, const float* __restrict__ taps,
    float* __restrict__ out, long long N, int kp, int hist_len,
    int hist_stride, int frames_per_block) {
  extern __shared__ float2 sm2[];
  float2* buf = sm2;                                   // fft_padded(CH_N)
  float2* tw = sm2 + fft_padded(CH_N);                 // CH_N / 2
  float* s_taps = reinterpret_cast<float*>(tw + CH_N / 2);   // kp
  float* s_win = s_taps + kp;                          // kp - 1 + CH_N
  const int c = blockIdx.y;
  const long long frames = N / CH_N;
  const long long f0 = (long long)blockIdx.x * frames_per_block;
  const long long f1 = min(f0 + frames_per_block, frames);
  if (f0 >= f1) return;
  fft_twiddles(tw, CH_LOG2N);
  for (int k = threadIdx.x; k < kp; k += blockDim.x) s_taps[k] = taps[k];
  const T* row = x + (long long)c * N;
  const T* hrow = hist + (long long)c * hist_stride;
  const int wlen = kp - 1 + CH_N;
  float p[CH_PER_THREAD];
#pragma unroll
  for (int q = 0; q < CH_PER_THREAD; ++q) p[q] = 0.0f;
  for (long long f = f0; f < f1; ++f) {
    const long long g0 = f * CH_N - (kp - 1);
    for (int j = threadIdx.x; j < wlen; j += blockDim.x) {
      const long long g = g0 + j;
      float v = 0.0f;
      if (g >= 0) v = to_f32(row[g]);
      else if (g >= -(long long)hist_len)
        v = to_f32(load_hist<kCoherentHist>(hrow + hist_len + g));
      s_win[j] = v;
    }
    __syncthreads();
    float acc[FIR_R];
    fir_tile(s_win, s_taps, kp, acc);
#pragma unroll
    for (int r = 0; r < FIR_R; ++r)
      buf[fft_pad(fir_out_index(r))] = make_float2(acc[r], 0.0f);
    // fft_forward's opening barrier also orders this frame's window reads
    // before the next frame's window stores
    fft_forward(buf, tw, CH_LOG2N, 1);
#pragma unroll
    for (int q = 0; q < CH_PER_THREAD; ++q) {
      const float2 v = buf[fft_pad(threadIdx.x + FIR_THREADS * q)];
      p[q] = fmaf(v.x, v.x, fmaf(v.y, v.y, p[q]));
    }
    // the next frame writes buf only after the barrier that follows its
    // window load, so these reads are safe without another barrier
  }
  float* o = out + (long long)c * CH_N;
#pragma unroll
  for (int q = 0; q < CH_PER_THREAD; ++q)
    atomicAdd(o + fft_bin(threadIdx.x + FIR_THREADS * q, CH_LOG2N), p[q]);
}
