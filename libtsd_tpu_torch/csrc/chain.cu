// Kernel #3, the metric kernel: FIR -> DFT-4096 -> |X|^2 accumulated per
// channel, in one pass; the FIR output lives only in shared memory.
// Replaces ops/pallas/chain.py::fir_periodogram4096, single-device branch
// (the JAX package's _kernel with halo_axis=None).  What bounds it and the
// design are those of chain::chain_frames (chain_body.cuh): the FIR of the
// bf16 tiers on the tensor cores, the fp32 one on the FMA pipes, the FFT on
// fft_reg.cuh with two real frames per complex transform.  The tensor-core
// tiers with one tap plane (passes 1-2) and K <= chain_wg::K_MAX take
// chain_wg.cu's body (the FIR on wgmma, overlapped with the FFT of the
// pairs before); passes 0 and 3, and larger K, take chain_frames.  Kernel
// #11 (chain_halo.cu) takes the same two bodies by the same route.
#include "chain_body.cuh"

int chain_wg_launch(const void* x, const void* hist, const float* taps,
                    const float* tw, float* out, int dtype, int passes,
                    long long N, int C, int K, int hist_len, int hist_stride,
                    cudaStream_t stream);

template <typename T, int kPasses>
__global__ void __launch_bounds__(chain::THREADS, chain::MIN_BLOCKS)
chain_kernel(const T* __restrict__ x, const T* __restrict__ hist,
             const float* __restrict__ taps, const float2* __restrict__ tw,
             float* __restrict__ out, long long N, int K, int hist_len,
             int hist_stride, int frames_per_block) {
  chain::chain_frames<T, kPasses, false>(x, hist, taps, tw, out, N, K,
                                         hist_len, hist_stride,
                                         frames_per_block);
}

template <typename T, int kPasses>
static int launch(const void* x, const void* hist, const float* taps,
                  const float* tw, float* out, long long N, int C, int K,
                  int hist_len, int hist_stride, cudaStream_t stream) {
  const int smem =
      chain::smem_bytes(kPasses, K, (int)sizeof(T));
  cudaFuncSetAttribute(chain_kernel<T, kPasses>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int fpb = 0;
  const dim3 grid = chain::grid_for(chain_kernel<T, kPasses>, smem, C,
                                    N / chain::NF, &fpb);
  chain_kernel<T, kPasses><<<grid, chain::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(hist), taps,
      reinterpret_cast<const float2*>(tw), out, N, K, hist_len, hist_stride,
      fpb);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16, 2 int8, 3 int16 (the ingest dtype of x and
// hist).  passes: 0 the fp32 FIR, with K = kp taps zero-padded to a
// multiple of FIR_TAP_QUANTUM; 1-3 the bf16 tensor-core FIR (chain_body.cuh)
// with the K taps.  The pairs that exist: float32 with 0, 2 or 3; bfloat16
// and int8 with 1; int16 with 2 or 3; any other returns
// cudaErrorInvalidValue.  tw: ops/kernels/fft.py twiddles(12).  x, hist:
// 16-byte aligned (8 for int8).  N % 4096 == 0.
extern "C" int fir_periodogram4096(const void* x, const void* hist,
                                   const float* taps, const float* tw,
                                   float* out, int dtype, int passes,
                                   long long N, int C, int K, int hist_len,
                                   int hist_stride, cudaStream_t stream) {
  if (C <= 0 || N < chain::NF) return 0;
  const int wg = chain_wg_launch(x, hist, taps, tw, out, dtype, passes, N, C,
                                 K, hist_len, hist_stride, stream);
  if (wg >= 0) return wg;
#define CHAIN_LAUNCH(T, P) \
  launch<T, P>(x, hist, taps, tw, out, N, C, K, hist_len, hist_stride, stream)
  switch (dtype * 4 + passes) {
    case 0: return CHAIN_LAUNCH(float, 0);
    case 2: return CHAIN_LAUNCH(float, 2);
    case 3: return CHAIN_LAUNCH(float, 3);
    case 5: return CHAIN_LAUNCH(__nv_bfloat16, 1);
    case 9: return CHAIN_LAUNCH(int8_t, 1);
    case 14: return CHAIN_LAUNCH(int16_t, 2);
    case 15: return CHAIN_LAUNCH(int16_t, 3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CHAIN_LAUNCH
}
