// Kernel #3, the metric kernel: FIR -> DFT-4096 -> |X|^2 accumulated per
// channel, in one pass; the FIR output lives only in shared memory.
// Replaces ops/pallas/chain.py::fir_periodogram4096, single-device branch
// (the JAX package's _kernel with halo_axis=None).  The computation and
// its design are those of chain_frames (chain_body.cuh), which kernel #11
// (chain_halo.cu) shares.
//
// Bound on the H100: the 256-tap FIR costs 512 flop per sample and the FFT
// about 60, against 1-4 bytes of input per sample: 140-570 flop/byte, far
// above the fp32 ridge of 20.  The kernel is bound by FMA issue and by the
// shared-memory loads of the FIR and the FFT stages, not by memory.
//
// Frames of one channel are split over gridDim.x blocks to fill the
// 132 SMs.
#include "chain_body.cuh"

// 3 resident blocks per SM (<= 85 registers a thread): shared memory
// (~68 KB a block) allows 3, and more warps hide the shared-memory latency
template <typename T>
__global__ void __launch_bounds__(FIR_THREADS, 3)
chain_kernel(const T* __restrict__ x, const T* __restrict__ hist,
             const float* __restrict__ taps, float* __restrict__ out,
             long long N, int kp, int hist_len, int hist_stride,
             int frames_per_block) {
  chain_frames<T, false>(x, hist, taps, out, N, kp, hist_len, hist_stride,
                         frames_per_block);
}

template <typename T>
static int launch(const void* x, const void* hist, const float* taps,
                  float* out, long long N, int C, int kp, int hist_len,
                  int hist_stride, int frames_per_block, cudaStream_t stream) {
  const int smem = chain_smem_bytes(kp);
  cudaFuncSetAttribute(chain_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const long long frames = N / CH_N;
  dim3 grid((unsigned)((frames + frames_per_block - 1) / frames_per_block),
            (unsigned)C);
  chain_kernel<T><<<grid, FIR_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(hist), taps, out, N, kp,
      hist_len, hist_stride, frames_per_block);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16, 2 int8, 3 int16 (the ingest dtype of x
// and hist).  Returns cudaErrorInvalidValue for an unknown code.
extern "C" int fir_periodogram4096(const void* x, const void* hist,
                                   const float* taps, float* out, int dtype,
                                   long long N, int C, int kp, int hist_len,
                                   int hist_stride, int frames_per_block,
                                   cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch<float>(x, hist, taps, out, N, C, kp, hist_len,
                                 hist_stride, frames_per_block, stream);
    case 1: return launch<__nv_bfloat16>(x, hist, taps, out, N, C, kp,
                                         hist_len, hist_stride,
                                         frames_per_block, stream);
    case 2: return launch<int8_t>(x, hist, taps, out, N, C, kp, hist_len,
                                  hist_stride, frames_per_block, stream);
    case 3: return launch<int16_t>(x, hist, taps, out, N, C, kp, hist_len,
                                   hist_stride, frames_per_block, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
