// Kernel #4: batched complex power-of-two FFT on re/im planes (B, n),
// natural bin order, forward or inverse (the inverse scales by 1/n).
// Replaces ops/pallas/fft.py::fft_pow2 / ifft_pow2 (the JAX package's
// N1 x 128 two-matmul factorization on the MXU).
//
// Bound on the H100: about 5 n log2 n flop per transform (70 flop per
// point at n = 16384) against 16 bytes of traffic per point (two f32
// planes in, two out): 2.5-4.4 flop/byte, below the fp32 ridge of 20, so a
// fast FFT is bound by device memory.  This simple kernel is held by its
// shared-memory passes (fft_smem.cuh: 3-4 radix-16 passes) and by the
// digit-reversed gather of its natural-order store.
//
// Design: one block per transform, several per block for n < 4096, so a
// block always works on >= 4096 points.  The transform is staged in
// shared memory (n = 16384 takes 136 KB of padded data and 64 KB of
// twiddles, hence the dynamic-shared-memory attribute), loaded in natural
// order, transformed by fft_smem.cuh and stored in natural order by
// reading the position that holds each bin.  The inverse is
// conj(FFT(conj(x))) / n.
#include <cuda_runtime.h>
#include "fft_smem.cuh"

constexpr int FFT_THREADS = 256;
constexpr int FFT_MIN_POINTS = 4096;   // points per block for small n

// >= 3 resident blocks per SM where shared memory allows (n <= 4096)
__global__ void __launch_bounds__(FFT_THREADS, 3)
fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
           float* __restrict__ yr, float* __restrict__ yi, int B, int log2n,
           int count, int inverse) {
  extern __shared__ float2 sm2[];
  const int n = 1 << log2n;
  const int total = count * n;
  float2* buf = sm2;                       // fft_padded(total)
  float2* tw = sm2 + fft_padded(total);    // n / 2
  const long long b0 = (long long)blockIdx.x * count;
  const float sign = inverse ? -1.0f : 1.0f;     // conj in and out
  fft_twiddles(tw, log2n);
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const long long b = b0 + (e >> log2n);
    float2 v = make_float2(0.0f, 0.0f);
    if (b < B) {
      const long long off = b * n + (e & (n - 1));
      v = make_float2(xr[off], sign * xi[off]);
    }
    buf[fft_pad(e)] = v;
  }
  fft_forward(buf, tw, log2n, count);
  const float scale = inverse ? 1.0f / (float)n : 1.0f;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int t = e >> log2n;
    const long long b = b0 + t;
    if (b < B) {
      const int k = e & (n - 1);
      const float2 v = buf[fft_pad((t << log2n) + fft_pos(k, log2n))];
      const long long off = b * n + k;
      yr[off] = v.x * scale;
      yi[off] = sign * v.y * scale;
    }
  }
}

extern "C" int fft_pow2_f32(const float* xr, const float* xi, float* yr,
                            float* yi, int B, int log2n, int inverse,
                            cudaStream_t stream) {
  const int n = 1 << log2n;
  const int count = n >= FFT_MIN_POINTS ? 1 : FFT_MIN_POINTS / n;
  const int smem = (fft_padded(count * n) + n / 2) * 8;
  cudaFuncSetAttribute(fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const unsigned blocks = (unsigned)((B + count - 1) / count);
  fft_kernel<<<blocks, FFT_THREADS, smem, stream>>>(xr, xi, yr, yi, B, log2n,
                                                    count, inverse);
  return (int)cudaGetLastError();
}
