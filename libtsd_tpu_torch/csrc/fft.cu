// Kernel #4: batched complex power-of-two FFT on re/im planes (B, n),
// n = 2^8 .. 2^14, natural bin order, forward or inverse (the inverse
// scales by 1/n).  Replaces ops/pallas/fft.py::fft_pow2 / ifft_pow2 (the
// JAX package's N1 x 128 two-matmul factorization on the MXU).
//
// Bound on the H100: about 5 n log2 n flop per transform (60 flop per
// point at n = 4096) against 16 bytes of traffic per point (two f32 planes
// in, two out): 3.75 flop/byte, far below the fp32 ridge of 20, so the
// kernel is bound by device memory, if on-chip traffic keeps up: the
// first port's shared-memory FFT swept every point through shared
// memory five times, with 16-way bank conflicts in its second pass's
// twiddle reads, and a natural-order store after it gathered 16-way
// conflicted too, which left it at a quarter of the bound.
//
// Design: the register-resident core of fft_reg.cuh.  Each thread loads
// its 16 points straight from the planes into registers (coalesced), runs
// the first pass there, and the data crosses shared memory only between
// passes, conflict-free (two exchanges at n = 4096); the last pass leaves
// each thread 16 bins that neighbouring threads store to neighbouring
// addresses.  Twiddles come from one float64-made table per (n, device),
// read in order through L1.  A block has 256 threads and holds 4096
// points: 4096 / n transforms for n < 4096, one for n > 4096, each thread
// then taking n / 4096 columns of every pass in turn (64 or 128 KB of
// shared memory).  Loads overlap compute across blocks: at n <= 4096 a
// block takes 32 KB and at most 80 registers a thread, so three run on
// each SM.  Measured slower on the card (PERF.md): four blocks at 64
// registers, and a persistent grid staging the next transform with
// cp.async.  The inverse is conj(FFT(conj(x))) / n.
#include <cuda_runtime.h>
#include "fft_reg.cuh"

namespace {

constexpr int FFT_THREADS = 256;
constexpr int FFT_MAX_DEVICES = 64;

template <int L>
__global__ void __launch_bounds__(FFT_THREADS, L <= 12 ? 3 : 1)
fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
           float* __restrict__ yr, float* __restrict__ yi,
           const float2* __restrict__ tw, int B, int inverse) {
  using F = fft_reg::Core<L>;
  constexpr int NT = F::U < FFT_THREADS ? F::U : FFT_THREADS;  // per transform
  constexpr int TPB = FFT_THREADS / NT;       // transforms per block
  constexpr int W = F::U / NT;                // columns per thread and pass
  extern __shared__ float2 sm2[];
  const int tr = threadIdx.x / NT, u0 = threadIdx.x % NT;
  const long long b = (long long)blockIdx.x * TPB + tr;
  const bool live = b < B;                    // dead rows still pass barriers
  float2* buf = sm2 + tr * F::N;
  const float sign = inverse ? -1.0f : 1.0f;  // conj in and out
  const float* pr = xr + b * F::N;
  const float* pi = xi + b * F::N;
#pragma unroll 1
  for (int w = 0; w < W; ++w) {
    const int u = u0 + NT * w;
    float2 v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = live ? make_float2(__ldg(pr + u + F::U * i),
                                sign * __ldg(pi + u + F::U * i))
                  : make_float2(0.0f, 0.0f);
    F::first_pass(v, u, tw);
    F::put_first(buf, v, u);
  }
  __syncthreads();
  F::template middle<NT>(buf, tw, u0);
  const float scale = inverse ? 1.0f / (float)F::N : 1.0f;
  float* qr = yr + b * F::N;
  float* qi = yi + b * F::N;
#pragma unroll 1
  for (int w = 0; w < W; ++w) {
    const int u = u0 + NT * w;
    float2 v[16];
    F::last_pass(buf, v, u);
    if (live) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        qr[u + F::U * k] = v[k].x * scale;
        qi[u + F::U * k] = sign * v[k].y * scale;
      }
    }
  }
}

template <int L>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           const float2* tw, int B, int inverse, cudaStream_t stream) {
  constexpr int N = 1 << L;
  constexpr int TPB = N >= 4096 ? 1 : 4096 / N;
  constexpr int smem = TPB * N * 8;
  if (smem > 48 * 1024) {
    // once per instantiation and device (the attribute is per device)
    static bool set[FFT_MAX_DEVICES];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < FFT_MAX_DEVICES && !set[dev]) {
      const cudaError_t e = cudaFuncSetAttribute(
          fft_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      set[dev] = true;
    }
  }
  const unsigned blocks = (unsigned)((B + TPB - 1) / TPB);
  fft_kernel<L><<<blocks, FFT_THREADS, smem, stream>>>(xr, xi, yr, yi, tw, B,
                                                      inverse);
  return (int)cudaGetLastError();
}

}  // namespace

// tw: ops/kernels/fft.py twiddles(log2n), fft_reg::Core<log2n>::TW_SIZE
// float2 entries.  Returns cudaGetLastError() after the launch.
extern "C" int fft_pow2_f32(const float* xr, const float* xi, float* yr,
                            float* yi, const float* tw, int B, int log2n,
                            int inverse, cudaStream_t stream) {
  const float2* t = reinterpret_cast<const float2*>(tw);
  switch (log2n) {
    case 8: return launch<8>(xr, xi, yr, yi, t, B, inverse, stream);
    case 9: return launch<9>(xr, xi, yr, yi, t, B, inverse, stream);
    case 10: return launch<10>(xr, xi, yr, yi, t, B, inverse, stream);
    case 11: return launch<11>(xr, xi, yr, yi, t, B, inverse, stream);
    case 12: return launch<12>(xr, xi, yr, yi, t, B, inverse, stream);
    case 13: return launch<13>(xr, xi, yr, yi, t, B, inverse, stream);
    case 14: return launch<14>(xr, xi, yr, yi, t, B, inverse, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
