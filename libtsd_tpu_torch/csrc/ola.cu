// Kernel #9: streaming overlap-save FFT convolution of complex signals,
// complex taps.  Replaces ops/pallas/ola.py::_ola_filter_planes (its
// _kernel: window assembly, two-stage matmul DFT in a [k1, q] layout, x H,
// conjugate-factor inverse, discard, all inside one grid step).
//
// Semantics: channel c's window w is the Nf = 2^L samples [w Ne - V, w Ne +
// Ne) of that channel's stream, where indices < 0 read the carried state
// (the last V samples before x) and Ne = Nf - V.  The kernel writes the
// last Ne samples of IFFT(FFT(window) x H) to y[c, w Ne ...].  The new
// state (the last V inputs) is a slice the wrapper takes.
//
// Bound on the H100: each input sample is read once and each output
// written once, 16 bytes a sample as complex64, against ~(10 log2 Nf + 6)
// Nf / Ne flop a sample (two FFTs and the product): ~128 flop at Nf = 4096,
// Ne = 3968, i.e. 8 flop/byte, below the fp32 ridge of 20.  So a fast
// kernel is bound by device memory; the spectrum must never go there.
//
// Design: one block per (channel, window), blocks independent (window w >
// 0 reads its V-sample history straight from x, window 0 from the state),
// on the register-resident core of fft_reg.cuh (fft_reg::Core<L>, L = 8 ..
// 14), with min(Nf / 16, 256) threads; a thread takes W = Nf / 4096
// columns of each pass in turn when Nf > 4096.
//   forward  thread u loads window points u + U i (U = Nf / 16, i < 16; x or
//            the state) straight into the first pass; first_pass, put_first,
//            middle, last_pass: thread u then holds bins u + U k in natural
//            order in register k;
//   product  each register times H[u + U k] (natural order, coalesced, L2
//            resident), conjugated: the inverse is conj(FFT(conj(Y))) / Nf;
//   inverse  bins u + U k in register k of thread u are exactly the first
//            pass's input pattern, so the inverse starts from registers:
//            first_pass, then (after a barrier: every column of the forward
//            must be read before the exchange buffer is overwritten)
//            put_first, middle, last_pass;
//   store    samples u + U k >= V, scaled by 1 / Nf and conjugated:
//            neighbouring threads store neighbouring samples.
// Four exchanges through shared memory, conflict-free, and no per-block
// twiddle table: the twiddles are ops/kernels/fft.py's table for Nf, read
// through L1 as #4 reads them.  At Nf > 4096 (W > 1) a thread holds all W x
// 16 products in registers across the barrier between the forward's last
// pass and the inverse's first exchange (a second exchange buffer would
// take 256 KB at Nf = 16384, above the 227 KB a block may use).  The TPU
// kernel's block-diagonal kron factors, [k1, q] layout and Karatsuba
// matmuls were MXU choices and are not carried over.  fp32 throughout
// (both JAX tiers).
//
// Shared memory: the exchange buffer, Nf float2: 32 KB at Nf = 4096, 128 KB
// at Nf = 16384.  Two blocks an SM up to Nf = 8192 (<= 128 registers a
// thread, no spills); at three (<= 80 registers) Nf = 4096 spilled 160
// bytes and ran 1.39x slower (PERF.md).  At Nf = 8192 a second
// exchange buffer in place of the registers held across the barrier ran
// 1.27x slower (one 128 KB block an SM).
// tests/test_torch_ola_detfront_design.py models the handoff (every L,
// every column order) on test_torch_fft_design.py's model of the core.
#include <cuda_runtime.h>
#include "fft_reg.cuh"

namespace {

constexpr int OLA_THREADS = 256;
constexpr int OLA_MAX_DEVICES = 64;

__host__ __device__ constexpr int ola_nt(int L) {
  return (1 << (L - 4)) < OLA_THREADS ? (1 << (L - 4)) : OLA_THREADS;
}

template <int L>
__global__ void __launch_bounds__(ola_nt(L), L <= 13 ? 2 : 1)
ola_kernel(const float2* __restrict__ x, const float2* __restrict__ st,
           const float2* __restrict__ h, const float2* __restrict__ tw,
           float2* __restrict__ y, long long N, int V, int nwin) {
  using F = fft_reg::Core<L>;
  constexpr int NT = ola_nt(L);               // threads of the block
  constexpr int W = F::U / NT;                // columns per thread and pass
  extern __shared__ float2 buf[];
  const int u0 = threadIdx.x;
  const int c = blockIdx.x / nwin;
  const int w = blockIdx.x - c * nwin;
  const int ne = F::N - V;
  const float2* xc = x + (long long)c * N;
  const float2* sc = st + (long long)c * V;
  const long long g0 = (long long)w * ne - V;   // stream index of point 0
#pragma unroll 1
  for (int k = 0; k < W; ++k) {
    const int u = u0 + NT * k;
    float2 v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const long long g = g0 + u + F::U * i;
      v[i] = g >= 0 ? __ldg(xc + g) : __ldg(sc + V + g);
    }
    F::first_pass(v, u, tw);
    F::put_first(buf, v, u);
  }
  __syncthreads();
  F::template middle<NT>(buf, tw, u0);
  // forward's bins u + U j times H, conjugated: the inverse's first input
  float2 z[W][16];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int u = u0 + NT * k;
    F::last_pass(buf, z[k], u);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 p = fft_reg::cmul(z[k][j], __ldg(h + u + F::U * j));
      z[k][j] = make_float2(p.x, -p.y);
    }
  }
  __syncthreads();                            // every column has been read
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int u = u0 + NT * k;
    F::first_pass(z[k], u, tw);
    F::put_first(buf, z[k], u);
  }
  __syncthreads();
  F::template middle<NT>(buf, tw, u0);
  const float scale = 1.0f / (float)F::N;
  float2* yc = y + (long long)c * N + (long long)w * ne;
#pragma unroll 1
  for (int k = 0; k < W; ++k) {
    const int u = u0 + NT * k;
    float2 v[16];
    F::last_pass(buf, v, u);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int p = u + F::U * j;
      if (p >= V) yc[p - V] = make_float2(v[j].x * scale, -v[j].y * scale);
    }
  }
}

template <int L>
int launch(const float2* x, const float2* st, const float2* h,
           const float2* tw, float2* y, int C, long long N, int V,
           cudaStream_t stream) {
  constexpr int smem = (1 << L) * (int)sizeof(float2);
  if (smem > 48 * 1024) {
    // once per instantiation and device (the attribute is per device)
    static bool set[OLA_MAX_DEVICES];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < OLA_MAX_DEVICES && !set[dev]) {
      const cudaError_t e = cudaFuncSetAttribute(
          ola_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      set[dev] = true;
    }
  }
  const int nwin = (int)(N / ((1 << L) - V));
  const long long blocks = (long long)C * nwin;
  ola_kernel<L><<<(unsigned)blocks, ola_nt(L), smem, stream>>>(
      x, st, h, tw, y, N, V, nwin);
  return (int)cudaGetLastError();
}

}  // namespace

// h: the response in natural bin order (Nf = 2^log2nf entries); tw:
// ops/kernels/fft.py twiddles(log2nf), fft_reg::Core<log2nf>::TW_SIZE float2
// entries.  Returns cudaGetLastError() after the launch.
extern "C" int ola_f32(const float2* x, const float2* st, const float2* h,
                       const float* tw, float2* y, int C, long long N,
                       int log2nf, int V, cudaStream_t stream) {
  const float2* t = reinterpret_cast<const float2*>(tw);
  switch (log2nf) {
    case 8: return launch<8>(x, st, h, t, y, C, N, V, stream);
    case 9: return launch<9>(x, st, h, t, y, C, N, V, stream);
    case 10: return launch<10>(x, st, h, t, y, C, N, V, stream);
    case 11: return launch<11>(x, st, h, t, y, C, N, V, stream);
    case 12: return launch<12>(x, st, h, t, y, C, N, V, stream);
    case 13: return launch<13>(x, st, h, t, y, C, N, V, stream);
    case 14: return launch<14>(x, st, h, t, y, C, N, V, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
