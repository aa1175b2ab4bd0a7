// Kernel #9: streaming overlap-save FFT convolution of complex signals,
// complex taps.  Replaces ops/pallas/ola.py::_ola_filter_planes (its
// _kernel: window assembly, two-stage matmul DFT in a [k1, q] layout, x H,
// conjugate-factor inverse, discard, all inside one grid step).
//
// Semantics: channel c's window w is the Nf = 2^log2nf samples
// [w Ne - V, w Ne + Ne) of that channel's stream, where indices < 0 read
// the carried state (the last V samples before x) and Ne = Nf - V.  The
// kernel writes the last Ne samples of IFFT(FFT(window) x H) to
// y[c, w Ne ...].  The new state (the last V inputs) is a slice the
// wrapper takes.
//
// Bound on the H100: each input sample is read once and each output
// written once, 16 bytes a sample as complex64, against ~(10 log2 Nf + 6)
// Nf / Ne flop a sample (two FFTs and the product): ~128 flop at Nf = 4096,
// Ne = 3968, i.e. 8 flop/byte, below the fp32 ridge of 20.  So a fast
// kernel is bound by device memory; the spectrum must never go there.
//
// Design: one block per (channel, window), blocks independent (Hopper runs
// them in no order; window w > 0 reads its V-sample history straight from
// x, window 0 from the state).  The window is loaded into shared memory,
// transformed by fft_forward (fft_smem.cuh, radix 16) whose output stays
// in its mixed-radix position order; position p reads the bin it holds,
// H[fft_bin(p)], from the natural-order response (32 KB at Nf = 4096, L2
// resident), so the product is elementwise in place; the inverse is
// conj(F conj(Y)) / Nf with F run as fft_forward_t, the transpose of
// fft_forward, which takes position order and returns natural order: no
// permuting pass and no second buffer.  Only the last Ne samples are
// stored.  The TPU kernel's block-diagonal kron factors, [k1, q] layout and
// Karatsuba matmuls were MXU choices and are not carried over.  fp32
// throughout (both JAX tiers).
//
// Shared memory: the padded window fft_padded(Nf) float2 and Nf/2
// twiddles: 51 KB at Nf = 4096, 200 KB at Nf = 16384 (dynamic, above the
// 48 KB default, under the 227 KB a block may use).
#include <cuda_runtime.h>
#include "fft_smem.cuh"

constexpr int OLA_THREADS = 256;

__global__ void __launch_bounds__(OLA_THREADS)
ola_kernel(const float2* __restrict__ x, const float2* __restrict__ st,
           const float2* __restrict__ h, float2* __restrict__ y,
           long long N, int log2nf, int V, int nwin) {
  extern __shared__ float2 sm2[];
  const int nf = 1 << log2nf;
  const int ne = nf - V;
  float2* buf = sm2;                        // fft_padded(nf)
  float2* tw = sm2 + fft_padded(nf);        // nf / 2
  const int c = blockIdx.x / nwin;
  const int w = blockIdx.x - c * nwin;
  const float2* xc = x + (long long)c * N;
  const float2* sc = st + (long long)c * V;
  const long long g0 = (long long)w * ne - V;   // stream index of sample 0
  fft_twiddles(tw, log2nf);
  for (int j = threadIdx.x; j < nf; j += blockDim.x) {
    const long long g = g0 + j;
    buf[fft_pad(j)] = g >= 0 ? xc[g] : sc[V + g];
  }
  fft_forward(buf, tw, log2nf, 1);
  // Y = X H position by position, conjugated for the inverse
  for (int p = threadIdx.x; p < nf; p += blockDim.x) {
    const float2 v = fft_cmul(buf[fft_pad(p)], h[fft_bin(p, log2nf)]);
    buf[fft_pad(p)] = make_float2(v.x, -v.y);
  }
  fft_forward_t(buf, tw, log2nf, 1);
  const float scale = 1.0f / (float)nf;
  float2* yc = y + (long long)c * N + (long long)w * ne;
  for (int j = threadIdx.x; j < ne; j += blockDim.x) {
    const float2 v = buf[fft_pad(V + j)];
    yc[j] = make_float2(v.x * scale, -v.y * scale);
  }
}

extern "C" int ola_f32(const float2* x, const float2* st, const float2* h,
                       float2* y, int C, long long N, int log2nf, int V,
                       cudaStream_t stream) {
  const int nf = 1 << log2nf;
  const int nwin = (int)(N / (nf - V));
  const int smem = (fft_padded(nf) + nf / 2) * (int)sizeof(float2);
  cudaFuncSetAttribute(ola_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const long long blocks = (long long)C * nwin;
  ola_kernel<<<(unsigned)blocks, OLA_THREADS, smem, stream>>>(
      x, st, h, y, N, log2nf, V, nwin);
  return (int)cudaGetLastError();
}
