// The port's one copy of the FFT: a forward complex float32 power-of-two
// FFT run in place in shared memory by all threads of a block.  It plays
// the role that _dft_mm/_pack_factors play for the JAX package's Pallas
// kernels (ops/pallas/periodogram.py); the periodogram, the fused chain
// and the plain FFT kernel all call fft_forward.
//
// Algorithm: mixed-radix decimation in frequency.  n = 2^log2n is split
// into passes of radix 16, with one first pass of radix 2, 4 or 8 when
// log2n is not a multiple of 4 (4096 = 16 x 16 x 16).  In a pass over
// sub-transforms of size M, each thread takes one "column": the R values
// x[b M + t + r M/R] (r < R) into registers, runs an R-point DFT there
// with compile-time twiddles, multiplies output k by W_M^(t k) and writes
// it back to x[b M + t + k M/R].  So a 4096-point transform costs 3 passes
// of shared-memory traffic and 3 barriers, against 12 of each for radix 2.
//
// Layout: element i lives at buf[fft_pad(i)], one float2 of padding after
// every 16, so that the last pass (16 consecutive values per thread) is
// free of bank conflicts; a buffer of `count` transforms holds
// fft_padded(count * n) float2.
//
// Output order: position p holds bin fft_bin(p, log2n) (a mixed-radix
// digit reversal); fft_pos is its inverse.  Callers that only accumulate
// |X|^2 keep positions and un-permute once; the FFT kernel gathers.
//
// Twiddles: a table of n/2 values exp(-2 pi i k / n) that the block fills
// once with sincospif (~1 ulp); W^(k + n/2) = -W^k gives the other half.
// The inverse transform is conj(FFT(conj(x))), applied by the caller.
#pragma once
#include <cuda_runtime.h>

__host__ __device__ constexpr int fft_pad(int i) { return i + (i >> 4); }
__host__ __device__ constexpr int fft_padded(int n) { return n + (n >> 4); }

// log2 of the radix of pass j: the remainder radix first, then 16s
__device__ __forceinline__ int fft_first_radix_bits(int log2n) {
  return (log2n & 3) ? (log2n & 3) : 4;
}

// Bin held by position p of an n = 2^log2n transform after fft_forward.
__device__ __forceinline__ int fft_bin(int p, int log2n) {
  int bin = 0, shift = 0, rem = log2n, rb = fft_first_radix_bits(log2n);
  while (rem > 0) {
    rem -= rb;
    bin += (p >> rem) << shift;
    p &= (1 << rem) - 1;
    shift += rb;
    rb = 4;
  }
  return bin;
}

// Position that holds bin k after fft_forward (inverse of fft_bin).
__device__ __forceinline__ int fft_pos(int k, int log2n) {
  int pos = 0, rem = log2n, rb = fft_first_radix_bits(log2n);
  while (rem > 0) {
    rem -= rb;
    pos += (k & ((1 << rb) - 1)) << rem;
    k >>= rb;
    rb = 4;
  }
  return pos;
}

// tw[k] = exp(-2 pi i k / n), k < n/2.  The caller synchronises
// (fft_forward starts with a barrier).
__device__ __forceinline__ void fft_twiddles(float2* tw, int log2n) {
  const int half = 1 << (log2n - 1);
  const float scale = -2.0f / (float)(1 << log2n);
  for (int k = threadIdx.x; k < half; k += blockDim.x) {
    float s, c;
    sincospif(scale * (float)k, &s, &c);
    tw[k] = make_float2(c, s);
  }
}

// cos(2 pi e / 16); constant-folded when e is a compile-time constant
__device__ __forceinline__ float fft_cos16(int e) {
  constexpr float K1 = 0.923879532511286756f;   // cos(pi/8)
  constexpr float K2 = 0.707106781186547524f;   // cos(pi/4)
  constexpr float K3 = 0.382683432365089772f;   // cos(3 pi/8)
  e &= 15;
  const int a = e <= 8 ? e : 16 - e;
  return a == 0 ? 1.0f : a == 1 ? K1 : a == 2 ? K2 : a == 3 ? K3
       : a == 4 ? 0.0f : a == 5 ? -K3 : a == 6 ? -K2 : a == 7 ? -K1 : -1.0f;
}

__device__ __forceinline__ float2 fft_cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In-register R-point DFT (R = 2^LR <= 16), natural order in and out:
// radix-2 decimation in frequency, then a compile-time register reorder.
template <int LR>
__device__ __forceinline__ void fft_dft_reg(float2 (&v)[1 << LR]) {
  constexpr int R = 1 << LR;
#pragma unroll
  for (int s = LR - 1; s >= 0; --s) {
    const int m = 1 << s;
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {
      const int k = j & (m - 1);
      const int i0 = ((j >> s) << (s + 1)) + k;
      const int i1 = i0 + m;
      const int e = k * (8 >> s);           // W_{2m}^k = W_16^e
      const float2 a = v[i0], c = v[i1];
      const float dr = a.x - c.x, di = a.y - c.y;
      v[i0] = make_float2(a.x + c.x, a.y + c.y);
      if (e == 0) {
        v[i1] = make_float2(dr, di);
      } else {
        const float wr = fft_cos16(e), wi = -fft_cos16(e + 12);
        v[i1] = make_float2(dr * wr - di * wi, dr * wi + di * wr);
      }
    }
  }
  float2 t[R];
#pragma unroll
  for (int q = 0; q < R; ++q) t[q] = v[q];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    int r = 0;
#pragma unroll
    for (int b = 0; b < LR; ++b) r |= ((q >> b) & 1) << (LR - 1 - b);
    v[r] = t[q];
  }
}

// One radix-2^LR pass over sub-transforms of size 2^log2m.
template <int LR>
__device__ __forceinline__ void fft_pass(float2* buf, const float2* tw,
                                         int log2n, int count, int log2m) {
  constexpr int R = 1 << LR;
  const int lq = log2m - LR;                   // column stride M / R
  const int cols = count << (log2n - LR);
  const int half = 1 << (log2n - 1);
  const int tw_shift = log2n - log2m;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const int t = c & ((1 << lq) - 1);
    const int base = ((c >> lq) << log2m) + t;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = buf[fft_pad(base + (r << lq))];
    fft_dft_reg<LR>(v);
#pragma unroll
    for (int k = 1; k < R; ++k) {
      const int e = (t * k) << tw_shift;       // W_M^(t k) = W_n^e, e < n
      float2 w = tw[e & (half - 1)];
      if (e >= half) w = make_float2(-w.x, -w.y);
      v[k] = fft_cmul(v[k], w);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) buf[fft_pad(base + (k << lq))] = v[k];
  }
}

// `count` forward transforms of n = 2^log2n (4 <= log2n) points, stored
// one after another in the padded layout.  Starts and ends with a
// block-wide barrier, so the caller may write buf just before and read it
// just after.
__device__ __forceinline__ void fft_forward(float2* buf, const float2* tw,
                                            int log2n, int count) {
  __syncthreads();
  int log2m = log2n;
  switch (log2n & 3) {
    case 1: fft_pass<1>(buf, tw, log2n, count, log2m); log2m -= 1; break;
    case 2: fft_pass<2>(buf, tw, log2n, count, log2m); log2m -= 2; break;
    case 3: fft_pass<3>(buf, tw, log2n, count, log2m); log2m -= 3; break;
    default: break;
  }
  if (log2m != log2n) __syncthreads();
  while (log2m >= 4) {
    fft_pass<4>(buf, tw, log2n, count, log2m);
    log2m -= 4;
    __syncthreads();
  }
}
