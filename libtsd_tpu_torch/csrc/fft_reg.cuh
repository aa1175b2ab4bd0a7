// A register-resident forward complex float32 FFT of n = 2^L points
// (8 <= L <= 14), templated on L so that every index map is a constant at
// compile time.  Kernels #2 (periodogram.cu), #4 (fft.cu), the fused
// chain #3/#11 (chain_body.cuh) and the overlap-save filter #9 (ola.cu)
// run on it.
//
// Passes: decimation in frequency, each thread keeping the 16 values of
// one column in registers through a pass, and the data crosses shared
// memory only between passes.  The first pass has radix
// R0 = 2^(L % 4) when L % 4 != 0, else 16; then radix-16 passes over
// sub-transforms of size M = n/R0 (or n/16), ..., 256 ("middle"), and a
// last radix-16 pass over M = 16.  4096 = 16 x 16 x 16 is three passes and
// two exchanges: the first pass's stores, the middle pass's load and store
// in place, the last pass's loads.  With U = n/16 columns ("threads" u < U
// of one transform):
//   first  thread u loads x[u + U i] (i < 16; coalesced for each i) straight
//          into registers.  Radix 16: one DFT of v[0..15], then output k
//          times W_n^(u k).  Radix R0: 16/R0 DFTs, column q < 16/R0 on
//          v[q + (16/R0) r], output k times W_n^(t k), t = u + U q.  Output
//          register i holds position u + U i.
//   middle column c = u of size M: positions b M + t + (M/16) r (b = c /
//          (M/16), t = c % (M/16)); read, DFT, output k times W_M^(t k),
//          written back to the same positions (so no barrier inside).
//   last   thread u takes column col(u) = fft_pos(u) / 16, positions
//          16 col + r; after its DFT, register k holds bin u + U k, so
//          neighbouring threads store neighbouring bins (coalesced), with
//          no gather.  fft_pos / fft_bin: the mixed-radix digit reversal
//          of the passes (the remainder digit first).
// Layout of an exchange: position p lives at float2 slot swz(p) = p XOR
// (fft_bin(p) & 15), the low nibble of the bin it will hold.  The writers
// and readers of every pass vary the low nibble of p across a half-warp,
// except the last pass's readers, whose 16 columns differ exactly in the
// bits that make up fft_bin's low nibble; either way the 16 threads of a
// half-warp hit 16 distinct bank pairs (8-byte accesses).  A block of
// several transforms puts transform j at slot offset j n (n % 16 == 0).
// Twiddles: one global table per (n, device), made in float64 and rounded
// once to float32 (ops/kernels/fft.py twiddle_table): for each pass but
// the last, T[k - 1][t] = W_M^(t k), t fastest, so a half-warp reads 16
// consecutive entries (L1-resident: 32 KB at n = 4096).
// The inverse transform is conj(FFT(conj(x))), applied by the caller.
//
// tests/test_torch_fft_design.py holds a numpy model of exactly these
// loads, passes, tables, swizzles and stores (and checks the bank pairs);
// keep it and this header in step.
#pragma once
#include <cuda_runtime.h>

namespace fft_reg {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// d * W_16^e, 0 <= e < 8; e is a constant once the caller's loops unroll
__device__ __forceinline__ float2 mul_w16(float2 d, int e) {
  constexpr float K1 = 0.923879532511286756f;   // cos(pi/8)
  constexpr float K2 = 0.707106781186547524f;   // cos(pi/4)
  constexpr float K3 = 0.382683432365089772f;   // cos(3 pi/8)
  switch (e) {
    case 0: return d;
    case 4: return make_float2(d.y, -d.x);
    case 2: return make_float2((d.x + d.y) * K2, (d.y - d.x) * K2);
    case 6: return make_float2((d.y - d.x) * K2, -(d.x + d.y) * K2);
    default: {
      // (cos, -sin) of 2 pi e / 16 for e = 1, 3, 5, 7
      const float wr = e == 1 ? K1 : e == 3 ? K3 : e == 5 ? -K3 : -K1;
      const float wi = e == 1 ? -K3 : e == 3 ? -K1 : e == 5 ? -K1 : -K3;
      return make_float2(d.x * wr - d.y * wi, d.x * wi + d.y * wr);
    }
  }
}

__host__ __device__ constexpr int brev(int r, int bits) {
  int o = 0;
  for (int b = 0; b < bits; ++b) o |= ((r >> b) & 1) << (bits - 1 - b);
  return o;
}

// In-register 2^LR-point DFT of v[q + S r] (r < 2^LR), natural order in and
// out: radix-2 decimation in frequency, then a bit reversal of the slots
// (a renaming of registers).  q must be a compile-time constant.
template <int LR, int S>
__device__ __forceinline__ void dft(float2 (&v)[16], int q) {
  constexpr int R = 1 << LR;
#pragma unroll
  for (int s = LR - 1; s >= 0; --s) {
    const int m = 1 << s;
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {
      const int k = j & (m - 1);
      const int i0 = q + S * (((j >> s) << (s + 1)) + k);
      const int i1 = i0 + S * m;
      const float2 a = v[i0], c = v[i1];
      v[i0] = make_float2(a.x + c.x, a.y + c.y);
      v[i1] = mul_w16(make_float2(a.x - c.x, a.y - c.y), k * (8 >> s));
    }
  }
  float2 t[R];
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = v[q + S * r];
#pragma unroll
  for (int r = 0; r < R; ++r) v[q + S * brev(r, LR)] = t[r];
}

template <int L>
struct Core {
  static_assert(L >= 8 && L <= 14, "n = 256 .. 16384");
  static constexpr int N = 1 << L;
  static constexpr int U = N >> 4;            // columns of a radix-16 pass
  static constexpr int RHO = L & 3;           // log2 R0, 0 if no remainder
  static constexpr int LR0 = RHO ? RHO : 4;   // log2 radix of the first pass
  static constexpr int MID_TOP = L - LR0;     // log2 M of the first middle
  static constexpr int FIRST_TW = ((1 << LR0) - 1) * (N >> LR0);

  // offset of middle pass log2 M = mL in the table (mL = 4: its length)
  __host__ __device__ static constexpr int tw_off(int mL) {
    int off = FIRST_TW;
    for (int m = MID_TOP; m > mL && m >= 8; m -= 4) off += 15 << (m - 4);
    return off;
  }
  static constexpr int TW_SIZE = tw_off(4);

  // slot of position p < N: p ^ (fft_bin(p) & 15)
  __device__ __forceinline__ static int swz(int p) {
    if constexpr (RHO == 0) return p ^ ((p >> (L - 4)) & 15);
    else
      return p ^ (((p >> (L - RHO)) | ((p >> (L - RHO - 4)) << RHO)) & 15);
  }

  // fft_pos(u) / 16 for u < U: the last pass's column of thread u
  __device__ __forceinline__ static int last_col(int u) {
    constexpr int D = 1 + (L - LR0) / 4;      // digits of a position
    int pos = 0, rem = L, rb = LR0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      rem -= rb;
      pos += (u & ((1 << rb) - 1)) << rem;
      u >>= rb;
      rb = 4;
    }
    return pos >> 4;
  }

  // First pass on v[i] = x[u + U i]; leaves position u + U i in v[i].
  __device__ __forceinline__ static void first_pass(
      float2 (&v)[16], int u, const float2* __restrict__ tw) {
    constexpr int R = 1 << LR0, S = 16 / R, Q = N >> LR0;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      dft<LR0, S>(v, q);
      const int t = u + U * q;
#pragma unroll
      for (int k = 1; k < R; ++k)
        v[q + S * k] = cmul(v[q + S * k], __ldg(tw + (k - 1) * Q + t));
    }
  }

  // Stores the first pass's output of thread u (u < U) into buf.
  __device__ __forceinline__ static void put_first(float2* buf,
                                                   const float2 (&v)[16],
                                                   int u) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if constexpr (RHO == 0) buf[(u ^ i) + U * i] = v[i];   // u < U
      else buf[swz(u + U * i)] = v[i];
    }
  }

  // The middle passes over one transform in buf, whose NT threads are
  // u0 < NT (columns u0 + NT w); a block-wide barrier after each.
  template <int NT>
  __device__ __forceinline__ static void middle(float2* buf,
                                                const float2* __restrict__ tw,
                                                int u0) {
#pragma unroll
    for (int mL = MID_TOP; mL >= 8; mL -= 4) {
      const int Q = 1 << (mL - 4);
      const float2* T = tw + tw_off(mL);
#pragma unroll 1
      for (int w = 0; w < U / NT; ++w) {
        const int c = u0 + NT * w;
        const int t = c & (Q - 1);
        const int base = ((c >> (mL - 4)) << mL) + t;
        int slot[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          // RHO == 0: the swizzle reads bits >= L-4 only, which r and t
          // leave alone, so one XOR serves the column
          if constexpr (RHO == 0) slot[r] = swz(base) + (r << (mL - 4));
          else slot[r] = swz(base + (r << (mL - 4)));
        }
        float2 v[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) v[r] = buf[slot[r]];
        dft<4, 1>(v, 0);
#pragma unroll
        for (int k = 1; k < 16; ++k)
          v[k] = cmul(v[k], __ldg(T + (k - 1) * Q + t));
#pragma unroll
        for (int k = 0; k < 16; ++k) buf[slot[k]] = v[k];
      }
      __syncthreads();
    }
  }

  // Last pass of thread u: v[k] = X[u + U k] (natural order).
  __device__ __forceinline__ static void last_pass(const float2* buf,
                                                   float2 (&v)[16], int u) {
    const int base = last_col(u) << 4;
    const int h = swz(base) & 15;              // the same for all 16 slots
#pragma unroll
    for (int r = 0; r < 16; ++r) v[r] = buf[base + (r ^ h)];
    dft<4, 1>(v, 0);
  }
};

}  // namespace fft_reg
