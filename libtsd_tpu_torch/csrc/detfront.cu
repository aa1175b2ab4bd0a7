// Kernel #10: the pattern detector's front end in one pass over complex x:
//
//     c[t]  = sum_{k < M} h[k] x[t - k]          complex correlation
//     en[t] = sum_{k < M} |x[t - k]|^2           window energy
//     sc[t] = sqrt(|c[t]|^2 / (en[t] + 1e-20))   raw normalised score
//
// written as four fp32 planes (cr, ci, en, sc), each (C, n).  Samples
// before the block come from the state (the last V inputs of the channel).
// Replaces ops/pallas/detfront.py::_detfront_jit (its _kernel: Karatsuba
// complex correlation and the energy as banded-Toeplitz bf16 hi/lo
// matmuls on the MXU, one grid step per 128-row tile).
//
// Bound on the H100: the function's least work (the correlation by
// overlap-save at ola_plan(M), ~130 flop a sample at M = 128, and the
// energy as a running sum) is bound by its 8 bytes in and 16 out a
// sample.  This kernel's direct form does about 10 M flop a sample (4 FMAs
// of the complex MAC and 1 of the window sum per tap): at M = 128, 1280
// flop per 24 bytes, 53 flop/byte, above the fp32 ridge of 20, so it is
// bound by FMA issue and the shared-memory loads that feed it; the direct
// form was chosen for its exact fp32 energy and simplicity.
//
// Design: one block per (channel, tile of DF_TILE outputs), blocks
// independent.  Taps come in chunks of up to DF_KC (zero-padded to a
// multiple of DF_TAP_QUANTUM; a second weight row, 1 for k < M and 0
// after, keeps the energy window exactly M long); for each chunk the block
// loads the tile plus its left context into shared memory (state, x or
// zeros past the end).  The MACs are register-blocked as fir_tile.cuh does
// them: lane l of warp w owns outputs 32 DF_R w + l + 32 r, taps are taken
// as k + 32 j, so DF_R + DF_J - 1 window loads and DF_J tap loads feed
// DF_R x DF_J complex MACs and window-sum terms, and |x|^2 is formed once
// per loaded sample.  The energy is a direct window sum, not a prefix-sum
// difference (that cancels badly in fp32).  fp32 throughout, where the
// JAX kernel's default tier is the bf16 hi/lo "split" (~1e-5).
#include <cuda_runtime.h>

constexpr int DF_THREADS = 256;
constexpr int DF_R = 8;                          // outputs per thread
constexpr int DF_J = 4;                          // tap blocking factor
constexpr int DF_TILE = DF_THREADS * DF_R;       // outputs per block
constexpr int DF_TAP_QUANTUM = 32 * DF_J;        // taps pad to a multiple
constexpr int DF_KC = 1024;                      // taps per chunk
static_assert(DF_KC % DF_TAP_QUANTUM == 0, "chunk / tap quantum");

__global__ void __launch_bounds__(DF_THREADS)
detfront_kernel(const float2* __restrict__ x, const float2* __restrict__ st,
                const float2* __restrict__ taps, float* __restrict__ cr,
                float* __restrict__ ci, float* __restrict__ en,
                float* __restrict__ sc, int n, int M, int Mp, int V) {
  __shared__ float2 s_win[DF_KC - 1 + DF_TILE];
  __shared__ float2 s_tap[DF_KC];
  __shared__ float s_we[DF_KC];
  const int c = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * DF_TILE;
  const float2* xc = x + (long long)c * n;
  const float2* sv = st + (long long)c * V;
  const int i0 = (threadIdx.x >> 5) * (32 * DF_R) + (threadIdx.x & 31);
  float accr[DF_R], acci[DF_R], acce[DF_R];
#pragma unroll
  for (int r = 0; r < DF_R; ++r) accr[r] = acci[r] = acce[r] = 0.0f;
  for (int kc0 = 0; kc0 < Mp; kc0 += DF_KC) {
    const int kcn = min(DF_KC, Mp - kc0);
    const int wlen = kcn - 1 + DF_TILE;
    const long long gw = t0 - kc0 - (kcn - 1);    // sample of s_win[0]
    __syncthreads();                               // last chunk consumed
    for (int k = threadIdx.x; k < kcn; k += blockDim.x) {
      s_tap[k] = taps[kc0 + k];
      s_we[k] = kc0 + k < M ? 1.0f : 0.0f;
    }
    for (int j = threadIdx.x; j < wlen; j += blockDim.x) {
      const long long g = gw + j;
      float2 v = make_float2(0.0f, 0.0f);
      if (g >= 0) {
        if (g < n) v = xc[g];
      } else if (g >= -V) {
        v = sv[V + g];
      }
      s_win[j] = v;
    }
    __syncthreads();
    const float2* base = s_win + (kcn - 1) + i0;
    for (int k0 = 0; k0 < 32; ++k0) {
      for (int jb = 0; jb < kcn / 32; jb += DF_J) {
        float2 h[DF_J];
        float we[DF_J];
#pragma unroll
        for (int j = 0; j < DF_J; ++j) {
          h[j] = s_tap[k0 + 32 * (jb + j)];
          we[j] = s_we[k0 + 32 * (jb + j)];
        }
        const float2* p = base - k0 - 32 * jb;
        float2 xv[DF_R + DF_J - 1];
        float e2[DF_R + DF_J - 1];
#pragma unroll
        for (int q = 0; q < DF_R + DF_J - 1; ++q) {
          xv[q] = p[32 * (q - (DF_J - 1))];
          e2[q] = fmaf(xv[q].x, xv[q].x, xv[q].y * xv[q].y);
        }
#pragma unroll
        for (int r = 0; r < DF_R; ++r) {
#pragma unroll
          for (int j = 0; j < DF_J; ++j) {
            const float2 v = xv[r - j + DF_J - 1];
            accr[r] = fmaf(h[j].x, v.x, accr[r]);
            accr[r] = fmaf(-h[j].y, v.y, accr[r]);
            acci[r] = fmaf(h[j].x, v.y, acci[r]);
            acci[r] = fmaf(h[j].y, v.x, acci[r]);
            acce[r] = fmaf(we[j], e2[r - j + DF_J - 1], acce[r]);
          }
        }
      }
    }
  }
  const long long o = (long long)c * n;
#pragma unroll
  for (int r = 0; r < DF_R; ++r) {
    const long long i = t0 + i0 + 32 * r;
    if (i < n) {
      cr[o + i] = accr[r];
      ci[o + i] = acci[r];
      en[o + i] = acce[r];
      sc[o + i] = sqrtf((accr[r] * accr[r] + acci[r] * acci[r])
                        / (acce[r] + 1e-20f));
    }
  }
}

extern "C" int detfront_f32(const float2* x, const float2* st,
                            const float2* taps, float* cr, float* ci,
                            float* en, float* sc, int C, int n, int M, int Mp,
                            int V, cudaStream_t stream) {
  const dim3 grid((unsigned)((n + DF_TILE - 1) / DF_TILE), (unsigned)C);
  detfront_kernel<<<grid, DF_THREADS, 0, stream>>>(x, st, taps, cr, ci, en,
                                                   sc, n, M, Mp, V);
  return (int)cudaGetLastError();
}
