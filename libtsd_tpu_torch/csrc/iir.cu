// Kernel #7: a cascade of IIR sections in frame state-space form.
// Replaces ops/pallas/iir.py::_kernel (via iir_cascade_pallas and
// IirCascadePallas): per section, the input -> state update of each
// 128-sample frame (x @ W), the k-dim state hop across frames
// (s_{j+1} = M s_j + u_j, the one sequential dependence), then the
// in-frame Toeplitz plus state -> output (y = x @ T + s_start @ S); the
// section's output feeds the next section in shared memory.
//
// Operators (the JAX wrapper's layout, float32): T (nsec, 128, 128) with
// T[s][m][i] = h_s[i - m] (zero for i < m), S (nsec, 8, 128), W (nsec, 128,
// 8), M (nsec, 8, 8), the state (C, nsec, 8) in the canonical coordinates,
// zero-padded beyond each section's order k <= 8.  T is the in-frame
// Toeplitz of the section's impulse response by construction
// (_iir_frame_mats), so the kernel reads its first row, h_s[0..127].
//
// Bound on the H100: 8 bytes a sample (x in, y out).  The least work is the
// direct-form recursion, ~9 flop a sample and section, far below the fp32
// ridge: a fast kernel would be bound by device memory.  This one is not
// yet: the frame form costs ~128 FMA a sample and section (the in-frame
// Toeplitz, done in full) and the hop is serial per channel.
//
// Design: one block per channel walks its frames in chunks of 64 (32 KB in
// shared memory, ping-pong with a second buffer across sections).  Per
// section: (1) u_j = x_j . W, one warp per frame, lanes over samples and a
// shuffle reduction; (2) the hop by one thread over the chunk's frames,
// the carry kept in shared memory across chunks; (3) y_j = x_j T + s_j S,
// each thread four outputs i = g + 32 p of eight frames, x read as float4
// broadcasts, h from a zero-padded copy.  All arithmetic of a frame is the
// same wherever a call starts, so a stream cut at frame boundaries is
// bit-identical to one call.  The TPU kernel's MXU matmuls and the
// (rows, 8) VMEM staging were TPU choices and are not carried over.  Blocks
// run in no order; nothing crosses channels.
#include <cuda_runtime.h>

namespace {
constexpr int L = 128;
constexpr int KP = 8;
constexpr int FR = 64;        // frames per chunk
constexpr int THREADS = 256;  // 8 warps
}  // namespace

__global__ void __launch_bounds__(THREADS)
iir_cascade_kernel(const float* __restrict__ x, const float* __restrict__ T,
                   const float* __restrict__ S, const float* __restrict__ W,
                   const float* __restrict__ M, const float* __restrict__ st_in,
                   float* __restrict__ y, float* __restrict__ st_out,
                   long long N, int nsec) {
  extern __shared__ __align__(16) float sm[];
  float* bufA = sm;                      // FR * L
  float* bufB = bufA + FR * L;           // FR * L
  float* u = bufB + FR * L;              // FR * KP
  float* sst = u + FR * KP;              // FR * KP
  float* carry = sst + FR * KP;          // nsec * KP
  float* hp = carry + nsec * KP;         // nsec * 2L: hp[L + d] = h[d]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = blockIdx.x;
  for (int e = tid; e < nsec * 2 * L; e += THREADS) {
    const int s = e / (2 * L);
    const int d = e - s * 2 * L - L;
    hp[e] = d >= 0 ? T[(long long)s * L * L + d] : 0.f;
  }
  for (int e = tid; e < nsec * KP; e += THREADS)
    carry[e] = st_in[(long long)c * nsec * KP + e];
  __syncthreads();
  const long long nfr = N / L;
  const float* xc = x + (long long)c * N;
  float* yc = y + (long long)c * N;
  for (long long f0 = 0; f0 < nfr; f0 += FR) {
    const int nfc = (int)(nfr - f0 < FR ? nfr - f0 : FR);
    const float4* src = reinterpret_cast<const float4*>(xc + f0 * L);
    float4* dA = reinterpret_cast<float4*>(bufA);
    for (int e = tid; e < FR * L / 4; e += THREADS)
      dA[e] = e < nfc * L / 4 ? src[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    float* cur = bufA;
    float* nxt = bufB;
    for (int s = 0; s < nsec; ++s) {
      const float* Ws = W + (long long)s * L * KP;
      const float* Ss = S + (long long)s * KP * L;
      const float* hs = hp + s * 2 * L;
      // (1) input -> state update of each frame
      for (int j = warp; j < nfc; j += THREADS / 32) {
        float acc[KP];
#pragma unroll
        for (int r = 0; r < KP; ++r) acc[r] = 0.f;
#pragma unroll
        for (int q = 0; q < L / 32; ++q) {
          const int i = lane + 32 * q;
          const float xv = cur[j * L + i];
#pragma unroll
          for (int r = 0; r < KP; ++r)
            acc[r] = fmaf(xv, __ldg(Ws + i * KP + r), acc[r]);
        }
#pragma unroll
        for (int r = 0; r < KP; ++r) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < KP; ++r) u[j * KP + r] = acc[r];
        }
      }
      __syncthreads();
      // (2) the state hop across the chunk's frames
      if (tid == 0) {
        float Mr[KP][KP], sv[KP];
#pragma unroll
        for (int r = 0; r < KP; ++r) {
          sv[r] = carry[s * KP + r];
#pragma unroll
          for (int q = 0; q < KP; ++q)
            Mr[r][q] = M[(long long)s * KP * KP + r * KP + q];
        }
        for (int j = 0; j < nfc; ++j) {
          float nv[KP];
#pragma unroll
          for (int r = 0; r < KP; ++r) {
            sst[j * KP + r] = sv[r];
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < KP; ++q) a = fmaf(Mr[r][q], sv[q], a);
            nv[r] = a + u[j * KP + r];
          }
#pragma unroll
          for (int r = 0; r < KP; ++r) sv[r] = nv[r];
        }
#pragma unroll
        for (int r = 0; r < KP; ++r) carry[s * KP + r] = sv[r];
      }
      __syncthreads();
      // (3) in-frame Toeplitz + state -> output
      {
        const int g = lane;              // outputs i = g + 32 p
        const int j0 = warp * 8;         // frames j0 .. j0 + 7
        float acc[8][4];
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int p = 0; p < 4; ++p) acc[q][p] = 0.f;
        if (j0 < nfc) {
          for (int m = 0; m < L; m += 4) {
            float hv[4][4];              // hv[p][t] = h[g + 32 p - m - t]
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
              for (int t = 0; t < 4; ++t) hv[p][t] = hs[L + g + 32 * p - m - t];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const float4 xv =
                  *reinterpret_cast<const float4*>(cur + (j0 + q) * L + m);
#pragma unroll
              for (int p = 0; p < 4; ++p) {
                acc[q][p] = fmaf(hv[p][0], xv.x, acc[q][p]);
                acc[q][p] = fmaf(hv[p][1], xv.y, acc[q][p]);
                acc[q][p] = fmaf(hv[p][2], xv.z, acc[q][p]);
                acc[q][p] = fmaf(hv[p][3], xv.w, acc[q][p]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < KP; ++r) {
            float sr[4];
#pragma unroll
            for (int p = 0; p < 4; ++p) sr[p] = __ldg(Ss + r * L + g + 32 * p);
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const float sv = sst[(j0 + q) * KP + r];
#pragma unroll
              for (int p = 0; p < 4; ++p) acc[q][p] = fmaf(sv, sr[p], acc[q][p]);
            }
          }
#pragma unroll
          for (int q = 0; q < 8; ++q)
#pragma unroll
            for (int p = 0; p < 4; ++p) nxt[(j0 + q) * L + g + 32 * p] = acc[q][p];
        }
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    float4* dst = reinterpret_cast<float4*>(yc + f0 * L);
    const float4* cs = reinterpret_cast<const float4*>(cur);
    for (int e = tid; e < nfc * L / 4; e += THREADS) dst[e] = cs[e];
    __syncthreads();
  }
  for (int e = tid; e < nsec * KP; e += THREADS)
    st_out[(long long)c * nsec * KP + e] = carry[e];
}

extern "C" int iir_cascade_f32(const float* x, const float* T, const float* S,
                               const float* W, const float* M,
                               const float* st_in, float* y, float* st_out,
                               int C, long long N, int nsec,
                               cudaStream_t stream) {
  const int smem =
      (2 * FR * L + 2 * FR * KP + nsec * KP + nsec * 2 * L) * (int)sizeof(float);
  cudaFuncSetAttribute(iir_cascade_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  iir_cascade_kernel<<<C, THREADS, smem, stream>>>(x, T, S, W, M, st_in, y,
                                                    st_out, N, nsec);
  return (int)cudaGetLastError();
}
