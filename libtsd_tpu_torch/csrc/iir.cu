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
// ridge: a fast kernel would be bound by device memory.  The frame form
// costs 64.5 + 2 kk useful FMA a sample and section (the Toeplitz's lower
// triangle, then W and S on the kk <= 8 state rows the section uses), and
// the hop is serial per channel.
//
// Design: a grid over (channel, chunk of FR = 64 frames), so that every
// SM has work (64 channels x 2^18 samples: 2048 blocks).  A block takes a
// virtual index from an atomic ticket in chunk-major order, so it only
// ever waits on a chunk whose ticket came earlier, i.e. on a block that is
// resident or done: no deadlock, whatever the hardware's block order.
// Per section, in each block:
//   (a) u_j = x_j . W for the chunk's frames, one warp per frame, lanes
//       over samples and a shuffle reduction (the kk columns in use);
//   (b) warp 0 takes the carry: chunk 0 from st_in, chunk b from chunk
//       b - 1's published end state; it runs the hop over the chunk's
//       frames one by one, the state in every lane's registers, row r of
//       M s_j one fmaf chain over q in the first port's order, on the kk
//       state rows the section uses (kk = 2 for a second-order section;
//       hop_chunk says why that keeps the bits); lane 0 then publishes
//       its end state (8 floats, __threadfence, then the flag set to the
//       call's epoch with st.release.gpu; the waiter spins on
//       ld.acquire.gpu and reads the state through L2); the last chunk
//       writes st_out;
//   (c) y_j = x_j T + s_j S, each warp eight frames, each thread outputs
//       i = g + 32 p, skipping the m-blocks of the zero triangle of T
//       (p < m / 32), in place: a warp reads only its own frames and writes
//       them after its sums are done.
// Section s + 1 of chunk b waits only on section s + 1 of chunk b - 1, so
// the sections pipeline across chunks and other resident blocks fill the
// SM while warp 0 hops.  There is no prefix over chunks through powers
// M^FR: every frame's arithmetic is the same wherever a call or a chunk
// starts, so a stream cut at any frame boundary is bit-identical to one
// call.  The flags carry a per-call epoch (the wrapper's, never 0), so a
// flag left by an earlier call, or the zeroed workspace, never satisfies
// a wait; the ticket is zeroed on the stream before each launch.  A wait
// that has not seen its flag after 10 s traps instead of hanging the card.
#include <cuda_runtime.h>

namespace {
constexpr int L = 128;
constexpr int KP = 8;
constexpr int FR = 64;        // frames per chunk
constexpr int THREADS = 256;  // 8 warps
constexpr unsigned long long WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_gpu(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
}  // namespace

// (b) of one section for one chunk, run by every lane of warp 0 alike: the
// carry in (st_in, or chunk b - 1's published end state), the hop over
// the chunk's frames, the carry out.  Only the first KK >= kk state rows
// are carried, where rows and columns kk.. of M are zero (and the columns
// of W, the rows of S): every fmaf left out adds an exact +-0 to a sum that
// is never -0, so rows < KK keep the bits of the full 8 x 8 fmaf chain,
// and rows >= KK are +0 from the first frame on, as the full hop makes
// them.  Row r of M s_j is summed q = 0, 1, ... in one fmaf chain, as the
// first port's kernel did.
template <int KK>
__device__ __forceinline__ void hop_chunk(
    int lane, int b, int nchunk, int nfc, const float* __restrict__ Ms,
    const float* __restrict__ s_in, const float* u, float* sst,
    const unsigned* flag_in, const float* carry_in, unsigned* flag_out,
    float* carry_out, float* __restrict__ st_out, unsigned epoch) {
  // M in registers up to 4 x 4; an 8 x 8 M (a section of order > 4) is
  // read from L1 each frame, so that the kernel stays within 64 registers
  constexpr int KR = KK <= 4 ? KK : 1;
  float Mr[KR][KR], sv[KK];
#pragma unroll
  for (int r = 0; r < KR; ++r)
#pragma unroll
    for (int q = 0; q < KR; ++q) Mr[r][q] = __ldg(Ms + r * KP + q);
  if (b == 0) {
#pragma unroll
    for (int r = 0; r < KK; ++r) sv[r] = s_in[r];
  } else {
    if (lane == 0) {
      const unsigned long long t0 = global_ns();
      while (ld_acquire_gpu(flag_in) != epoch) {
        __nanosleep(32);
        if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < KK; ++r) sv[r] = __ldcg(carry_in + r);
  }
  float un[KK];                 // u of the next frame, loaded a frame early
#pragma unroll
  for (int r = 0; r < KK; ++r) un[r] = u[r];
#pragma unroll 4
  for (int j = 0; j < nfc; ++j) {
    float uc[KK];
#pragma unroll
    for (int r = 0; r < KK; ++r) {
      uc[r] = un[r];
      un[r] = u[(j + 1 < nfc ? j + 1 : j) * KP + r];
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < KK; r += 2)
        *reinterpret_cast<float2*>(sst + j * KP + r) =
            make_float2(sv[r], sv[r + 1]);
    }
    float nv[KK];
#pragma unroll
    for (int r = 0; r < KK; ++r) {
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < KK; ++q)
        a = fmaf(KK <= 4 ? Mr[r % KR][q % KR] : __ldg(Ms + r * KP + q), sv[q],
                 a);
      nv[r] = a + uc[r];
    }
#pragma unroll
    for (int r = 0; r < KK; ++r) sv[r] = nv[r];
  }
  if (lane == 0) {
    float* dst = b + 1 < nchunk ? carry_out : st_out;
#pragma unroll
    for (int r = 0; r < KP; ++r) __stcg(dst + r, r < KK ? sv[r] : 0.f);
    if (b + 1 < nchunk) {
      __threadfence();
      st_release_gpu(flag_out, epoch);
    }
  }
}

// (a) of one section: u_j = x_j . W for the chunk's frames, on W's first
// KK >= kk columns (the others are zero, and u there +0, as the full sum
// makes it): each warp two frames at a time, lane l summing samples
// l + 32 q in q order, then an xor butterfly; W's columns in registers.
template <int KK>
__device__ __forceinline__ void frame_updates(const float* buf,
                                              const float* __restrict__ Ws,
                                              float* u, int nfc, int warp,
                                              int lane) {
  float wr[L / 32][KK];
#pragma unroll
  for (int q = 0; q < L / 32; ++q)
#pragma unroll
    for (int r = 0; r < KK; ++r) wr[q][r] = __ldg(Ws + (lane + 32 * q) * KP + r);
  for (int j = warp; j < nfc; j += 2 * (THREADS / 32)) {
    const int j2 = j + THREADS / 32;
    const bool two = j2 < nfc;
    float acc[2][KK];
#pragma unroll
    for (int r = 0; r < KK; ++r) acc[0][r] = acc[1][r] = 0.f;
#pragma unroll
    for (int q = 0; q < L / 32; ++q) {
      const float x0 = buf[j * L + lane + 32 * q];
      const float x1 = two ? buf[j2 * L + lane + 32 * q] : 0.f;
#pragma unroll
      for (int r = 0; r < KK; ++r) {
        acc[0][r] = fmaf(x0, wr[q][r], acc[0][r]);
        acc[1][r] = fmaf(x1, wr[q][r], acc[1][r]);
      }
    }
#pragma unroll
    for (int r = 0; r < KK; ++r) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        acc[0][r] += __shfl_xor_sync(0xffffffffu, acc[0][r], o);
        acc[1][r] += __shfl_xor_sync(0xffffffffu, acc[1][r], o);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < KP; ++r) {
        u[j * KP + r] = r < KK ? acc[0][r] : 0.f;
        if (two) u[j2 * KP + r] = r < KK ? acc[1][r] : 0.f;
      }
    }
  }
}

// ws: the ticket (and 3 words of padding), then C * nchunk * nsec flags,
// then as many 8-float carries, the end state of chunk b, section s of
// channel c at (c * nchunk + b) * nsec + s (ops/kernels/iir.py's
// workspace_words sizes it).
__global__ void __launch_bounds__(THREADS, 4)
iir_cascade_kernel(const float* __restrict__ x, const float* __restrict__ T,
                   const float* __restrict__ S, const float* __restrict__ W,
                   const float* __restrict__ M, const float* __restrict__ st_in,
                   float* __restrict__ y, float* __restrict__ st_out,
                   long long N, int C, int nsec, int nchunk,
                   unsigned* __restrict__ ticket, unsigned* __restrict__ flags,
                   float* __restrict__ carries, unsigned epoch) {
  extern __shared__ __align__(16) float sm[];
  float* buf = sm;                       // FR * L
  float* u = buf + FR * L;               // FR * KP
  float* sst = u + FR * KP;              // FR * KP
  float* hp = sst + FR * KP;             // nsec * 2L: hp[L + d] = h[d]
  __shared__ unsigned s_tk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* kk = reinterpret_cast<int*>(hp + nsec * 2 * L);   // nsec
  if (tid == 0) s_tk = atomicAdd(ticket, 1u);
  for (int e = tid; e < nsec; e += THREADS) kk[e] = 0;
  __syncthreads();
  for (int e = tid; e < nsec * 2 * L; e += THREADS) {
    const int s = e / (2 * L);
    const int d = e - s * 2 * L - L;
    hp[e] = d >= 0 ? T[(long long)s * L * L + d] : 0.f;
  }
  // kk[s]: the state rows that section s uses (rows and columns of M,
  // columns of W, rows of S beyond it are zero): each thread one element
  // of M and four each of W and S (loads issued together), then a maximum
  // per warp and one atomic a warp
  static_assert(KP * KP <= THREADS && L * KP == 4 * THREADS, "scan layout");
  for (int s = 0; s < nsec; ++s) {
    const float mv = tid < KP * KP ? __ldg(M + (long long)s * KP * KP + tid)
                                   : 0.f;
    const float4 wv = __ldg(reinterpret_cast<const float4*>(
                                W + (long long)s * L * KP) + tid);
    const float4 sv = __ldg(reinterpret_cast<const float4*>(
                                S + (long long)s * KP * L) + tid);
    int m = mv != 0.f ? max(tid / KP, tid % KP) + 1 : 0;
    const int wc = (4 * tid) % KP;              // W: columns wc .. wc + 3
    if (wv.x != 0.f) m = max(m, wc + 1);
    if (wv.y != 0.f) m = max(m, wc + 2);
    if (wv.z != 0.f) m = max(m, wc + 3);
    if (wv.w != 0.f) m = max(m, wc + 4);
    if (sv.x != 0.f || sv.y != 0.f || sv.z != 0.f || sv.w != 0.f)
      m = max(m, 4 * tid / L + 1);              // S: row (4 tid) / L
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0 && m > 0) atomicMax(kk + s, m);
  }
  __syncthreads();
  const int b = (int)(s_tk / (unsigned)C);
  const int c = (int)(s_tk % (unsigned)C);
  const long long nfr = N / L;
  const long long f0 = (long long)b * FR;
  const int nfc = (int)(nfr - f0 < FR ? nfr - f0 : FR);
  const float* xc = x + (long long)c * N + f0 * L;
  float* yc = y + (long long)c * N + f0 * L;
  {
    const float4* src = reinterpret_cast<const float4*>(xc);
    float4* d = reinterpret_cast<float4*>(buf);
    for (int e = tid; e < FR * L / 4; e += THREADS)
      d[e] = e < nfc * L / 4 ? src[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const long long slot = ((long long)c * nchunk + b) * nsec;
  for (int s = 0; s < nsec; ++s) {
    const float* Ws = W + (long long)s * L * KP;
    const float* Ss = S + (long long)s * KP * L;
    const float* hs = hp + s * 2 * L;
    const int ks = kk[s];
    // (a) input -> state update of each frame (columns r >= ks of W are 0)
    if (ks <= 2)
      frame_updates<2>(buf, Ws, u, nfc, warp, lane);
    else if (ks <= 4)
      frame_updates<4>(buf, Ws, u, nfc, warp, lane);
    else
      frame_updates<8>(buf, Ws, u, nfc, warp, lane);
    __syncthreads();
    // (b) the carry in, the hop over the chunk's frames, the carry out
    if (warp == 0) {
      const float* Ms = M + (long long)s * KP * KP;
      const float* s_in = st_in + ((long long)c * nsec + s) * KP;
      const unsigned* fin = flags + slot - nsec + s;
      const float* cin = carries + (slot - nsec + s) * KP;
      float* sout = st_out + ((long long)c * nsec + s) * KP;
      if (ks <= 2)
        hop_chunk<2>(lane, b, nchunk, nfc, Ms, s_in, u, sst, fin, cin,
                     flags + slot + s, carries + (slot + s) * KP, sout, epoch);
      else if (ks <= 4)
        hop_chunk<4>(lane, b, nchunk, nfc, Ms, s_in, u, sst, fin, cin,
                     flags + slot + s, carries + (slot + s) * KP, sout, epoch);
      else
        hop_chunk<8>(lane, b, nchunk, nfc, Ms, s_in, u, sst, fin, cin,
                     flags + slot + s, carries + (slot + s) * KP, sout, epoch);
    }
    __syncthreads();
    // (c) in-frame Toeplitz (lower triangle) + state -> output, in place
    {
      const int g = lane;              // outputs i = g + 32 p
      const int j0 = warp * 8;         // frames j0 .. j0 + 7
      if (j0 < nfc) {
        float acc[8][4];
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int p = 0; p < 4; ++p) acc[q][p] = 0.f;
        // m in [32 mb, 32 mb + 32) reaches only outputs i >= m: p >= mb
        // (for p == mb the zero-padded h covers i < m)
#pragma unroll
        for (int mb = 0; mb < 4; ++mb) {
          for (int m = 32 * mb; m < 32 * mb + 32; m += 4) {
            float hv[4][4];            // hv[p][t] = h[g + 32 p - m - t]
#pragma unroll
            for (int p = mb; p < 4; ++p)
#pragma unroll
              for (int t = 0; t < 4; ++t) hv[p][t] = hs[L + g + 32 * p - m - t];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const float4 xv =
                  *reinterpret_cast<const float4*>(buf + (j0 + q) * L + m);
#pragma unroll
              for (int p = mb; p < 4; ++p) {
                acc[q][p] = fmaf(hv[p][0], xv.x, acc[q][p]);
                acc[q][p] = fmaf(hv[p][1], xv.y, acc[q][p]);
                acc[q][p] = fmaf(hv[p][2], xv.z, acc[q][p]);
                acc[q][p] = fmaf(hv[p][3], xv.w, acc[q][p]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < KP; ++r) {
          if (r >= ks) break;
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
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int p = 0; p < 4; ++p) buf[(j0 + q) * L + g + 32 * p] = acc[q][p];
      }
    }
    __syncthreads();
  }
  float4* dst = reinterpret_cast<float4*>(yc);
  const float4* cs = reinterpret_cast<const float4*>(buf);
  for (int e = tid; e < nfc * L / 4; e += THREADS) dst[e] = cs[e];
}

extern "C" int iir_cascade_f32(const float* x, const float* T, const float* S,
                               const float* W, const float* M,
                               const float* st_in, float* y, float* st_out,
                               int C, long long N, int nsec, unsigned* ws,
                               unsigned epoch, cudaStream_t stream) {
  const long long nchunk = (N / L + FR - 1) / FR;
  const long long nslot = (long long)C * nchunk * nsec;
  unsigned* flags = ws + 4;
  float* carries = reinterpret_cast<float*>(flags + nslot);
  const int smem =
      (FR * L + 2 * FR * KP + nsec * 2 * L + nsec) * (int)sizeof(float);
  cudaFuncSetAttribute(iir_cascade_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaError_t e = cudaMemsetAsync(ws, 0, sizeof(unsigned), stream);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)(C * nchunk);
  iir_cascade_kernel<<<blocks, THREADS, smem, stream>>>(
      x, T, S, W, M, st_in, y, st_out, N, C, nsec, (int)nchunk, ws, flags,
      carries, epoch);
  return (int)cudaGetLastError();
}
