// Welch's two passes around kernel #4 (ops/psd.py::psd_welch on the FFT
// kernel's route): welch_frames_kernel writes #4's input planes, the
// windowed 50 %-overlapping segments of each channel, and
// welch_partial_kernel with welch_db_kernel turn #4's output planes into
// the summed, fftshifted power in dB.  They replace no TPU kernel: they
// replace the XLA glue around ops/pallas/fft.py::fft_pow2 in the JAX
// package's psd_welch (segments, window, complex cast, |X|^2, shift, sum
// over segments, dB), which the port had written as PyTorch tensor ops,
// each moving a full complex64 or float32 copy of the frame matrix.
//
// Bound on the H100: a few flops a value, so device memory bounds both.
// Framing reads the input once and writes two float32 planes of C nseg N
// values (4 x 2^26 float32 samples at N 4096: 1.07 GB read, 4.29 GB
// written, 1.60 ms at 3.35 TB/s); the power pass reads the two planes once
// (4.29 GB, 1.28 ms) and writes C N values.
//
// Design.  Framing: with hop = N / 2, segment s is the half-segments H_s
// and H_{s+1} of its channel, so a thread loads a 16-byte group of H_k
// once and stores it, windowed, twice: into row k's first half and row
// k - 1's second half.  Every input byte is read from device memory once,
// the window (N floats) stays in L1, and every store is a whole 16-byte
// group (real input stores its zero imaginary plane in the same pass).
// Power: a block sums |Y|^2 over a fixed range of segments, 4 bins a
// thread with 16-byte loads, four segments' loads in flight before their
// sums, and writes one row of partial sums; the ranges split the segment
// axis so that a call of 4 channels still fills the card.  A second
// kernel adds each bin's partials in range order, scales by 1/N,
// fftshifts by output index and takes 10 log10(S + 1e-30).  The ranges
// come from the shapes alone and no sum uses atomics, so a call is
// bit-identical from run to run and from card to card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FR_THREADS = 256;
constexpr int FR_GROUPS = 4;      // 16-byte groups of a half-segment a thread
constexpr int PW_THREADS = 256;   // at most; N / 4 below N = 1024
constexpr int PW_SEGS = 4;        // segments whose loads are in flight
constexpr int DB_THREADS = 256;
constexpr int MAX_GRID_YZ = 65535;

__device__ __forceinline__ float4 mul4(float4 a, float4 w) {
  return make_float4(a.x * w.x, a.y * w.y, a.z * w.z, a.w * w.w);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Samples p..p+3 of a channel's row xc, as re and im groups.  VEC: the
// row's groups are 16-byte aligned (16-byte loads); otherwise one load a
// float.
template <bool CPLX, bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ xc,
                                      long long p, float4& r, float4& i) {
  if (CPLX) {
    const float* q = xc + 2 * p;
    float4 a, b;
    if (VEC) {
      a = __ldg(reinterpret_cast<const float4*>(q));
      b = __ldg(reinterpret_cast<const float4*>(q + 4));
    } else {
      a = make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
      b = make_float4(__ldg(q + 4), __ldg(q + 5), __ldg(q + 6),
                      __ldg(q + 7));
    }
    r = make_float4(a.x, a.z, b.x, b.z);
    i = make_float4(a.y, a.w, b.y, b.w);
  } else {
    const float* q = xc + p;
    r = VEC ? __ldg(reinterpret_cast<const float4*>(q))
            : make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
    i = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// x (C, n) float32 or complex64 (interleaved); w (N,); re, im (C nseg, N).
// Group g of a channel is samples 4 g..4 g + 3: half-segment k = g / q,
// columns j..j+3 with j = 4 (g % q), q = N / 8 groups a half-segment.
template <bool CPLX, bool VEC>
__global__ void __launch_bounds__(FR_THREADS)
welch_frames_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ re, float* __restrict__ im, int C,
                    long long n, int nseg, int lq) {
  const int q = 1 << lq;
  const int hop = 4 * q, N = 8 * q;
  const long long G = (long long)(nseg + 1) << lq;   // groups a channel
  const long long g0 =
      (long long)blockIdx.x * (FR_THREADS * FR_GROUPS) + threadIdx.x;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = blockIdx.y; c < C; c += gridDim.y) {
    const float* xc = x + (CPLX ? 2 : 1) * (long long)c * n;
    float* rc = re + (long long)c * nseg * N;
    float* ic = im + (long long)c * nseg * N;
    float4 vr[FR_GROUPS], vi[FR_GROUPS];
#pragma unroll
    for (int u = 0; u < FR_GROUPS; ++u) {   // every load before any store
      const long long g = g0 + u * FR_THREADS;
      vr[u] = vi[u] = zero;
      if (g < G) load4<CPLX, VEC>(xc, 4 * g, vr[u], vi[u]);
    }
#pragma unroll
    for (int u = 0; u < FR_GROUPS; ++u) {
      const long long g = g0 + u * FR_THREADS;
      if (g >= G) break;
      const long long k = g >> lq;
      const int j = 4 * (int)(g & (q - 1));
      if (k < nseg) {            // row k, first half
        const float4 wl = __ldg(reinterpret_cast<const float4*>(w + j));
        const long long o = k * N + j;
        st4(rc + o, mul4(vr[u], wl));
        st4(ic + o, CPLX ? mul4(vi[u], wl) : zero);
      }
      if (k > 0) {               // row k - 1, second half
        const float4 wh =
            __ldg(reinterpret_cast<const float4*>(w + hop + j));
        const long long o = (k - 1) * N + hop + j;
        st4(rc + o, mul4(vr[u], wh));
        st4(ic + o, CPLX ? mul4(vi[u], wh) : zero);
      }
    }
  }
}

__device__ __forceinline__ float4 add_power(float4 s, float4 a, float4 b) {
  s.x = fmaf(b.x, b.x, fmaf(a.x, a.x, s.x));
  s.y = fmaf(b.y, b.y, fmaf(a.y, a.y, s.y));
  s.z = fmaf(b.z, b.z, fmaf(a.z, a.z, s.z));
  s.w = fmaf(b.w, b.w, fmaf(a.w, a.w, s.w));
  return s;
}

// yr, yi (C nseg, N); part (C, P, N): part[c, p, k] = the sum over
// segments s of range p (p L <= s < min(nseg, (p + 1) L)), in order, of
// yr^2 + yi^2 at bin k.  Grid: (N / 4 / blockDim.x, P, channels).
__global__ void __launch_bounds__(PW_THREADS)
welch_partial_kernel(const float* __restrict__ yr,
                     const float* __restrict__ yi, float* __restrict__ part,
                     int C, int nseg, int lN, int L, int P) {
  const int col = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int p = blockIdx.y;
  const int s0 = p * L;
  const int s1 = min(nseg, s0 + L);
  for (int c = blockIdx.z; c < C; c += gridDim.z) {
    const long long base = ((long long)c * nseg << lN) + col;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int s = s0;
    for (; s + PW_SEGS <= s1; s += PW_SEGS) {
      float4 a[PW_SEGS], b[PW_SEGS];
#pragma unroll
      for (int u = 0; u < PW_SEGS; ++u) {
        const long long o = base + ((long long)(s + u) << lN);
        a[u] = __ldcs(reinterpret_cast<const float4*>(yr + o));
        b[u] = __ldcs(reinterpret_cast<const float4*>(yi + o));
      }
#pragma unroll
      for (int u = 0; u < PW_SEGS; ++u) acc = add_power(acc, a[u], b[u]);
    }
    for (; s < s1; ++s) {
      const long long o = base + ((long long)s << lN);
      acc = add_power(acc, __ldcs(reinterpret_cast<const float4*>(yr + o)),
                      __ldcs(reinterpret_cast<const float4*>(yi + o)));
    }
    st4(part + (((long long)c * P + p) << lN) + col, acc);
  }
}

// out (C, N): out[c, i] = 10 log10(S[c, (i + N/2) % N] / N + 1e-30), S
// the partials of part[c, :, k] added in range order.
__global__ void __launch_bounds__(DB_THREADS)
welch_db_kernel(const float* __restrict__ part, float* __restrict__ out,
                int C, int P, int lN) {
  const int N = 1 << lN;
  const long long i = (long long)blockIdx.x * DB_THREADS + threadIdx.x;
  if (i >= ((long long)C << lN)) return;
  const long long c = i >> lN;
  const int k = ((int)(i & (N - 1)) + N / 2) & (N - 1);
  const float* q = part + ((c * P) << lN) + k;
  float s = 0.0f;
  for (int p = 0; p < P; ++p) s += q[(long long)p << lN];
  out[i] = 10.0f * log10f(s * (1.0f / (float)N) + 1e-30f);
}

template <bool CPLX>
void launch_frames(bool vec, dim3 grid, const float* x, const float* w,
                   float* re, float* im, int C, long long n, int nseg, int lq,
                   cudaStream_t stream) {
  if (vec)
    welch_frames_kernel<CPLX, true><<<grid, FR_THREADS, 0, stream>>>(
        x, w, re, im, C, n, nseg, lq);
  else
    welch_frames_kernel<CPLX, false><<<grid, FR_THREADS, 0, stream>>>(
        x, w, re, im, C, n, nseg, lq);
}

}  // namespace

// x (C, n) float32 (cplx 0) or complex64 (cplx 1), w (N,) float32 16-byte
// aligned, re and im (C nseg, N) float32; N = 2^log2n, 2^8..2^14, and
// (nseg + 1) N / 2 <= n.  Returns cudaGetLastError() after the launch.
extern "C" int welch_frames_f32(const float* x, const float* w, float* re,
                                float* im, int C, long long n, int nseg,
                                int log2n, int cplx, cudaStream_t stream) {
  if (log2n < 8 || log2n > 14 || C < 1 || nseg < 1 ||
      ((long long)(nseg + 1) << (log2n - 1)) > n ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int lq = log2n - 3;
  const long long G = (long long)(nseg + 1) << lq;
  const long long per = FR_THREADS * FR_GROUPS;
  const dim3 grid((unsigned)((G + per - 1) / per),
                  (unsigned)(C < MAX_GRID_YZ ? C : MAX_GRID_YZ));
  // a row's groups are 16-byte aligned when the base is and a row's
  // length keeps them so (4 floats, or 2 complex samples)
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   n % (cplx ? 2 : 4) == 0;
  if (cplx)
    launch_frames<true>(vec, grid, x, w, re, im, C, n, nseg, lq, stream);
  else
    launch_frames<false>(vec, grid, x, w, re, im, C, n, nseg, lq, stream);
  return (int)cudaGetLastError();
}

// yr, yi (C nseg, N) float32, part (C, P, N) float32 scratch, out (C, N)
// float32; N = 2^log2n, 2^8..2^14; the segments cut into P ranges of L
// (ops/kernels/welch.py power_ranges).  Returns cudaGetLastError() after
// the second launch, or the first launch's error.
extern "C" int welch_power_f32(const float* yr, const float* yi, float* part,
                               float* out, int C, int nseg, int log2n, int L,
                               int P, cudaStream_t stream) {
  if (log2n < 8 || log2n > 14 || C < 1 || nseg < 1 || L < 1 || P < 1 ||
      P > MAX_GRID_YZ || (long long)(P - 1) * L >= nseg ||
      (long long)P * L < nseg)
    return (int)cudaErrorInvalidValue;
  const int quads = 1 << (log2n - 2);                // bins / 4
  const int threads = quads < PW_THREADS ? quads : PW_THREADS;
  const dim3 grid((unsigned)(quads / threads), (unsigned)P,
                  (unsigned)(C < MAX_GRID_YZ ? C : MAX_GRID_YZ));
  welch_partial_kernel<<<grid, threads, 0, stream>>>(yr, yi, part, C, nseg,
                                                     log2n, L, P);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)C << log2n;
  welch_db_kernel<<<(unsigned)((total + DB_THREADS - 1) / DB_THREADS),
                    DB_THREADS, 0, stream>>>(part, out, C, P, log2n);
  return (int)cudaGetLastError();
}
