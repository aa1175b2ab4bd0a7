// Kernel #11: kernel #3 on one time shard of a (chan, time) mesh, with the
// overlap halo exchanged inside the kernel.  Replaces the fused-halo branch
// of ops/pallas/chain.py::fir_periodogram4096 (halo_axis=..., the JAX
// package's make_async_remote_copy of each shard's input tail into its
// right neighbour's VMEM).  The spectrum is chain_frames (chain_body.cuh),
// the same code as #3; this file adds the exchange.
//
// Push/flag protocol.  Shard t of a row of T shards, call epoch e, slot
// s = e & 1.  Its receive slot recv[s] (C x P samples, ingest dtype) and
// flags flag[s] (C words) live on its own device.
//
//   push   Block (0, c) of shard t < T - 1 first copies channel c's input
//          tail, the last P = (D - 1) * 128 samples, into the right
//          neighbour's recv[s] row c through a peer pointer (16-byte
//          stores), fences at system scope, and thread 0 stores e into
//          the neighbour's flag[s][c] with st.release.sys.  The last shard
//          pushes nothing (the JAX ring wraps its tail to shard 0, which
//          discards it).
//   wait   Block (0, c) of shard t > 0, the only block that reads the
//          history (a channel's first frame), pushes first, then acquires
//          its own flag[s][c] with ld.acquire.sys until it reads e, and
//          loads the history from recv[s] row c through L2 (ld.global.cg).
//          Shard 0 reads the caller's hist0, or zeros.
//
// Every block that waits has pushed already, and waits only on a shard to
// its left, so the chain of waits ends at shard 0, which never waits: no
// cycle.  On one card the wrapper launches a row's shards in time order on
// one stream, so a waiting shard's left neighbour has finished before it
// starts and no waiting block holds SMs a publisher needs.  On several
// cards each device's stream carries its shards in time order, and a
// shard's stream waits for its left neighbour's launch, so a wait lasts
// about one kernel start.  A wait that has not seen its flag after 10 s
// traps: a broken exchange fails the launch instead of hanging the card.
//
// Why the slots alternate by epoch parity.  Flags carry the epoch, so a
// flag left by an earlier call (or zero, from allocation) never satisfies
// a later wait; buffers and flags belong to one mesh row, so other meshes
// cannot write them.  Call e writes slot e & 1 of its neighbour; the last
// reader of that slot was call e - 2.  Where shards sit on several
// streams, the wrapper makes the pushing shard's stream wait for the
// event recorded after its neighbour's kernel of call e - 2, so a call may
// run beside the one before it but never overwrites a slot its neighbour
// has not read yet.  On one stream the launch order gives that for free.
//
// Bound on the H100: #3's (140-570 flop per input byte, FMA- and
// shared-memory-issue bound), plus P samples a channel read and written
// once more for the push.
#include "chain_body.cuh"

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr unsigned long long WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;

// recv/flag: this shard's slot (null on shard 0: history from hist0);
// peer_recv/peer_flag: the right neighbour's slot (null on the last shard).
template <typename T>
__global__ void __launch_bounds__(FIR_THREADS, 3)
chain_halo_kernel(const T* __restrict__ x, const T* __restrict__ hist0,
                  const T* recv, const unsigned* flag, T* peer_recv,
                  unsigned* peer_flag, const float* __restrict__ taps,
                  float* __restrict__ out, long long N, int kp, int P,
                  int hist0_len, int hist0_stride, unsigned epoch,
                  int frames_per_block) {
  const int c = blockIdx.y;
  if (blockIdx.x == 0 && P > 0) {
    if (peer_recv != nullptr) {
      const uint4* src =
          reinterpret_cast<const uint4*>(x + (long long)c * N + (N - P));
      uint4* dst = reinterpret_cast<uint4*>(peer_recv + (long long)c * P);
      const int nvec = (int)(P * sizeof(T) / sizeof(uint4));
      for (int j = threadIdx.x; j < nvec; j += blockDim.x) dst[j] = src[j];
      __threadfence_system();
      __syncthreads();
      if (threadIdx.x == 0) st_release_sys(peer_flag + c, epoch);
    }
    if (recv != nullptr) {
      if (threadIdx.x == 0) {
        const unsigned* f = flag + c;
        const unsigned long long t0 = global_ns();
        while (ld_acquire_sys(f) != epoch) {
          __nanosleep(256);
          if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
        }
        __threadfence_system();
      }
      __syncthreads();
    }
  }
  // one inlined body: the history is the slot or the caller's hist0
  const bool from_left = recv != nullptr && P > 0;
  chain_frames<T, true>(x, from_left ? recv : hist0, taps, out, N, kp,
                        from_left ? P : hist0_len,
                        from_left ? P : hist0_stride, frames_per_block);
}

template <typename T>
static int launch(const void* x, const void* hist0, const void* recv,
                  const unsigned* flag, void* peer_recv, unsigned* peer_flag,
                  const float* taps, float* out, long long N, int C, int kp,
                  int P, int hist0_len, int hist0_stride, unsigned epoch,
                  int frames_per_block, cudaStream_t stream) {
  const int smem = chain_smem_bytes(kp);
  cudaFuncSetAttribute(chain_halo_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const long long frames = N / CH_N;
  dim3 grid((unsigned)((frames + frames_per_block - 1) / frames_per_block),
            (unsigned)C);
  chain_halo_kernel<T><<<grid, FIR_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(hist0),
      static_cast<const T*>(recv), flag, static_cast<T*>(peer_recv),
      peer_flag, taps, out, N, kp, P, hist0_len, hist0_stride, epoch,
      frames_per_block);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16, 2 int8, 3 int16 (x, hist0 and the slots).
// P: samples pushed per channel, a multiple of 128 and at most N; 0 turns
// the exchange off (D == 1).  Returns cudaErrorInvalidValue for an unknown
// dtype code.
extern "C" int fir_periodogram4096_halo(
    const void* x, const void* hist0, const void* recv, const unsigned* flag,
    void* peer_recv, unsigned* peer_flag, const float* taps, float* out,
    int dtype, long long N, int C, int kp, int P, int hist0_len,
    int hist0_stride, unsigned epoch, int frames_per_block,
    cudaStream_t stream) {
#define CHAIN_HALO_LAUNCH(T)                                                 \
  launch<T>(x, hist0, recv, flag, peer_recv, peer_flag, taps, out, N, C, kp, \
            P, hist0_len, hist0_stride, epoch, frames_per_block, stream)
  switch (dtype) {
    case 0: return CHAIN_HALO_LAUNCH(float);
    case 1: return CHAIN_HALO_LAUNCH(__nv_bfloat16);
    case 2: return CHAIN_HALO_LAUNCH(int8_t);
    case 3: return CHAIN_HALO_LAUNCH(int16_t);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CHAIN_HALO_LAUNCH
}

// Let device `dev` store into device `peer`'s memory (the push across
// cards).  Restores the calling thread's current device.  Returns 0 when
// access is enabled, or was already.
extern "C" int chain_halo_enable_peer(int dev, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  int can = 0;
  err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();   // reset the last-error state it set
      err = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)err;
}
