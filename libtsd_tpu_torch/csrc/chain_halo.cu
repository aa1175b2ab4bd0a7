// Kernel #11: kernel #3 on one time shard of a (chan, time) mesh, with the
// overlap halo exchanged inside the kernel.  Replaces the fused-halo branch
// of ops/pallas/chain.py::fir_periodogram4096 (halo_axis=..., the JAX
// package's make_async_remote_copy of each shard's input tail into its
// right neighbour's VMEM).  The spectrum is #3's code; this file and
// chain_wg.cu's kHalo form add the exchange.  Like #3, the tiers with one
// tap plane (passes 1-2) at K <= chain_wg::K_MAX take chain_wg.cu's
// persistent wgmma pipeline (chain_wg::chain_halo_kernel), the others
// chain::chain_frames (chain_halo_kernel below); the route depends on
// (dtype, passes, K) alone.
//
// Push/flag protocol.  Shard t of a row of T shards, call epoch e, slot
// s = e & 1.  Its receive slot recv[s] (C x P samples, ingest dtype) and
// flags flag[s] (C words) live on its own device.
//
//   push   Each channel c of shard t < T - 1 is pushed by one block, in
//          its prologue: it copies the channel's input tail, the last P =
//          (D - 1) * 128 samples, into the right neighbour's recv[s] row c
//          through a peer pointer (16-byte stores), fences at system
//          scope, and stores e into the neighbour's flag[s][c] with
//          st.release.sys (chain::push_tails).  chain_frames: block (0,
//          c); the wgmma body: persistent block b of G pushes channels
//          [C b / G, C (b + 1) / G).  The last shard pushes nothing (the
//          JAX ring wraps its tail to shard 0, which discards it).
//   wait   On shard t > 0, whoever reads a channel's history (a channel's
//          first frame) first acquires its own flag[s][c] with
//          ld.acquire.sys until it reads e (chain::wait_flag), then loads
//          the history from recv[s] row c through L2 (ld.global.cg).
//          chain_frames: block (0, c) after its push; the wgmma body: the
//          FIR warpgroup whose pair slot is the channel's first, before
//          it splits the window.  Shard 0 reads the caller's hist0, or
//          zeros.
//
// Every block pushes before any of its waits, and waits only on a shard to
// its left, so the chain of waits ends at shard 0, which never waits: no
// cycle.  On one card the wrapper launches a row's shards in time order on
// one stream, so a waiting shard's left neighbour has finished before it
// starts and no waiting block holds SMs a publisher needs.  On several
// cards each device's stream carries its shards in time order, and a
// shard's stream waits for its left neighbour's launch, so a wait lasts
// about one kernel start.  A wait that has not seen its flag after
// wait_ns traps: a broken exchange fails the launch instead of hanging the
// card (the wrapper passes 10 s where the neighbours start together, and
// the row group's timeout where a late neighbour's host is waited for
// inside this kernel).
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
// Across processes.  A mesh row may span several processes on one host
// (one per card, or several sharing a card).  The receive slot (and flags)
// of a process's first shard is then one cudaMalloc segment that it
// exports with cudaIpcGetMemHandle; the process on its left maps it with
// cudaIpcOpenMemHandle and its last shard pushes there as above.  The
// protocol and this kernel do not change: the flags are acquired and
// released at system scope already.  The calls of the processes are
// ordered from the host, so that call e writes a slot only after its
// reader of call e - 2 is done (see ops/kernels/chain_halo.py): on
// distinct cards by the row's all-reduce of each call's spectra, which
// completes after every rank's kernel of the call and before the next one
// starts (the sharded chain), or else by a row barrier each call; where
// the processes share a card, each shard also starts after its left
// neighbour's kernel has finished.  Without the barrier a shard whose left
// neighbour starts late spins on its flag inside this kernel.
//
// Bound on the H100: #3's (the tensor-core FIR of the bf16 tiers, the fp32
// FMAs of "highest"; chain_body.cuh), plus P samples a channel read and
// written once more for the push.
#include "chain_body.cuh"

// recv/flag: this shard's slot (null on shard 0: history from hist0);
// peer_recv/peer_flag: the right neighbour's slot (null on the last shard).
template <typename T, int kPasses>
__global__ void __launch_bounds__(chain::THREADS, chain::MIN_BLOCKS)
chain_halo_kernel(const T* __restrict__ x, const T* __restrict__ hist0,
                  const T* recv, const unsigned* flag, T* peer_recv,
                  unsigned* peer_flag, const float* __restrict__ taps,
                  const float2* __restrict__ tw, float* __restrict__ out,
                  long long N, int K, int P, int hist0_len, int hist0_stride,
                  long long wait_ns, unsigned epoch, int frames_per_block) {
  const int c = blockIdx.y;
  if (blockIdx.x == 0 && P > 0) {
    if (peer_recv != nullptr)
      chain::push_tails(x, N, P, c, c + 1, peer_recv, peer_flag, epoch);
    if (recv != nullptr) {
      if (threadIdx.x == 0) chain::wait_flag(flag + c, epoch, wait_ns);
      __syncthreads();
    }
  }
  // one inlined body: the history is the slot or the caller's hist0
  const bool from_left = recv != nullptr && P > 0;
  chain::chain_frames<T, kPasses, true>(
      x, from_left ? recv : hist0, taps, tw, out, N, K,
      from_left ? P : hist0_len, from_left ? P : hist0_stride,
      frames_per_block);
}

template <typename T, int kPasses>
static int launch(const void* x, const void* hist0, const void* recv,
                  const unsigned* flag, void* peer_recv, unsigned* peer_flag,
                  const float* taps, const float* tw, float* out, long long N,
                  int C, int K, int P, int hist0_len, int hist0_stride,
                  long long wait_ns, unsigned epoch, cudaStream_t stream) {
  const int smem =
      chain::smem_bytes(kPasses, K, (int)sizeof(T));
  cudaFuncSetAttribute(chain_halo_kernel<T, kPasses>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int fpb = 0;
  const dim3 grid = chain::grid_for(chain_halo_kernel<T, kPasses>, smem, C,
                                    N / chain::NF, &fpb);
  chain_halo_kernel<T, kPasses><<<grid, chain::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(hist0),
      static_cast<const T*>(recv), flag, static_cast<T*>(peer_recv),
      peer_flag, taps, reinterpret_cast<const float2*>(tw), out, N, K, P,
      hist0_len, hist0_stride, wait_ns, epoch, fpb);
  return (int)cudaGetLastError();
}

int chain_wg_halo_launch(const void* x, const void* hist0, const void* recv,
                         const unsigned* flag, void* peer_recv,
                         unsigned* peer_flag, const float* taps,
                         const float* tw, float* out, int dtype, int passes,
                         long long N, int C, int K, int P, int hist0_len,
                         int hist0_stride, long long wait_ns, unsigned epoch,
                         cudaStream_t stream);

// dtype and passes: as fir_periodogram4096 (chain.cu), the same pairs.
// P: samples pushed per channel, a multiple of 128 and at most N; 0 turns
// the exchange off (D == 1).  tw: ops/kernels/fft.py twiddles(12).
// wait_ns: how long a shard waits for its flag before it traps.
// Returns cudaErrorInvalidValue for a pair that does not exist.
extern "C" int fir_periodogram4096_halo(
    const void* x, const void* hist0, const void* recv, const unsigned* flag,
    void* peer_recv, unsigned* peer_flag, const float* taps, const float* tw,
    float* out, int dtype, int passes, long long N, int C, int K, int P,
    int hist0_len, int hist0_stride, long long wait_ns, unsigned epoch,
    cudaStream_t stream) {
  if (C <= 0 || N < chain::NF) return 0;
  const int wg = chain_wg_halo_launch(x, hist0, recv, flag, peer_recv,
                                      peer_flag, taps, tw, out, dtype, passes,
                                      N, C, K, P, hist0_len, hist0_stride,
                                      wait_ns, epoch, stream);
  if (wg >= 0) return wg;
#define CHAIN_HALO_LAUNCH(T, Q)                                              \
  launch<T, Q>(x, hist0, recv, flag, peer_recv, peer_flag, taps, tw, out, N, \
               C, K, P, hist0_len, hist0_stride, wait_ns, epoch, stream)
  switch (dtype * 4 + passes) {
    case 0: return CHAIN_HALO_LAUNCH(float, 0);
    case 2: return CHAIN_HALO_LAUNCH(float, 2);
    case 3: return CHAIN_HALO_LAUNCH(float, 3);
    case 5: return CHAIN_HALO_LAUNCH(__nv_bfloat16, 1);
    case 9: return CHAIN_HALO_LAUNCH(int8_t, 1);
    case 14: return CHAIN_HALO_LAUNCH(int16_t, 2);
    case 15: return CHAIN_HALO_LAUNCH(int16_t, 3);
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

// CUDA IPC for a receive slot that the process on the left pushes into.
// chain_halo_ipc_alloc: cudaMalloc `bytes` on device `dev`, zeroed, and
// its handle (cudaIpcMemHandle_t, 64 bytes) into `handle`.  The others
// open, close and free such a segment.  Each restores the calling thread's
// current device.
struct DeviceScope {
  int prev = 0;
  cudaError_t err;
  explicit DeviceScope(int dev) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(dev);
  }
  ~DeviceScope() { cudaSetDevice(prev); }
};

extern "C" int chain_halo_ipc_alloc(int dev, long long bytes, void** ptr,
                                    void* handle) {
  DeviceScope scope(dev);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaError_t err = cudaMalloc(ptr, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(*ptr, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return (int)err;
}

extern "C" int chain_halo_ipc_open(int dev, const void* handle, void** ptr) {
  DeviceScope scope(dev);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)cudaIpcOpenMemHandle(
      ptr, *static_cast<const cudaIpcMemHandle_t*>(handle),
      cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int chain_halo_ipc_close(int dev, void* ptr) {
  DeviceScope scope(dev);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int chain_halo_ipc_free(int dev, void* ptr) {
  DeviceScope scope(dev);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)cudaFree(ptr);
}
