// All-to-all exchange of G send buffers: recv_j[i] = send_i[j], where
// send_i is shard i's [G, S, F] buffer (slot j goes to shard j) and recv_j
// is shard j's [G, S, F] buffer (slot i came from shard i). The wire step of
// the halo exchange of the edge-partitioned path (parallel/halo.py): every
// outer layer moves one such payload, its backward the same exchange of the
// cotangents (the exchange is its own adjoint).
//
// Replaces bignn_tpu/ops/pallas/collectives.py:_a2a_kernel (all_to_all_pallas,
// reached through _a2a_call's pallas_call). On the TPU each device pushes
// its chunks into its peers' receive buffers by remote DMA, after a barrier
// built from semaphores, and waits on per-source receive semaphores. Where
// the shards of a mesh share one card, the exchange is one kernel over
// every (destination j, source i) pair: stream order is the barrier (every
// send buffer is written before the launch, every receive buffer read after
// it). The entry point takes arrays of source and destination base
// pointers, so a source may lie on another card or in another process's
// memory.
//
// Across the cards of one process (a mesh over distinct cards,
// ops/collectives.py all_to_all_cards): every ordered pair of cards has
// peer access (bignn_enable_peer_access), and each card launches this
// kernel once on its own range of destinations [j_begin, j_begin +
// j_count), reading every source chunk through the source card's pointer
// over NVLink. This pulls, where the TPU kernel pushes. The TPU kernel's
// semaphores become CUDA events on the host side: each reader's stream
// waits on an event recorded on every source's stream after its send
// buffer was written, and each source's stream waits on every reader's
// "done" event before it may reuse that memory.
//
// Across processes (the multi-process p2 run, ops/collectives.py
// PeerExchange): each process copies its local shards' send buffers into a
// staging buffer of its own (bignn_ipc_alloc, cudaMalloc'd outside
// PyTorch's caching allocator so that one IPC handle covers exactly it),
// the processes trade the handles once and map each other's staging
// buffers (bignn_ipc_open, cudaIpcOpenMemHandle). Where the TPU kernel
// pushes each chunk into its peer by remote DMA, this one pulls: a
// process's launch (bignn_all_to_all on a range of destinations) writes
// only its own receive buffers, recv_j[i] = send_i[j] for its destinations
// j in [j_begin, j_begin + j_count), reading every source i from local or
// peer-mapped pointers. The TPU kernel's barrier semaphore becomes a process-group
// barrier on the host, once the staging copies are done and again once
// every launch that reads them is.
//
// Design: the grid is (piece of a chunk, pair j * G + i); a block copies
// 16 KB tiles of one chunk, each thread kUnroll words loaded before any is
// stored. The word is 16 bytes where both addresses and the chunk size are
// 16-byte aligned (every f32 payload of a width that is a multiple of 4:
// config5's GAT payload is 132 floats, 528 bytes), and otherwise the widest
// of 8, 4, 2 and 1 bytes that they allow. The choice is made here, per
// block, never by falling back to a library copy.
//
// What bounds it on the H100: device-memory bytes, each send byte read once
// and each receive byte written once, 2 * G * G * S * F * sizeof(T) over
// 3.35 TB/s (config5-large in f32: 845 MB, 0.252 ms). At config5's
// 3.6 MB it is the launch. Across cards, per card: the chunks it reads from
// peers over the NVLink rate in one direction, and its local bytes over
// the device-memory rate.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxShards = 32;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kTileBytes = 16LL * kThreads * kUnroll;
constexpr long long kMaxPieces = 1LL << 20;

struct Shards {
  const unsigned char* send[kMaxShards];
  unsigned char* recv[kMaxShards];
};

template <class W>
__device__ void copy_chunk(const unsigned char* src, unsigned char* dst,
                           long long nbytes) {
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(dst);
  const long long n = nbytes / static_cast<long long>(sizeof(W));
  const long long tile = static_cast<long long>(blockDim.x) * kUnroll;
  for (long long base = blockIdx.x * tile; base < n;
       base += static_cast<long long>(gridDim.x) * tile) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = base + u * blockDim.x + threadIdx.x;
      if (k < n) v[u] = s[k];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = base + u * blockDim.x + threadIdx.x;
      if (k < n) d[k] = v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    exchange(Shards shards, int num_shards, int j_begin,
             long long chunk_bytes) {
  const int jj = blockIdx.y / num_shards;  // destination, from j_begin
  const int i = blockIdx.y % num_shards;   // source shard
  const unsigned char* src = shards.send[i] + (j_begin + jj) * chunk_bytes;
  unsigned char* dst = shards.recv[jj] + i * chunk_bytes;
  const uint64_t align = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst) |
                         static_cast<uint64_t>(chunk_bytes);
  if ((align & 15) == 0) {
    copy_chunk<uint4>(src, dst, chunk_bytes);
  } else if ((align & 7) == 0) {
    copy_chunk<uint2>(src, dst, chunk_bytes);
  } else if ((align & 3) == 0) {
    copy_chunk<unsigned int>(src, dst, chunk_bytes);
  } else if ((align & 1) == 0) {
    copy_chunk<unsigned short>(src, dst, chunk_bytes);
  } else {
    copy_chunk<unsigned char>(src, dst, chunk_bytes);
  }
}

}  // namespace

static_assert(sizeof(cudaIpcMemHandle_t) == 64,
              "ops/collectives.py trades 64-byte IPC handles");

extern "C" {

// send[i]: the device base pointers of the G = num_shards send buffers
// (local, or a peer's staging buffer mapped here); recv[jj]: those of the
// receive buffers of destinations j_begin + jj, jj < j_count (one process
// of a mesh: 0 and G); chunk_bytes: the bytes of one slot
// (S * F * sizeof(T)). Nothing to move (chunk_bytes 0) launches nothing.
int bignn_all_to_all(const void* const* send, void* const* recv,
                     int num_shards, int j_begin, int j_count,
                     long long chunk_bytes, cudaStream_t stream) {
  if (num_shards < 1 || num_shards > kMaxShards || chunk_bytes < 0 ||
      j_begin < 0 || j_count < 1 || j_begin + j_count > num_shards) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunk_bytes == 0) return static_cast<int>(cudaSuccess);
  Shards shards;
  for (int s = 0; s < num_shards; ++s) {
    shards.send[s] = static_cast<const unsigned char*>(send[s]);
  }
  for (int s = 0; s < j_count; ++s) {
    shards.recv[s] = static_cast<unsigned char*>(recv[s]);
  }
  long long pieces = (chunk_bytes + kTileBytes - 1) / kTileBytes;
  if (pieces > kMaxPieces) pieces = kMaxPieces;
  const dim3 grid(static_cast<unsigned>(pieces),
                  static_cast<unsigned>(j_count * num_shards));
  exchange<<<grid, kThreads, 0, stream>>>(shards, num_shards, j_begin,
                                          chunk_bytes);
  return static_cast<int>(cudaGetLastError());
}

// The staging buffer of the exchange across processes, on the current
// device.
int bignn_ipc_alloc(long long bytes, void** out) {
  *out = nullptr;
  return static_cast<int>(cudaMalloc(out, static_cast<size_t>(bytes)));
}

int bignn_ipc_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// Writes the 64 bytes of ptr's cudaIpcMemHandle_t to out.
int bignn_ipc_handle(void* ptr, void* out) {
  cudaIpcMemHandle_t handle;
  const cudaError_t err = cudaIpcGetMemHandle(&handle, ptr);
  if (err == cudaSuccess) std::memcpy(out, &handle, sizeof(handle));
  return static_cast<int>(err);
}

// Maps another process's staging buffer from its 64-byte handle.
int bignn_ipc_open(const void* handle_bytes, void** out) {
  cudaIpcMemHandle_t handle;
  std::memcpy(&handle, handle_bytes, sizeof(handle));
  *out = nullptr;
  return static_cast<int>(
      cudaIpcOpenMemHandle(out, handle, cudaIpcMemLazyEnablePeerAccess));
}

int bignn_ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// Lets the current card read peer's memory through its pointers; access
// that is already enabled (by this process or by PyTorch) is success, a
// pair without peer access is cudaErrorPeerAccessUnsupported.
int bignn_enable_peer_access(int peer) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int can = 0;
  err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: later launches check the last error
    return static_cast<int>(cudaSuccess);
  }
  return static_cast<int>(err);
}

}  // extern "C"
