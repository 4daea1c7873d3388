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
// built from semaphores, waits on per-source receive semaphores, and drains
// its send semaphores before it exits. Where the shards of a mesh share one
// card, the exchange is one kernel over every (destination j, source i)
// pair: stream order is the barrier (every send buffer is written before
// the launch, every receive buffer read after it). The entry points take
// arrays of source and destination base pointers, so a source or a
// destination may lie on another card or in another process's memory.
//
// Across the cards of one process (a mesh over distinct cards,
// ops/collectives.py all_to_all_cards) and across processes whose cards are
// all distinct (ops/collectives.py PeerExchange), each card launches the
// kernel once, and the TPU kernel's semaphores live on the cards
// (bignn_all_to_all_sync, the kSync form). Each card owns a signal area
// (kSignalBytes, zeroed when allocated): its epoch, the count of the
// launch's blocks that have copied, an abort word, an "arrived" word per
// card and a "done" word per card. One launch a card, every card of the
// exchange in the same sequence of exchanges, so that the epochs agree:
//   (a) arrive: the first block to run (whichever it is: no block waits on
//       one that is not resident) stores the new epoch into every card's
//       arrived[me], after a system-scope fence: the send buffers (or the
//       staging copy across processes) were written earlier in stream order;
//   (b) wait: each block polls, with a __nanosleep backoff, until
//       arrived[] of the card at the far end of its pair reaches the
//       epoch, then fences (acquire at system scope);
//   (c) copy;
//   (d) done: the launch's last block (a count in the card's own area)
//       stores the epoch into every card's done[me];
//   (e) drain: that block waits until done[] of every card reaches the
//       epoch before the kernel exits, so that the stream, the caching
//       allocator and the next staging copy may reuse this card's buffers.
// Every wait is bounded on %globaltimer (the host's limit): on expiry the
// block writes the card it waited on into a host-mapped error word, sets
// the area's abort word (the other blocks stop waiting) and ends; the
// wrapper raises at its next check. A block that gave up, or saw the
// abort word, fills its part of its pair's receive chunk with all-ones
// bytes (NaN in every float type) in place of the copy, so that no
// result of an expired exchange can pass for a valid one.
//
// A launch pulls: this card's destinations, every source (another card's
// send buffer through peer access, or another process's staging buffer
// through this card's IPC mapping). A push with remote 16-byte stores
// (possible in one process only: across processes the receive buffers
// are allocator memory no peer maps) and 8 words a thread in flight were
// both slower at config5-large's buffers on four H100s (PERF.md, row 9).
// Where a process's cards share one card with another process, or between
// hosts, the form without semaphores (bignn_all_to_all) runs between the
// host's barriers.
//
// Design: the grid is (piece of a chunk, pair); a block copies tiles of
// one chunk, each thread kUnroll words loaded before any is stored. The
// word is 16 bytes where both addresses and the chunk size are 16-byte
// aligned (every f32 payload of a width that is a multiple of 4: config5's
// GAT payload is 132 floats, 528 bytes), and otherwise the widest of 8, 4,
// 2 and 1 bytes that they allow. The choice is made here, per block, never
// by falling back to a library copy. The kSync form caps its grid at one
// wave of the card (kWaveBlocks), the pieces of a pair walked in a loop.
//
// Any number of shards G and of cards. Up to kInline of each, a launch
// takes its pointers by value (Inline: config5's 4 shards, config5-large's
// 8). Past that they would outgrow the launch's parameters, so the wrapper
// fills a table of 64-bit words in device memory (Table: send[G], recv[G],
// card_of[G], the launch's destinations, the cards' signal areas), copied
// in stream order before the launch; indices are 32-bit. The G * G pairs
// (or a launch's destinations times G) lie on gridDim.y up to its 65,535
// rows (the kSync form: up to one wave), each block walking pairs
// blockIdx.y, blockIdx.y + gridDim.y, ... So past 1,056 pairs the kSync
// grid stays one wave: every block is resident, and a block only ever
// waits on other cards' arrivals (their first block to run stores them)
// and, the launch's last block, on every card's "done", which each card's
// last block stores once all of that card's blocks have counted. The
// drain counts gridDim.x * gridDim.y blocks, each once after its pairs.
// A card's signal area grows with the cards: arrived[] at word kArrived,
// done[] after it, each rounded up to 32 words, at least kSignalBytes
// (ops/collectives.py signal_bytes, which sizes and zeroes it).
//
// What bounds it on the H100: device-memory bytes, each send byte read once
// and each receive byte written once, 2 * G * G * S * F * sizeof(T) over
// 3.35 TB/s (config5-large in f32: 845 MB, 0.252 ms). At config5's
// 3.6 MB it is the launch. Across cards, per card: the chunks it reads from
// (or writes to) peers over the NVLink rate in one direction, and its local
// bytes over the device-memory rate.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

// shards (and cards) whose pointers a launch takes by value; more go
// through a table in device memory (Table)
constexpr int kInline = 32;
constexpr int kThreads = 256;
constexpr long long kMaxPieces = 1LL << 20;
constexpr long long kMaxRows = 65535;  // gridDim.y
// words a thread loads before it stores any
constexpr int kUnroll = 4;
// the kSync form's most blocks: one wave of 256-thread blocks on the
// H100's 132 SMs (8 a SM)
constexpr int kWaveBlocks = 1056;
// blocks an SM holds at least (the launch bounds: at most 32 registers a
// thread), so that one wave of kWaveBlocks is resident; the pair tables'
// forms took 48-64 registers without it, 5 blocks an SM, and row 9 across
// four cards at config5-large's buffers ran 13 % slower
constexpr int kMinBlocks = 8;
// 0 leaves out the kSync form's copy: the semaphores alone, a measurement
// of scripts/probe_variants.py (kind a2a), which edits these constants in
// a copy of this file
constexpr int kCopy = 1;

// a card's signal area: 32-bit words (ops/collectives.py signal_bytes)
constexpr int kSignalBytes = 1024;  // its least size (up to 32 cards)
constexpr int kEpoch = 0;     // the epoch of the card's last exchange
constexpr int kStarted = 1;   // the epoch whose first block has arrived
constexpr int kBlocks = 2;    // blocks of the current launch that copied
constexpr int kAbort = 3;     // set once a wait has expired
constexpr int kArrived = 32;  // [cards], from a cache line of their own
static_assert(4 * (kArrived + 2 * 32) <= kSignalBytes, "signal area");

// done[cards] follows arrived[], both rounded up to 32 words (64 at up to
// 32 cards)
__host__ __device__ inline int done_word(int cards) {
  return kArrived + (cards + 31) / 32 * 32;
}

// the error word: the wait that expired (top two bits), and the card it
// waited on + 1
constexpr unsigned kWaitArrive = 1u << 30;
constexpr unsigned kWaitDone = 2u << 30;

// A launch's pairs by value (G and cards up to kInline): every shard's
// send and receive buffer, the launch's destinations, each shard's card,
// every card's signal area as this card maps it (kSync).
struct Inline {
  const unsigned char* send[kInline];  // slot j at j * chunk
  unsigned char* recv[kInline];        // slot i at i * chunk
  unsigned char rows[kInline];         // the launch's destinations j
  unsigned char card_of[kInline];      // each shard's card (kSync)
  unsigned int* area[kInline];
  __device__ const unsigned char* src(int i) const { return send[i]; }
  __device__ unsigned char* dst(int j) const { return recv[j]; }
  __device__ int row(int r) const { return rows[r]; }
  __device__ int card(int s) const { return card_of[s]; }
  __device__ unsigned int* area_of(int q) const { return area[q]; }
};

// The same in device memory that the wrapper fills, 64-bit words:
// send[g], recv[g], card_of[g], rows[n_rows], area[cards].
struct Table {
  const unsigned long long* t;
  int g, n_rows;
  __device__ const unsigned char* src(int i) const {
    return reinterpret_cast<const unsigned char*>(t[i]);
  }
  __device__ unsigned char* dst(int j) const {
    return reinterpret_cast<unsigned char*>(t[g + j]);
  }
  __device__ int card(int s) const { return static_cast<int>(t[2 * g + s]); }
  __device__ int row(int r) const { return static_cast<int>(t[3 * g + r]); }
  __device__ unsigned int* area_of(int q) const {
    return reinterpret_cast<unsigned int*>(t[3 * g + n_rows + q]);
  }
};

struct Barrier {
  unsigned int* error;  // host-mapped: this card's error word
  unsigned long long timeout_ns;
  int me, cards;
};

// Signals are relaxed system-scope loads and stores, ordered by one fence
// on each side: a fence before a card's stores of one signal (not one
// release a store), and one after a poll has seen its value (not an
// acquire a poll).
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.sys.global.u32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void fence_acquire() {
  asm volatile("fence.acq_rel.sys;" ::: "memory");
}

__device__ __forceinline__ unsigned ld_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// whether word `word` of this card's area reached epoch e (wrapping)
__device__ __forceinline__ bool reached(const unsigned* mine, int word,
                                        unsigned e) {
  return static_cast<int>(ld_relaxed(mine + word) - e) >= 0;
}

// Wait until word `word` of this card's area `mine` reaches e (then
// acquire); false if the area was aborted or the wait expired (then the
// error word names `card`).
__device__ bool wait_for(const Barrier& b, unsigned* mine, int word,
                         unsigned e, int card, unsigned what) {
  if (reached(mine, word, e)) {
    fence_acquire();
    return true;
  }
  const unsigned long long t0 = globaltimer();
  unsigned ns = 32;
  for (;;) {
    __nanosleep(ns);
    if (ns < 256) ns *= 2;
    if (reached(mine, word, e)) {
      fence_acquire();
      return true;
    }
    if (ld_volatile(mine + kAbort)) return false;
    if (globaltimer() - t0 > b.timeout_ns) {
      *reinterpret_cast<volatile unsigned*>(b.error) =
          what | static_cast<unsigned>(card + 1);
      atomicExch(mine + kAbort, 1u);
      __threadfence_system();
      return false;
    }
  }
}

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

// This block's part of a chunk filled with all-ones bytes (an expired
// exchange's result).
__device__ void fill_chunk(unsigned char* dst, long long nbytes) {
  for (long long k = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       k < nbytes; k += static_cast<long long>(gridDim.x) * blockDim.x) {
    dst[k] = 0xFF;
  }
}

__device__ void copy_pair(const unsigned char* src, unsigned char* dst,
                          long long chunk_bytes) {
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

// Pair k: its row r (the launch's destination p.row(r)) and its source i.
__device__ __forceinline__ void pair_of(long long k, int n_cols, int& r,
                                        int& i) {
  if (k < 0x7fffffffLL) {  // 32-bit arithmetic where it fits
    const int k32 = static_cast<int>(k);
    r = k32 / n_cols;
    i = k32 - r * n_cols;
  } else {
    r = static_cast<int>(k / n_cols);
    i = static_cast<int>(k - static_cast<long long>(r) * n_cols);
  }
}

// The pairs of n_rows destinations (p.row) times n_cols sources: pair k
// is destination p.row(k / n_cols) taking slot k % n_cols from that
// source. By value (Inline: G <= kInline, at most 1,024 pairs) block row
// blockIdx.y takes pair blockIdx.y, as the form before tables did; from a
// table, pairs blockIdx.y, blockIdx.y + gridDim.y, ...
template <bool kSync, class P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    exchange(P p, Barrier b, int n_rows, int n_cols, long long chunk_bytes) {
  constexpr bool kLoop = std::is_same<P, Table>::value;
  const long long pairs = static_cast<long long>(n_rows) * n_cols;
  if constexpr (!kSync) {
    if constexpr (!kLoop) {
      const int j = p.row(blockIdx.y / n_cols);  // destination
      const int i = blockIdx.y % n_cols;         // source
      copy_pair(p.src(i) + j * chunk_bytes, p.dst(j) + i * chunk_bytes,
                chunk_bytes);
    } else {
      for (long long k = blockIdx.y; k < pairs; k += gridDim.y) {
        int r, i;
        pair_of(k, n_cols, r, i);
        const int j = p.row(r);
        copy_pair(p.src(i) + j * chunk_bytes, p.dst(j) + i * chunk_bytes,
                  chunk_bytes);
      }
    }
  } else {
    unsigned* mine = p.area_of(b.me);
    __shared__ unsigned s_epoch;
    __shared__ int s_go;
    bool go = false;  // thread 0's
    if (threadIdx.x == 0) {
      // every block reads the epoch before it counts itself, so the last
      // block's store of the new one comes after every read
      const unsigned e = ld_volatile(mine + kEpoch) + 1;
      s_epoch = e;
      go = ld_volatile(mine + kAbort) == 0;
      if (go && atomicCAS(mine + kStarted, e - 1, e) == e - 1) {
        __threadfence_system();  // (a) arrive
        for (int q = 0; q < b.cards; ++q) {
          st_relaxed(p.area_of(q) + kArrived + b.me, e);
        }
      }
    }
    // destination j's slot from source i
    auto one = [&](int j, int i) {
      if (threadIdx.x == 0) {
        // (b) wait for the card at the far end of the pair (one end is
        // this card, whose own arrival is the store above)
        const unsigned e = s_epoch;
        go = go &&
             wait_for(b, mine, kArrived + p.card(i), e, p.card(i),
                      kWaitArrive) &&
             wait_for(b, mine, kArrived + p.card(j), e, p.card(j),
                      kWaitArrive);
        s_go = go;
      }
      __syncthreads();
      unsigned char* dst = p.dst(j) + i * chunk_bytes;
      if (!s_go) {
        fill_chunk(dst, chunk_bytes);
      } else if (kCopy) {
        copy_pair(p.src(i) + j * chunk_bytes, dst, chunk_bytes);  // (c)
      }
      __syncthreads();
    };
    if constexpr (!kLoop) {
      one(p.row(blockIdx.y / n_cols), blockIdx.y % n_cols);
    } else {
      for (long long k = blockIdx.y; k < pairs; k += gridDim.y) {
        int r, i;
        pair_of(k, n_cols, r, i);
        one(p.row(r), i);
      }
    }
    if (threadIdx.x == 0) {
      const unsigned e = s_epoch;
      const int done = done_word(b.cards);
      __threadfence();
      const unsigned total = gridDim.x * gridDim.y;
      if (atomicAdd(mine + kBlocks, 1u) == total - 1) {
        *reinterpret_cast<volatile unsigned*>(mine + kBlocks) = 0;
        __threadfence_system();  // (d) done
        for (int q = 0; q < b.cards; ++q) {
          st_relaxed(p.area_of(q) + done + b.me, e);
        }
        // (e) drain: no card still reads this card's buffers
        for (int q = 0; q < b.cards; ++q) {
          if (!wait_for(b, mine, done + q, e, q, kWaitDone)) break;
        }
        *reinterpret_cast<volatile unsigned*>(mine + kEpoch) = e;
      }
    }
  }
}

template <bool kSync, class P>
int launch(const P& p, const Barrier& b, int n_rows, int n_cols,
           long long chunk_bytes, cudaStream_t stream) {
  long long pieces = (chunk_bytes + 16LL * kThreads * kUnroll - 1) /
                     (16LL * kThreads * kUnroll);
  if (pieces > kMaxPieces) pieces = kMaxPieces;
  const long long pairs = static_cast<long long>(n_rows) * n_cols;
  long long rows = pairs < kMaxRows ? pairs : kMaxRows;
  if (kSync) {
    const long long most = kWaveBlocks / pairs;
    pieces = pieces < most ? pieces : (most > 0 ? most : 1);
    if (rows > kWaveBlocks) rows = kWaveBlocks;
  }
  const dim3 grid(static_cast<unsigned>(pieces),
                  static_cast<unsigned>(rows));
  exchange<kSync, P><<<grid, kThreads, 0, stream>>>(p, b, n_rows, n_cols,
                                                     chunk_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

static_assert(sizeof(cudaIpcMemHandle_t) == 64,
              "ops/collectives.py trades 64-byte IPC handles");

extern "C" {

// send[i]: the device base pointers of the G = num_shards send buffers
// (local, or a peer's staging buffer mapped here); recv[jj]: those of the
// receive buffers of destinations j_begin + jj, jj < j_count (one process
// of a mesh: 0 and G); chunk_bytes: the bytes of one slot
// (S * F * sizeof(T)). G up to kInline; more take bignn_all_to_all_table.
// Nothing to move (chunk_bytes 0) launches nothing.
int bignn_all_to_all(const void* const* send, void* const* recv,
                     int num_shards, int j_begin, int j_count,
                     long long chunk_bytes, cudaStream_t stream) {
  if (num_shards < 1 || num_shards > kInline || chunk_bytes < 0 ||
      j_begin < 0 || j_count < 1 || j_begin + j_count > num_shards) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunk_bytes == 0) return static_cast<int>(cudaSuccess);
  Inline p{};
  for (int s = 0; s < num_shards; ++s) {
    p.send[s] = static_cast<const unsigned char*>(send[s]);
  }
  for (int s = 0; s < j_count; ++s) {
    p.recv[j_begin + s] = static_cast<unsigned char*>(recv[s]);
    p.rows[s] = static_cast<unsigned char>(j_begin + s);
  }
  return launch<false>(p, Barrier{}, j_count, num_shards, chunk_bytes,
                       stream);
}

// The same for any G, its pointers in `table`: device memory of 64-bit
// words send[G], recv[G] (destination j's at j), G unused words, then the
// launch's j_count destinations (ascending), filled by the wrapper in
// stream order before this launch.
int bignn_all_to_all_table(const void* table, int num_shards, int j_count,
                           long long chunk_bytes, cudaStream_t stream) {
  if (num_shards < 1 || chunk_bytes < 0 || j_count < 1 ||
      j_count > num_shards || table == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunk_bytes == 0) return static_cast<int>(cudaSuccess);
  const Table p{static_cast<const unsigned long long*>(table), num_shards,
                j_count};
  return launch<false>(p, Barrier{}, j_count, num_shards, chunk_bytes,
                       stream);
}

// The kSync form: one launch on each of this process's n_local cards of an
// exchange over `cards` cards (one host call for them all: a card's kernel
// waits for every card's launch, so the launches go out back to back).
// Local card k is CUDA device devices[k], participant me[k], and launches
// on streams[k]; send[k * G + i], shard i's send buffer as card k reaches
// it; recv[j], shard j's receive buffer (null where no local card writes
// it); card_of[s], shard s's participant card; areas[k * cards + q], card
// q's signal area as card k reaches it; error[k], card k's word of mapped
// host memory; timeout_ns, the limit of every wait. Card k pulls the pairs
// (its shards' destinations, every source). tables: null where G and
// cards are at most kInline, else tables[k], card k's table (Table's
// layout: send as card k reaches them, recv, card_of, its shards in
// ascending order, areas as card k reaches them) in device memory on card
// k, filled in stream order before the launch. The current device is
// kept.
int bignn_all_to_all_sync(const void* const* send, void* const* recv,
                          int num_shards, const int* card_of,
                          long long chunk_bytes, void* const* areas,
                          int cards, int n_local, const int* me,
                          const int* devices, void* const* streams,
                          void* error, long long timeout_ns,
                          const void* const* tables) {
  const bool inline_ptrs = num_shards <= kInline && cards <= kInline;
  if (num_shards < 1 || chunk_bytes < 0 || cards < 1 || n_local < 1 ||
      n_local > cards || timeout_ns <= 0 || error == nullptr ||
      (!inline_ptrs && tables == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int s = 0; s < num_shards; ++s) {
    if (card_of[s] < 0 || card_of[s] >= cards) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (chunk_bytes == 0) return static_cast<int>(cudaSuccess);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  for (int k = 0; k < n_local && err == cudaSuccess; ++k) {
    if (me[k] < 0 || me[k] >= cards) {
      err = cudaErrorInvalidValue;
      break;
    }
    Barrier b{};
    b.error = static_cast<unsigned int*>(error) + k;
    b.timeout_ns = static_cast<unsigned long long>(timeout_ns);
    b.me = me[k];
    b.cards = cards;
    // this card's shards: the launch's destinations
    int own = 0;
    for (int s = 0; s < num_shards; ++s) own += card_of[s] == me[k];
    for (int q = 0; q < cards; ++q) {
      if (areas[k * cards + q] == nullptr) err = cudaErrorInvalidValue;
    }
    if (own == 0 || err != cudaSuccess) {
      err = cudaErrorInvalidValue;
      break;
    }
    cudaStream_t stream = static_cast<cudaStream_t>(streams[k]);
    err = cudaSetDevice(devices[k]);
    if (err != cudaSuccess) break;
    if (inline_ptrs && tables == nullptr) {
      Inline p{};
      int r = 0;
      for (int s = 0; s < num_shards; ++s) {
        p.send[s] =
            static_cast<const unsigned char*>(send[k * num_shards + s]);
        p.recv[s] = static_cast<unsigned char*>(recv[s]);
        p.card_of[s] = static_cast<unsigned char>(card_of[s]);
        if (card_of[s] == me[k]) p.rows[r++] = static_cast<unsigned char>(s);
      }
      for (int q = 0; q < cards; ++q) {
        p.area[q] = static_cast<unsigned int*>(areas[k * cards + q]);
      }
      err = static_cast<cudaError_t>(
          launch<true>(p, b, own, num_shards, chunk_bytes, stream));
    } else {
      if (tables[k] == nullptr) {
        err = cudaErrorInvalidValue;
        break;
      }
      const Table p{static_cast<const unsigned long long*>(tables[k]),
                    num_shards, own};
      err = static_cast<cudaError_t>(
          launch<true>(p, b, own, num_shards, chunk_bytes, stream));
    }
  }
  const cudaError_t back = cudaSetDevice(current);
  return static_cast<int>(err != cudaSuccess ? err : back);
}

// A buffer of `bytes` on the current device, outside PyTorch's caching
// allocator (so that one IPC handle covers exactly it), whose first `head`
// bytes, a card's signal area, are zeroed before it
// returns: the staging buffer of the exchange across processes (the area,
// then the payload), or a card's signal area alone.
int bignn_ipc_alloc(long long bytes, long long head, void** out) {
  *out = nullptr;
  if (head < 0 || head > bytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMalloc(out, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*out, 0, static_cast<size_t>(head));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
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

// `bytes` of zeroed page-locked host memory mapped into every card's
// address space (the kSync form's error words, which the host reads
// without synchronising): its host pointer and the pointer a kernel uses.
int bignn_host_alloc(long long bytes, void** host, void** device) {
  *host = nullptr;
  *device = nullptr;
  cudaError_t err = cudaHostAlloc(host, static_cast<size_t>(bytes),
                                  cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::memset(*host, 0, static_cast<size_t>(bytes));
  return static_cast<int>(cudaHostGetDevicePointer(device, *host, 0));
}

int bignn_host_free(void* host) {
  return static_cast<int>(cudaFreeHost(host));
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
