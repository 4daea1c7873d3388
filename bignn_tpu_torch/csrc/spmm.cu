// Sorted-COO SpMM over an edge list, forward and backward, for float32 or
// bf16 rows (float32 weights, float32 sums, one rounding at the store):
//   y[d, :]   = sum_{e: dst_e = d} w_e x[clip(src_e), :]          (forward)
//   d_x[s, :] = sum_{e: src_e = s, 0 <= dst_e < num_out} w_e g[dst_e, :]
// with w_e = 1 when no weights are given (GIN's unweighted sum). Edges with
// dst outside [0, num_out) (padding: dst == node_cap) take no part.
//
// Replaces bignn_tpu/ops/pallas/spmm.py:spmm_pallas: its forward (_forward:
// a row gather x[src], the weight, then the Pallas sorted segment sum over
// dst) and its backward (_dx_sorted: the per-edge cotangent g[dst] * w,
// permuted to source order and summed by the same Pallas kernel over
// src_sorted). Both write an [E, F] message tensor to HBM and read it back;
// here neither direction does: each output row is summed in registers and
// stored once. Both directions are one walk over positions i of a sorted
// order: the forward over the edges (ids = dst), the backward in a
// permuted-read form over the source-sorted order (ids = src_sorted; edge e
// = perm[i], whose row g[dst_e] and weight w_e it reads): _dx_sorted fused,
// with no permuted copy of the cotangent.
//
// bf16 rounding as the JAX package's (ops/pallas/spmm.py:55, :97): the
// weight is rounded to bf16 and so is each weighted message w_e x[s],
// before the float32 sum (unweighted messages are the bf16 rows themselves).
// For float32 both roundings are the identity.
//
// What bounds it on the H100: device-memory bytes of the row gathers. Each
// edge reads one F-wide row of x; the rows a molecule's edges read are few
// and L2 holds them, so the least the card must move is x, the ids, the
// weights and y once each, against the plain version's [E, F] messages
// written and read again. Each position is a chain of dependent loads (its
// id and perm entry, then its edge's row index and weight, then the row),
// so the walk must keep many positions in flight; and a row's positions may
// be few (a molecule row: ~3 edges with its self-loop) or most of the list
// (the hub rows below), so work must be cut by positions, not by rows.
//
// Design, in four launches: init (each row's bounds empty, the long-row
// counters cleared), then
//   1. bounds: each output row's first and last position (segment_bounds.cuh,
//      atomics at the ends of runs); positions whose id is another row's
//      (holes of padding ids between runs, F1, or any order of the ids)
//      are skipped by their id, so the result is right for any ids.
//   2. rows: row slots as segment_sum.cu's: a row takes G lanes, its words
//      (16, 8 or 4 bytes, or one value, as the width and every base pointer
//      allow) rounded up to a power of two, at most 32 (wider rows take
//      more sweeps), so a warp sums 32 / G rows. The G lanes load G of the
//      row's positions at once, one a lane (ids, perm entries, row indices,
//      weights), then kInFlight of those rows' words at once, the indices
//      and weights handed round by shuffles; the row is stored once, an
//      empty one as zeros.
//   3. long rows: a row spanning more than `long_min` positions (an even
//      share of the positions over 1,024 slots, at least kLongMin) is not
//      walked by one slot. Its slot claims
//      it with one 64-bit integer atomic (an entry of the long-row list and
//      the indices of its pieces) and, when it has more than one piece, a
//      second (its rows of float32 partial sums); where the scratch is full
//      it walks the row itself. A piece is kSharePerSlot positions for each
//      slot of a block, walked by the whole block: each slot takes a
//      contiguous share, and the shares are added in slot order. A row of
//      one piece is stored by it; otherwise each piece leaves its partial in
//      the scratch, and the block that completes the row's last piece (an
//      integer ticket after a fence) adds the partials in piece order, each
//      slot a contiguous share, and stores the row. The pieces of all long
//      rows are dealt round 2 blocks an SM, so a hub row (the distributed
//      GIN's clamped sources, parallel/halo.py: about half a shard's edges
//      on one row of each of its two SpMMs; a hub drug of the outer graph)
//      is summed by the whole card.
// Every sum runs in a fixed order (positions in order within a slot's
// share, shares in slot order, pieces in order), with no float atomics, so
// a result repeats bit for bit. Zero-weight edges are summed, not skipped:
// 0 * NaN stays NaN, as in JAX. bf16 messages are formed two at a time
// (elem.cuh: add_messages).
//
// Measured by scripts/compare_kernel_trees.py (device time of calls queued
// back to back; the redesign's chip call 12, PERF.md section 6, A B B A
// against the one-warp-a-row walk this design replaces; NVIDIA H100 80GB
// HBM3, 700.00 W): path G(ii)'s two split SpMMs on shard 0 of config5's
// plan, float32 F 128, backward 0.0553 ms (9.9497: one warp walked each
// hub row), forward 0.0367 (0.0656); path E's batch (4.1M edge slots),
// bf16 F 128, 0.4564 forward, 0.5418 backward (0.5336, 0.5832;
// torch.sparse.mm 0.7363, 0.7368; bound 0.2080, 0.2129), weighted F 64
// 0.2658, 0.3102 (0.5119, 0.5553; 0.5666, 0.5667); path A's largest
// bucket, float32 F 128, 0.0376, 0.0410 (0.0378, 0.0408), weighted F 64
// 0.0241, 0.0287 (0.0265, 0.0294). scripts/probe_variants.py (kind spr,
// the redesign's calls 6-13): where a row fills the warp, one row in
// flight (path A's backward 0.046 against 0.049 with two, call 11); where
// two rows share it, two (path E 0.392 against 0.445 with four, call 9);
// splitting every row above 64 positions sent path A's 131-position
// padding row (its backward's source 0) to a serial pass after the rows:
// 0.046 against 0.041 with the share rule (calls 11, 12); one launch whose
// blocks took their roles by a ticket (an atomic on one counter a block)
// took 0.072 ms at path A (call 8); the chain launched without dependent
// launches, 0.042 and 0.046 at path A against 0.038 and 0.041 with them,
// alternating in one call (call 13).

#include <cuda_runtime.h>

#include <cstdint>

#include "elem.cuh"
#include "segment_bounds.cuh"

namespace {

constexpr int kRowWarps = 4;      // warps of a block in the row pass
constexpr int kWarps = 8;         // warps of a block in the long-row pass
constexpr int kThreads = kWarps * 32;
// rows a lane loads at once: in the row pass where a row fills the warp,
// where it shares it, and in the long-row pass (scripts/probe_variants.py,
// kind spr)
constexpr int kInFlightWide = 1;
constexpr int kInFlightNarrow = 2;
constexpr int kInFlightLong = 8;
// 1: the kernels after init launch as dependents (launch_dependent)
constexpr int kDependentLaunch = 1;
constexpr int kLongMin = 64;      // least span of a split row
constexpr int kFillSlots = 1024;  // slots that share the positions
constexpr int kSharePerSlot = 32;  // positions of a piece per slot
// the shortest piece: kWarps warps of one slot each
constexpr int kMinPiece = kWarps * kSharePerSlot;
constexpr int kHeader = 16;  // bytes of the scratch's counters

// The scratch: the counters, the long-row list and the partial sums.
struct LongRows {
  unsigned long long* count;  // (entries << 32) | pieces dealt
  unsigned* parts;            // partial rows handed out
  int* row;                   // [cap] the entry's output row
  int* first_piece;           // [cap] its pieces' first index
  int* part0;                 // [cap] its first partial row
  int* done;                  // [cap] its pieces completed
  float* part;                // [part_cap, feat] float32 partial sums
  int cap, part_cap;
};

inline int64_t round16(int64_t b) { return (b + 15) / 16 * 16; }

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Entries of the long-row list: rows spanning more than long_min positions
// have disjoint spans when the ids are sorted, so at most num_pos /
// (long_min + 1) of them; partial rows: only rows of two or more pieces
// take them, each piece at least kMinPiece positions.
inline int list_cap(int num_pos, int long_min) {
  return num_pos / (long_min + 1) + 1;
}
inline int part_cap(int num_pos) {
  return 2 * ceil_div(num_pos, kMinPiece) + 1;
}
// A row is long when one slot would walk it for longer than the row pass
// takes: when it spans more than an even share of the positions over
// kFillSlots slots, and more than kLongMin. (A shard's 426 destinations of
// ~155 edges are long: one slot each would leave most SMs idle; path A's
// padding row, 131 of 210,944 positions, is not: the pass walks it along
// with the rest, where a split would add a serial pass after it.)
inline int long_min_of(int num_pos) {
  const int share = ceil_div(num_pos, kFillSlots);
  return share > kLongMin ? share : kLongMin;
}
inline int64_t scratch_bytes(int num_pos, int feat) {
  const int cap = list_cap(num_pos, long_min_of(num_pos));
  return round16(kHeader + 16 * static_cast<int64_t>(cap)) +
         4 * static_cast<int64_t>(part_cap(num_pos)) * feat;
}

LongRows long_rows(void* scratch, int num_pos) {
  unsigned char* p = static_cast<unsigned char*>(scratch);
  LongRows l;
  l.cap = list_cap(num_pos, long_min_of(num_pos));
  l.part_cap = part_cap(num_pos);
  l.count = reinterpret_cast<unsigned long long*>(p);
  l.parts = reinterpret_cast<unsigned*>(p + 8);
  l.row = reinterpret_cast<int*>(p + kHeader);
  l.first_piece = l.row + l.cap;
  l.part0 = l.first_piece + l.cap;
  l.done = l.part0 + l.cap;
  l.part = reinterpret_cast<float*>(
      p + round16(kHeader + 16 * int64_t{l.cap}));
  return l;
}

// Programmatic dependent launch (Hopper): a kernel of the chain init ->
// bounds -> rows -> long rows lets the next one be scheduled once each of
// its blocks has done its work (launch_next), and the next one waits at its
// start until this one has finished and its writes are seen (wait_prior):
// the next launch's latency hides behind this one's last wave, and its
// waiting blocks take no room from this one's work.
__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_next() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Empty bounds, as segment_bounds.cuh's init, and cleared counters.
__global__ void init_spmm(int* first, int* last, int num_out, int num_pos,
                          LongRows l) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < num_out) {
    first[r] = num_pos;
    last[r] = -1;
  }
  if (r == 0) {
    *l.count = 0;
    *l.parts = 0;
  }
  launch_next();
}

// The operands of a walk. Position i belongs to output row r when ids[i]
// == r; it names edge e = perm[i] (e = i without perm), whose gathered row
// is rows[e] and weight weight[e] (1 without weights). clip: a gathered
// index outside [0, num_x) is clipped (the forward, as JAX's
// take(mode="clip")); otherwise such an edge is dropped (the backward's
// padding edges, dst == num_out).
template <class T>
struct Walk {
  const T* x;
  int num_x;
  const int* ids;
  const int* perm;
  const int* rows;
  const float* weight;
  int feat;
  bool clip;
};

// acc += the word `col` (NV values of T) of w_e x[g_e] over the positions
// i0 .. i1 (inclusive) that belong to row r, in order. The G = 1 << lg
// lanes of the slot (lane c of it, `mask` its lanes) load G positions at
// once, one a lane: the id and perm entry, then (with perm) the edge's row
// index and weight; without perm those load with the id. Then kInFlight
// of the positions' words load together, their row indices and weights
// handed round the slot by shuffles. `mine` says whether the lane holds a
// word of this sweep.
template <class T, int NV, bool kPerm, int kInFlight, class W>
__device__ __forceinline__ void walk(const Walk<T>& a, int i0, int i1, int r,
                                     int c, int lg, unsigned mask, int col,
                                     bool mine, float (&acc)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;
  const int slot = 1 << lg;
  for (int base = i0; base <= i1; base += slot) {
    const int p = base + c;
    int g = -1;
    float w = 1.f;
    if (p <= i1) {
      const int id = __ldg(a.ids + p);
      int gi = 0;
      float wi = 1.f;
      if constexpr (kPerm) {
        const int e = __ldg(a.perm + p);
        if (id == r) {
          gi = __ldg(a.rows + e);
          if (a.weight != nullptr) wi = __ldg(a.weight + e);
        }
      } else {
        gi = __ldg(a.rows + p);
        if (a.weight != nullptr) wi = __ldg(a.weight + p);
      }
      if (a.clip) {
        gi = min(max(gi, 0), a.num_x - 1);
      } else if (gi >= a.num_x) {
        gi = -1;
      }
      if (id == r) {
        g = gi;
        w = a.weight != nullptr ? bignn::round_to<T>(wi) : 1.f;
      }
    }
    const int n = min(slot, i1 - base + 1);
    for (int j = 0; j < n; j += kInFlight) {
      int gs[kInFlight];
      float ws[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int from = (j + u) & (slot - 1);
        gs[u] = __shfl_sync(mask, g, from, slot);
        ws[u] = a.weight != nullptr ? __shfl_sync(mask, w, from, slot) : 1.f;
        if (j + u >= n) gs[u] = -1;
      }
      W v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        v[u] = mine && gs[u] >= 0
                   ? __ldg(reinterpret_cast<const W*>(
                         a.x + static_cast<int64_t>(gs[u]) * a.feat +
                         col * NV))
                   : W{};
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (gs[u] >= 0) bignn::add_messages<T, NV>(v[u], ws[u], acc);
    }
  }
}

// The lanes of the slot that lane `lane` belongs to (G = 1 << lg lanes).
__device__ __forceinline__ unsigned slot_mask(int lane, int lg) {
  return lg == 5 ? 0xffffffffu
                 : ((1u << (1 << lg)) - 1u) << (lane & ~((1 << lg) - 1));
}

// Claim row r (spanning n positions) for the long-row pass: an entry and
// its pieces, and its partial rows when it has more than one piece. False
// where the scratch is full: the caller walks the row. One lane calls it.
__device__ bool claim(LongRows l, int r, int n, int piece) {
  const int pieces = ceil_div(n, piece);
  int part0 = 0;
  if (pieces > 1) {
    part0 = static_cast<int>(
        atomicAdd(l.parts, static_cast<unsigned>(pieces)));
    if (part0 > l.part_cap - pieces) return false;
  }
  const unsigned long long old = atomicAdd(
      l.count, (1ull << 32) | static_cast<unsigned long long>(pieces));
  const int i = static_cast<int>(old >> 32);
  if (i >= l.cap) return false;
  l.first_piece[i] = static_cast<int>(old & 0xffffffffu);
  l.part0[i] = part0;
  l.done[i] = 0;
  l.row[i] = r;
  return true;
}

// Row pass: slot q of the grid takes output row q; a row spanning more
// than long_min positions is claimed for the long-row pass instead. kWide:
// a row fills the warp (G = 32), each variant with its own registers.
template <class T, int NV, bool kPerm, bool kWide>
__global__ void __launch_bounds__(kRowWarps * 32)
    spmm_rows(Walk<T> a, const int* __restrict__ first,
              const int* __restrict__ last, int num_out, int long_min,
              int piece, LongRows l, T* __restrict__ out) {
  using W = typename bignn::Word<NV * static_cast<int>(sizeof(T))>::type;
  constexpr int kInFlight = kWide ? kInFlightWide : kInFlightNarrow;
  const int words = a.feat / NV;
  const int lg = kWide ? 5 : bignn::slot_log2(words);
  const int lane = threadIdx.x % 32;
  const int c = lane & ((1 << lg) - 1);
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> lg;
  wait_prior();
  if (r < num_out) {  // whole slots: the slots of a warp are apart
    const unsigned mask = slot_mask(lane, lg);
    const int i0 = first[r];
    const int i1 = last[r];  // i1 < i0 for an empty row
    int taken = 0;
    if (i1 - i0 + 1 > long_min) {
      if (c == 0) taken = claim(l, r, i1 - i0 + 1, piece);
      taken = __shfl_sync(mask, taken, lane - c);
    }
    T* o = out + static_cast<int64_t>(r) * a.feat;
    for (int c0 = 0; !taken && c0 < words; c0 += 32) {
      const int col = c0 + c;
      const bool mine = col < words;
      float acc[NV];
      walk<T, NV, kPerm, kInFlight, W>(a, i0, i1, r, c, lg, mask, col, mine,
                                       acc);
      if (mine)
        *reinterpret_cast<W*>(o + col * NV) = bignn::pack_word<T, NV, W>(acc);
    }
  }
  launch_next();
}

// The bounds of segment_bounds.cuh, as a link of the chain.
__global__ void spmm_bounds(const int* __restrict__ ids, int num_pos,
                            int num_out, int* first, int* last) {
  wait_prior();
  bignn::bounds_of_row(ids, blockIdx.x * blockDim.x + threadIdx.x, num_pos,
                       num_out, first, last);
  launch_next();
}

// Long-row pass: the pieces q = blockIdx.x, + gridDim.x, ... of all
// entries, in the order the entries were claimed.
template <class T, int NV, bool kPerm>
__global__ void __launch_bounds__(kThreads)
    spmm_long(Walk<T> a, const int* __restrict__ first,
              const int* __restrict__ last, int piece, LongRows l,
              T* __restrict__ out) {
  using W = typename bignn::Word<NV * static_cast<int>(sizeof(T))>::type;
  extern __shared__ float share[];  // [slots, G, NV]: one sweep's sums
  __shared__ int finisher;
  const int tid = threadIdx.x;
  wait_prior();
  const unsigned long long count = *l.count;
  const int entries = min(static_cast<int>(count >> 32), l.cap);
  const int pieces = static_cast<int>(count & 0xffffffffu);
  if (entries == 0) return;
  const int words = a.feat / NV;
  const int lg = bignn::slot_log2(min(words, 32));
  const int j = tid >> lg;  // this thread's slot
  const int c = tid & ((1 << lg) - 1);
  const unsigned mask = slot_mask(tid % 32, lg);
  const int slots = kThreads >> lg;
  float* mine_share = share + (j * (1 << lg) + c) * NV;

  // the slots' sums of one sweep, added in slot order by slot 0
  auto add_shares = [&](float (&acc)[NV]) {
#pragma unroll
    for (int k = 0; k < NV; ++k) mine_share[k] = acc[k];
    __syncthreads();
    if (j == 0) {
      for (int s = 1; s < slots; ++s) {
        const float* o = share + (s * (1 << lg) + c) * NV;
#pragma unroll
        for (int k = 0; k < NV; ++k) acc[k] += o[k];
      }
    }
    __syncthreads();
  };

  for (int q = blockIdx.x; q < pieces; q += gridDim.x) {
    // the entry of piece q: the last whose first piece is at most q
    int lo = 0, hi = entries - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (l.first_piece[mid] <= q) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int r = l.row[lo];
    const int f = first[r];
    const int n = last[r] - f + 1;
    const int np = ceil_div(n, piece);
    const int k = q - l.first_piece[lo];
    if (k >= np) continue;  // a piece of an entry past the list's end
    const int part0 = l.part0[lo];
    // this slot's share of the piece
    const int p0 = f + k * piece;
    const int len = min(piece, n - k * piece);
    const int per = ceil_div(len, slots);
    const int s0 = p0 + min(j * per, len);
    const int s1 = p0 + min((j + 1) * per, len) - 1;
    float* part = l.part + static_cast<int64_t>(part0 + k) * a.feat;
    for (int c0 = 0; c0 < words; c0 += 32) {
      const int col = c0 + c;
      const bool mine = col < words;
      float acc[NV];
      walk<T, NV, kPerm, kInFlightLong, W>(a, s0, s1, r, c, lg, mask, col,
                                           mine, acc);
      add_shares(acc);
      if (j == 0 && mine) {
        if (np == 1) {
          *reinterpret_cast<W*>(out + static_cast<int64_t>(r) * a.feat +
                                col * NV) = bignn::pack_word<T, NV, W>(acc);
        } else {
#pragma unroll
          for (int v = 0; v < NV; ++v) part[col * NV + v] = acc[v];
        }
      }
    }
    if (np == 1) continue;
    // the block that completes the row's last piece adds its partials
    __threadfence();
    __syncthreads();
    if (tid == 0) finisher = atomicAdd(l.done + lo, 1) == np - 1;
    __syncthreads();
    if (!finisher) continue;
    __threadfence();
    const float* parts = l.part + static_cast<int64_t>(part0) * a.feat;
    const int kper = ceil_div(np, slots);
    const int k0 = min(j * kper, np);
    const int k1 = min((j + 1) * kper, np);
    for (int c0 = 0; c0 < words; c0 += 32) {
      const int col = c0 + c;
      const bool mine = col < words;
      float acc[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v] = 0.f;
      for (int kk = k0; mine && kk < k1; ++kk) {
#pragma unroll
        for (int v = 0; v < NV; ++v)
          acc[v] += __ldcg(parts + static_cast<int64_t>(kk) * a.feat +
                           col * NV + v);
      }
      add_shares(acc);
      if (j == 0 && mine)
        *reinterpret_cast<W*>(out + static_cast<int64_t>(r) * a.feat +
                              col * NV) = bignn::pack_word<T, NV, W>(acc);
    }
  }
}

// Blocks of the long-row pass: 2 an SM of the current device.
int long_blocks() {
  static int sms[bignn::kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 264;
  if (dev >= bignn::kMaxDevices) return 264;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 264;
  return 2 * sms[dev];
}

// Launch `kernel` as a dependent link of the chain (programmatic stream
// serialization: it may start before the kernel before it has finished,
// and waits for it with griddepcontrol.wait).
template <class... Params, class... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             dim3 block, size_t smem, cudaStream_t st,
                             Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = kDependentLaunch;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <class T, int NV>
cudaError_t launch_walks(const Walk<T>& a, const int* first,
                         const int* last, int num_pos, int num_out,
                         LongRows l, T* out, cudaStream_t st) {
  const int words = a.feat / NV;
  const int lg = bignn::slot_log2(words < 32 ? words : 32);
  const int long_min = long_min_of(num_pos);
  // a piece: kSharePerSlot positions for each slot of a block
  const int piece = (kThreads >> lg) * kSharePerSlot;
  const int64_t threads = static_cast<int64_t>(num_out) << lg;
  const int grid = static_cast<int>((threads + kRowWarps * 32 - 1) /
                                    (kRowWarps * 32));
  const bool perm = a.perm != nullptr;
  const bool wide = lg == 5;
  const cudaError_t err = launch_dependent(
      perm ? (wide ? spmm_rows<T, NV, true, true>
                   : spmm_rows<T, NV, true, false>)
           : (wide ? spmm_rows<T, NV, false, true>
                   : spmm_rows<T, NV, false, false>),
      dim3(grid), dim3(kRowWarps * 32), 0, st, a, first, last, num_out,
      long_min, piece, l, out);
  if (err != cudaSuccess || num_pos <= long_min)  // no row can be long
    return err;
  return launch_dependent(
      perm ? spmm_long<T, NV, true> : spmm_long<T, NV, false>,
      dim3(long_blocks()), dim3(kThreads), sizeof(float) * kThreads * NV, st,
      a, first, last, piece, l, out);
}

template <class T>
int spmm(const void* x, int num_x, const void* ids, int num_pos,
         const void* perm, const void* rows, const void* weight, int num_out,
         int feat, bool clip, void* first, void* last, void* scratch,
         void* out, void* stream) {
  if (num_x < 0 || num_pos < 0 || num_out < 0 || feat < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_out > 0) {
    const int* id = static_cast<const int*>(ids);
    int* f = static_cast<int*>(first);
    int* la = static_cast<int*>(last);
    const LongRows l = long_rows(scratch, num_pos);
    init_spmm<<<ceil_div(num_out, 256), 256, 0, st>>>(f, la, num_out,
                                                         num_pos, l);
    cudaError_t err = cudaSuccess;
    if (num_pos > 0)
      err = launch_dependent(spmm_bounds, dim3(ceil_div(num_pos, 256)),
                             dim3(256), 0, st, id, num_pos, num_out, f, la);
    if (err == cudaSuccess && feat > 0) {
      const Walk<T> a{static_cast<const T*>(x), num_x, id,
                      static_cast<const int*>(perm),
                      static_cast<const int*>(rows),
                      static_cast<const float*>(weight), feat, clip};
      T* o = static_cast<T*>(out);
      // the widest word on which every row of x and of out starts
      const int nv = bignn::word_values<T>(
          feat, reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out));
      if (sizeof(T) == 2 && nv == 8) {
        err = launch_walks<T, 16 / sizeof(T)>(a, f, la, num_pos, num_out, l,
                                              o, st);
      } else if (nv == 4) {
        err = launch_walks<T, 4>(a, f, la, num_pos, num_out, l, o, st);
      } else if (nv == 2) {
        err = launch_walks<T, 2>(a, f, la, num_pos, num_out, l, o, st);
      } else {
        err = launch_walks<T, 1>(a, f, la, num_pos, num_out, l, o, st);
      }
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of the scratch that the entry points below take for num_pos
// positions (edges) and rows of feat values, written to *bytes (int64).
int bignn_spmm_scratch(int num_pos, int feat, void* bytes, void* stream) {
  (void)stream;
  *static_cast<int64_t*>(bytes) =
      num_pos < 0 || feat < 0 ? 0 : scratch_bytes(num_pos, feat);
  return static_cast<int>(cudaSuccess);
}

// Forward. x [num_x, feat] f32 or bf16, src/dst [num_edges] int32 (dst
// sorted for speed, right in any order), weight [num_edges] f32 or null, out
// [num_out, feat] in x's type; first/last are [num_out] int32 scratch, and
// scratch bignn_spmm_scratch(num_edges, feat) bytes on 16 bytes.
// Returns cudaGetLastError().
int bignn_spmm_f32(const void* x, int num_x, const void* src, const void* dst,
                   const void* weight, int num_edges, int num_out, int feat,
                   void* first, void* last, void* scratch, void* out,
                   void* stream) {
  return spmm<float>(x, num_x, dst, num_edges, nullptr, src, weight, num_out,
                     feat, true, first, last, scratch, out, stream);
}

int bignn_spmm_bf16(const void* x, int num_x, const void* src,
                    const void* dst, const void* weight, int num_edges,
                    int num_out, int feat, void* first, void* last,
                    void* scratch, void* out, void* stream) {
  return spmm<__nv_bfloat16>(x, num_x, dst, num_edges, nullptr, src, weight,
                             num_out, feat, true, first, last, scratch, out,
                             stream);
}

// Backward d_x. g [num_g, feat] f32 or bf16 (the cotangent of the forward's
// output, num_g = its num_out), dst/weight as in the forward,
// perm/src_sorted [num_edges] int32 (argsort of src, src[perm]), d_x
// [num_x, feat] in g's type; first/last are [num_x] int32 scratch, and
// scratch bignn_spmm_scratch(num_edges, feat) bytes on 16 bytes.
int bignn_spmm_bwd_f32(const void* g, int num_g, const void* dst,
                       const void* weight, const void* perm,
                       const void* src_sorted, int num_edges, int num_x,
                       int feat, void* first, void* last, void* scratch,
                       void* d_x, void* stream) {
  return spmm<float>(g, num_g, src_sorted, num_edges, perm, dst, weight,
                     num_x, feat, false, first, last, scratch, d_x, stream);
}

int bignn_spmm_bwd_bf16(const void* g, int num_g, const void* dst,
                        const void* weight, const void* perm,
                        const void* src_sorted, int num_edges, int num_x,
                        int feat, void* first, void* last, void* scratch,
                        void* d_x, void* stream) {
  return spmm<__nv_bfloat16>(g, num_g, src_sorted, num_edges, perm, dst,
                             weight, num_x, feat, false, first, last,
                             scratch, d_x, stream);
}

}  // extern "C"
