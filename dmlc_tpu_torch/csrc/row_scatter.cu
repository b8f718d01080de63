// Row scatter-add for Hopper (sm_90a) that gives the same bits on every run:
//
//   table[d, :] (+)= sum over i with idx[i] == d of src[i, :]
//
// for idx [N], src [N, R] and table [D, R] (R = 1 for a vector). It takes
// the place of the XLA scatter-adds of the JAX package's ALS and FM steps
// and of its bcoo gradient (dmlc_tpu/models/als.py:169-171, the transposes
// of the gathers in dmlc_tpu/models/fm.py:64-69, bcoo_dot_general's
// transpose); no Pallas kernel stands behind them. On this card PyTorch's index_add_
// adds with one float atomic a word, in an order that changes from run to
// run, and index_put_(accumulate=True), deterministic, ran 38-132x slower
// than index_add_ at the ALS shapes (PERF.md §6).
//
// What bounds it: bytes, and only the bytes the N entries need. Without
// accumulate the whole table is written once (zeroed); then src is read
// once and each touched row written once. A row no entry hits costs
// nothing beyond the zeroing, so the cost follows N, not D.
//
// The entries are first put in a stable order by row id, so each table
// row's entries form one run, kept in their original order:
//
// 0. the sort. For tables of at most kSortMaxRows rows, a counting sort
//    here (dmlc_row_sort, three launches): each tile of kSortTile entries
//    counts its ids in shared memory (integer atomics: the counts are the
//    same whatever their order); one block turns the (id, tile) counts
//    into each tile's first slot for each id; then one warp a tile loads
//    its ids into registers and walks them 32 at a time, in order, and the
//    lanes that hold one id take consecutive slots by lane
//    (__match_any_sync). Wider tables are sorted by the caller
//    (torch.sort(stable=True) with an id outside [0, D) keyed as D): the
//    same order. Either way an id outside [0, D) sorts after every row.
//
// Then, without accumulate, the table is zeroed by cudaMemsetAsync (on the
// H100 it beat a grid-stride kernel of 16-byte stores by 2% on 1.6 GB).
// Then two launches, no float atomics; the sorted order is cut into
// chunks of kChunk entries:
//
// 1. chunk runs: one thread a chunk and column (a float4 of four columns
//    for rows of kVecMinWidth words or more), neighbouring threads on
//    neighbouring columns, walks the chunk's entries in sorted order. A
//    run that begins and ends in the chunk is summed entry by entry and
//    written to its row. For the run that began in the chunk before,
//    head[c] is its sum in the chunk; for the one that goes on into the
//    next chunk, tail[c] (a chunk inside one run: head == tail == its sum).
// 2. long runs: one thread a chunk and column. The thread of the chunk
//    where a run that goes on begins finds the run's last chunk (a search
//    over the chunks' first ids, kProbes loads a round) and writes
//    tail[first chunk] + tail of each chunk inside it + head[last chunk],
//    the partials loaded kBatch at a time. Every other thread returns
//    after three id loads.
//
// Both launches take blocks as small as a warp when the grid would leave
// SMs idle: a 1-D table gives one thread a chunk, N / 32 threads in all.
//
// Why this shape: the launches see only the N entries, so a row no entry
// hits costs nothing beyond the zeroing. The version before this one gave
// each table word a thread and each table row a binary search over the
// sorted ids. On an H100 (chip_smoke.py row_scatter_ab, sort included,
// PERF.md §6): 81,920 ids into 50,000,001 words 0.17 ms against its 1.31
// (zeros + index_add_ 0.13); into [50,000,001, 8] 0.59 ms against 4.89
// (0.55); at the ALS gram 0.047 ms against 0.045, the FM shapes level.
// Variants tried on the H100 and dropped: runs found tile by tile
// (a search a run, packed in shared memory) ran 10-30% over the version
// before at the small FM and ALS shapes, as a long run's chain of partials
// started only when the scheduler reached its tile; a warp folding each
// narrow run together (shuffles) ran several times over it, its lanes
// taking one run's columns in turn. Launch 1 reads every entry anyway, so
// it sums the short runs; float4 shares cut its time at the 256-word ALS
// rows by a third, but slowed launch 2's chains, which stay a float a
// thread.
//
// The sums run in exactly the order of the version before, so each
// touched row has the same bits as it gave. One deliberate difference:
// with accumulate, a row no entry hits is not touched at all (that
// version wrote *out + 0.0f there, turning a -0.0 into +0.0; index_add_
// also leaves such a row as it was). Without accumulate a row with no
// entries gets +0.0, as before. Every sum runs in an order fixed by idx
// alone, so the result has the same bits on every run, whichever route
// sorted it.
//
// Host interface: plain C, loaded with ctypes. The launches go on the
// caller's stream, do not synchronise and allocate nothing: the caller
// passes the sort's outputs and scratch (dmlc_row_sort_counts() ints, 0
// when the table is too wide for the counting sort) and the partials' (two
// [ceil(N / kChunk), R] float arrays, dmlc_row_scatter_chunks() rows). The
// return value is cudaGetLastError() after the launches.

#include <cstdint>
#include <cuda_runtime.h>

#include "k1_tiles.cuh"  // dmlc_k1::sm_count

namespace {

constexpr int64_t kChunk = 32;  // sorted entries a partial sums at most
constexpr int kThreads = 256;
constexpr int kSortSteps = 32;            // 32-entry steps of a tile, its keys held in registers
constexpr int64_t kSortTile = 32 * kSortSteps;  // entries one warp places
constexpr int64_t kSortMaxRows = 4095;    // its rows + 1 id counts fit 16 KB of shared memory
constexpr int64_t kSortMaxCounts = 1 << 20;  // (rows + 1) x tiles, scanned by one block
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;                  // counts a scan thread takes from shared memory
constexpr int kScanSegment = kScanThreads * kScanPer;  // counts staged at once: 32 KB
constexpr int kBatch = 64;                  // partials a long run's thread loads at once
constexpr int kProbes = 8;                  // ids a search round loads at once
constexpr int64_t kVecMinWidth = 64;        // rows this wide take launch 1 by float4 shares

// ids outside [0, rows) sort after every row, as the id `rows`
__device__ __forceinline__ int32_t sort_key(int32_t id, int64_t rows) {
  return id < 0 || id >= rows ? static_cast<int32_t>(rows) : id;
}

__global__ void tile_counts(const int32_t* __restrict__ idx, int64_t n, int64_t rows,
                            int64_t tiles, int32_t* __restrict__ counts) {
  extern __shared__ int32_t hist[];
  int64_t keys = rows + 1;
  for (int64_t b = threadIdx.x; b < keys; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  int64_t lo = blockIdx.x * kSortTile, hi = lo + kSortTile < n ? lo + kSortTile : n;
  for (int64_t j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    atomicAdd(&hist[sort_key(idx[j], rows)], 1);
  }
  __syncthreads();
  for (int64_t b = threadIdx.x; b < keys; b += blockDim.x) counts[b * tiles + blockIdx.x] = hist[b];
}

// exclusive prefix sum of the counts in place, in (id, tile) order: one
// block, a segment of kScanSegment counts at a time staged in shared
// memory with coalesced loads; each thread sums kScanPer of them, the
// threads' sums are scanned by warp shuffles, and a carry runs from one
// segment to the next
__global__ void scan_counts(int32_t* __restrict__ counts, int64_t total) {
  __shared__ int32_t seg[kScanSegment];
  __shared__ int32_t warp_sums[kScanThreads / 32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t carry = 0;
  for (int64_t base = 0; base < total; base += kScanSegment) {
    for (int i = threadIdx.x; i < kScanSegment; i += blockDim.x) {
      seg[i] = base + i < total ? counts[base + i] : 0;
    }
    __syncthreads();
    int32_t sum = 0;
    for (int i = 0; i < kScanPer; ++i) sum += seg[threadIdx.x * kScanPer + i];
    int32_t incl = sum;  // inclusive over the warp's threads
    for (int d = 1; d < 32; d <<= 1) {
      int32_t v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t w = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        int32_t v = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += v;
      }
      warp_sums[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    int32_t run = carry + incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
    for (int i = 0; i < kScanPer; ++i) {
      int32_t v = seg[threadIdx.x * kScanPer + i];
      seg[threadIdx.x * kScanPer + i] = run;
      run += v;
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
    for (int i = threadIdx.x; i < kScanSegment && base + i < total; i += blockDim.x) {
      counts[base + i] = seg[i];
    }
    __syncthreads();
  }
}

__global__ void place(const int32_t* __restrict__ idx, int64_t n, int64_t rows, int64_t tiles,
                      const int32_t* __restrict__ first_slot, int32_t* __restrict__ sorted,
                      int64_t* __restrict__ perm) {
  extern __shared__ int32_t next[];  // the next free slot of each id, this tile
  int lane = threadIdx.x;
  int64_t lo = blockIdx.x * kSortTile;
  int32_t keys[kSortSteps];  // all loads of the tile in flight at once
#pragma unroll
  for (int s = 0; s < kSortSteps; ++s) {
    int64_t j = lo + s * 32 + lane;
    keys[s] = j < n ? sort_key(idx[j], rows) : -1;
  }
  for (int64_t b = lane; b <= rows; b += 32) next[b] = first_slot[b * tiles + blockIdx.x];
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kSortSteps; ++s) {
    int32_t key = keys[s];
    unsigned peers = __match_any_sync(0xffffffffu, key);
    unsigned below = peers & ((1u << lane) - 1u);
    int32_t slot = key >= 0 ? next[key] + __popc(below) : 0;
    __syncwarp();
    if (key >= 0) {
      sorted[slot] = key;
      perm[slot] = lo + s * 32 + lane;
      if (below == 0) next[key] += __popc(peers);  // the lowest lane of its peers
    }
    __syncwarp();
  }
}

// A thread's share of a row: one float, or four adjacent floats (a row of
// a multiple of 4 words, 16-byte aligned). Each word is summed on its own,
// in the same order either way.
__device__ __forceinline__ float vzero(float) { return 0.0f; }
__device__ __forceinline__ float4 vzero(float4) { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// row `id`'s share `col` (of `width` shares a row) set to, or added to, sum
template <typename T>
__device__ __forceinline__ void write_row(T* __restrict__ table, int32_t id, int64_t rows,
                                          int64_t width, int64_t col, T sum, int accumulate) {
  if (id < 0 || id >= rows) return;  // an id outside [0, rows) adds to no row
  T* out = table + static_cast<int64_t>(id) * width + col;
  *out = accumulate ? vadd(*out, sum) : sum;
}

// launch 1: one thread a chunk and share of a row walks the chunk's
// entries in sorted order. A run that begins and ends in the chunk is
// written to its row; the sum of the run that began in the chunk before
// goes to head, of the one that goes on into the next chunk to tail (both,
// for a chunk inside one run). Single floats are loaded first, all 32 in
// flight at once, then walked in registers; float4 shares in a loop.
template <typename T>
__global__ void chunk_runs(const int32_t* __restrict__ sorted, const int64_t* __restrict__ perm,
                           const T* __restrict__ src, T* __restrict__ head, T* __restrict__ tail,
                           T* __restrict__ table, int64_t n, int64_t width, int64_t rows,
                           int64_t chunks, int accumulate) {
  int64_t item = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (item >= chunks * width) return;
  int64_t c = item / width, col = item - c * width;
  int64_t lo = c * kChunk;
  int count = n - lo < kChunk ? static_cast<int>(n - lo) : static_cast<int>(kChunk);
  int32_t cur = sorted[lo];
  bool head_run = lo > 0 && sorted[lo - 1] == cur;
  bool goes_on = lo + count < n && sorted[lo + count] == sorted[lo + count - 1];
  T acc = vzero(T());
  auto step = [&](int32_t id, T v) {
    if (id != cur) {
      if (head_run) {
        head[item] = acc;
      } else {
        write_row(table, cur, rows, width, col, acc, accumulate);
      }
      head_run = false;
      cur = id;
      acc = vzero(T());
    }
    acc = vadd(acc, v);
  };
  if (sizeof(T) == sizeof(float)) {
    int32_t ids[kChunk];
    T vals[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      ids[u] = u < count ? sorted[lo + u] : 0;
      vals[u] = u < count ? src[perm[lo + u] * width + col] : vzero(T());
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (u < count) step(ids[u], vals[u]);
    }
  } else {
#pragma unroll 8
    for (int u = 0; u < count; ++u) step(sorted[lo + u], src[perm[lo + u] * width + col]);
  }
  if (goes_on) tail[item] = acc;
  if (head_run) {
    head[item] = acc;
  } else if (!goes_on) {
    write_row(table, cur, rows, width, col, acc, accumulate);
  }
}

// The first chunk in [a, b) that does not begin with id, or b; the chunks
// before it from a on all do (the ids are sorted). kProbes loads a round,
// all in flight at once.
__device__ __forceinline__ int64_t first_other_chunk(const int32_t* __restrict__ sorted,
                                                     int32_t id, int64_t a, int64_t b) {
  while (a < b) {
    int64_t step = (b - a + kProbes - 1) / kProbes;
    bool same[kProbes];
#pragma unroll
    for (int u = 0; u < kProbes; ++u) {
      int64_t p = a + u * step;
      same[u] = p < b && sorted[p * kChunk] == id;
    }
    int u = 0;
    while (u < kProbes && same[u]) ++u;
    if (u == 0) return a;
    int64_t next_b = a + u * step;  // the first probe that differs (or past b)
    a = a + (u - 1) * step + 1;
    b = next_b < b ? next_b : b;
  }
  return a;
}

// launch 2: a run that spans chunks, from the thread of the chunk and
// column where it begins: its last chunk (the last that begins with its
// id), then tail[first chunk] + tail of each chunk inside it +
// head[last chunk], the partials loaded kBatch at a time, all in flight.
__global__ void long_runs(const int32_t* __restrict__ sorted, const float* __restrict__ head,
                          const float* __restrict__ tail, float* __restrict__ table, int64_t n,
                          int64_t width, int64_t rows, int64_t chunks, int accumulate) {
  int64_t item = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (item >= chunks * width) return;
  int64_t c = item / width, col = item - c * width;
  int64_t lo = c * kChunk, hi = lo + kChunk;
  if (hi >= n) return;
  int32_t id = sorted[hi - 1];
  if (sorted[hi] != id || (lo > 0 && sorted[lo - 1] == id) || id < 0 || id >= rows) return;
  int64_t last = first_other_chunk(sorted, id, c + 2, chunks) - 1, k = c + 1;
  float acc = tail[c * width + col];
  for (; k + kBatch <= last; k += kBatch) {
    float part[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) part[u] = tail[(k + u) * width + col];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc += part[u];
  }
  for (; k < last; ++k) acc += tail[k * width + col];
  write_row(table, id, rows, width, col, acc + head[last * width + col], accumulate);
}

// Threads a block for `items` threads in all: kThreads, halved down to a
// warp while the grid would leave SMs idle (a 1-D table gives a launch one
// thread a chunk, N / 32 threads in all).
int block_for(int64_t items) {
  int dev = 0;
  cudaGetDevice(&dev);
  int block = kThreads, sms = dmlc_k1::sm_count(dev);
  while (block > 32 && (items + block - 1) / block < 2 * sms) block >>= 1;
  return block;
}

unsigned blocks_for(int64_t items, int block) {
  return static_cast<unsigned>((items + block - 1) / block);
}

}  // namespace

// The int32 scratch the counting sort of N ids into `rows` rows needs, or 0
// when the table is too wide for it (the caller sorts then).
extern "C" int64_t dmlc_row_sort_counts(int64_t n, int64_t rows) {
  int64_t tiles = (n + kSortTile - 1) / kSortTile;
  if (n <= 0 || rows <= 0 || rows > kSortMaxRows || (rows + 1) * tiles > kSortMaxCounts) return 0;
  return (rows + 1) * tiles;
}

// Stable order of idx [N] by row id: sorted [N] (ids outside [0, rows) as
// `rows`, after every row) and perm [N], the entry each slot holds.
extern "C" int dmlc_row_sort(const int32_t* idx, int64_t n, int64_t rows, int32_t* counts,
                             int32_t* sorted, int64_t* perm, cudaStream_t stream) {
  int64_t total = dmlc_row_sort_counts(n, rows);
  if (total == 0) return static_cast<int>(cudaErrorInvalidValue);
  int64_t tiles = total / (rows + 1);
  size_t smem = (rows + 1) * sizeof(int32_t);
  tile_counts<<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(idx, n, rows, tiles,
                                                                      counts);
  scan_counts<<<1, kScanThreads, 0, stream>>>(counts, total);
  place<<<static_cast<unsigned>(tiles), 32, smem, stream>>>(idx, n, rows, tiles, counts, sorted,
                                                            perm);
  return static_cast<int>(cudaGetLastError());
}

// Rows of each partial array (and of the chunk count): ceil(N / kChunk).
extern "C" int64_t dmlc_row_scatter_chunks(int64_t n) { return (n + kChunk - 1) / kChunk; }

extern "C" int dmlc_row_scatter_f32(const int32_t* sorted, const int64_t* perm,
                                    const float* src, float* table, float* head, float* tail,
                                    int64_t n, int64_t width, int64_t rows, int accumulate,
                                    cudaStream_t stream) {
  if (n < 0 || width <= 0 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  if (!accumulate) {
    cudaError_t rc = cudaMemsetAsync(table, 0, rows * width * sizeof(float), stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  if (n > 0) {
    int64_t chunks = dmlc_row_scatter_chunks(n), items = chunks * width;
    bool vec4 = width % 4 == 0 && width >= kVecMinWidth &&
                ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(table) |
                  reinterpret_cast<uintptr_t>(head) | reinterpret_cast<uintptr_t>(tail)) & 15) == 0;
    if (vec4) {
      int block = block_for(items / 4);
      chunk_runs<float4><<<blocks_for(items / 4, block), block, 0, stream>>>(
          sorted, perm, reinterpret_cast<const float4*>(src), reinterpret_cast<float4*>(head),
          reinterpret_cast<float4*>(tail), reinterpret_cast<float4*>(table), n, width / 4, rows,
          chunks, accumulate);
    } else {
      int block = block_for(items);
      chunk_runs<float><<<blocks_for(items, block), block, 0, stream>>>(
          sorted, perm, src, head, tail, table, n, width, rows, chunks, accumulate);
    }
    int block = block_for(items);
    long_runs<<<blocks_for(items, block), block, 0, stream>>>(sorted, head, tail, table, n, width,
                                                              rows, chunks, accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}
