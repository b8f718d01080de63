// Row scatter-add for Hopper (sm_90a) that gives the same bits on every run:
//
//   table[d, :] (+)= sum over i with idx[i] == d of src[i, :]
//
// for idx [N], src [N, R] and table [D, R] (R = 1 for a vector). It takes
// the place of the XLA scatter-adds of the JAX package's ALS and FM steps
// and of its bcoo gradient (dmlc_tpu/models/als.py:169-171, the transposes
// of the gathers in dmlc_tpu/models/fm.py:64-69, bcoo_dot_general's
// transpose); no Pallas kernel stands behind them. On this card PyTorch's
// index_add_ adds with one float atomic a word, in an order that changes
// from run to run, and index_put_(accumulate=True), deterministic, ran
// 38-132x slower than index_add_ at the ALS shapes (PERF.md §6).
//
// What bounds it: bytes. Each entry's row of src is read and each table
// row written. The entries are first put in a stable order by row id, so
// each table row's entries form one run, kept in their original order:
//
// 0. the sort. For tables of at most kSortMaxRows rows, a counting sort
//    here (dmlc_row_sort, three launches): each tile of kSortTile entries
//    counts its ids in shared memory (integer atomics: the counts are the
//    same whatever their order); one block turns the (id, tile) counts
//    into each tile's first slot for each id; then one warp a tile loads
//    its ids into registers and walks them 32 at a time, in order, and the
//    lanes that hold one id take consecutive slots by lane
//    (__match_any_sync). Wider tables are sorted by the caller
//    (torch.sort(stable=True)): the same order.
//
// Then two launches, no float atomics:
//
// 1. chunk partials: the sorted order is cut into chunks of kChunk entries.
//    For a chunk whose first run began in the chunk before, head[c] is the
//    sum of that run's entries in the chunk; for one whose last run goes
//    on into the next chunk, tail[c] the sum of that run's entries in the
//    chunk (one thread a chunk and column, in sorted order; other chunks
//    write nothing). A chunk inside one long run has head == tail == its
//    sum.
// 2. row sums: one thread a table row and column. Each block first finds
//    where its rows' runs start (a binary search a row, into shared
//    memory). A run inside one chunk is summed entry by entry; a longer
//    one as tail[first chunk] + tail of each chunk inside it + head[last
//    chunk]. So a run of any length (the ELL pad sink takes a quarter of
//    the entries at the ALS shapes) costs a thread at most kChunk loads
//    plus a partial a chunk, and the partials are spread over as many
//    threads as the run has chunks.
//
// Every sum runs in an order fixed by idx alone, so the result has the
// same bits on every run, whichever route sorted it. An id outside
// [0, D) adds to no row. With accumulate = 0 every table row is written
// (a row with no entries gets 0), so the caller need not zero the table
// first.
//
// Host interface: plain C, loaded with ctypes. The launches go on the
// caller's stream, do not synchronise and allocate nothing: the caller
// passes the sort's outputs and scratch (dmlc_row_sort_counts() ints, 0
// when the table is too wide for the counting sort) and the partials' (two
// [ceil(N / kChunk), R] float arrays, dmlc_row_scatter_chunks() rows). The
// return value is cudaGetLastError() after the launches.

#include <cstdint>
#include <cuda_runtime.h>

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

__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ sorted,
                                               int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(sorted[mid]) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void chunk_partials(const int32_t* __restrict__ sorted,
                               const int64_t* __restrict__ perm,
                               const float* __restrict__ src, float* __restrict__ head,
                               float* __restrict__ tail, int64_t n, int64_t width,
                               int64_t chunks) {
  int64_t item = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (item >= chunks * width) return;
  int64_t c = item / width, col = item - c * width;
  int64_t lo = c * kChunk, hi = lo + kChunk < n ? lo + kChunk : n;
  int32_t first = sorted[lo], last = sorted[hi - 1];
  bool need_head = lo > 0 && sorted[lo - 1] == first;
  bool need_tail = hi < n && sorted[hi] == last;
  if (!need_head && !need_tail) return;
  float h = 0.0f, t = 0.0f;
  for (int64_t j = lo; j < hi; ++j) {
    int32_t id = sorted[j];
    float v = src[perm[j] * width + col];
    if (id == first) h += v;
    if (id == last) t += v;
  }
  if (need_head) head[item] = h;
  if (need_tail) tail[item] = t;
}

__global__ void row_sums(const int32_t* __restrict__ sorted, const int64_t* __restrict__ perm,
                         const float* __restrict__ src, const float* __restrict__ head,
                         const float* __restrict__ tail, float* __restrict__ table, int64_t n,
                         int64_t width, int64_t rows, int accumulate) {
  // the runs' starts of this block's rows and of the row after the last
  __shared__ int64_t starts[kThreads + 2];
  int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  int64_t last = first + blockDim.x < rows * width ? first + blockDim.x - 1 : rows * width - 1;
  int64_t row0 = first / width, bounds = last / width - row0 + 2;
  for (int64_t t = threadIdx.x; t < bounds; t += blockDim.x) {
    starts[t] = lower_bound(sorted, n, row0 + t);
  }
  __syncthreads();
  int64_t item = first + threadIdx.x;
  if (item > last) return;
  int64_t d = item / width, col = item - d * width;
  int64_t lo = starts[d - row0], hi = starts[d - row0 + 1];
  float acc = 0.0f;
  if (hi > lo) {
    int64_t cf = lo / kChunk, cl = (hi - 1) / kChunk;
    if (cf == cl) {
      for (int64_t j = lo; j < hi; ++j) acc += src[perm[j] * width + col];
    } else {
      acc = tail[cf * width + col];
      for (int64_t c = cf + 1; c < cl; ++c) acc += tail[c * width + col];
      acc += head[cl * width + col];
    }
  }
  float* out = table + item;
  *out = accumulate ? *out + acc : acc;
}

unsigned grid_for(int64_t items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
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
  if (n == 0) {
    if (accumulate) return static_cast<int>(cudaSuccess);
    return static_cast<int>(
        cudaMemsetAsync(table, 0, rows * width * sizeof(float), stream));
  }
  int64_t chunks = dmlc_row_scatter_chunks(n);
  chunk_partials<<<grid_for(chunks * width), kThreads, 0, stream>>>(sorted, perm, src, head,
                                                                   tail, n, width, chunks);
  row_sums<<<grid_for(rows * width), kThreads, 0, stream>>>(sorted, perm, src, head, tail,
                                                           table, n, width, rows, accumulate);
  return static_cast<int>(cudaGetLastError());
}
