// The weight gradient of the ELL matvec for Hopper (sm_90a), without atomics:
//
//   dw[j] = sum over (b, k) with idx[b, k] == j of val[b, k] * g[b]
//
// Replaces the backward of the TPU kernel ell_matvec_pallas
// (dmlc_tpu/ops/pallas_sparse.py, _ell_ad_bwd: an XLA scatter-add of
// val * g into the idx rows). On this card PyTorch's scatter-add
// (index_add_) is one float atomic per slot: 229,376 of them into 29
// addresses a step on the main path, serialised on those addresses, and
// summed in an order that changes from run to run.
//
// What bounds it: bytes. Each slot reads 4 B of idx and 4 B of val (and g
// once a row) for one multiply-add. Two launches, no float atomics:
//
// - Narrow tables (W <= kLaneBinsMax, the main path's 29 words), when idx
//   and val start 16-byte aligned and K <= 64: the forward's tile machinery
//   (k1_tiles.cuh). Each warp walks 32-row tiles that lane 0 copies into
//   the warp's shared memory with cp.async.bulk, double-buffered on two
//   mbarriers, and lane r takes row r: it reads g[row] once and adds each
//   of the row's products val * g to its own bin of that index. Every lane
//   owns W bins, laid out lane-minor so that lane l's bins all sit in bank
//   l: no two lanes ever touch one word, so there is nothing to match, and
//   no bank conflict whatever the indices are. The block then sums each
//   (warp, bin) over its 32 lanes, one thread each, and each bin over its
//   warps, in fixed orders, into its row of a [blocks, W] partial.
// - Otherwise (W <= kDwMaxTable): each block takes a contiguous run of
//   rows, each warp a run of those, walked 32 flat slots at a time, and
//   every warp owns W bins. In a chunk, the lanes holding the same index
//   find each other with __match_any_sync; the lowest of them sums their
//   products in lane order, pulling each with a shuffle, and adds the sum
//   to the warp's bin. The block sums its warps' bins in warp order.
// - A second launch sums the partials over the blocks: one warp a word,
//   lane l over blocks l, l + 32, ..., then a fixed shuffle tree.
//
// Every sum runs in an order fixed by B, K, W, the route and the card's SM
// count, so dw has the same bits on every run for a given shape and card.
// Eligible for W <= kDwMaxTable (4096): eight warps' bins then take at most
// 128 KB of the 227 KB of shared memory a block may use. A wider table
// keeps PyTorch's scatter (the caller routes by W). An index outside
// [0, W) contributes nothing, as in the forward.
//
// Host interface: plain C, loaded with ctypes. The launches go on the
// caller's stream, do not synchronise and allocate nothing: the caller
// passes a scratch of dmlc_ell_dw_scratch_floats() floats for the
// partials. The return value is cudaGetLastError() after the launches.

#include <cstdint>
#include <cuda_runtime.h>

#include "k1_tiles.cuh"

namespace {

using namespace dmlc_k1;

constexpr int kWarps = 8;         // the flat route's block
constexpr int kTileWarps = 4;     // the tile route's block
constexpr int64_t kDwMaxTable = 4096;
constexpr int kLaneBinsMax = 48;  // 4 warps x 32 lanes x 48 bins = 24 KB
constexpr int64_t kMaxTileK = 64;
constexpr int64_t kSmemPerSm = 200 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoBin = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kTileWarps * 32)
ell_dw_tiles_kernel(const int32_t* __restrict__ idx, const float* __restrict__ val,
                    const float* __restrict__ g, float* __restrict__ partial,
                    int64_t num_rows, int num_k, int table_size, int64_t num_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kTileWarps][2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile_words = 32LL * num_k;
  const int64_t stage_bytes = 2 * tile_words * 4;
  unsigned char* stages = smem + warp * 2 * stage_bytes;
  // [kTileWarps][table_size][32] lane bins, then [kTileWarps][table_size]
  float* bins = reinterpret_cast<float*>(smem + kTileWarps * 2 * stage_bytes);
  float* lane_sums = bins + kTileWarps * table_size * 32;
  const int64_t all_warps = static_cast<int64_t>(gridDim.x) * kTileWarps;
  int64_t tile = static_cast<int64_t>(blockIdx.x) * kTileWarps + warp;

  for (int i = tid; i < kTileWarps * table_size * 32; i += kTileWarps * 32) bins[i] = 0.0f;
  if (lane == 0) {
    mbar_init(&bars[warp][0], 1);
    mbar_init(&bars[warp][1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (tile < num_tiles) {
      issue_tile(stages, tile_words, &bars[warp][0], idx, val, num_rows, num_k, 32, tile);
    }
  }
  __syncthreads();

  float* my_bins = bins + warp * table_size * 32;
  const uint32_t ws = static_cast<uint32_t>(table_size);
  const int first = first_group(num_k, lane);
  uint32_t phase = 0;  // bit s: the parity stage s waits for next
  for (int it = 0; tile < num_tiles; tile += all_warps, ++it) {
    const int stage = it & 1;
    const int64_t row0 = tile * 32;
    const int64_t rows = min(static_cast<int64_t>(32), num_rows - row0);
    const int64_t next = tile + all_warps;
    // the other stage was last read in the previous iteration, which ended
    // in __syncwarp
    if (lane == 0 && next < num_tiles) {
      issue_tile(stages + (stage ^ 1) * stage_bytes, tile_words, &bars[warp][stage ^ 1], idx,
                 val, num_rows, num_k, 32, next);
    }
    while (!mbar_try_wait(&bars[warp][stage], (phase >> stage) & 1u)) {
    }
    phase ^= 1u << stage;
    if (lane < rows) {
      const float g_row = __ldg(g + row0 + lane);
      const int32_t* row_idx =
          reinterpret_cast<const int32_t*>(stages + stage * stage_bytes) + lane * num_k;
      const float* row_val = reinterpret_cast<const float*>(
                                 stages + stage * stage_bytes + tile_words * 4) + lane * num_k;
      for_row_groups<false, kVec>(row_idx, row_val, num_k, first, 0, true,
                                  [&](int32_t i, float v) {
                                    // unsigned: a negative index wraps high, skipped too
                                    const uint32_t u = static_cast<uint32_t>(i);
                                    if (u < ws) my_bins[u * 32 + lane] += v * g_row;
                                  });
    }
    __syncwarp();
  }
  __syncthreads();
  // each (warp, bin) over its lanes, one thread each; the lanes are read
  // rotated by the cell's number, so a warp's 32 reads fall in 32 banks
  for (int wj = tid; wj < kTileWarps * table_size; wj += kTileWarps * 32) {
    const float* cell = bins + wj * 32;
    float s = 0.0f;
#pragma unroll 8
    for (int l = 0; l < 32; ++l) s += cell[(l + wj) & 31];
    lane_sums[wj] = s;
  }
  __syncthreads();
  for (int j = tid; j < table_size; j += kTileWarps * 32) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) s += lane_sums[w * table_size + j];
    partial[static_cast<int64_t>(blockIdx.x) * table_size + j] = s;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
ell_dw_flat_kernel(const int32_t* __restrict__ idx, const float* __restrict__ val,
                   const float* __restrict__ g, float* __restrict__ partial,
                   int64_t num_rows, int num_k, int table_size, int64_t rows_per_block) {
  extern __shared__ float warp_bins[];  // [kWarps][table_size]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kWarps * table_size; i += kWarps * 32) warp_bins[i] = 0.0f;
  __syncthreads();

  float* my_bins = warp_bins + warp * table_size;
  const int64_t b_lo = blockIdx.x * rows_per_block;
  const int64_t b_hi = min(num_rows, b_lo + rows_per_block);
  const int64_t per_warp = (b_hi - b_lo + kWarps - 1) / kWarps;
  const int64_t r_lo = b_lo + warp * per_warp;
  const int64_t r_hi = min(b_hi, r_lo + per_warp);
  if (r_lo < r_hi) {  // warp-uniform
    const int32_t* w_idx = idx + r_lo * num_k;
    const float* w_val = val + r_lo * num_k;
    const float* w_g = g + r_lo;
    const int end = static_cast<int>((r_hi - r_lo) * num_k);
    for (int base = 0; base < end; base += 32) {
      const int slot = base + lane;
      uint32_t bin = kNoBin;
      float c = 0.0f;
      if (slot < end) {
        // unsigned compare: a negative index wraps high and is skipped too
        const uint32_t i = static_cast<uint32_t>(__ldg(w_idx + slot));
        if (i < static_cast<uint32_t>(table_size)) {
          bin = i;
          c = __ldg(w_val + slot) * __ldg(w_g + slot / num_k);
        }
      }
      const unsigned peers = __match_any_sync(kFull, bin);
      const unsigned most = __reduce_max_sync(kFull, static_cast<unsigned>(__popc(peers)));
      unsigned rest = peers & (peers - 1);  // the peers after the lowest lane
      float sum = c;
      for (unsigned t = 1; t < most; ++t) {
        const int src = rest ? __ffs(rest) - 1 : lane;
        const float v = __shfl_sync(kFull, c, src);
        if (rest) {
          sum += v;
          rest &= rest - 1;
        }
      }
      if (bin != kNoBin && lane == __ffs(peers) - 1) my_bins[bin] += sum;
      __syncwarp();  // this chunk's bin writes before the next chunk's reads
    }
  }
  __syncthreads();
  for (int j = tid; j < table_size; j += kWarps * 32) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_bins[w * table_size + j];
    partial[static_cast<int64_t>(blockIdx.x) * table_size + j] = s;
  }
}

// The partials summed over the blocks: one warp a word.
__global__ void __launch_bounds__(kWarps * 32)
ell_dw_finish_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                     int64_t num_blocks, int table_size) {
  const int lane = threadIdx.x & 31;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (j >= table_size) return;  // warp-uniform
  float s = 0.0f;
#pragma unroll 4
  for (int64_t b = lane; b < num_blocks; b += 32) s += partial[b * table_size + j];
  s = warp_sum(s);
  if (lane == 0) dw[j] = s;
}

struct Plan {
  bool tiles;        // the tile route
  int64_t blocks;
  int64_t rows_per_block;  // the flat route's
  size_t smem;
};

// The route and the grid. Tile route: a persistent grid of as many blocks
// an SM as shared memory holds, at most 4. Flat route: 2 blocks an SM up to
// 1024 words, then 1 (the partials grow with blocks * W), at least kWarps
// rows a block.
Plan plan(const int32_t* idx, const float* val, int64_t num_rows, int64_t num_k,
          int64_t table_size, int dev) {
  Plan p{};
  const int64_t sms = sm_count(dev);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(val)) & 15) == 0;
  p.tiles = table_size <= kLaneBinsMax && num_k <= kMaxTileK && aligned;
  if (p.tiles) {
    p.smem = static_cast<size_t>(kTileWarps) *
             (2 * 2 * 32 * num_k + table_size * 32 + table_size) * sizeof(float);
    int64_t fit = kSmemPerSm / static_cast<int64_t>(p.smem);
    fit = fit < 1 ? 1 : (fit > 4 ? 4 : fit);
    const int64_t tiles = (num_rows + 31) / 32;
    p.blocks = (tiles + kTileWarps - 1) / kTileWarps;
    const int64_t cap = sms * fit;
    if (p.blocks > cap) p.blocks = cap;
    return p;
  }
  p.smem = static_cast<size_t>(kWarps) * table_size * sizeof(float);
  int64_t target = sms * (table_size <= 1024 ? 2 : 1);
  const int64_t most = (num_rows + kWarps - 1) / kWarps;
  if (target > most) target = most;
  if (target < 1) target = 1;
  p.rows_per_block = (num_rows + target - 1) / target;
  p.blocks = (num_rows + p.rows_per_block - 1) / p.rows_per_block;
  return p;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int variant, int dev, size_t smem) {
  static size_t granted[3][64] = {};
  if (smem <= 48 * 1024 || dev < 0 || dev >= 64 || granted[variant][dev] >= smem) {
    return cudaSuccess;
  }
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc == cudaSuccess) granted[variant][dev] = smem;
  return rc;
}

}  // namespace

extern "C" int64_t dmlc_ell_dw_max_table() { return kDwMaxTable; }

// The scratch the launch below needs, in floats; it depends on idx and
// val's alignment too (the route).
extern "C" int64_t dmlc_ell_dw_scratch_floats(const int32_t* idx, const float* val,
                                              int64_t num_rows, int64_t num_k,
                                              int64_t table_size) {
  if (num_rows <= 0 || num_k <= 0 || table_size <= 0) return 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  return plan(idx, val, num_rows, num_k, table_size, dev).blocks * table_size;
}

extern "C" int dmlc_ell_matvec_dw_f32(const int32_t* idx, const float* val,
                                      const float* g, float* dw, float* scratch,
                                      int64_t num_rows, int64_t num_k, int64_t table_size,
                                      cudaStream_t stream) {
  if (num_rows < 0 || num_k < 0 || table_size < 0 || table_size > kDwMaxTable) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (table_size == 0) return static_cast<int>(cudaSuccess);
  if (num_rows == 0 || num_k == 0) {
    return static_cast<int>(cudaMemsetAsync(dw, 0, table_size * sizeof(float), stream));
  }
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const Plan p = plan(idx, val, num_rows, num_k, table_size, dev);
  if (!p.tiles && p.rows_per_block * num_k > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k = static_cast<int>(num_k);
  const int ws = static_cast<int>(table_size);
  const unsigned int grid = static_cast<unsigned int>(p.blocks);
  if (p.tiles) {
    const int64_t num_tiles = (num_rows + 31) / 32;
    if (num_k % 4 == 0) {
      rc = allow_smem(ell_dw_tiles_kernel<true>, 0, dev, p.smem);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      ell_dw_tiles_kernel<true><<<grid, kTileWarps * 32, p.smem, stream>>>(
          idx, val, g, scratch, num_rows, k, ws, num_tiles);
    } else {
      rc = allow_smem(ell_dw_tiles_kernel<false>, 1, dev, p.smem);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      ell_dw_tiles_kernel<false><<<grid, kTileWarps * 32, p.smem, stream>>>(
          idx, val, g, scratch, num_rows, k, ws, num_tiles);
    }
  } else {
    rc = allow_smem(ell_dw_flat_kernel, 2, dev, p.smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    ell_dw_flat_kernel<<<grid, kWarps * 32, p.smem, stream>>>(
        idx, val, g, scratch, num_rows, k, ws, p.rows_per_block);
  }
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned int finish_grid = static_cast<unsigned int>((table_size + kWarps - 1) / kWarps);
  ell_dw_finish_kernel<<<finish_grid, kWarps * 32, 0, stream>>>(scratch, dw, p.blocks, ws);
  return static_cast<int>(cudaGetLastError());
}
