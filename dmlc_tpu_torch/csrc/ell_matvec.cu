// ELL sparse x dense matvec for Hopper (sm_90a):
//
//   out[b] = sum_k w[idx[b, k]] * val[b, k]
//
// Replaces the TPU kernel ell_matvec_pallas (dmlc_tpu/ops/pallas_sparse.py,
// kernel body _ell_kernel). That kernel builds a one-hot [D, bb] slab in
// VMEM and contracts it on the MXU only because Mosaic cannot gather; this
// card can, so the kernel is a direct gather: O(B*K) work instead of
// O(B*K*D), with no bound on the table width D.
//
// What bounds it: bytes. Each slot reads 4 B of idx and 4 B of val, gathers
// one 4 B word of w and does one multiply-add: about 0.25 FLOP a byte, some
// 80x below where the fp32 units would be the limit, and a gather-FMA has
// no dense product for the tensor cores to take. So no tensor cores; the
// design only moves bytes well:
//
// - A tile a warp. L lanes share a row and a warp's tile is one pass of
//   its lanes, 32 / L consecutive rows; every warp of the grid takes
//   exactly one tile, read straight from device memory, each L-lane group
//   over one row's contiguous bytes. L is enough lanes for a row's groups,
//   at most 8, up to K = 64, and K / 8 rounded up to a power of two for
//   wider rows (up to 32). Each lane takes every L-th group of its row (a
//   16-byte vector when K % 4 == 0, else a word) and a fixed shuffle tree
//   over the L lanes sums the parts. No lane idles while its warp has
//   rows. Sums are fp32.
// - w in shared memory. A table of more than kTableL1Bytes (the main
//   path's 29 words stay in L1 after the first gathers: staging them only
//   added a round trip) and at most kTableSmemBytes (4096 words: the TPU
//   band's 2049) is staged in shared memory once per block, by one
//   cp.async.bulk when w starts 16-byte aligned (else with coalesced
//   loads), and every gather reads it there. A wider table (a hashed
//   2^20-word one) is gathered through the read-only path and L2, where it
//   stays resident.
// - One route for every batch size. At the main path's 8192 rows the
//   kernel sits near the launch floor, where the shortest chain of
//   dependent steps wins. A second, persistent route for batches above
//   65,536 rows (double-buffered cp.async.bulk tiles on per-warp
//   mbarriers, a capped grid, one lane a row up to K = 32) was timed only
//   at 262,144 x 28, where it ran 1.4% behind this one (PERF.md), and no
//   caller feeds such a batch; it went, and such batches sum in this
//   route's lane order.
//
// The order of each row's sum depends only on K, L and the lane, so a
// given shape gives the same bits on every run. An index outside [0, W)
// contributes nothing (the plain version raises on it): the kernel never
// reads outside the table.
//
// The shard window. Under feature sharding (LinearLearner(model_axis=)) a
// rank holds words [lo, lo + W) of the global table, and its margin is the
// partial sum over the slots whose id falls in that window. The kernel
// takes lo as an integer and reads word id - lo, one subtraction a slot:
// no second [B, K] id tensor and no copy of w, and an id outside the
// window is skipped by the same unsigned compare as above. The unsharded
// call passes lo = 0 and gives the same bits as before.
//
// Host interface: plain C, loaded with ctypes. The launch goes on the
// caller's stream, does not synchronise and allocates nothing; the return
// value is cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "k1_tiles.cuh"

namespace {

using namespace dmlc_k1;

constexpr int kMaxWarps = 4;                    // warps a block
constexpr int64_t kTableSmemBytes = 16 * 1024;  // w staged up to 4096 words
constexpr int64_t kTableL1Bytes = 1024;         // smaller tables stay in L1

template <bool kTableSmem>
__device__ __forceinline__ float gather(const float* table, uint32_t i) {
  return kTableSmem ? table[i] : __ldg(table + i);
}

// The table holds words [lo, lo + table_size) of a model-sharded table
// (lo = 0 unsharded): id i reads word i - lo. Unsigned: an id below lo or
// negative wraps high and is skipped, as is one past the window (the
// caller keeps lo + table_size <= 2^31).
template <bool kTableSmem>
__device__ __forceinline__ void fma_slot(float& acc, const float* table, uint32_t lo,
                                         uint32_t table_size, int32_t i, float v) {
  const uint32_t u = static_cast<uint32_t>(i) - lo;
  if (u < table_size) acc = fmaf(gather<kTableSmem>(table, u), v, acc);
}

// Lanes that share a row (a power of two), from the sweep PERF.md quotes:
// enough lanes for a row's groups (see for_row_groups), at most 8, up to
// K = 64; wider rows K / 8 rounded up, at most 32.
int lanes_per_row(int64_t num_k) {
  const int64_t groups = num_k % 4 == 0 ? num_k / 4 : num_k;
  if (num_k <= 64) {
    int lanes = 1;
    while (lanes < 8 && lanes < groups) lanes <<= 1;
    return lanes;
  }
  int lanes = 2;
  while (lanes < 32 && lanes * 8 < num_k) lanes <<= 1;
  return lanes;
}

// The warp's sums for a tile of `rows` (<= 32 >> lane_shift) rows at
// tile_idx / tile_val ([rows, K] each, in device memory), written to
// out[0 .. rows): 2^lane_shift lanes a row, each lane's part (see
// for_row_groups) summed in fp32, the parts by a fixed shuffle tree.
template <bool kTableSmem, bool kVec>
__device__ __forceinline__ void tile_sums(const int32_t* tile_idx, const float* tile_val,
                                          const float* table, uint32_t lo,
                                          uint32_t table_size, float* out, int64_t rows,
                                          int num_k, int lane, int lane_shift) {
  const int lanes = 1 << lane_shift;
  const int r = lane >> lane_shift;
  const int sub = lane & (lanes - 1);
  float acc = 0.0f;
  if (r < rows) {
    for_row_groups<true, kVec>(tile_idx + r * num_k, tile_val + r * num_k, num_k, sub,
                               lane_shift, false, [&](int32_t i, float v) {
                                 fma_slot<kTableSmem>(acc, table, lo, table_size, i, v);
                               });
  }
  for (int off = 1; off < lanes; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && r < rows) out[r] = acc;
}

template <bool kTableSmem, bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
ell_matvec_kernel(const float* __restrict__ w, const int32_t* __restrict__ idx,
                  const float* __restrict__ val, float* __restrict__ out,
                  int64_t num_rows, int num_k, uint32_t lo, uint32_t table_size,
                  int lane_shift, int64_t num_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];  // the staged table
  __shared__ __align__(8) uint64_t table_bar;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warps = blockDim.x >> 5;
  const int tile_rows = 32 >> lane_shift;  // one pass of the warp's lanes
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * warps + (tid >> 5);
  float* s_table = reinterpret_cast<float*>(smem);
  const bool table_bulk = kTableSmem && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  if (kTableSmem) {
    if (table_bulk) {
      if (tid == 0) {
        mbar_init(&table_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        const uint32_t bytes = table_size * 4;
        const uint32_t bulk = bytes & ~15u;
        for (uint32_t i = bulk / 4; i < table_size; ++i) s_table[i] = w[i];
        if (bulk == 0) {
          mbar_arrive(&table_bar);
        } else {
          mbar_arrive_expect_tx(&table_bar, bulk);
          bulk_copy_g2s(s_table, w, bulk, &table_bar);
        }
      }
    } else {
      for (uint32_t i = tid; i < table_size; i += blockDim.x) s_table[i] = __ldg(w + i);
    }
  }
  __syncthreads();
  if (table_bulk) {
    while (!mbar_try_wait(&table_bar, 0)) {
    }
  }
  if (tile >= num_tiles) return;
  const int64_t row0 = tile * tile_rows;
  tile_sums<kTableSmem, kVec>(idx + row0 * num_k, val + row0 * num_k,
                              kTableSmem ? s_table : w, lo, table_size, out + row0,
                              min(static_cast<int64_t>(tile_rows), num_rows - row0), num_k,
                              lane, lane_shift);
}

using Kernel = void (*)(const float*, const int32_t*, const float*, float*, int64_t, int,
                        uint32_t, uint32_t, int, int64_t);

}  // namespace

// w holds words [lo, lo + table_size) of the table; lo = 0 and the whole
// table unsharded. Ids are int32, so a window past 2^31 reads nothing.
extern "C" int dmlc_ell_matvec_f32(const float* w, const int32_t* idx,
                                   const float* val, float* out,
                                   int64_t num_rows, int64_t num_k, int64_t lo,
                                   int64_t table_size, cudaStream_t stream) {
  if (num_rows <= 0) return static_cast<int>(cudaSuccess);
  if (num_k < 0 || num_k > 0x7fffffffLL / 32 || table_size < 0 || lo < 0 ||
      lo + table_size > 0x80000000LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_k == 0 || table_size == 0) {
    return static_cast<int>(cudaMemsetAsync(out, 0, num_rows * sizeof(float), stream));
  }
  int dev = 0;
  const cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(val)) & 15) == 0;
  const bool vec = num_k % 4 == 0 && aligned;
  // a table of a few hundred words stays in L1 once gathered: staging it
  // would only add a round trip before the first gather
  const bool table_smem = table_size * 4 <= kTableSmemBytes && table_size * 4 > kTableL1Bytes;
  const int lanes = lanes_per_row(num_k);
  const int tile_rows = 32 / lanes;
  const int64_t num_tiles = (num_rows + tile_rows - 1) / tile_rows;
  // 4 warps a block once the tiles fill the card, else 2 (more SMs)
  const int warps = num_tiles >= 4LL * sm_count(dev) ? 4 : 2;
  const int64_t grid = (num_tiles + warps - 1) / warps;  // a tile a warp
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  // at most 16 KB, 16-byte aligned: within the default 48 KB
  const size_t smem = table_smem ? (table_size * 4 + 15) / 16 * 16 : 0;
  static const Kernel kernels[4] = {
      ell_matvec_kernel<false, false>, ell_matvec_kernel<false, true>,
      ell_matvec_kernel<true, false>, ell_matvec_kernel<true, true>};
  const Kernel kernel = kernels[(table_smem ? 2 : 0) + (vec ? 1 : 0)];
  kernel<<<static_cast<unsigned int>(grid), warps * 32, smem, stream>>>(
      w, idx, val, out, num_rows, static_cast<int>(num_k), static_cast<uint32_t>(lo),
      static_cast<uint32_t>(table_size), __builtin_ctz(static_cast<unsigned>(lanes)),
      num_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dmlc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
